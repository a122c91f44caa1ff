// Gear-CDC rolling hash over a byte stream, with or without the fused
// boundary test.
//
// Replaces the JAX reference's Pallas kernels in
// src/repro/kernels/gear_cdc.py: _fire_kernel (launched by
// _gear_fire_padded; writes the bool fire bitmap (h & mask) == 0) and
// _kernel (launched by _gear_hash_padded; writes the uint32 hashes).  Both
// share the tile body _hash_tile there, and one templated kernel here.
//
//   h[t] = sum_{j<32} gear[byte[t-j]] << j   (mod 2^32)
//
// History before stream position 0 contributes 0, not gear[0].
//
// What bounds it on an H100: per byte, one read, one gear-table lookup
// and a shift-add, then a 1-byte (fire) or 4-byte (hash) write.  The
// stream is read once from device memory (each thread also rereads its
// left neighbour's 32 bytes, from L1/L2), so the fire form is close to
// the memory bound and the hash form is write-bound.
//
// Design: the windowed sum equals the recurrence h = 2h + gear[b] run in
// 32-bit arithmetic, because a byte's term is shifted out of the word
// after 32 steps.  So each thread takes 32 consecutive positions, warms h
// up over the 32 bytes before them (h = 0 and no warm-up for the thread
// at position 0: zero history), and then emits one output per byte.
// Loads are 16-byte vectors; the 256-entry gear table sits in shared
// memory.  256 threads cover one 8192-byte tile (the reference's TILE);
// the wrapper pads the stream to bucket_len, a multiple of it.  The fire
// form stores each thread's 32 bitmap bytes as two 16-byte vectors.  The
// hash form writes four bytes a position: stored straight from each
// thread, one warp store would scatter 16-byte pieces 128 bytes apart
// over 32 lines, so each warp first passes its 32 x 32 hashes through
// 4 KB of shared memory (16-byte chunks, XOR-swizzled so neither side
// conflicts on banks) and then stores its 4 KB of output as 8 warp
// stores of 512 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define SEG 32
#define THREADS 256
#define TILE (SEG * THREADS)

__device__ __forceinline__ void load32(const uint8_t* p, uint32_t w[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

template <bool FIRE>
__global__ void gear_kernel(const uint8_t* __restrict__ data,
                            const uint32_t* __restrict__ gear, uint32_t mask,
                            void* __restrict__ out) {
  __shared__ uint32_t sg[256];
  sg[threadIdx.x] = gear[threadIdx.x];
  __syncthreads();

  const long long t0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * SEG;
  uint32_t h = 0;
  uint32_t w[8];
  if (t0 > 0) {
    load32(data + t0 - SEG, w);
#pragma unroll
    for (int m = 0; m < SEG; ++m)
      h = (h << 1) + sg[(w[m >> 2] >> ((m & 3) * 8)) & 255u];
  }
  load32(data + t0, w);
  if constexpr (FIRE) {
    uint32_t bits[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) bits[q] = 0;
#pragma unroll
    for (int m = 0; m < SEG; ++m) {
      h = (h << 1) + sg[(w[m >> 2] >> ((m & 3) * 8)) & 255u];
      bits[m >> 2] |= static_cast<uint32_t>((h & mask) == 0) << ((m & 3) * 8);
    }
    uint4* o = reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) + t0);
    o[0] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    o[1] = make_uint4(bits[4], bits[5], bits[6], bits[7]);
  } else {
    // each warp's 1024 positions are 4 KB of contiguous output
    __shared__ uint4 stage[THREADS / 32][32 * 8];
    const int lane = threadIdx.x & 31;
    uint4* st = stage[threadIdx.x >> 5];
    uint32_t hs[SEG];
#pragma unroll
    for (int m = 0; m < SEG; ++m) {
      h = (h << 1) + sg[(w[m >> 2] >> ((m & 3) * 8)) & 255u];
      hs[m] = h;
    }
    // 16-byte chunk q of lane l at row l, column q ^ (l & 7)
#pragma unroll
    for (int q = 0; q < SEG / 4; ++q)
      st[lane * 8 + (q ^ (lane & 7))] =
          make_uint4(hs[4 * q], hs[4 * q + 1], hs[4 * q + 2], hs[4 * q + 3]);
    __syncwarp();
    uint4* o = reinterpret_cast<uint4*>(static_cast<uint32_t*>(out) + t0 -
                                        lane * SEG);
#pragma unroll
    for (int i = 0; i < SEG / 4; ++i) {
      const int c = i * 32 + lane, row = c >> 3;
      o[c] = st[row * 8 + ((c & 7) ^ (row & 7))];
    }
  }
}

// data: (n,) uint8, 16-byte aligned, n % TILE == 0; gear: (256,) uint32;
// out: (n,) bool (fire != 0) or (n,) uint32 (fire == 0), 16-byte
// aligned.  Returns cudaGetLastError() after the launch.
extern "C" int sears_gear(const void* data, const void* gear, uint32_t mask,
                          void* out, long long n, int fire, void* stream) {
  if (n <= 0 || n % TILE != 0 || n / TILE > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(n / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const uint32_t* g = static_cast<const uint32_t*>(gear);
  if (fire)
    gear_kernel<true><<<blocks, THREADS, 0, s>>>(d, g, mask, out);
  else
    gear_kernel<false><<<blocks, THREADS, 0, s>>>(d, g, mask, out);
  return static_cast<int>(cudaGetLastError());
}
