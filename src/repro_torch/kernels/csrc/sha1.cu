// Batched SHA-1 over host-padded message blocks.
//
// Replaces the JAX reference's Pallas kernel
// src/repro/kernels/sha1.py::_kernel (rounds in _compress, launched by
// _sha1_padded): (B, M, 16) big-endian word blocks plus each message's
// real block count -> (B, 5) digest words, equal to hashlib's.
//
// The words come from hashing.sha1_pad_batch as big-endian *values* held
// in host-order 32-bit integers, so the kernel does no byte swap.
//
// What bounds it on an H100: SHA-1 is sequential over a message's blocks,
// about 1,200 integer operations per 64-byte block, so it is bound by
// integer issue rate, not bytes.  With at most 512 messages per launch
// (the engine's hash_batch) it cannot fill 132 SMs at one thread per
// message; the launch is latency-bound, and its time is written down.
//
// Design: one thread per message, looping over that message's real
// blocks only (the reference masks padded blocks instead), with the
// message schedule as a rolling 16-word window in registers and the 80
// rounds fully unrolled.  Blocks of 32 threads spread the messages over
// as many SMs as possible.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 32

__device__ __forceinline__ uint32_t rotl(uint32_t x, int c) {
  return __funnelshift_l(x, x, c);
}

__global__ void sha1_kernel(const uint32_t* __restrict__ blocks,
                            const int32_t* __restrict__ counts,
                            uint32_t* __restrict__ out, int B, int M) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t h0 = 0x67452301u, h1 = 0xEFCDAB89u, h2 = 0x98BADCFEu,
           h3 = 0x10325476u, h4 = 0xC3D2E1F0u;
  const int nb = min(max(counts[b], 0), M);
  const uint4* msg =
      reinterpret_cast<const uint4*>(blocks + static_cast<size_t>(b) * M * 16);
  for (int m = 0; m < nb; ++m) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = msg[m * 4 + q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    uint32_t a = h0, bb = h1, c = h2, d = h3, e = h4;
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      uint32_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        wt = rotl(w[(t - 3) & 15] ^ w[(t - 8) & 15] ^ w[(t - 14) & 15] ^
                      w[t & 15], 1);
        w[t & 15] = wt;
      }
      uint32_t f, k;
      if (t < 20) {
        f = (bb & c) | (~bb & d); k = 0x5A827999u;
      } else if (t < 40) {
        f = bb ^ c ^ d; k = 0x6ED9EBA1u;
      } else if (t < 60) {
        f = (bb & c) | (bb & d) | (c & d); k = 0x8F1BBCDCu;
      } else {
        f = bb ^ c ^ d; k = 0xCA62C1D6u;
      }
      const uint32_t tmp = rotl(a, 5) + f + e + k + wt;
      e = d; d = c; c = rotl(bb, 30); bb = a; a = tmp;
    }
    h0 += a; h1 += bb; h2 += c; h3 += d; h4 += e;
  }
  uint32_t* o = out + static_cast<size_t>(b) * 5;
  o[0] = h0; o[1] = h1; o[2] = h2; o[3] = h3; o[4] = h4;
}

// blocks: (B, M, 16) uint32, 16-byte aligned; counts: (B,) int32;
// out: (B, 5) uint32.  Returns cudaGetLastError() after the launch.
extern "C" int sears_sha1(const void* blocks, const void* counts, void* out,
                          int B, int M, void* stream) {
  if (B <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((B + THREADS - 1) / THREADS);
  sha1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks),
      static_cast<const int32_t*>(counts), static_cast<uint32_t*>(out), B, M);
  return static_cast<int>(cudaGetLastError());
}
