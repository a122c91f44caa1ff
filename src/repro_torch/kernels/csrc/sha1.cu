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
// What bounds it on an H100: not bytes (a launch moves a few MB) but the
// rounds' dependent chain.  A message's blocks are hashed in order, 80
// rounds each, and round t + 1 needs round t's `a`:
//     a' = rotl(a, 5) + X,   X = f(b, c, d) + e + W[t] + K[t]
// where X needs only values known a round earlier.  So the longest
// message's 80 x blocks rounds, at two dependent integer operations
// (funnel shift, add) a round, are the floor of a launch, whatever the
// number of messages.
//
// Design: warp-specialised, latency first.  A block of 64 threads takes
// 32 messages, one a lane:
// - warp 1, the producer, brings each message's next 64-byte blocks into
//   a shared-memory ring with cp.async, RAW_SLOTS - 1 blocks ahead of the
//   one it expands, coalesced (four lanes x 16 bytes cover one message's
//   block).  It expands the schedule of the block (W[16..79]) and stores
//   W[t] + K[t] for the consumer in a second ring.
// - warp 0, the consumer, runs only the rounds: f as one LOP3, X formed a
//   round ahead, rotl(a, 5) added last, so its chain per round is
//   rotl(a, 5) + X (one LEA.HI once compiled), and the schedule takes
//   none of its instruction slots (the two warps sit on different SM
//   sub-partitions).
// The rings are handed over with named barriers (FULL: producer arrives,
// consumer waits; EMPTY: the reverse).  Both warps loop to the largest
// block count of their messages; a lane whose message is shorter skips
// the work of the blocks past its end.  Padded blocks past counts[b] are
// never read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sears_device.cuh"

#define MAX_MSGS 32   // messages a block: one a consumer lane
#define RAW_SLOTS 4   // staged blocks a message: copies run 3 ahead
#define WK_SLOTS 2    // expanded schedules a message in flight
#define RAW_WORDS 20  // words a message takes in a raw slot: 16 + 4, so
                      // 16-byte reads of 8 lanes hit 8 distinct banks
#define THREADS 64    // consumer warp + producer warp
#define BAR_FULL 1    // named barriers BAR_FULL + slot, BAR_EMPTY + slot
#define BAR_EMPTY (BAR_FULL + WK_SLOTS)

namespace {

struct Rings {
  uint32_t raw[RAW_SLOTS][MAX_MSGS * RAW_WORDS];
  uint4 wk[WK_SLOTS][20][MAX_MSGS];  // W[t] + K[t] at [t / 4][lane], t % 4
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(THREADS) : "memory");
}

__device__ __forceinline__ uint32_t round_k(int t) {
  return t < 20 ? 0x5A827999u
       : t < 40 ? 0x6ED9EBA1u
       : t < 60 ? 0x8F1BBCDCu
                : 0xCA62C1D6u;
}

// Round t's f (t is a constant once the rounds unroll): one LOP3 each.
__device__ __forceinline__ uint32_t round_f(int t, uint32_t b, uint32_t c,
                                            uint32_t d) {
  if (t < 20) return (b & c) | (~b & d);
  if (t < 40 || t >= 60) return b ^ c ^ d;
  return (b & c) | (b & d) | (c & d);
}

// Producer: stage, expand, hand over.  `nb` is this lane's message's
// block count (0 past the block's messages), `mmax` the block's largest.
__device__ __forceinline__ void produce(Rings& ring,
                                        const uint32_t* __restrict__ blocks,
                                        int first, int M, int nb, int mmax,
                                        int lane) {
  // copy q moves the 16-byte quarter lane % 4 of message 8 q + lane / 4
  constexpr int COPIES = MAX_MSGS / 8;
  int cnt[COPIES];
  const uint32_t* src[COPIES];
#pragma unroll
  for (int q = 0; q < COPIES; ++q) {
    const int msg = 8 * q + lane / 4;
    cnt[q] = __shfl_sync(0xffffffffu, nb, msg);
    src[q] = cnt[q] > 0 ? blocks + (static_cast<size_t>(first + msg) * M) *
                                       16 + (lane & 3) * 4
                        : nullptr;
  }
  auto stage = [&](int m) {
    uint32_t* slot = ring.raw[m % RAW_SLOTS];
#pragma unroll
    for (int q = 0; q < COPIES; ++q) {
      if (m < cnt[q])
        cp_async16(slot + (8 * q + lane / 4) * RAW_WORDS + (lane & 3) * 4,
                   src[q] + static_cast<size_t>(m) * 16);
    }
    cp_async_commit();  // one group a block, empty ones too
  };
#pragma unroll
  for (int m = 0; m < RAW_SLOTS - 1; ++m) stage(m);
  for (int m = 0; m < mmax; ++m) {
    // the slot refilled here was read in iteration m - 1, which ended
    // with a __syncwarp
    stage(m + RAW_SLOTS - 1);
    cp_async_wait<RAW_SLOTS - 1>();  // this lane's copies of block m
    __syncwarp();                    // ... and every other lane's
    const int s = m % WK_SLOTS;
    if (m >= WK_SLOTS) bar_sync(BAR_EMPTY + s);
    if (m < nb) {
      const uint4* raw = reinterpret_cast<const uint4*>(
          ring.raw[m % RAW_SLOTS] + lane * RAW_WORDS);
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = raw[i];
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
      uint32_t v[4];
#pragma unroll
      for (int t = 0; t < 80; ++t) {
        if (t >= 16)
          w[t & 15] = sears::rotl(w[(t - 3) & 15] ^ w[(t - 8) & 15] ^
                                      w[(t - 14) & 15] ^ w[t & 15], 1);
        v[t & 3] = w[t & 15] + round_k(t);
        if ((t & 3) == 3)
          ring.wk[s][t >> 2][lane] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncwarp();
    bar_arrive(BAR_FULL + s);
  }
}

// The 80 rounds of one block from the expanded W + K, folded into h.
__device__ __forceinline__ void rounds(uint32_t (&h)[5],
                                       const uint4 (*wk)[MAX_MSGS],
                                       int lane) {
  uint32_t x[80];
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    const uint4 v = wk[i][lane];
    x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
  uint32_t X = round_f(0, b, c, d) + e + x[0];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    const uint32_t next = sears::rotl(a, 5) + X;
    const uint32_t b30 = sears::rotl(b, 30);
    // round t + 1 sees (next, a, b30, c, d): its X needs no `next`
    if (t < 79) X = round_f(t + 1, a, b30, c) + d + x[t + 1];
    e = d; d = c; c = b30; b = a; a = next;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e;
}

// Consumer: wait for each expanded block, run its rounds, free the slot.
__device__ __forceinline__ void consume(const Rings& ring,
                                        uint32_t (&h)[5], int nb, int mmax,
                                        int lane) {
  for (int m = 0; m < mmax; ++m) {
    const int s = m % WK_SLOTS;
    bar_sync(BAR_FULL + s);
    if (m < nb) rounds(h, ring.wk[s], lane);
    __syncwarp();
    if (m + WK_SLOTS < mmax) bar_arrive(BAR_EMPTY + s);
  }
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
    sha1_kernel(const uint32_t* __restrict__ blocks,
                const int32_t* __restrict__ counts,
                uint32_t* __restrict__ out, int B, int M) {
  __shared__ Rings ring;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * MAX_MSGS;
  const int b = first + lane;
  const int nb = b < B ? min(max(counts[b], 0), M) : 0;
  const int mmax = __reduce_max_sync(0xffffffffu, nb);
  if (threadIdx.x >= 32) {  // warp-uniform: the producer warp
    produce(ring, blocks, first, M, nb, mmax, lane);
    return;
  }
  uint32_t h[5];
  sears::sha1_init(h);
  consume(ring, h, nb, mmax, lane);
  if (b < B) {
    uint32_t* o = out + static_cast<size_t>(b) * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i] = h[i];
  }
}

// blocks: (B, M, 16) uint32, 16-byte aligned; counts: (B,) int32;
// out: (B, 5) uint32.  Returns cudaGetLastError() after the launch.
extern "C" int sears_sha1(const void* blocks, const void* counts, void* out,
                          int B, int M, void* stream) {
  if (B <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((B + MAX_MSGS - 1) / MAX_MSGS);
  sha1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks),
      static_cast<const int32_t*>(counts), static_cast<uint32_t*>(out), B,
      M);
  return static_cast<int>(cudaGetLastError());
}
