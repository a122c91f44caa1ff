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
// never read.  The expansion, the hand-over and the rounds are
// sha1_ring.cuh's, which fused_ingest.cu (K5) runs too; the staging of
// host-padded blocks is this kernel's own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha1_ring.cuh"

#define RAW_SLOTS 4   // staged blocks a message: copies run 3 ahead
#define THREADS 64    // consumer warp + producer warp

namespace {

using namespace sears::ring;

struct Rings {
  uint32_t raw[RAW_SLOTS][MAX_MSGS * RAW_WORDS];
  WkSlot wk[WK_SLOTS];
};

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
    expand_hand_over(ring.wk, ring.raw[m % RAW_SLOTS] + lane * RAW_WORDS,
                     m, nb, lane);
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
  consume(ring.wk, h, nb, mmax, lane);
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
