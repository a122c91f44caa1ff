// The warp-specialised SHA-1 rounds shared by sha1.cu (K4) and
// fused_ingest.cu (K5): the rings in shared memory, the named-barrier
// hand-over, the schedule expansion and the consumer's rounds.
//
// A consumer warp hashes 32 messages, one a lane, from a ring of expanded
// schedules (W[t] + K[t]) that a producer warp fills ahead of it.  Round
// t + 1 needs round t's `a`:
//     a' = rotl(a, 5) + X,   X = f(b, c, d) + e + W[t] + K[t]
// and X needs only values known a round earlier, so the consumer forms X
// a round ahead and its chain per round is rotl(a, 5) + X (one LEA.HI
// once compiled); the schedule takes none of its instruction slots.
// The ring is handed over with named barriers between the two warps
// (FULL: producer arrives, consumer waits; EMPTY: the reverse).  Both
// warps loop to the largest block count of their messages; a lane whose
// message is shorter skips the work of the blocks past its end.
//
// Everything here is `static` or in an unnamed namespace and inlined, so
// each source that includes this header compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sears {
namespace ring {

static __device__ __forceinline__ uint32_t rotl(uint32_t x, int c) {
  return __funnelshift_l(x, x, c);
}

static __device__ __forceinline__ void sha1_init(uint32_t (&h)[5]) {
  h[0] = 0x67452301u; h[1] = 0xEFCDAB89u; h[2] = 0x98BADCFEu;
  h[3] = 0x10325476u; h[4] = 0xC3D2E1F0u;
}

constexpr int MAX_MSGS = 32;  // messages a consumer warp: one a lane
constexpr int WK_SLOTS = 2;   // expanded schedules a message in flight
constexpr int RAW_WORDS = 20; // words a message takes in a slot of 16
                              // message words: 16 + 4, so 16-byte reads of
                              // 8 lanes hit 8 distinct banks
constexpr int PAIR = 64;      // threads of a named barrier: two warps
constexpr int BAR_FULL = 1;   // named barriers BAR_FULL + slot and
constexpr int BAR_EMPTY = BAR_FULL + WK_SLOTS;  // BAR_EMPTY + slot

// W[t] + K[t] of one block of each message, at [t / 4][lane], t % 4.
typedef uint4 WkSlot[20][MAX_MSGS];

static __device__ __forceinline__ void cp_async16(void* dst,
                                                  const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static __device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(PAIR) : "memory");
}

static __device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(PAIR) : "memory");
}

static __device__ __forceinline__ uint32_t round_k(int t) {
  return t < 20 ? 0x5A827999u
       : t < 40 ? 0x6ED9EBA1u
       : t < 60 ? 0x8F1BBCDCu
                : 0xCA62C1D6u;
}

// Round t's f (t is a constant once the rounds unroll): one LOP3 each.
static __device__ __forceinline__ uint32_t round_f(int t, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  if (t < 20) return (b & c) | (~b & d);
  if (t < 40 || t >= 60) return b ^ c ^ d;
  return (b & c) | (b & d) | (c & d);
}

// Producer side: block m of this lane's message, its 16 big-endian words
// at `raw` (16-byte aligned), expanded into W[t] + K[t] in slot m %
// WK_SLOTS, then the slot handed to the consumer.  Every lane of the
// producer warp calls it for every m < mmax; `nb` is this lane's block
// count.
static __device__ __forceinline__ void expand_hand_over(
    WkSlot* wk, const uint32_t* raw, int m, int nb, int lane) {
  const int s = m % WK_SLOTS;
  if (m >= WK_SLOTS) bar_sync(BAR_EMPTY + s);
  if (m < nb) {
    const uint4* r4 = reinterpret_cast<const uint4*>(raw);
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = r4[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      if (t >= 16)
        w[t & 15] = rotl(w[(t - 3) & 15] ^ w[(t - 8) & 15] ^
                             w[(t - 14) & 15] ^ w[t & 15], 1);
      v[t & 3] = w[t & 15] + round_k(t);
      if ((t & 3) == 3)
        wk[s][t >> 2][lane] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncwarp();
  bar_arrive(BAR_FULL + s);
}

// The 80 rounds of one block from the expanded W + K, folded into h.
static __device__ __forceinline__ void rounds(uint32_t (&h)[5],
                                              const WkSlot& wk, int lane) {
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
    const uint32_t next = rotl(a, 5) + X;
    const uint32_t b30 = rotl(b, 30);
    // round t + 1 sees (next, a, b30, c, d): its X needs no `next`
    if (t < 79) X = round_f(t + 1, a, b30, c) + d + x[t + 1];
    e = d; d = c; c = b30; b = a; a = next;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e;
}

// Consumer: wait for each expanded block, run its rounds, free the slot;
// then h is this lane's digest (if nb > 0).
static __device__ __forceinline__ void consume(const WkSlot* wk,
                                               uint32_t (&h)[5], int nb,
                                               int mmax, int lane) {
  sha1_init(h);
  for (int m = 0; m < mmax; ++m) {
    const int s = m % WK_SLOTS;
    bar_sync(BAR_FULL + s);
    if (m < nb) rounds(h, wk[s], lane);
    __syncwarp();
    if (m + WK_SLOTS < mmax) bar_arrive(BAR_EMPTY + s);
  }
}

}  // namespace ring
}  // namespace sears
