// Fused ingest: SHA-1 chunk ids and the RS encode of one piece-length
// bucket, in one launch.
//
// Replaces the JAX reference's src/repro/kernels/ops.py::
// _fused_ingest_pallas, which issues the Pallas SHA-1 kernel and the
// bit-sliced GF matmul under one jit: (B, k, Lp) packed chunk bytes ->
// (B, 5) digest words and (B, n, Lp) code pieces.  The reference uploads
// each chunk twice, packed for the GF matmul and again as a host-built,
// host-padded SHA-1 message schedule; this kernel reads only the packed
// bytes plus each chunk's length and piece length, and pads on the
// device.
//
// Layout of chunk b (rs_code.pack_blob): message byte i sits at row
// i / L_b, column i % L_b of its (k, Lp) slab, where L_b is the chunk's
// own piece length (any integer >= 1), not Lp; columns past L_b are zero.
//
// What bounds it on an H100: the SHA-1 half is K4's dependent chain, ~80
// rounds of rotl(a, 5) + X for each 64-byte block of the longest message,
// on whichever SM hashes it; the GF half moves k*Lp bytes in and n*Lp out
// per chunk and is a few LOP3s a byte.  At a bucket of ~1000 chunks the
// chain is the floor and the GF work fits beside it on the other SMs.
// At a put window's buckets (~10^4 chunks) both halves are integer-bound
// and the assemblers' padding, which the staged path leaves to the host,
// adds to the hashing half's instructions.
//
// Design: one grid, two roles chosen by blockIdx.
// - The first ceil(B / 32) blocks hash 32 messages each, on K4's design
//   (sha1_ring.cuh): warp 0 is the consumer and runs only the rounds;
//   warp 1 expands each block's schedule into W + K and hands it over;
//   warps 2 and 3, the assemblers, do what the host does for K4, for the
//   even and the odd blocks of each message: they stage the blocks from
//   the packed slab with cp.async, a block ahead, and turn them into 16
//   big-endian words (alignment, byte order and padding) for the
//   expander.  Assembly takes about as many instruction slots a block as
//   the consumer's chain takes clocks, so one assembler warp held the
//   chain back; two share it, and each of the four warps has its own SM
//   sub-partition.
//   A message block starts at row 64m / L, column c = 64m % L.  The
//   assembler stages the five 16-byte granules of that row that cover
//   [c, c + 64) (cp.async needs 16-byte-aligned ends; the slab rows are
//   16-byte aligned) and, when the block runs past the row end, the first
//   four granules of the next row; it copies only granules that hold
//   message bytes.  A block inside one row and inside the message takes
//   one PRMT a word: the funnel of two staged words and the byte swap in
//   one selector.  Any other block -- across a row end, at the message
//   end, all padding -- takes the general form a word: the row part and
//   the next row's part, each funnelled, joined by a byte mask, then the
//   bytes past the message cleared and 0x80 set; the bit length fills
//   words 14-15 of the last block.  Rows shorter than 64 bytes (chunks of
//   under 64 k bytes, pad rows) are read byte by byte from the slab.
// - The other blocks encode: each thread takes one 16-byte column group
//   of one batch row at a time, K1's bit-plane product (gf_bitplane.cuh),
//   a grid-stride loop.  The (10,5) encode is a template instantiation
//   with its constants in the kernel's parameters; every other (n, k)
//   runs the generic one, which reads them from device memory.
// While the hashing blocks need at most half the SMs, every block has 512
// threads and more than half an SM's shared memory, so each SM holds one
// block: the hashing SMs keep their sub-partitions to the chains, and
// the encode blocks, one for each other SM, have 16 warps to hide their
// loads.  Past that, blocks of 128 threads, four encode blocks an SM,
// share the SMs with the hashing blocks.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "gf_bitplane.cuh"
#include "sha1_ring.cuh"

#define THREADS 512      // most a block; the hashing role uses 4 warps
#define SMALL_THREADS 128 // a block once the hashing blocks fill the card
#define TILE_L 512        // Lp is a multiple of it (the bucketing quantum)
#define ASSEMBLERS 2      // assembler warps: blocks m % 2 == 0 and == 1
#define STAGE_SLOTS 2     // staged blocks an assembler: one copy ahead
#define STAGE_WORDS 36    // a message's staging: row part 20, next row 16
#define ROW_PART 80       // bytes of the row part; the next row's follows
#define RAW_SLOTS 4       // assembled blocks a message in flight
#define ENCODE_BLOCKS_PER_SM 4  // small blocks, once the card is full

namespace {

using namespace sears::ring;

constexpr int BAR_RAW_FULL = BAR_EMPTY + WK_SLOTS;  // after the W + K ring
constexpr int BAR_RAW_EMPTY = BAR_RAW_FULL + RAW_SLOTS;
static_assert(BAR_RAW_EMPTY + RAW_SLOTS <= 16, "16 named barriers");
static_assert(RAW_SLOTS % ASSEMBLERS == 0, "a raw slot has one assembler");

struct Rings {
  // each assembler's own staging
  uint32_t stage[ASSEMBLERS][STAGE_SLOTS][MAX_MSGS * STAGE_WORDS];
  uint32_t raw[RAW_SLOTS][MAX_MSGS * RAW_WORDS];  // assemblers -> expander
  WkSlot wk[WK_SLOTS];                            // expander -> consumer
};

// One lane's message: n bytes in rows of L bytes, rows Lp bytes apart.
struct Msg {
  const uint8_t* base;
  int n, L, nb;  // nb: real 64-byte blocks, 0 past the batch
};

__device__ __forceinline__ Msg message(const uint8_t* __restrict__ data,
                                       const int32_t* __restrict__ nbytes,
                                       const int32_t* __restrict__ piece_lens,
                                       int b, int B, int k, int Lp) {
  Msg g{data, 0, 1, 0};
  if (b < B) {
    // clamp to the slab so a bad length cannot read past it
    g.L = min(max(piece_lens[b], 1), Lp);
    g.n = static_cast<int>(min(static_cast<long long>(max(nbytes[b], 0)),
                               static_cast<long long>(k) * g.L));
    g.nb = (g.n + 8) / 64 + 1;
    g.base = data + static_cast<size_t>(b) * k * Lp;
  }
  return g;
}

// __byte_perm selector: the big-endian word of the four bytes that start
// at byte q (0..3) of the 8-byte pair (lo, hi).
__device__ __forceinline__ uint32_t be_sel(int q) {
  return (q << 12) | ((q + 1) << 8) | ((q + 2) << 4) | (q + 3);
}

// The first min(max(d, 0), 4) bytes of a big-endian word set.
__device__ __forceinline__ uint32_t head_bytes(int d) {
  return ~__funnelshift_rc(0xFFFFFFFFu, 0u, 8 * min(max(d, 0), 4));
}

// Assembler `id`: stage each block m = id, id + ASSEMBLERS, ... of this
// lane's message, assemble its 16 big-endian words, hand them to the
// expander.
__device__ __forceinline__ void assemble(Rings& ring, const Msg g, int Lp,
                                         int mmax, int id, int lane) {
  constexpr int STEP = 64 * ASSEMBLERS;  // bytes from one block to the next
  const bool tiny = g.L < 64;
  uint32_t(*const stage_ring)[MAX_MSGS * STAGE_WORDS] = ring.stage[id];
  // where the next block to stage starts, and block m (L >= 64 only:
  // a step then crosses at most STEP / 64 row ends)
  int srow = 0, scol = 64 * id, col = 64 * id;
  if (!tiny && scol >= g.L) { scol -= g.L; ++srow; col -= g.L; }
  auto stage = [&](int i) {  // this assembler's i-th block
    const int ms = id + ASSEMBLERS * i;
    uint32_t* dst = stage_ring[i % STAGE_SLOTS] + lane * STAGE_WORDS;
    if (!tiny && ms < g.nb) {
      const int left = g.n - srow * g.L;  // message bytes from this row on
      const int a_end = min(min(scol + 64, g.L), left);
      const int c0 = scol & ~15;
      const uint8_t* row = g.base + static_cast<size_t>(srow) * Lp;
#pragma unroll
      for (int q = 0; q < 5; ++q)
        if (c0 + 16 * q < a_end) cp_async16(dst + 4 * q, row + c0 + 16 * q);
      const int b_end = min(64 - (g.L - scol), left - g.L);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (16 * q < b_end)
          cp_async16(dst + ROW_PART / 4 + 4 * q, row + Lp + 16 * q);
    }
    cp_async_commit();  // one group a block, empty ones too
    if (!tiny) {
      scol += STEP;
#pragma unroll
      for (int r = 0; r < ASSEMBLERS && scol >= g.L; ++r) {
        scol -= g.L;
        ++srow;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < STAGE_SLOTS - 1; ++i) stage(i);
  for (int i = 0, m = id; m < mmax; ++i, m += ASSEMBLERS) {
    // the slot refilled here was read by this lane in iteration i - 1
    stage(i + STAGE_SLOTS - 1);
    cp_async_wait<STAGE_SLOTS - 1>();  // this lane's copies of block m
    const int s = m % RAW_SLOTS;
    if (m >= RAW_SLOTS) bar_sync(BAR_RAW_EMPTY + s);
    if (m < g.nb) {
      uint32_t w[16];
      const int rem = g.n - 64 * m;  // message bytes from the block on
      if (tiny) {
        // rows under 64 bytes: byte by byte from the slab
        int r = (64 * m) / g.L, c = 64 * m - r * g.L;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          uint32_t v = 0;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int at = 4 * j + t;
            uint32_t byte = 0;
            if (at < rem) {
              byte = __ldg(g.base + static_cast<size_t>(r) * Lp + c);
              if (++c == g.L) { c = 0; ++r; }
            } else if (at == rem) {
              byte = 0x80u;
            }
            v = (v << 8) | byte;
          }
          w[j] = v;
        }
      } else {
        const uint32_t* st = stage_ring[i % STAGE_SLOTS] +
                             lane * STAGE_WORDS;
        const int sa = col & 15;   // the block's first byte in the staging
        const int a = g.L - col;   // bytes of the block left in this row
        if (a >= 64 && rem >= 64) {
          // inside the row and the message: one PRMT a word
          const uint32_t* p = st + (sa >> 2);
          const uint32_t sel = be_sel(sa & 3);
          uint32_t lo = p[0];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t hi = p[j + 1];
            w[j] = __byte_perm(lo, hi, sel);
            lo = hi;
          }
        } else {
          // byte p of the block: row part at staging byte sa + p while p
          // < a, else next row at ROW_PART + p - a
          const int qb = ROW_PART - min(a, 64);
          const uint32_t sel_a = be_sel(sa & 3), sel_b = be_sel(qb & 3);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int qa = sa + 4 * j, qn = qb + 4 * j;
            const uint32_t wa =
                __byte_perm(st[qa >> 2], st[(qa >> 2) + 1], sel_a);
            const uint32_t wn =
                __byte_perm(st[qn >> 2], st[(qn >> 2) + 1], sel_b);
            const uint32_t from_row = head_bytes(a - 4 * j);
            const int e = rem - 4 * j;  // message bytes of this word
            uint32_t v = ((wa & from_row) | (wn & ~from_row)) &
                         head_bytes(e);
            if (e >= 0 && e < 4) v |= 0x80000000u >> (8 * e);
            w[j] = v;
          }
        }
      }
      if (m == g.nb - 1) {  // the bit length, big-endian, ends the message
        const uint64_t bits = static_cast<uint64_t>(g.n) * 8u;
        w[14] = static_cast<uint32_t>(bits >> 32);
        w[15] = static_cast<uint32_t>(bits);
      }
      uint4* o = reinterpret_cast<uint4*>(ring.raw[s] + lane * RAW_WORDS);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2],
                          w[4 * q + 3]);
    }
    __syncwarp();
    bar_arrive(BAR_RAW_FULL + s);
    if (!tiny) {
      col += STEP;
#pragma unroll
      for (int r = 0; r < ASSEMBLERS && col >= g.L; ++r) col -= g.L;
    }
  }
  cp_async_wait<0>();
}

// Expander: each assembled block's schedule, handed to the consumer.
__device__ __forceinline__ void expand(Rings& ring, int nb, int mmax,
                                       int lane) {
  for (int m = 0; m < mmax; ++m) {
    const int s = m % RAW_SLOTS;
    bar_sync(BAR_RAW_FULL + s);
    expand_hand_over(ring.wk, ring.raw[s] + lane * RAW_WORDS, m, nb, lane);
    if (m + RAW_SLOTS < mmax) bar_arrive(BAR_RAW_EMPTY + s);
  }
}

// The hashing role of block `group`: its 32 messages from 32 group on.
__device__ __forceinline__ void hash_role(
    Rings& ring, const uint8_t* __restrict__ data,
    const int32_t* __restrict__ nbytes,
    const int32_t* __restrict__ piece_lens, uint32_t* __restrict__ words,
    int group, int B, int k, int Lp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp > 1 + ASSEMBLERS) return;  // warp-uniform
  const int b = group * MAX_MSGS + lane;
  const Msg g = message(data, nbytes, piece_lens, b, B, k, Lp);
  const int mmax = __reduce_max_sync(0xffffffffu, g.nb);
  if (warp >= 2) {
    assemble(ring, g, Lp, mmax, warp - 2, lane);
  } else if (warp == 1) {
    expand(ring, g.nb, mmax, lane);
  } else {
    uint32_t h[5];
    consume(ring.wk, h, g.nb, mmax, lane);
    if (b < B) {
      uint32_t* o = words + static_cast<size_t>(b) * 5;
#pragma unroll
      for (int i = 0; i < 5; ++i) o[i] = h[i];
    }
  }
}

}  // namespace

// The (10,5) encode: constants in the kernel's parameters.
template <int R, int K>
__global__ void __launch_bounds__(THREADS)
    fused_ingest_kernel(const __grid_constant__ ParamConsts<R, K> cst,
                        const uint8_t* __restrict__ data,
                        const int32_t* __restrict__ nbytes,
                        const int32_t* __restrict__ piece_lens,
                        uint32_t* __restrict__ words,
                        uint4* __restrict__ enc, int B, int Lp,
                        int hash_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rings& ring = *reinterpret_cast<Rings*>(smem);
  if (static_cast<int>(blockIdx.x) < hash_blocks) {
    hash_role(ring, data, nbytes, piece_lens, words, blockIdx.x, B, K, Lp);
    return;
  }
  const int L16 = Lp / 16;
  const long long units = static_cast<long long>(B) * L16;
  const uint4* d16 = reinterpret_cast<const uint4*>(data);
  const long long stride =
      static_cast<long long>(gridDim.x - hash_blocks) * blockDim.x;
  for (long long u = (blockIdx.x - hash_blocks) *
                         static_cast<long long>(blockDim.x) + threadIdx.x;
       u < units; u += stride) {
    const long long b = u / L16, col = u - b * L16;
    gf_unit(cst, d16 + b * K * L16 + col, enc + b * R * L16 + col, L16);
  }
}

// Any other (r, k): constants from device memory.
__global__ void __launch_bounds__(THREADS)
    fused_ingest_generic_kernel(const uint32_t* __restrict__ consts,
                                const uint8_t* __restrict__ data,
                                const int32_t* __restrict__ nbytes,
                                const int32_t* __restrict__ piece_lens,
                                uint32_t* __restrict__ words,
                                uint4* __restrict__ enc, int B, int Lp,
                                int hash_blocks, int r, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rings& ring = *reinterpret_cast<Rings*>(smem);
  if (static_cast<int>(blockIdx.x) < hash_blocks) {
    hash_role(ring, data, nbytes, piece_lens, words, blockIdx.x, B, k, Lp);
    return;
  }
  const GlobalConsts cst{consts, k};
  const int L16 = Lp / 16;
  const long long units = static_cast<long long>(B) * L16;
  const uint4* d16 = reinterpret_cast<const uint4*>(data);
  const long long stride =
      static_cast<long long>(gridDim.x - hash_blocks) * blockDim.x;
  for (long long u = (blockIdx.x - hash_blocks) *
                         static_cast<long long>(blockDim.x) + threadIdx.x;
       u < units; u += stride) {
    const long long b = u / L16, col = u - b * L16;
    gf_unit_generic(cst, d16 + b * k * L16 + col, enc + b * r * L16 + col,
                    L16, r, k);
  }
}

// What the launch shape depends on, read once a device (the current one
// then); the first read also lets both kernels take up to the largest
// dynamic shared memory a block can have.
struct Card {
  int sms, sm_smem, block_smem;
};

static cudaError_t card_of(int dev, Card& card) {
  constexpr int MAX_DEVICES = 64;
  static Card cards[MAX_DEVICES];
  static bool known[MAX_DEVICES] = {};
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[dev]) {
    card = cards[dev];
    return cudaSuccess;
  }
  cudaError_t err =
      cudaDeviceGetAttribute(&card.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &card.sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &card.block_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_ingest_kernel<10, 5>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               card.block_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_ingest_generic_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               card.block_smem);
  if (err == cudaSuccess) {
    cards[dev] = card;
    known[dev] = true;
  }
  return err;
}

// consts_host and consts_dev: the same (r, k, 8) uint32 constants
// C[i][j][b] = M[i][j] * 2^b (the byte in all four bytes), on the host
// (read here for the (10,5) instantiation) and on the device (read by the
// generic kernel).  data: (B, k, Lp) uint8, 16-byte aligned, Lp %
// TILE_L == 0; nbytes, piece_lens: (B,) int32; words: (B, 5) uint32;
// enc: (B, r, Lp) uint8, 16-byte aligned; all contiguous; r and k in
// [1, 128].  Returns cudaGetLastError() after the launch.
extern "C" int sears_fused_ingest(const void* consts_host,
                                  const void* consts_dev, const void* data,
                                  const void* nbytes, const void* piece_lens,
                                  void* words, void* enc, int B, int r, int k,
                                  int Lp, void* stream) {
  if (B <= 0 || r <= 0 || k <= 0 || r > 128 || k > 128 || Lp <= 0 ||
      Lp % TILE_L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  Card card;
  if (err == cudaSuccess) err = card_of(dev, card);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = card.sms, sm_smem = card.sm_smem,
            block_smem = card.block_smem;
  const long long hash_blocks = (static_cast<long long>(B) + MAX_MSGS - 1) /
                                MAX_MSGS;
  const long long units = static_cast<long long>(B) * (Lp / 16);
  // While the hashing blocks need at most half the SMs: one block an SM
  // (more than half an SM's shared memory each), 512 threads, so the
  // encode blocks take the other SMs whole and leave the chains their
  // sub-partitions.  Past that: small blocks, several an SM.
  const bool spread = 2 * hash_blocks <= sms;
  const int threads = spread ? THREADS : SMALL_THREADS;
  int smem = static_cast<int>(sizeof(Rings));
  if (spread && smem <= sm_smem / 2) smem = sm_smem / 2;
  if (smem > block_smem) smem = static_cast<int>(sizeof(Rings));
  long long enc_blocks = spread ? sms - hash_blocks
                                : static_cast<long long>(sms) *
                                      ENCODE_BLOCKS_PER_SM;
  const long long need = (units + threads - 1) / threads;
  if (enc_blocks > need) enc_blocks = need;
  const unsigned grid = static_cast<unsigned>(hash_blocks + enc_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const int32_t* nb = static_cast<const int32_t*>(nbytes);
  const int32_t* pl = static_cast<const int32_t*>(piece_lens);
  uint32_t* w = static_cast<uint32_t*>(words);
  uint4* o = static_cast<uint4*>(enc);
  if (r == 10 && k == 5) {
    ParamConsts<10, 5> cst;
    memcpy(cst.c, consts_host, sizeof(cst.c));
    fused_ingest_kernel<10, 5><<<grid, threads, smem, s>>>(
        cst, d, nb, pl, w, o, B, Lp, static_cast<int>(hash_blocks));
  } else {
    fused_ingest_generic_kernel<<<grid, threads, smem, s>>>(
        static_cast<const uint32_t*>(consts_dev), d, nb, pl, w, o, B, Lp,
        static_cast<int>(hash_blocks), r, k);
  }
  return static_cast<int>(cudaGetLastError());
}
