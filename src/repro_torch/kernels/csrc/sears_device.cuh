// Device-side building blocks shared by the storage kernels.
//
// Each piece of arithmetic exists once and is used by every kernel that
// needs it: the SHA-1 initial value and rotate by sha1.cu and
// fused_ingest.cu; the serial SHA-1 compression and the GF(2^8) log/exp
// table set-up and tile body by fused_ingest.cu (sha1.cu and gf_matmul.cu
// have their own warp-specialised rounds and bit-plane product).
// Everything here is `static` and inlined, so each source that includes
// this header compiles its own copy and nothing needs device linking.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sears {

// ------------------------------------------------------------- SHA-1 ---

static __device__ __forceinline__ uint32_t rotl(uint32_t x, int c) {
  return __funnelshift_l(x, x, c);
}

// One SHA-1 compression in one thread: folds the 16 big-endian message
// words `w` (used as the rolling schedule, so overwritten) into the
// chaining value `h`.  The schedule is a 16-word window in registers; the
// 80 rounds unroll.
static __device__ __forceinline__ void sha1_compress_serial(
    uint32_t (&h)[5], uint32_t (&w)[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
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
      f = (b & c) | (~b & d); k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d; k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (b & d) | (c & d); k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d; k = 0xCA62C1D6u;
    }
    const uint32_t tmp = rotl(a, 5) + f + e + k + wt;
    e = d; d = c; c = rotl(b, 30); b = a; a = tmp;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e;
}

static __device__ __forceinline__ void sha1_init(uint32_t (&h)[5]) {
  h[0] = 0x67452301u; h[1] = 0xEFCDAB89u; h[2] = 0x98BADCFEu;
  h[3] = 0x10325476u; h[4] = 0xC3D2E1F0u;
}

// ----------------------------------------------------------- GF(2^8) ---
//
// One block of SEARS_GF_THREADS threads computes one (batch row, TILE_L-byte
// column tile) of out = M x data.  The field product uses log/exp tables
// in shared memory; the byte 0 has the log ZERO_LOG (kernels/tables.py),
// so any sum with it lands in the zero tail of the extended exp table.

#define SEARS_TILE_L 512
#define SEARS_GF_THREADS (SEARS_TILE_L / 4)
#define SEARS_ROW_GROUP 16
#define SEARS_KEXP_LEN 1040

// Dynamic shared memory of a GF block for an (r, k) matrix.
static inline size_t gf_smem_bytes(int r, int k) {
  return (256 + static_cast<size_t>(r) * k) * sizeof(uint16_t) +
         SEARS_KEXP_LEN;
}

struct GfTables {
  const uint16_t* slog;   // 256 entries: log of each byte
  const uint16_t* smlog;  // r * k entries: log of each matrix entry
  const uint8_t* sexp;    // SEARS_KEXP_LEN entries: extended exp table
};

// Fill the block's shared tables; every thread of the block must call it.
static __device__ __forceinline__ GfTables gf_load_tables(
    unsigned char* smem, const uint8_t* __restrict__ M,
    const int16_t* __restrict__ klog, const uint8_t* __restrict__ kexp,
    int r, int k) {
  uint16_t* slog = reinterpret_cast<uint16_t*>(smem);
  uint16_t* smlog = slog + 256;
  uint8_t* sexp = reinterpret_cast<uint8_t*>(smlog + r * k);
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    slog[i] = static_cast<uint16_t>(klog[i]);
  for (int i = threadIdx.x; i < SEARS_KEXP_LEN; i += blockDim.x)
    sexp[i] = kexp[i];
  __syncthreads();
  for (int i = threadIdx.x; i < r * k; i += blockDim.x) smlog[i] = slog[M[i]];
  __syncthreads();
  return GfTables{slog, smlog, sexp};
}

// This thread's 4 columns of one tile: `d` points at column 0 of its
// columns in input row 0, `o` likewise in output row 0; rows are L bytes
// apart.  Each input word is read once; up to SEARS_ROW_GROUP output
// rows accumulate in registers (more rows loop over groups).
static __device__ __forceinline__ void gf_tile(const GfTables& t,
                                               const uint8_t* d, uint8_t* o,
                                               int r, int k, size_t L) {
  for (int i0 = 0; i0 < r; i0 += SEARS_ROW_GROUP) {
    uint32_t acc[SEARS_ROW_GROUP];
#pragma unroll
    for (int g = 0; g < SEARS_ROW_GROUP; ++g) acc[g] = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(d + j * L);
      const uint32_t l0 = t.slog[w & 255u];
      const uint32_t l1 = t.slog[(w >> 8) & 255u];
      const uint32_t l2 = t.slog[(w >> 16) & 255u];
      const uint32_t l3 = t.slog[w >> 24];
#pragma unroll
      for (int g = 0; g < SEARS_ROW_GROUP; ++g) {
        if (i0 + g < r) {
          const uint32_t lm = t.smlog[(i0 + g) * k + j];
          acc[g] ^= static_cast<uint32_t>(t.sexp[lm + l0]) |
                    (static_cast<uint32_t>(t.sexp[lm + l1]) << 8) |
                    (static_cast<uint32_t>(t.sexp[lm + l2]) << 16) |
                    (static_cast<uint32_t>(t.sexp[lm + l3]) << 24);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < SEARS_ROW_GROUP; ++g) {
      if (i0 + g < r)
        *reinterpret_cast<uint32_t*>(o + (i0 + g) * L) = acc[g];
    }
  }
}

}  // namespace sears
