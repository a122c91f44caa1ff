// GF(2^8) products by bit planes, shared by gf_matmul.cu (K1) and
// fused_ingest.cu (K5).
//
// Multiplying by a constant c is linear over GF(2): c * x = XOR_b x_b *
// (c * 2^b).  With the eight byte masks of a 32-bit word x (byte n of
// mask b is 0xFF where bit b of byte n of x is set) the product of four
// bytes is
//     c * x = XOR_b (mask_b(x) & C_b),   C_b = c * 2^b in all four bytes,
// eight LOP3s a word.  The wrapper builds the constants C[i][j][b] once per
// matrix (gf_matmul.bitplane_constants); an entry 0 adds nothing and an
// entry 1 adds x, on warp-uniform branches.  One unit of work is one
// 16-byte column group of one batch row: k uint4 loads, r uint4 stores.
//
// Everything here is in an unnamed namespace and inlined, so each source
// that includes this header compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t GF_ONE = 0x01010101u;
constexpr int GF_GROUP = 8;  // output rows a pass of the generic form

// The eight byte masks of each of the four words of a 16-byte group.
__device__ __forceinline__ void bit_masks(const uint32_t (&x)[4],
                                          uint32_t (&m)[4][8]) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      // bit b of each byte to its bit 7, then that sign into the byte
      asm("prmt.b32 %0, %1, %2, %3;\n"
          : "=r"(m[w][b])
          : "r"(x[w] << (7 - b)), "r"(0u), "r"(0xBA98u));
    }
  }
}

// acc ^= c * x over four words, c = M[i][j] given by its constants.
template <class Consts>
__device__ __forceinline__ void mul_acc(uint32_t (&acc)[4],
                                        const uint32_t (&x)[4],
                                        const uint32_t (&m)[4][8],
                                        const Consts& cst, int i, int j) {
  const uint32_t c0 = cst(i, j, 0);
  if (c0 == 0u) return;
  if (c0 == GF_ONE) {
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[w] ^= x[w];
    return;
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t cb = cst(i, j, b);
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[w] ^= m[w][b] & cb;
  }
}

// Constants in the kernel's parameters (the constant bank).
template <int R, int K>
struct ParamConsts {
  uint32_t c[R * K * 8];
  __device__ __forceinline__ uint32_t operator()(int i, int j, int b) const {
    return c[(i * K + j) * 8 + b];
  }
};

// Constants in device memory, every thread reading the same word.
struct GlobalConsts {
  const uint32_t* __restrict__ c;
  int k;
  __device__ __forceinline__ uint32_t operator()(int i, int j, int b) const {
    return __ldg(c + (i * k + j) * 8 + b);
  }
};

__device__ __forceinline__ void unpack(const uint4& v, uint32_t (&x)[4]) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// One unit of an instantiated (R, K): `d` points at the unit's group in
// input row 0 and `o` in output row 0; rows are L16 groups apart.  Every
// loop unrolls and every C_b is an operand of its LOP3.
template <int R, int K>
__device__ __forceinline__ void gf_unit(const ParamConsts<R, K>& cst,
                                        const uint4* __restrict__ d,
                                        uint4* __restrict__ o, int L16) {
  uint32_t x[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j) unpack(__ldg(d + j * L16), x[j]);
  uint32_t acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[i][w] = 0u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    uint32_t m[4][8];
    bit_masks(x[j], m);
#pragma unroll
    for (int i = 0; i < R; ++i) mul_acc(acc[i], x[j], m, cst, i, j);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    o[i * L16] = make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// One unit of any (r, k): constants from device memory, GF_GROUP output
// rows a pass (the input rows are read once a pass).
__device__ __forceinline__ void gf_unit_generic(const GlobalConsts& cst,
                                                const uint4* __restrict__ d,
                                                uint4* __restrict__ o,
                                                int L16, int r, int k) {
  for (int i0 = 0; i0 < r; i0 += GF_GROUP) {
    uint32_t acc[GF_GROUP][4];
#pragma unroll
    for (int g = 0; g < GF_GROUP; ++g)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[g][w] = 0u;
    for (int j = 0; j < k; ++j) {
      uint32_t x[4], m[4][8];
      unpack(__ldg(d + j * L16), x);
      bit_masks(x, m);
#pragma unroll
      for (int g = 0; g < GF_GROUP; ++g)
        if (i0 + g < r) mul_acc(acc[g], x, m, cst, i0 + g, j);
    }
#pragma unroll
    for (int g = 0; g < GF_GROUP; ++g)
      if (i0 + g < r)
        o[(i0 + g) * L16] =
            make_uint4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
}

}  // namespace
