// GF(2^8) matrix product over a batch of erasure-coding pieces, by bit
// planes on the integer ALUs.
//
// Replaces the JAX reference's Pallas kernel
// src/repro/kernels/gf_matmul.py::_kernel (launched by _gf_matmul_padded):
// out[b, i, :] = XOR_j M[i, j] * data[b, j, :] in GF(2^8), for an (r, k)
// coding matrix M -- RS encode with the generator matrix, degraded decode
// and repair with a decode matrix.
//
// The algebra is the TPU kernel's own: multiplying by a constant c is
// linear over GF(2), c * x = XOR_b x_b * (c * 2^b), so with the eight
// byte masks of a word x (byte n of mask b is 0xFF where bit b of byte n
// of x is set) the product of four bytes is
//     c * x = XOR_b (mask_b(x) & C_b),   C_b = c * 2^b in all four bytes,
// eight LOP3s on 32-bit words where the TPU ran a bit-plane matmul.  The
// wrapper builds the constants C[i][j][b] once per matrix (no tables in
// the kernel); an entry 0 adds nothing and an entry 1 adds x, on
// warp-uniform branches, which skips the systematic rows of a generator
// and the unit rows of a decode matrix.
//
// What bounds it on an H100: integer instructions and HBM about equally.
// At the main path's (10,5) encode, a 16-byte column group needs 5 x 4
// words x 15 operations for the masks (a shift and a PRMT in
// sign-replicate mode a mask) and 8 LOP3s per word for each entry that
// is neither 0 nor 1, against 15 bytes moved per column.
//
// Design: each thread takes one 16-byte column group of one batch row at
// a time (uint4 loads and stores: 32 lanes cover 512 contiguous bytes of
// a row), a grid-stride loop over the (row, group) units with at most
// BLOCKS_PER_SM blocks of 256 threads an SM.  The main path's shapes --
// (10,5) encode and (5,5) decode, repair included -- are template
// instantiations whose constants travel in the kernel's parameters, so
// every C_b is a constant-bank operand of its LOP3 and every loop
// unrolls.  Every other shape (r, k <= 128) runs the generic
// instantiation, which reads the constants from device memory (uniform
// loads) and keeps GROUP output rows in registers at a time.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define THREADS 256
#define BLOCKS_PER_SM 4
#define GROUP 8      // output rows a pass of the generic instantiation
#define ONE 0x01010101u

namespace {

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
  if (c0 == ONE) {
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

}  // namespace

// data: (B, K, 16 * L16) as uint4, out: (B, R, 16 * L16) as uint4.
template <int R, int K>
__global__ void __launch_bounds__(THREADS, 2)
    gf_matmul_kernel(const __grid_constant__ ParamConsts<R, K> cst,
                     const uint4* __restrict__ data, uint4* __restrict__ out,
                     long long units, int L16) {
  for (long long u = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       u < units; u += static_cast<long long>(gridDim.x) * THREADS) {
    const long long b = u / L16;
    const long long col = u - b * L16;
    const uint4* d = data + b * K * L16 + col;
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
    uint4* o = out + b * R * L16 + col;
#pragma unroll
    for (int i = 0; i < R; ++i)
      o[i * L16] = make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// Any (r, k): constants from device memory, GROUP output rows a pass
// (the input rows are read once a pass).
__global__ void __launch_bounds__(THREADS, 2)
    gf_matmul_generic_kernel(const uint32_t* __restrict__ consts,
                             const uint4* __restrict__ data,
                             uint4* __restrict__ out, long long units,
                             int L16, int r, int k) {
  const GlobalConsts cst{consts, k};
  for (long long u = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       u < units; u += static_cast<long long>(gridDim.x) * THREADS) {
    const long long b = u / L16;
    const long long col = u - b * L16;
    const uint4* d = data + b * k * L16 + col;
    uint4* o = out + b * r * L16 + col;
    for (int i0 = 0; i0 < r; i0 += GROUP) {
      uint32_t acc[GROUP][4];
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[g][w] = 0u;
      for (int j = 0; j < k; ++j) {
        uint32_t x[4], m[4][8];
        unpack(__ldg(d + j * L16), x);
        bit_masks(x, m);
#pragma unroll
        for (int g = 0; g < GROUP; ++g)
          if (i0 + g < r) mul_acc(acc[g], x, m, cst, i0 + g, j);
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (i0 + g < r)
          o[(i0 + g) * L16] =
              make_uint4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
  }
}

template <int R, int K>
static cudaError_t launch_fixed(const void* consts_host, const void* data,
                                void* out, long long units, int L16,
                                unsigned grid, cudaStream_t stream) {
  ParamConsts<R, K> cst;
  memcpy(cst.c, consts_host, sizeof(cst.c));
  gf_matmul_kernel<R, K><<<grid, THREADS, 0, stream>>>(
      cst, static_cast<const uint4*>(data), static_cast<uint4*>(out), units,
      L16);
  return cudaGetLastError();
}

// consts_host and consts_dev: the same (r, k, 8) uint32 constants
// C[i][j][b] = M[i][j] * 2^b (the byte in all four bytes), on the host
// (read here for the instantiated shapes) and on the device (read by the
// generic kernel).  data: (B, k, L) uint8 and out: (B, r, L) uint8,
// contiguous, 16-byte aligned, L % 16 == 0, r and k in [1, 128].
// Returns cudaGetLastError() after the launch.
extern "C" int sears_gf_matmul(const void* consts_host,
                               const void* consts_dev, const void* data,
                               void* out, int B, int r, int k, int L,
                               void* stream) {
  if (B <= 0 || r <= 0 || k <= 0 || r > 128 || k > 128 || L <= 0 ||
      L % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L16 = L / 16;
  const long long units = static_cast<long long>(B) * L16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (units + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(
      want < static_cast<long long>(sms) * BLOCKS_PER_SM
          ? want
          : static_cast<long long>(sms) * BLOCKS_PER_SM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r == 10 && k == 5)
    return static_cast<int>(
        launch_fixed<10, 5>(consts_host, data, out, units, L16, grid, s));
  if (r == 5 && k == 5)
    return static_cast<int>(
        launch_fixed<5, 5>(consts_host, data, out, units, L16, grid, s));
  gf_matmul_generic_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(consts_dev),
      static_cast<const uint4*>(data), static_cast<uint4*>(out), units, L16,
      r, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sears_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
