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
// The masks, the products and the per-unit bodies are gf_bitplane.cuh's,
// which fused_ingest.cu (K5) runs too.
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
// loads) and keeps GF_GROUP output rows in registers at a time.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "gf_bitplane.cuh"

#define THREADS 256
#define BLOCKS_PER_SM 4

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
    gf_unit(cst, data + b * K * L16 + col, out + b * R * L16 + col, L16);
  }
}

// Any (r, k): constants from device memory.
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
    gf_unit_generic(cst, data + b * k * L16 + col, out + b * r * L16 + col,
                    L16, r, k);
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
