// GF(2^8) matrix product over a batch of erasure-coding pieces.
//
// Replaces the JAX reference's Pallas kernel
// src/repro/kernels/gf_matmul.py::_kernel (launched by _gf_matmul_padded):
// out[b, i, :] = XOR_j M[i, j] * data[b, j, :] in GF(2^8), for an (r, k)
// coding matrix M -- RS encode with the generator matrix, degraded decode
// and repair with a decode matrix.
//
// What bounds it on an H100: the TPU kernel lifted the product to a
// bit-sliced f32 matmul because a TPU has no fast gathers.  Hopper has
// fast shared-memory lookups, so this kernel does the field product with
// log/exp tables held in shared memory: per output byte, k exp lookups
// plus k log lookups shared by all r outputs.  Device memory moves only
// k bytes in and r bytes out per column, so at the main path's (10,5)
// shapes the lookups (shared-memory bandwidth and bank conflicts of
// random byte reads), not HBM, are the limit.
//
// Design: one block of 128 threads per (batch row, 512-byte column tile);
// each thread owns 4 contiguous columns, reads one 32-bit word of each of
// the k input rows once, and keeps up to 16 output rows' 32-bit
// accumulators in registers (more rows loop over groups of 16).  Zero is
// special (m == 0 or d == 0 gives 0): the byte 0 gets the log 512, so any
// sum with it indexes the zero tail of the extended exp table -- no
// branch.  Tables come from the wrapper (kernels/tables.py); the kernel
// allocates nothing.  The table set-up and the tile body live in
// sears_device.cuh, shared with fused_ingest.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sears_device.cuh"

__global__ void gf_matmul_kernel(const uint8_t* __restrict__ M,
                                 const int16_t* __restrict__ klog,
                                 const uint8_t* __restrict__ kexp,
                                 const uint8_t* __restrict__ data,
                                 uint8_t* __restrict__ out,
                                 int r, int k, int L, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const sears::GfTables t = sears::gf_load_tables(smem, M, klog, kexp, r, k);
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const size_t col = static_cast<size_t>(tile) * SEARS_TILE_L +
                     threadIdx.x * 4;
  sears::gf_tile(t, data + static_cast<size_t>(b) * k * L + col,
                 out + static_cast<size_t>(b) * r * L + col, r, k, L);
}

// M: (r, k) uint8; klog: (256,) int16; kexp: (SEARS_KEXP_LEN,) uint8;
// data: (B, k, L) uint8 and out: (B, r, L) uint8, contiguous, 4-byte
// aligned, L % TILE_L == 0.  Returns cudaGetLastError() after the launch.
extern "C" int sears_gf_matmul(const void* M, const void* klog,
                               const void* kexp, const void* data, void* out,
                               int B, int r, int k, int L, void* stream) {
  const int tiles = L / SEARS_TILE_L;
  const long long blocks = static_cast<long long>(B) * tiles;
  if (B <= 0 || tiles <= 0 || blocks > 0x7fffffffLL ||
      L % SEARS_TILE_L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sears::gf_smem_bytes(r, k);
  gf_matmul_kernel<<<static_cast<unsigned>(blocks), SEARS_GF_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(M), static_cast<const int16_t*>(klog),
      static_cast<const uint8_t*>(kexp), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), r, k, L, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sears_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
