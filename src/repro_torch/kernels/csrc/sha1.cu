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
// compression of sears_device.cuh (shared with fused_ingest.cu).  Blocks
// of 32 threads spread the messages over as many SMs as possible.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sears_device.cuh"

#define THREADS 32

__global__ void sha1_kernel(const uint32_t* __restrict__ blocks,
                            const int32_t* __restrict__ counts,
                            uint32_t* __restrict__ out, int B, int M) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t h[5];
  sears::sha1_init(h);
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
    sears::sha1_compress(h, w);
  }
  uint32_t* o = out + static_cast<size_t>(b) * 5;
#pragma unroll
  for (int i = 0; i < 5; ++i) o[i] = h[i];
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
