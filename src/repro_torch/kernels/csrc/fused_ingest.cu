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
// own piece length, not Lp; columns past L_b are zero.
//
// What bounds it on an H100: the bytes are few (k*Lp in, n*Lp out per
// chunk) and the GF half is a log/exp table tile; the SHA-1 half is a
// sequential chain of ~(nbytes / 64) compressions per chunk, one thread
// each, so with B messages it is latency-bound and fills B / 128 SMs.
//
// Design: one grid, two roles chosen by blockIdx, 128 threads per block.
// The lowest blocks are SHA-1 blocks, one thread per message, so the long
// serial hashes start first; the rest are GF blocks, one per (row,
// 512-byte tile), with the log/exp tables of sears_device.cuh.  A SHA-1
// thread assembles each 64-byte block's 16 big-endian words on the fly:
// a block inside the message and inside one row takes 17 aligned 32-bit
// loads and funnels each word from two of them (`__byte_perm`, whatever
// the row's alignment); the few blocks that cross a row end or the
// message end go byte by byte: message bytes, 0x80, zeros.  The 64-bit
// bit length fills words 14-15 of the last block.  It loops over the
// message's (nbytes + 8) / 64 + 1 real blocks only.  The serial
// compression and the GF tile are sears_device.cuh's (K4 and K1 have
// their own Hopper designs in sha1.cu and gf_matmul.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sears_device.cuh"

#define THREADS SEARS_GF_THREADS  // 128 in both roles

// Digest of one packed message: n bytes laid out in rows of L bytes,
// rows Lp bytes apart, starting at `base` (4-byte aligned, as is Lp).
static __device__ void sha1_packed(const uint8_t* __restrict__ base,
                                   int n, int L, int Lp, uint32_t* out) {
  uint32_t h[5];
  sears::sha1_init(h);
  const int nb = (n + 8) / 64 + 1;
  for (int m = 0; m < nb; ++m) {
    const int off = m * 64;
    const int row = off / L, col = off - row * L;  // packed place of off
    uint32_t w[16];
    if (off + 64 <= n && col + 64 <= L) {
      // the block lies inside the message and inside one row: 17
      // aligned word loads, each big-endian word funnelled from two
      const uint8_t* p = base + static_cast<size_t>(row) * Lp + col;
      const uint32_t s = static_cast<uint32_t>(col) & 3u;
      const uint32_t* a = reinterpret_cast<const uint32_t*>(p - s);
      const uint32_t sel = (s << 12) | ((s + 1) << 8) | ((s + 2) << 4) |
                           (s + 3);
      uint32_t lo = a[0];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // word 16 holds bytes of this block only when s > 0; it never
        // crosses the row's Lp boundary, which is 4-byte aligned
        const uint32_t hi = (j < 15 || s) ? a[j + 1] : 0u;
        w[j] = __byte_perm(lo, hi, sel);
        lo = hi;
      }
    } else {
      // the block crosses a row end or the message end: byte by byte,
      // message bytes, then 0x80, then zeros
      int r = row, c = col;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t v = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = off + 4 * j + t;
          uint32_t byte = 0;
          if (i < n) {
            byte = base[static_cast<size_t>(r) * Lp + c];
            if (++c == L) { c = 0; ++r; }
          } else if (i == n) {
            byte = 0x80u;
          }
          v = (v << 8) | byte;
        }
        w[j] = v;
      }
    }
    if (m == nb - 1) {  // the bit length, big-endian, ends the last block
      const uint64_t bits = static_cast<uint64_t>(n) * 8u;
      w[14] = static_cast<uint32_t>(bits >> 32);
      w[15] = static_cast<uint32_t>(bits);
    }
    sears::sha1_compress_serial(h, w);
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i] = h[i];
}

__global__ void fused_ingest_kernel(const uint8_t* __restrict__ M,
                                    const int16_t* __restrict__ klog,
                                    const uint8_t* __restrict__ kexp,
                                    const uint8_t* __restrict__ data,
                                    const int32_t* __restrict__ nbytes,
                                    const int32_t* __restrict__ piece_lens,
                                    uint32_t* __restrict__ words,
                                    uint8_t* __restrict__ enc,
                                    int B, int r, int k, int Lp, int tiles,
                                    int sha_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < sha_blocks) {
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    // clamp to the slab so a bad length cannot read past it
    const int L = min(max(piece_lens[b], 1), Lp);
    const int n = static_cast<int>(min(
        static_cast<long long>(max(nbytes[b], 0)),
        static_cast<long long>(k) * L));
    sha1_packed(data + static_cast<size_t>(b) * k * Lp, n, L, Lp,
                words + static_cast<size_t>(b) * 5);
    return;
  }
  // GF role: every thread of these blocks takes this branch together
  const int g = blockIdx.x - sha_blocks;
  const sears::GfTables t = sears::gf_load_tables(smem, M, klog, kexp, r, k);
  const int b = g / tiles;
  const int tile = g - b * tiles;
  const size_t col = static_cast<size_t>(tile) * SEARS_TILE_L +
                     threadIdx.x * 4;
  sears::gf_tile(t, data + static_cast<size_t>(b) * k * Lp + col,
                 enc + static_cast<size_t>(b) * r * Lp + col, r, k, Lp);
}

// M: (r, k) uint8; klog: (256,) int16; kexp: (SEARS_KEXP_LEN,) uint8;
// data: (B, k, Lp) uint8, 4-byte aligned, Lp % SEARS_TILE_L == 0;
// nbytes, piece_lens: (B,) int32; words: (B, 5) uint32; enc: (B, r, Lp)
// uint8, 4-byte aligned; all contiguous.  Returns cudaGetLastError()
// after the launch.
extern "C" int sears_fused_ingest(const void* M, const void* klog,
                                  const void* kexp, const void* data,
                                  const void* nbytes, const void* piece_lens,
                                  void* words, void* enc, int B, int r, int k,
                                  int Lp, void* stream) {
  const int tiles = Lp / SEARS_TILE_L;
  const long long sha_blocks = (static_cast<long long>(B) + THREADS - 1) /
                               THREADS;
  const long long blocks = sha_blocks + static_cast<long long>(B) * tiles;
  if (B <= 0 || tiles <= 0 || r <= 0 || k <= 0 || blocks > 0x7fffffffLL ||
      Lp % SEARS_TILE_L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_ingest_kernel<<<static_cast<unsigned>(blocks), THREADS,
                        sears::gf_smem_bytes(r, k),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(M), static_cast<const int16_t*>(klog),
      static_cast<const uint8_t*>(kexp), static_cast<const uint8_t*>(data),
      static_cast<const int32_t*>(nbytes),
      static_cast<const int32_t*>(piece_lens), static_cast<uint32_t*>(words),
      static_cast<uint8_t*>(enc), B, r, k, Lp, tiles,
      static_cast<int>(sha_blocks));
  return static_cast<int>(cudaGetLastError());
}
