// Flash attention (GQA, causal and sliding-window masks) for Hopper.
//
// Replaces the JAX reference's Pallas kernel
// src/repro/kernels/flash_attn.py::_kernel (launched by _flash_padded,
// wrapped by flash_attention): softmax(q k^T * scale + mask) v with the
// running max m, row sum l and output accumulator kept on chip, the
// queries being the last S of T positions.  Same masks in the same order
// (keys past T, then k <= q if causal, then k > q - window if window >
// 0), masked scores at -1e30 so no row becomes NaN, p rounded to v's
// dtype before P.V while l sums the unrounded p, and acc / max(l, 1e-30)
// at the end.
//
// What bounds it on an H100: operations.  A causal pass does
// 4 * hd * (live query-key pairs) multiply-adds' worth of work against
// reading q, k and v once and writing o once; at S = T = 8192, 32 heads,
// hd = 64 that is ~2.7e11 operations against ~84 MB, far past the ridge
// point.  This first kernel runs on the CUDA cores (fp32 FMAs, 67 TFLOP/s
// at most), not on the tensor cores (989 TFLOP/s bf16): wgmma with TMA
// is later work.
//
// Design.  On the TPU the KV axis is a sequential grid dimension and
// (m, l, acc) live in VMEM scratch across its steps.  Here blocks run in
// no order, so one block of 256 threads owns one (batch, query head,
// tile of 64 queries) and loops over the 64-key tiles itself:
// - Q, then each K tile and V tile, are staged in shared memory as fp32
//   (rows padded by 4 floats so 128-bit loads hit distinct banks); K and
//   V share one buffer.  KV head h / (H / KV) is read straight from the
//   model layout (B, T, KV, hd) through the strides passed in: no
//   transpose, no pad copy.  Rows past S or T load as zeros.
// - Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and keys
//   tx + 16 j (i, j < 4) of the 64 x 64 score tile; a row's max and sum
//   reduce over its 16 lanes with shuffles.  m, l and the thread's
//   4 x hd/16 slice of acc stay in fp32 registers.
// - p, rounded to v's dtype, goes through shared memory to the P.V
//   product, where the thread owns rows ty + 16 i and columns
//   64 g + 4 tx .. + 3.
// - Causal: key tiles wholly after the tile's last real query are
//   skipped, and so are tiles wholly before the window of its first
//   query; a skipped tile is fully masked for every row, so the result
//   is what visiting it would give.  The heaviest query tiles launch
//   first.
// Templated on the element type (float, bf16) and hd (64, 128, 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 4;
constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (HD + 4) + BQ * LDP);
}

// One (BQ or BK) x HD tile of rows [row0, row0 + 64) of a (., len, ., HD)
// tensor at `base` (row stride `rs` elements) into shared memory as fp32.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base,
                                          long long rs, int row0, int len) {
  constexpr int LD = HD + 4;
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int row = row0 + r;
    dst[r * LD + d] =
        row < len ? to_f<T>(base[static_cast<long long>(row) * rs + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int Tn, int H, int KV, long long qsb, long long qss,
                      long long qsh, long long ksb, long long kss,
                      long long ksh, long long vsb, long long vss,
                      long long vsh, float scale, int causal, int window) {
  constexpr int LD = HD + 4;
  constexpr int NG = HD / 64;  // float4 column groups of a thread in P.V
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + BQ * LD;
  float* sP = sKV + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Tn - S;

  load_tile<T, HD>(sQ, q + b * qsb + h * qsh, qss, q0, S);
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, S) - 1;
  const int nk = (Tn + BK - 1) / BK;
  const int kt_hi = causal ? min(nk, q_last / BK + 1) : nk;
  const int kt_lo = window > 0 ? max(0, q_first - window + 1) / BK : 0;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P.V is done with sKV and sP
    load_tile<T, HD>(sKV, kb, kss, k0, Tn);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&sKV[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_first + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool live = kp < Tn;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && kp > qp - window;
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = to_f<T>(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K; sP is written
    load_tile<T, HD>(sKV, vb, vss, k0, Tn);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * LDP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sKV[(j + jj) * LD + 64 * g + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y
                          : jj == 2 ? pa[i].z : pa[i].w;
            acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[64 * g + 4 * tx + c] = from_f<T>(acc[i][4 * g + c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int KV, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attn_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tn, H, KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, S, H, hd), k and v: (B, T, KV, hd), each with unit stride in hd
// and the given (batch, sequence, head) strides in elements; o: (B, S, H,
// hd) contiguous.  dtype 0 = float32, 1 = bfloat16; hd in {64, 128, 256};
// S <= T; H % KV == 0.  strides: q's, k's, v's (batch, sequence, head).
// Returns cudaGetLastError() after the launch.
extern "C" int sears_flash_attn(const void* q, const void* k, const void* v,
                                void* o, int dtype, int B, int S, int T,
                                int H, int KV, int hd,
                                const long long* strides, float scale,
                                int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T < S || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SEARS_FLASH_CASE(TYPE, HD)                                          \
  return launch<TYPE, HD>(q, k, v, o, B, S, T, H, KV, strides, scale, causal, \
                          window, st)
  if (dtype == 0) {
    if (hd == 64) SEARS_FLASH_CASE(float, 64);
    if (hd == 128) SEARS_FLASH_CASE(float, 128);
    if (hd == 256) SEARS_FLASH_CASE(float, 256);
  } else if (dtype == 1) {
    if (hd == 64) SEARS_FLASH_CASE(__nv_bfloat16, 64);
    if (hd == 128) SEARS_FLASH_CASE(__nv_bfloat16, 128);
    if (hd == 256) SEARS_FLASH_CASE(__nv_bfloat16, 256);
  }
#undef SEARS_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
