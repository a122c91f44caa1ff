// Flash attention (GQA, causal and sliding-window masks) for Hopper:
// bf16 on the tensor cores (wgmma fed by TMA), fp32 on the CUDA cores.
//
// Replaces the JAX reference's Pallas kernel
// src/repro/kernels/flash_attn.py::_kernel (launched by _flash_padded,
// wrapped by flash_attention): softmax(q k^T * scale + mask) v with the
// running max m, row sum l and output accumulator kept on chip, the
// queries being the last S of T positions.  Same masks in the same order
// (keys past T, then k <= q if causal, then k > q - window if window >
// 0), masked scores at -1e30 so no row becomes NaN, p rounded to v's
// dtype before P.V while l sums the unrounded p, and acc / max(l, 1e-30)
// at the end.  hd is 64, 128 or 256.
//
// What bounds it on an H100: operations.  A causal pass does 4 hd
// operations per live query-key pair against reading q, k and v once and
// writing o once; at S = T = 8192, 32/8 heads, hd 64 that is 2.75e11
// operations (0.278 ms at the 989 TFLOP/s of the bf16 tensor cores)
// against 84 MB (0.025 ms at 3.35 TB/s).  Beside the products, each
// score costs one exp on the MUFU units (16 a clock an SM): at hd 64
// that is one exp per 256 tensor-core operations, about the products'
// own time, so the exps must run under the products.
//
// bf16 (flash_wgmma_kernel): q k^T from bf16 inputs with fp32 sums is
// exactly what the reference computes (it casts q and k to fp32; bf16 x
// bf16 products are exact in fp32), so both products go to the tensor
// cores.  One block of 1 + NCW warpgroups owns one (batch, query head,
// 64 NCW queries); NCW is 3 at hd 64, 2 at hd 128 and 256 (Cfg).
// - warpgroup 0 gives up registers (setmaxnreg) and one of its threads
//   issues TMA loads: Q once, then K and V tiles of BK keys into a ring
//   of STAGES slots with full and empty mbarriers (K and V each have
//   their own, so Q.K^T starts before V lands and K's slot frees before
//   V's).  4-D tensor maps over (hd, heads, len, B) read one KV head's
//   tile where it lies in the model layout; a 64-column box is one
//   128-byte swizzle row, so hd 128 and 256 take 2 or 4 boxes a tile;
//   rows past S or T come back as zeros.
// - the other warpgroups take the registers and own 64 query rows each.
//   S = Q K^T is a wgmma with both operands in shared memory (K-major);
//   S's accumulators go through the online softmax in registers (row max
//   and sum in four independent chains a row, then over the 4 lanes of
//   the row); p is rounded to bf16 and packed as the register A operand
//   of O += P V, whose V is read MN-major through the descriptor's
//   transpose bit: V is never transposed.  Each step issues Q K_i^T with
//   the P V of tile i - 1, so that product runs under tile i's softmax,
//   and the groups' steps interleave on the SM.
// - ptxas serialises wgmma (one instruction at a time) when it sits in a
//   path ptxas cannot prove warp-uniform or when its groups cannot be
//   matched to their waits: the warpgroup index comes through a shuffle,
//   barrier waits loop inside their asm, every consumer thread arrives
//   on the empty barriers (no lane test), and the main loop is peeled
//   (first tile, steady steps, last P V) so no wgmma is conditional.
// - masks apply only on tiles at the causal diagonal, the window's edge
//   or past T; tiles masked for every row of a warpgroup are skipped
//   (their result is what visiting them would give), and the heaviest
//   query tiles launch first.
// fp32 (flash_fp32_kernel): TF32 would break the 2e-5 tolerance, so fp32
// stays on the CUDA cores: 256 threads own 64 queries, fp32 tiles in
// shared memory, a 16 x 16 thread grid over each 64 x 64 score tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel.
namespace fp32 {


constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 4;
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (HD + 4) + BQ * LDP);
}

// One (BQ or BK) x HD tile of rows [row0, row0 + 64) of a (., len, ., HD)
// tensor at `base` (row stride `rs` elements) into shared memory as fp32.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ base,
                                          long long rs, int row0, int len) {
  constexpr int LD = HD + 4;
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int row = row0 + r;
    dst[r * LD + d] =
        row < len ? base[static_cast<long long>(row) * rs + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int S,
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

  load_tile<HD>(sQ, q + b * qsb + h * qsh, qss, q0, S);
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

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
    load_tile<HD>(sKV, kb, kss, k0, Tn);
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
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
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
    load_tile<HD>(sKV, vb, vss, k0, Tn);
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
    float* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[64 * g + 4 * tx + c] = acc[i][4 * g + c] / denom;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int KV, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fp32_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tn, H, KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel fed by a TMA ring.
namespace tc {

using sears::sm90::desc_sw128;
using sears::sm90::smem_u32;
namespace sm = sears::sm90;

constexpr int ROW_BYTES = 128;   // one 64-column bf16 swizzle row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// NCW consumer warpgroups of 64 query rows each, after one producer
// warpgroup; tiles of BK keys in a ring of STAGES slots.  Three consumer
// groups at hd 64 (more warps to hide the softmax's latency); two at hd
// 128 and 256, where the accumulators need the registers.
template <int HD>
struct Cfg {
  static constexpr int NCW = HD == 64 ? 3 : 2;
  static constexpr int NB = HD / 64;                  // 64-column boxes a row
  static constexpr int BQ = 64 * NCW;                 // queries a block
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int BK = HD == 256 ? 64 : 128;     // keys a tile
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr int Q_BYTES = NCW * NB * 64 * ROW_BYTES;
  static constexpr int KV_BYTES = NB * BK * ROW_BYTES;  // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (4 * STAGES + 1) + 1024;
  // registers a thread after setmaxnreg: producer, consumers
  static constexpr int PROD_REGS = NCW == 2 ? 40 : 24;
  static constexpr int CONS_REGS = NCW == 2 ? 232 : 160;
};

// One consumer warpgroup's running state and its steps on a tile.  S and
// O are wgmma accumulators: for n8 block j, [4j], [4j + 1] hold row g
// (cols 8j + 2t, + 1) and [4j + 2], [4j + 3] row g + 8.
template <int HD>
struct Consumer {
  using C = Cfg<HD>;
  static constexpr int BK = C::BK;
  static constexpr int NS = BK / 8;  // n8 blocks of S
  static constexpr int NO = HD / 8;  // n8 blocks of O

  float acc[HD / 2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];  // p (bf16 pairs) as P.V's A fragments
  float m[2], l[2];         // per row: running max (units of q.k), sum

  // issue S = Q K^T: A and B K-major in shared memory
  __device__ __forceinline__ void issue_qk(uint32_t qa, uint32_t ka) {
    sm::fence_regs(sc);
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm::wgmma_ss<BK>(
          sc,
          desc_sw128(qa + (kk >> 2) * 64 * ROW_BYTES + (kk & 3) * 32, 16,
                     1024),
          desc_sw128(ka + (kk >> 2) * BK * ROW_BYTES + (kk & 3) * 32, 16,
                     1024),
          kk > 0);
    sm::wgmma_commit();
  }

  // issue O += P V: P from registers, V read MN-major (transpose bit)
  __device__ __forceinline__ void issue_pv(uint32_t va) {
    sm::fence_regs(acc);
    sm::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      sm::wgmma_rs<HD>(
          acc, pa[j],
          desc_sw128(va + j * 16 * ROW_BYTES, BK * ROW_BYTES, 1024), 1);
    sm::wgmma_commit();
  }

  // Masks (only where `edge`), then the online softmax of S in registers:
  // row max and sum over four chains a row and the 4 lanes of the row,
  // p = exp(s scale - m scale) = 2^(s sl2 - m sl2) in one FMA.  Returns
  // each row's correction factor for O.
  __device__ __forceinline__ void softmax(bool edge, int k0, int qp0,
                                          int Tn, int causal, int window,
                                          int t, float sl2, float (&corr)[2]) {
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kp = k0 + 8 * j + 2 * t + (c & 1);
          const int qp = qp0 + 8 * (c >> 1);
          bool ok = kp < Tn;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          sc[4 * j + c] = ok ? sc[4 * j + c] : NEG_INF;
        }
    }
    float mp[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mp[c >> 1][c & 1] = sc[c];
      mp[c >> 1][2 + (c & 1)] = sc[4 + c];
    }
#pragma unroll
    for (int j = 2; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        mp[c >> 1][(c & 1) + 2 * (j & 1)] =
            fmaxf(mp[c >> 1][(c & 1) + 2 * (j & 1)], sc[4 * j + c]);
    float mo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = ex2((m[r] - m_new) * sl2);
      // a row masked so far takes offset 0, so its p are 0, not inf
      mo[r] = m_new == NEG_INF ? 0.f : m_new * sl2;
      m[r] = m_new;
    }
    float pp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ex2(fmaf(sc[4 * j + c], sl2, -mo[c >> 1]));
        pp[c >> 1][(c & 1) + 2 * (j & 1)] += p;
        sc[4 * j + c] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * corr[r] + ((pp[r][0] + pp[r][1]) + (pp[r][2] + pp[r][3]));
  }

  // O *= corr (after the previous P.V has landed), p rounded to bf16
  // into P.V's A fragments: n8 block j is half of k16 step j / 2.
  __device__ __forceinline__ void rescale_and_pack(const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[4 * j + c] *= corr[c >> 1];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int S, int Tn, int H,
                       int KV, float sl2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int NCW = C::NCW, NB = C::NB, BK = C::BK, ST = C::STAGES;
  constexpr int BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries of the shared window
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;
  unsigned char* sK = base + C::Q_BYTES;
  unsigned char* sV = sK + ST * C::KV_BYTES;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;
  uint64_t* q_full = empty_v + ST;

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Tn - S;
  const int nk = (Tn + BK - 1) / BK;
  // key tiles [kt_lo, kt_hi) that rows [first, last] need: the causal
  // diagonal bounds them above, the window below
  auto tile_range = [&](int first, int last, int& lo, int& hi) {
    hi = causal ? min(nk, last / BK + 1) : nk;
    lo = window > 0 ? max(0, first - window + 1) / BK : 0;
  };
  int kt_lo, kt_hi;
  tile_range(q_offset + q0, q_offset + min(q0 + BQ, S) - 1, kt_lo, kt_hi);
  const int n = kt_hi - kt_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(&full_k[s], 1);
      sm::mbar_init(&full_v[s], 1);
      sm::mbar_init(&empty_k[s], 128 * NCW);  // every consumer thread
      sm::mbar_init(&empty_v[s], 128 * NCW);
    }
    sm::mbar_init(q_full, 1);
    sm::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, through a shuffle so that ptxas knows it (and
  // every branch on it) to be warp-uniform: wgmma in a path it cannot
  // prove uniform is serialised (ptxas C7518)
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {
    // producer: one thread keeps the ring full, K ahead of V
    sm::setmaxnreg_dec<C::PROD_REGS>();
    if (threadIdx.x == 0) {
      sm::mbar_expect_tx(q_full, C::Q_BYTES);
      for (int w = 0; w < NCW; ++w)
        for (int nb = 0; nb < NB; ++nb)
          sm::tma_load_4d(sQ + (w * NB + nb) * 64 * ROW_BYTES, &qmap, q_full,
                          nb * 64, h, q0 + 64 * w, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, par = ((i / ST) & 1) ^ 1;
        const int k0 = (kt_lo + i) * BK;
        sm::mbar_wait(&empty_k[s], par);
        sm::mbar_expect_tx(&full_k[s], C::KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          sm::tma_load_4d(sK + s * C::KV_BYTES + nb * BK * ROW_BYTES, &kmap,
                          &full_k[s], nb * 64, kvh, k0, b);
        sm::mbar_wait(&empty_v[s], par);
        sm::mbar_expect_tx(&full_v[s], C::KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          sm::tma_load_4d(sV + s * C::KV_BYTES + nb * BK * ROW_BYTES, &vmap,
                          &full_v[s], nb * 64, kvh, k0, b);
      }
    }
  } else {
    // consumer warpgroup cw owns queries q0 + 64 cw .. + 63.  Each step
    // issues Q K_i^T together with the P V of tile i - 1, so that product
    // runs under tile i's softmax.  Tiles masked for every row of the
    // group change nothing and are only waited for and released; the
    // loop is peeled so that no wgmma sits under a per-tile condition
    // (ptxas serialises wgmma whose groups it cannot match to waits).
    sm::setmaxnreg_inc<C::CONS_REGS>();
    const int cw = wgi - 1;
    const int ct = threadIdx.x % 128;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * cw;  // first query row (of S) of the group
    const int wg_first = q_offset + row0;
    const int wg_last = q_offset + min(row0 + 64, S) - 1;
    const int qp0 = wg_first + warp * 16 + g;  // this thread's first row
    const uint32_t qa = smem_u32(sQ + cw * NB * 64 * ROW_BYTES);
    int i_lo = 0, i_hi = 0;  // live tiles [i_lo, i_hi) of the ring order
    if (row0 < S) {
      int lo, hi;
      tile_range(wg_first, wg_last, lo, hi);
      i_lo = max(lo, kt_lo) - kt_lo;
      i_hi = max(min(hi, kt_hi) - kt_lo, i_lo);
    }

    Consumer<HD> st;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) st.acc[i] = 0.f;
    st.m[0] = st.m[1] = NEG_INF;
    st.l[0] = st.l[1] = 0.f;
    auto skip = [&](int i) {
      const int s = i % ST, par = (i / ST) & 1;
      sm::mbar_wait(&full_k[s], par);
      sm::mbar_arrive(&empty_k[s]);
      sm::mbar_wait(&full_v[s], par);
      sm::mbar_arrive(&empty_v[s]);
    };
    auto edge = [&](int k0) {
      return k0 + BK > Tn || (causal && k0 + BK - 1 > wg_first) ||
             (window > 0 && k0 <= wg_last - window);
    };
    for (int i = 0; i < i_lo; ++i) skip(i);
    sm::mbar_wait(q_full, 0);
    if (i_lo < i_hi) {
      float corr[2];
      {  // first live tile: Q K^T alone
        const int s = i_lo % ST, par = (i_lo / ST) & 1;
        const int k0 = (kt_lo + i_lo) * BK;
        sm::mbar_wait(&full_k[s], par);
        st.issue_qk(qa, smem_u32(sK + s * C::KV_BYTES));
        sm::wgmma_wait<0>();
        sm::fence_regs(st.sc);
        sm::mbar_arrive(&empty_k[s]);
        st.softmax(edge(k0), k0, qp0, Tn, causal, window, t, sl2, corr);
        st.rescale_and_pack(corr);
        sm::mbar_wait(&full_v[s], par);
      }
      for (int i = i_lo + 1; i < i_hi; ++i) {
        const int s = i % ST, par = (i / ST) & 1;
        const int sp = (i - 1) % ST;
        const int k0 = (kt_lo + i) * BK;
        sm::mbar_wait(&full_k[s], par);
        st.issue_qk(qa, smem_u32(sK + s * C::KV_BYTES));
        st.issue_pv(smem_u32(sV + sp * C::KV_BYTES));
        sm::wgmma_wait<1>();  // S landed; P V may still run
        sm::fence_regs(st.sc);
        sm::mbar_arrive(&empty_k[s]);
        st.softmax(edge(k0), k0, qp0, Tn, causal, window, t, sl2, corr);
        sm::wgmma_wait<0>();
        sm::fence_regs(st.acc);
        sm::mbar_arrive(&empty_v[sp]);
        st.rescale_and_pack(corr);
        sm::mbar_wait(&full_v[s], par);
      }
      st.issue_pv(smem_u32(sV + ((i_hi - 1) % ST) * C::KV_BYTES));
      sm::wgmma_wait<0>();
      sm::fence_regs(st.acc);
      sm::mbar_arrive(&empty_v[(i_hi - 1) % ST]);
    }
    for (int i = i_hi; i < n; ++i) skip(i);

    if (row0 < S) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = st.l[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = row0 + warp * 16 + g + 8 * r;
        if (row >= S) continue;
        const float den = fmaxf(l, 1e-30f);
        __nv_bfloat16* orow =
            o + ((static_cast<long long>(b) * S + row) * H + h) * HD + 2 * t;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
              st.acc[4 * j + 2 * r] / den, st.acc[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetch it from the
// driver through the runtime, so the library links without -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a (B, len, heads, hd) bf16 tensor read through its
// (batch, sequence, head) strides in elements: dims (hd, heads, len, B),
// boxes of 64 columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle;
// rows past len read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int len, int heads,
              int hd, long long sb, long long ss, long long sh, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int KV, const long long* st, float sl2, int causal,
           int window, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, S, H, HD, st[0], st[1], st[2], 64) ||
      !make_map(&km, k, B, Tn, KV, HD, st[3], st[4], st[5], C::BK) ||
      !make_map(&vm, v, B, Tn, KV, HD, st[6], st[7], st[8], C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  flash_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, Tn, H, KV, sl2, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool bad_shape(int B, int S, int T, int H, int KV) {
  return B <= 0 || S <= 0 || T < S || H <= 0 || KV <= 0 || H % KV != 0 ||
         B > 65535 || H > 65535;
}

}  // namespace

// q: (B, S, H, hd), k and v: (B, T, KV, hd), each with unit stride in hd
// and the given (batch, sequence, head) strides in elements; o: (B, S, H,
// hd) contiguous.  hd in {64, 128, 256}; S <= T; H % KV == 0.  strides:
// q's, k's, v's (batch, sequence, head).  Returns cudaGetLastError()
// after the launch.

// float32 inputs, on the CUDA cores.
extern "C" int sears_flash_attn_fp32(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T, int H, int KV, int hd,
                                     const long long* strides, float scale,
                                     int causal, int window, void* stream) {
  if (bad_shape(B, S, T, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SEARS_FLASH_CASE(HD)                                                \
  return fp32::launch<HD>(q, k, v, o, B, S, T, H, KV, strides, scale, causal, \
                          window, st)
  if (hd == 64) SEARS_FLASH_CASE(64);
  if (hd == 128) SEARS_FLASH_CASE(128);
  if (hd == 256) SEARS_FLASH_CASE(256);
#undef SEARS_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// bfloat16 inputs, on the tensor cores.  q, k and v need 16-byte aligned
// bases and strides that are multiples of 8 elements (TMA); a tensor map
// the driver refuses returns cudaErrorInvalidValue.
extern "C" int sears_flash_attn_bf16(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T, int H, int KV, int hd,
                                     const long long* strides, float scale,
                                     int causal, int window, void* stream) {
  if (bad_shape(B, S, T, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
#define SEARS_FLASH_CASE(HD)                                                  \
  return tc::launch<HD>(q, k, v, o, B, S, T, H, KV, strides, sl2, causal, \
                        window, st)
  if (hd == 64) SEARS_FLASH_CASE(64);
  if (hd == 128) SEARS_FLASH_CASE(128);
  if (hd == 256) SEARS_FLASH_CASE(256);
#undef SEARS_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

