// Flash attention (GQA, causal and sliding-window masks) for Hopper:
// bf16 on the tensor cores (wgmma), fp32 on the CUDA cores (FFMA), both
// fed by a ring of TMA loads.
//
// Replaces the JAX reference's Pallas kernel
// src/repro/kernels/flash_attn.py::_kernel (launched by _flash_padded,
// wrapped by flash_attention): softmax(q k^T * scale + mask) v with the
// running max m, row sum l and output accumulator kept on chip, the
// queries being the last S of T positions.  Same masks in the same order
// (keys past T, then k <= q if causal, then k > q - window if window >
// 0), masked scores at -1e30 so no row becomes NaN, p rounded to v's
// dtype before P.V while l sums the unrounded p, and acc / max(l, 1e-30)
// at the end.  Any hd up to 256 whose rows are a multiple of 16 bytes (8
// bf16 or 4 fp32 columns), as the reference takes any hd: each kernel is
// instantiated at hd 32, 64, 96, 128 and 256, and another hd runs on the
// smallest instance above it.  Its tensor maps carry the real hd, so TMA
// fills the columns past it with zeros (scores and outputs unchanged),
// and only the real hd columns are stored; a native hd stores with its
// compile-time stride.
//
// What bounds it on an H100: operations.  A causal pass does 4 hd
// operations per live query-key pair against reading q, k and v once and
// writing o once; at S = T = 8192, 32/8 heads, hd 64 that is 2.75e11
// operations: 0.278 ms at the 989 TFLOP/s of the bf16 tensor cores
// against 84 MB (0.025 ms at 3.35 TB/s), or 4.10 ms at the 67 TFLOP/s of
// the fp32 CUDA cores against 168 MB (0.050 ms, about 1/80 of it).
// Beside the products, each score costs one exp on the MUFU units (16 a
// clock an SM): at hd 64 that is one exp per 256 tensor-core operations,
// about the products' own time, so the exps must run under the products;
// at hd 32 the exps take twice the products' time and bound the bf16
// kernel.
//
// bf16 (flash_wgmma_kernel): q k^T from bf16 inputs with fp32 sums is
// exactly what the reference computes (it casts q and k to fp32; bf16 x
// bf16 products are exact in fp32), so both products go to the tensor
// cores.  One block of 1 + NCW warpgroups owns one (batch, query head,
// 64 NCW queries); NCW is 3 at hd 32 and 64, 2 at hd 96, 128 and 256
// (Cfg).
// - warpgroup 0 gives up registers (setmaxnreg) and one of its threads
//   issues TMA loads: Q once, then K and V tiles of BK keys into a ring
//   of STAGES slots with full and empty mbarriers (K and V each have
//   their own, so Q.K^T starts before V lands and K's slot frees before
//   V's).  4-D tensor maps over (hd, heads, len, B) read one KV head's
//   tile where it lies in the model layout; a 64-column box is one
//   128-byte swizzle row, so hd 128 and 256 take 2 or 4 boxes a tile.  hd
//   32 and 96 take 1 or 3 boxes of 32 columns, 64-byte swizzle rows
//   (chunk c of row r at c ^ (r / 2 % 4)), read through descriptors of
//   layout 2; rows past S or T come back as zeros.
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
// fp32 (flash_fma_kernel): the products stay on the CUDA cores, because
// no tensor-core route holds the 2e-5 tolerance for every input.  Plain
// TF32 breaks it.  Split TF32 (a = hi + lo; hi hi + hi lo + lo hi, fp32
// sums), emulated in numpy with cvt.rna rounding and the online softmax
// over 64-key tiles, reads 2.4-4.2% of the gate 2e-5 + 2e-5 |plain| on
// standard normal inputs, 43% on inputs scaled x2 and 285% scaled x4
// (scores of std 16), where fp32 FMAs in the same order read 1%, 6% and
// 3% (time_kernels.py --flash reads this kernel on such inputs on the
// card).  On the CUDA cores the bound is the FFMA issue rate: an SM issues
// 4 warp instructions a clock, so every shared load, softmax step and
// address computation takes a slot from the FMAs, and shared memory
// serves one 128-byte wavefront a clock beside them.
// - TMA brings Q once, then K_i and V_i by turns into one ring of SLOTS
//   tile slots with a full mbarrier each, so K_i+1 lands during tile i's
//   P.V and V_i+1 during the next Q.K^T.  No warp is set apart to load
//   (a ninth warp would cap every thread at 168 registers): thread 0
//   fills the ring, and the last warp to release a slot (a shared count)
//   refills it.  A 128-byte swizzle row holds 32 fp32 columns: a row
//   takes hd / 32 boxes; rows past S or T come back as zeros.
// - NW = 8 warps own WQ = 4 MQ queries each, MQ = 8 at hd 32 and 64, 4
//   at hd 96 and 128, 2 at hd 256.  In Q.K^T a warp's lanes are 4 query
//   groups x 8 key groups and a thread holds MQ x 8 scores (queries qg +
//   4i, keys kg + 8j); in P.V the same lanes are 4 query groups x 8
//   column groups and a thread holds MQ rows of its 16-byte chunk kg of
//   every box: MQ hd / 8 accumulators (64 at hd 64, 128 and 256; 32 at
//   hd 32 and 48 at hd 96, where 16 or 6 query rows would cost 128
//   score registers or a fraction).  At hd 64 each 16-byte shared load
//   feeds 16 FFMAs in both products.
// - the 128-byte swizzle puts chunk c of a box's row r at c ^ (r % 8).  The
//   8 key rows a warp reads at once (and the 8 chunks of one V row) cover
//   the 8 phases, and the 4 query rows are broadcast to 8 lanes each, so
//   every shared load is one wavefront.  A thread's addresses carry its
//   phase in bits 4-6: a chunk's address is one XOR away.
// - p goes through a warp-private buffer in shared memory (rows padded to
//   BK + 8 floats: its stores and loads are conflict-free), ordered by
//   __syncwarp alone, so the warps drift apart and one warp's softmax runs
//   under the others' products; l stays per lane until the end.
// - exp is ex2.approx with log2(e) folded into the scale; masks apply only
//   on tiles at the causal diagonal, the window's edge or past T; tiles
//   masked for every row of a warp are only waited for and released; the
//   heaviest query tiles of every head launch before any lighter one.

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// A 4-D map over a (B, len, heads, hd) tensor of `type` (bf16 or fp32)
// read through its (batch, sequence, head) strides in elements: dims (hd,
// heads, len, B), boxes of one swizzle row of `row_bytes` (128: 64 bf16 or
// 32 fp32 columns; 64: 32 bf16 columns) x 1 head x `rows` rows x 1 batch;
// rows past len and columns past hd read as zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              int B, int len, int heads, int hd, long long sb, long long ss,
              long long sh, int rows, int row_bytes) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * size,
                                 static_cast<cuuint64_t>(ss) * size,
                                 static_cast<cuuint64_t>(sb) * size};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(row_bytes / size), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel fed by a TMA ring.
namespace tc {

using sears::sm90::desc_sw;
using sears::sm90::smem_u32;
namespace sm = sears::sm90;

constexpr float NEG_INF = -1e30f;

// NCW consumer warpgroups of 64 query rows each, after one producer
// warpgroup; tiles of BK keys in a ring of STAGES slots.  Three consumer
// groups at hd 32 and 64 (more warps to hide the softmax's latency); two
// at hd 96, 128 and 256, where the accumulators need the registers (three
// at hd 96 spill 144 bytes a thread and ptxas serialises their wgmma,
// C7512).  A
// row of a tile is NB boxes of BW columns, each a swizzle row of ROW
// bytes: 64 columns (128 bytes) where hd is a multiple of 64, else 32
// (64 bytes).
template <int HD>
struct Cfg {
  static constexpr int NCW = HD <= 64 ? 3 : 2;
  static constexpr int BW = HD % 64 == 0 ? 64 : 32;   // columns a box
  static constexpr int ROW = 2 * BW;                  // bytes a box row
  static constexpr int SBO = 8 * ROW;                 // a swizzle atom
  static constexpr int NB = HD / BW;                  // boxes a row
  static constexpr int BQ = 64 * NCW;                 // queries a block
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int BK = HD == 256 ? 64 : 128;     // keys a tile
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr int Q_BYTES = NCW * NB * 64 * ROW;
  static constexpr int KV_BYTES = NB * BK * ROW;      // one K or V tile
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
  static constexpr int BK = C::BK, ROW = C::ROW;
  static constexpr int KB = C::BW / 16;  // k16 steps a box
  static constexpr int NS = BK / 8;      // n8 blocks of S
  static constexpr int NO = HD / 8;      // n8 blocks of O

  float acc[HD / 2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];  // p (bf16 pairs) as P.V's A fragments
  float m[2], l[2];         // per row: running max (units of q.k), sum

  // issue S = Q K^T: A and B K-major in shared memory; k16 step kk is
  // 32 bytes into a row of box kk / KB
  __device__ __forceinline__ void issue_qk(uint32_t qa, uint32_t ka) {
    sm::fence_regs(sc);
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm::wgmma_ss<BK>(
          sc,
          desc_sw<ROW>(qa + (kk / KB) * 64 * ROW + (kk % KB) * 32, 16,
                       C::SBO),
          desc_sw<ROW>(ka + (kk / KB) * BK * ROW + (kk % KB) * 32, 16,
                       C::SBO),
          kk > 0);
    sm::wgmma_commit();
  }

  // issue O += P V: P from registers, V read MN-major (transpose bit),
  // its boxes BK rows apart
  __device__ __forceinline__ void issue_pv(uint32_t va) {
    sm::fence_regs(acc);
    sm::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      sm::wgmma_rs<HD>(acc, pa[j],
                       desc_sw<ROW>(va + j * 16 * ROW, BK * ROW, C::SBO), 1);
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

  // O / l into rows of `od` columns (o's row stride): od is HD at a native
  // hd, a constant here; else the real hd, a multiple of 8, and the n8
  // blocks past it are not stored.
  __device__ __forceinline__ void store(__nv_bfloat16* o, int b, int S,
                                        int H, int h, int row0, int warp,
                                        int g, int t, int od) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = row0 + warp * 16 + g + 8 * r;
      if (row >= S) continue;
      const float den = fmaxf(lr, 1e-30f);
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * S + row) * H + h) * od + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        if (8 * j < od)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
              acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int S, int Tn, int H,
                       int KV, int hd, float sl2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int NCW = C::NCW, NB = C::NB, BK = C::BK, ST = C::STAGES;
  constexpr int BQ = C::BQ, ROW = C::ROW, BW = C::BW;
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
          sm::tma_load_4d(sQ + (w * NB + nb) * 64 * ROW, &qmap, q_full,
                          nb * BW, h, q0 + 64 * w, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, par = ((i / ST) & 1) ^ 1;
        const int k0 = (kt_lo + i) * BK;
        sm::mbar_wait(&empty_k[s], par);
        sm::mbar_expect_tx(&full_k[s], C::KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          sm::tma_load_4d(sK + s * C::KV_BYTES + nb * BK * ROW, &kmap,
                          &full_k[s], nb * BW, kvh, k0, b);
        sm::mbar_wait(&empty_v[s], par);
        sm::mbar_expect_tx(&full_v[s], C::KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          sm::tma_load_4d(sV + s * C::KV_BYTES + nb * BK * ROW, &vmap,
                          &full_v[s], nb * BW, kvh, k0, b);
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
    const uint32_t qa = smem_u32(sQ + cw * NB * 64 * ROW);
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
      if (hd == HD)
        st.store(o, b, S, H, h, row0, warp, g, t, HD);
      else
        st.store(o, b, S, H, h, row0, warp, g, t, hd);
    }
  }
}

// hd <= HD: the real head dim, the tensor maps' extent
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int KV, int hd, const long long* st, float sl2,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&qm, BF16, q, B, S, H, hd, st[0], st[1], st[2], 64, C::ROW) ||
      !make_map(&km, BF16, k, B, Tn, KV, hd, st[3], st[4], st[5], C::BK,
                C::ROW) ||
      !make_map(&vm, BF16, v, B, Tn, KV, hd, st[6], st[7], st[8], C::BK,
                C::ROW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  flash_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, Tn, H, KV, hd, sl2,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel fed by a TMA ring.
namespace fp32 {

using sears::sm90::smem_u32;
namespace sm = sears::sm90;

constexpr int ROW_BYTES = 128;  // one 32-column fp32 swizzle row
constexpr float NEG_INF = -1e30f;

// NW warps of WQ = 4 MQ queries each; K and V tiles of BK keys share one
// ring of SLOTS slots.  MQ x 8 scores and MQ rows x hd / 8 columns of
// outputs a thread: MQ = 8 at hd 32 and 64, 4 at hd 96 and 128, 2 at hd
// 256 (an even MQ keeps the Q rows' swizzle phases qg ^ 4 (i & 1)).  8
// warps put 2 on each of the SM's 4 schedulers, so a thread may hold 255
// registers (hd 64 uses 254); a ninth would put 3 on one and cap every
// thread at 168.  The small tiles of hd 32 take a deeper ring.
template <int HD>
struct Cfg {
  static constexpr int NB = HD / 32;    // boxes a row; a thread's P.V chunks
  static constexpr int MQ = HD <= 64 ? 8 : HD <= 128 ? 4 : 2;  // query rows
  static constexpr int WQ = 4 * MQ;     // queries a warp
  static constexpr int NW = 8;          // warps
  static constexpr int BQ = NW * WQ;    // queries a block: 256, 128, 64
  static constexpr int BK = 64;         // keys a tile
  static constexpr int MK = BK / 8;     // keys a thread in Q.K^T
  static constexpr int SLOTS = HD == 32 ? 8 : HD <= 96 ? 4 : HD == 128 ? 3
                                                                       : 2;
  static constexpr int PST = BK + 8;    // floats a row of a warp's P
  static constexpr int THREADS = 32 * NW;
  static constexpr int Q_BYTES = NB * BQ * ROW_BYTES;
  static constexpr int TILE_BYTES = NB * BK * ROW_BYTES;  // a K or V tile
  static constexpr int P_OFF = Q_BYTES + SLOTS * TILE_BYTES;
  static constexpr int BAR_OFF = P_OFF + NW * WQ * PST * 4;
  // full barriers, Q's barrier, then a release count a slot
  static constexpr int SMEM = BAR_OFF + 8 * (SLOTS + 1) + 4 * SLOTS + 1024;
};

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x));
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    flash_fma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     float* __restrict__ o, int S, int Tn, int H, int KV,
                     int hd, float sl2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int NB = C::NB, MQ = C::MQ, MK = C::MK, WQ = C::WQ;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::SLOTS, PST = C::PST;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries of the shared window
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;
  unsigned char* ring = base + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* q_full = full + NS;
  unsigned* released = reinterpret_cast<unsigned*>(q_full + 1);

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (static_cast<int>(gridDim.y - 1 - blockIdx.y)) * BQ;
  const int kvh = h / (H / KV);
  const int q_offset = Tn - S;
  const int nk = (Tn + BK - 1) / BK;
  // key tiles [lo, hi) that rows [first, last] need: the causal diagonal
  // bounds them above, the window below
  auto tile_range = [&](int first, int last, int& lo, int& hi) {
    hi = causal ? min(nk, last / BK + 1) : nk;
    lo = window > 0 ? max(0, first - window + 1) / BK : 0;
  };
  int kt_lo, kt_hi;
  tile_range(q_offset + q0, q_offset + min(q0 + BQ, S) - 1, kt_lo, kt_hi);
  const int n = kt_hi - kt_lo;  // the ring carries K_i, V_i: 2 n tiles

  // tile u of the ring (K_u/2 if u is even, else V_u/2) into slot u % NS
  auto issue = [&](int u) {
    const int s = u % NS;
    sm::mbar_expect_tx(&full[s], C::TILE_BYTES);
    for (int nb = 0; nb < NB; ++nb)
      sm::tma_load_4d(ring + s * C::TILE_BYTES + nb * BK * ROW_BYTES,
                      (u & 1) ? &vmap : &kmap, &full[s], nb * 32, kvh,
                      (kt_lo + u / 2) * BK, b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      sm::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    sm::mbar_init(q_full, 1);
    sm::mbar_fence_init();
    sm::mbar_expect_tx(q_full, C::Q_BYTES);
    for (int nb = 0; nb < NB; ++nb)
      sm::tma_load_4d(sQ + nb * BQ * ROW_BYTES, &qmap, q_full, nb * 32, h,
                      q0, b);
    for (int u = 0; u < min(NS, 2 * n); ++u) issue(u);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp owns query rows row0 + qg + 4 i (i < MQ)
  const int qg = lane >> 3, kg = lane & 7;  // kg: P.V's chunk too
  const int row0 = q0 + warp * WQ;
  const int w_first = q_offset + row0;
  const int w_last = q_offset + min(row0 + WQ, S) - 1;
  int i_lo = 0, i_hi = 0;  // live tiles [i_lo, i_hi) of the ring order
  if (row0 < S) {
    int lo, hi;
    tile_range(w_first, w_last, lo, hi);
    i_lo = max(lo, kt_lo) - kt_lo;
    i_hi = max(min(hi, kt_hi) - kt_lo, i_lo);
  }
  // Shared addresses with the thread's swizzle phase in bits 4-6 (every
  // box starts on 1024 bytes): chunk c of its row is the address ^ c << 4.
  // Q row qg + 4 i has phase qg ^ 4 (i & 1); K rows kg + 8 j phase kg; V
  // row r's chunk kg lies at kg ^ r % 8.
  const uint32_t qx = smem_u32(sQ) + (warp * WQ + qg) * ROW_BYTES + (qg << 4);
  const uint32_t kx0 = smem_u32(ring) + kg * ROW_BYTES + (kg << 4);
  const uint32_t vx0 = smem_u32(ring) + (kg << 4);
  // this thread's row of the warp's P (rows qg + 4 i)
  const uint32_t px = smem_u32(base + C::P_OFF) + (warp * WQ + qg) * PST * 4;

  float acc[MQ][NB][4];  // O rows qg + 4 i, columns 32 t + 4 kg .. + 3
  float m[MQ], l[MQ];    // running max (log2 units) and this lane's sum
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
  }
  auto wait_tile = [&](int u) {
    sm::mbar_wait(&full[u % NS], (u / NS) & 1);
    return u % NS;
  };
  // the warp is done with tile u's slot: the last warp to say so refills
  // it with tile u + NS (a count a slot, NW a round, never reset)
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&released[u % NS], 1u) % C::NW == C::NW - 1 &&
          u + NS < 2 * n)
        issue(u + NS);
    }
  };
  for (int u = 0; u < 2 * i_lo; ++u) {
    wait_tile(u);
    release(u);
  }
  sm::mbar_wait(q_full, 0);
  for (int it = i_lo; it < i_hi; ++it) {
    const int k0 = (kt_lo + it) * BK;
    // S = Q K^T: MQ x MK scores a thread, 16-byte chunks of d in step
    float sc[MQ][MK];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MK; ++j) sc[i][j] = 0.f;
    const int sk = wait_tile(2 * it);
#pragma unroll 1
    for (int nb = 0; nb < NB; ++nb) {
      const uint32_t kb = kx0 + sk * C::TILE_BYTES + nb * BK * ROW_BYTES;
      const uint32_t qb = qx + nb * BQ * ROW_BYTES;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float4 kf[MK];
#pragma unroll
        for (int j = 0; j < MK; ++j)
          kf[j] = lds128((kb ^ (c << 4)) + j * 8 * ROW_BYTES);
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const float4 qf =
              lds128((qb ^ ((c ^ 4 * (i & 1)) << 4)) + i * 4 * ROW_BYTES);
#pragma unroll
          for (int j = 0; j < MK; ++j) {
            sc[i][j] = fmaf(qf.x, kf[j].x, sc[i][j]);
            sc[i][j] = fmaf(qf.y, kf[j].y, sc[i][j]);
            sc[i][j] = fmaf(qf.z, kf[j].z, sc[i][j]);
            sc[i][j] = fmaf(qf.w, kf[j].w, sc[i][j]);
          }
        }
      }
    }
    release(2 * it);

    // online softmax in log2 units; masks only where they bite
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > w_first) ||
                      (window > 0 && k0 <= w_last - window);
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MK; ++j) sc[i][j] *= sl2;
    if (edge) {
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MK; ++j) {
          const int kp = k0 + kg + 8 * j;
          const int qp = w_first + qg + 4 * i;
          bool ok = kp < Tn;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          sc[i][j] = ok ? sc[i][j] : NEG_INF;
        }
    }
    float corr[MQ];
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      float mx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[j] = fmaxf(sc[i][j], sc[i][j + 4]);
      float mr = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 4));
      const float m_new = fmaxf(m[i], mr);
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < MK; ++j) {
        sc[i][j] = ex2(sc[i][j] - m_new);
        ps[j & 1] += sc[i][j];
      }
      l[i] = l[i] * corr[i] + (ps[0] + ps[1]);
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MK; ++j)
        sts32(px + (4 * i * PST + kg + 8 * j) * 4, sc[i][j]);
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int t = 0; t < NB; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] *= corr[i];
    __syncwarp();  // the warp's P is written

    // O += P V: key by key, p from the warp's P, V's chunk kg of each box
    const int sv = wait_tile(2 * it + 1);
    const uint32_t vb = vx0 + sv * C::TILE_BYTES;
#pragma unroll 1
    for (int kk = 0; kk < BK / 8; ++kk) {
      float4 pf[MQ][2];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          pf[i][hh] = lds128(px + (4 * i * PST + 8 * kk + 4 * hh) * 4);
      const uint32_t vk = vb + kk * 8 * ROW_BYTES;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t va = (vk ^ (r << 4)) + r * ROW_BYTES;
        float4 vf[NB];
#pragma unroll
        for (int t = 0; t < NB; ++t) vf[t] = lds128(va + t * BK * ROW_BYTES);
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          const float p = lane_of(pf[i][r >> 2], r & 3);
#pragma unroll
          for (int t = 0; t < NB; ++t) {
            acc[i][t][0] = fmaf(p, vf[t].x, acc[i][t][0]);
            acc[i][t][1] = fmaf(p, vf[t].y, acc[i][t][1]);
            acc[i][t][2] = fmaf(p, vf[t].z, acc[i][t][2]);
            acc[i][t][3] = fmaf(p, vf[t].w, acc[i][t][3]);
          }
        }
      }
    }
    release(2 * it + 1);  // also orders this tile's P reads before the
                          // next tile's writes
  }
  for (int u = 2 * i_hi; u < 2 * n; ++u) {
    wait_tile(u);
    release(u);
  }

  // O / l into rows of `od` columns (o's row stride): od is HD at a native
  // hd, a constant here; else the real hd, a multiple of 4, and the chunks
  // past it are not stored
  auto store = [&](int od) {
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li += __shfl_xor_sync(0xffffffffu, li, 4);
      const int row = row0 + qg + 4 * i;
      if (row >= S) continue;
      const float den = fmaxf(li, 1e-30f);
      float* orow =
          o + ((static_cast<long long>(b) * S + row) * H + h) * od + 4 * kg;
#pragma unroll
      for (int t = 0; t < NB; ++t)
        if (32 * t + 4 * kg < od)
          *reinterpret_cast<float4*>(orow + 32 * t) =
              make_float4(acc[i][t][0] / den, acc[i][t][1] / den,
                          acc[i][t][2] / den, acc[i][t][3] / den);
    }
  };
  if (row0 < S) {
    if (hd == HD)
      store(HD);
    else
      store(hd);
  }
}

// hd <= HD: the real head dim, the tensor maps' extent
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int KV, int hd, const long long* st, float sl2,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int nq = (S + C::BQ - 1) / C::BQ;
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!make_map(&qm, F32, q, B, S, H, hd, st[0], st[1], st[2], C::BQ, 128) ||
      !make_map(&km, F32, k, B, Tn, KV, hd, st[3], st[4], st[5], C::BK,
                128) ||
      !make_map(&vm, F32, v, B, Tn, KV, hd, st[6], st[7], st[8], C::BK, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // heads fastest: every head's heaviest query tile launches first
  const dim3 grid(H, nq, B);
  flash_fma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<float*>(o), S, Tn, H, KV, hd, sl2, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

constexpr int MAX_HD = 256;  // wgmma's N, and shared memory

// hd's row must be a multiple of 16 bytes (TMA), `size` bytes an element
bool bad_shape(int B, int S, int T, int H, int KV, int hd, int size) {
  return B <= 0 || S <= 0 || T < S || H <= 0 || KV <= 0 || H % KV != 0 ||
         B > 65535 || H > 65535 || hd <= 0 || hd > MAX_HD ||
         hd * size % 16 != 0;
}

}  // namespace

// q: (B, S, H, hd), k and v: (B, T, KV, hd), each with unit stride in hd
// and the given (batch, sequence, head) strides in elements; o: (B, S, H,
// hd) contiguous.  hd <= 256 with rows of a multiple of 16 bytes, run by
// the instance at hd 32, 64, 96, 128 or 256, the smallest at or above it;
// S <= T; H % KV == 0.  strides: q's, k's, v's (batch, sequence, head).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue,
// launching nothing, for a shape outside these.

// float32 inputs, on the CUDA cores.  q, k and v need 16-byte aligned
// bases and strides that are multiples of 4 elements (TMA); a tensor map
// the driver refuses returns cudaErrorInvalidValue.
extern "C" int sears_flash_attn_fp32(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T, int H, int KV, int hd,
                                     const long long* strides, float scale,
                                     int causal, int window, void* stream) {
  if (bad_shape(B, S, T, H, KV, hd, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // exp(x) = exp2(x log2 e), the product rounded once
  const float sl2 = static_cast<float>(scale * 1.4426950408889634);
#define SEARS_FLASH_CASE(HD)                                                \
  return fp32::launch<HD>(q, k, v, o, B, S, T, H, KV, hd, strides, sl2,    \
                          causal, window, st)
  if (hd <= 32) SEARS_FLASH_CASE(32);
  if (hd <= 64) SEARS_FLASH_CASE(64);
  if (hd <= 96) SEARS_FLASH_CASE(96);
  if (hd <= 128) SEARS_FLASH_CASE(128);
  SEARS_FLASH_CASE(256);
#undef SEARS_FLASH_CASE
}

// bfloat16 inputs, on the tensor cores.  q, k and v need 16-byte aligned
// bases and strides that are multiples of 8 elements (TMA); a tensor map
// the driver refuses returns cudaErrorInvalidValue.
extern "C" int sears_flash_attn_bf16(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T, int H, int KV, int hd,
                                     const long long* strides, float scale,
                                     int causal, int window, void* stream) {
  if (bad_shape(B, S, T, H, KV, hd, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
#define SEARS_FLASH_CASE(HD)                                              \
  return tc::launch<HD>(q, k, v, o, B, S, T, H, KV, hd, strides, sl2,    \
                        causal, window, st)
  if (hd <= 32) SEARS_FLASH_CASE(32);
  if (hd <= 64) SEARS_FLASH_CASE(64);
  if (hd <= 96) SEARS_FLASH_CASE(96);
  if (hd <= 128) SEARS_FLASH_CASE(128);
  SEARS_FLASH_CASE(256);
#undef SEARS_FLASH_CASE
}

