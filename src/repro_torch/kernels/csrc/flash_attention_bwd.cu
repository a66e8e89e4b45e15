// K2's backward on Hopper: the gradients of causal attention.
//
// The TPU package has no backward kernel: its trainer differentiates the
// plain attention (src/repro/models/layers.py: naive_attention) with XLA.
// This is the backward of the port's forward kernel (flash_attention.cu),
// a FlashAttention-2 scheme in three launches that never writes an
// [Sq, Sk] matrix to memory and needs no atomics:
//   1. delta[b, h, i] = rowsum(dO * O), fp32, one warp per row (and, for
//      the tc schedule, lse2 = lse * log2(e) beside it; both are scratch
//      rows of Sq rounded up to 4, so TMA may read them a tile at a time);
//   2. dK and dV: one block per (kv tile, kv head, batch).  It holds its
//      kv tile and walks the q tiles of every query head that reads this
//      kv head (GQA), from the causal diagonal on.  Per q tile it
//      recomputes P = exp(S * scale - lse) from the forward's log-sum-exp
//      and accumulates, in fp32 registers,
//          dV += P^T dO,   dK += (P * (dO V^T - delta))^T Q * scale;
//   3. dQ: one block per (q tile, head, batch), walking the kv tiles up to
//      the diagonal: dQ += (P * (dO V^T - delta)) K * scale.
// Masks: causal with q_offset = 0 over the full kv length, or no mask;
// ragged Sq and Sk; GQA by index; D in {32, 64, 128}.
//
// Bound on an H100 SXM at the training shape (B=8, S=1024, H=16, D=128,
// causal): q, k, v, o, dO, dQ, dK, dV once each plus lse and delta,
// 269 MB -> 0.080 ms at 3.35 TB/s; five products of 2 * D flops per
// visible (query, key) pair per head (S recomputed, dP, dV, dK, dQ), 10 * D
// in all, 85.9 GFLOP -> 0.087 ms at 989 TFLOP/s: the operations bound it,
// narrowly.  In fp32, 1.28 ms at 67 TFLOP/s.
//
// Two schedules, by dtype (plan_backward in kernels/flash_attention.py):
//
// * tc (bf16).  Kernels 2 and 3 run their products on wgmma, with a
//   producer warpgroup whose one thread brings tiles in by TMA through a
//   2-stage ring guarded by mbarriers, and two consumer warpgroups of 64
//   rows each.  dK/dV block: 128 kv rows; K and V stay in shared memory,
//   the ring brings Q, dO, lse and delta per 64-row q tile.  S^T = K Q^T
//   and dP^T = V dO^T take both operands from shared memory (K-major);
//   P^T and dS^T are rounded to bf16 in registers and are the A operands
//   of dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major (the
//   transpose bit).  dQ block: 128 q rows; Q, dO, lse and delta stay, the
//   ring brings K and V per 64-row kv tile; S = Q K^T, dP = dO V^T, then
//   dQ += dS K with K read MN-major.  The element mask runs only on tiles
//   the diagonal or the ragged edge cuts; tiles wholly above the diagonal
//   for a warpgroup are skipped.
// * fma (fp32): the first, simple version, on the fp32 FMA pipes (full
//   fp32, which the fp32 parity phases need): 32 x 32 tiles staged in
//   shared memory as fp32, 128 threads a block.  Instantiated for fp32
//   only: no bf16 tensor reaches it.

#include "hopper.cuh"

namespace {

using hopper::bf16;
using hopper::ERR_SCHEDULE;
using hopper::tensor_map_error;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Params {
  const void* q;     // [B, Sq, H, D]
  const void* k;     // [B, Sk, KV, D]
  const void* v;     // [B, Sk, KV, D]
  const void* o;     // [B, Sq, H, D]   the forward's output
  const void* dout;  // [B, Sq, H, D]
  const float* lse;  // [B, H, Sq]      the forward's log-sum-exp
  float* delta;      // [B, H, Sq_pad]  scratch: rowsum(dO * O)
  float* lse2;       // [B, H, Sq_pad]  scratch: lse * log2(e), or null
  void* dq;          // [B, Sq, H, D]
  void* dk;          // [B, Sk, KV, D]
  void* dv;          // [B, Sk, KV, D]
  int B, Sq, Sk, H, KV, causal;
  float scale;
  int Sq_pad;  // the row stride of delta and lse2: Sq rounded up to 4
};

constexpr int NT_DELTA = 128;

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp per row,
// rows in [b][i][h] order (the memory order of O); lse2 beside it.
template <typename T, int D>
__global__ void __launch_bounds__(NT_DELTA) bwd_delta_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (NT_DELTA / 32) + (threadIdx.x >> 5);
  if (row >= (long)p.B * p.Sq * p.H) return;  // whole warps leave together
  const T* O = (const T*)p.o + row * D;
  const T* dO = (const T*)p.dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f(O[d]) * to_f(dO[d]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % p.H);
    const long bs = row / p.H;
    const int s = (int)(bs % p.Sq);
    const int b = (int)(bs / p.Sq);
    const long bh = (long)b * p.H + h;
    p.delta[bh * p.Sq_pad + s] = acc;
    if (p.lse2 != nullptr)
      p.lse2[bh * p.Sq_pad + s] = p.lse[bh * p.Sq + s] * LOG2E;
  }
}

// ------------------------------------------------------------------- fma
namespace fmak {

constexpr int BQ = 32;   // query rows per tile
constexpr int BKV = 32;  // kv rows per tile (== the warp size: one lane each)
constexpr int NT = 128;  // threads per block
constexpr int WARPS = NT / 32;

template <int D>
constexpr size_t smem_bytes() {
  // sK, sV [BKV][D+1]; sQ, sdO [BQ][D+1]; sP, sdS [BQ][BKV+1]; lse, delta
  return sizeof(float) *
         (2 * BKV * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BKV + 1) + 2 * BQ);
}

// One (BQ x BKV) tile of scores: S = (q * scale) k^T and dP = dO v^T from
// shared memory, then P = exp(S - lse) (0 where masked) and
// dS = P * (dP - delta), both written to shared memory (P only if sP).
// Warp w owns query rows w, w + 4, ...; lane c owns kv column c.
template <int D>
__device__ __forceinline__ void tile_scores(
    const Params& p, const float* sQ, const float* sdO, const float* sK,
    const float* sV, const float* sLse, const float* sDelta, float* sP,
    float* sdS, int q0, int j0) {
  static_assert(BKV == 32, "one lane per kv column");
  constexpr int S_ = D + 1;
  constexpr int PS = BKV + 1;
  constexpr int RPT = BQ / WARPS;  // query rows per thread
  const int c = threadIdx.x & 31;
  const int rg = threadIdx.x >> 5;
  float s[RPT], dp[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kc = sK[c * S_ + d];
    const float vc = sV[c * S_ + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + WARPS * i;
      s[i] += sQ[r * S_ + d] * kc;
      dp[i] += sdO[r * S_ + d] * vc;
    }
  }
  const int kpos = j0 + c;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + WARPS * i;
    const int qpos = q0 + r;
    const bool ok =
        qpos < p.Sq && kpos < p.Sk && (!p.causal || kpos <= qpos);
    const float pr = ok ? expf(s[i] - sLse[r]) : 0.f;
    if (sP != nullptr) sP[r * PS + c] = pr;
    sdS[r * PS + c] = pr * (dp[i] - sDelta[r]);
  }
}

// Stage rows [row0, row0 + R) of a [B, S, heads, D] tensor (batch and head
// offsets already applied; rs = heads * D) as fp32 times mul; zero past S.
template <typename T, int D, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, long rs,
                                      int row0, int S, float mul) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int rr = i / D, dd = i % D;
    const int s = row0 + rr;
    dst[rr * (D + 1) + dd] = s < S ? to_f(src[s * rs + dd]) * mul : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_fma_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int S_ = D + 1;
  constexpr int PS = BKV + 1;
  constexpr int DC = D / 4;  // accumulator columns per thread
  float* sK = smem;
  float* sV = sK + BKV * S_;
  float* sQ = sV + BKV * S_;   // q * scale
  float* sdO = sQ + BQ * S_;
  float* sP = sdO + BQ * S_;
  float* sdS = sP + BQ * PS;
  float* sLse = sdS + BQ * PS;
  float* sDelta = sLse + BQ;

  const int j0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = p.H / p.KV;
  const long q_rs = (long)p.H * D;
  const long kv_rs = (long)p.KV * D;
  const long kv_off = (long)b * p.Sk * kv_rs + (long)kvh * D;
  stage<T, D, BKV>(sK, (const T*)p.k + kv_off, kv_rs, j0, p.Sk, 1.f);
  stage<T, D, BKV>(sV, (const T*)p.v + kv_off, kv_rs, j0, p.Sk, 1.f);

  // this thread's slice of dK and dV: kv row c, columns part + 4 j
  const int c = tid >> 2;
  const int part = tid & 3;
  float dk[DC], dv[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) dk[j] = dv[j] = 0.f;

  // the first q tile holding a row that sees key j0
  const int q_begin = p.causal ? (j0 / BQ) * BQ : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const long q_off = (long)b * p.Sq * q_rs + (long)h * D;
    const float* lse = p.lse + ((long)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long)b * p.H + h) * p.Sq_pad;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's sQ, sdO, sP, sdS are consumed
      stage<T, D, BQ>(sQ, (const T*)p.q + q_off, q_rs, q0, p.Sq, p.scale);
      stage<T, D, BQ>(sdO, (const T*)p.dout + q_off, q_rs, q0, p.Sq, 1.f);
      if (tid < BQ) {
        const int s = q0 + tid;
        sLse[tid] = s < p.Sq ? lse[s] : 0.f;
        sDelta[tid] = s < p.Sq ? delta[s] : 0.f;
      }
      __syncthreads();
      tile_scores<D>(p, sQ, sdO, sK, sV, sLse, sDelta, sP, sdS, q0, j0);
      __syncthreads();
      for (int r = 0; r < BQ; ++r) {
        const float pr = sP[r * PS + c];
        const float ds = sdS[r * PS + c];
        const float* dorow = sdO + r * S_ + part;
        const float* qrow = sQ + r * S_ + part;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dv[j] += pr * dorow[4 * j];
          dk[j] += ds * qrow[4 * j];  // sQ holds q * scale
        }
      }
    }
  }
  if (j0 + c < p.Sk) {
    const long at = kv_off + (long)(j0 + c) * kv_rs + part;
    T* dkrow = (T*)p.dk + at;
    T* dvrow = (T*)p.dv + at;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      store(dkrow + 4 * j, dk[j]);
      store(dvrow + 4 * j, dv[j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_fma_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int S_ = D + 1;
  constexpr int PS = BKV + 1;
  constexpr int DC = D / 4;
  float* sK = smem;
  float* sV = sK + BKV * S_;
  float* sQ = sV + BKV * S_;
  float* sdO = sQ + BQ * S_;
  float* sdS = sdO + BQ * S_ + BQ * PS;  // the sP slot stays unused
  float* sLse = sdS + BQ * PS;
  float* sDelta = sLse + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const long q_rs = (long)p.H * D;
  const long kv_rs = (long)p.KV * D;
  const long q_off = (long)b * p.Sq * q_rs + (long)h * D;
  const long kv_off = (long)b * p.Sk * kv_rs + (long)kvh * D;
  stage<T, D, BQ>(sQ, (const T*)p.q + q_off, q_rs, q0, p.Sq, p.scale);
  stage<T, D, BQ>(sdO, (const T*)p.dout + q_off, q_rs, q0, p.Sq, 1.f);
  if (tid < BQ) {
    const int s = q0 + tid;
    const long bh = (long)b * p.H + h;
    sLse[tid] = s < p.Sq ? p.lse[bh * p.Sq + s] : 0.f;
    sDelta[tid] = s < p.Sq ? p.delta[bh * p.Sq_pad + s] : 0.f;
  }

  // this thread's slice of dQ: query row r, columns part + 4 j
  const int r = tid >> 2;
  const int part = tid & 3;
  float dq[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) dq[j] = 0.f;

  int j_end = p.Sk;  // the last row of the tile sees keys <= its position
  if (p.causal) j_end = min(j_end, min(q0 + BQ, p.Sq));
  for (int j0 = 0; j0 < j_end; j0 += BKV) {
    __syncthreads();  // sQ/sdO staged; the previous sK, sV, sdS consumed
    stage<T, D, BKV>(sK, (const T*)p.k + kv_off, kv_rs, j0, p.Sk, 1.f);
    stage<T, D, BKV>(sV, (const T*)p.v + kv_off, kv_rs, j0, p.Sk, 1.f);
    __syncthreads();
    tile_scores<D>(p, sQ, sdO, sK, sV, sLse, sDelta, nullptr, sdS, q0, j0);
    __syncthreads();
    for (int cc = 0; cc < BKV; ++cc) {
      const float ds = sdS[r * PS + cc];
      const float* krow = sK + cc * S_ + part;
#pragma unroll
      for (int j = 0; j < DC; ++j) dq[j] += ds * krow[4 * j];
    }
  }
  if (q0 + r < p.Sq) {
    T* dqrow = (T*)p.dq + q_off + (long)(q0 + r) * q_rs + part;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(dqrow + 4 * j, dq[j] * p.scale);
  }
}


}  // namespace fmak

// -------------------------------------------------------------------- tc
namespace tc {

constexpr int BKV = 128;  // dK/dV block: kv rows (two consumer warpgroups)
constexpr int BQ = 128;   // dQ block: q rows (two consumer warpgroups)
constexpr int TQ = 64;    // q rows per ring stage of the dK/dV block
constexpr int TK = 64;    // kv rows per ring stage of the dQ block
constexpr int STAGES = 2;
constexpr int NT = 384;   // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;

constexpr int align1024(int n) { return (n + 1023) / 1024 * 1024; }

template <int D>
struct DkdvSmem {
  static constexpr int KV = BKV * D * 2;  // bytes of the K (or V) tile
  static constexpr int QT = TQ * D * 2;   // bytes of a Q (or dO) tile
  // a stage: Q, dO, then lse and delta (TQ fp32 each)
  static constexpr int STAGE = align1024(2 * QT + 2 * TQ * 4);
  static constexpr int BARS = 2 * KV + STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
struct DqSmem {
  static constexpr int QT = BQ * D * 2;  // bytes of the Q (or dO) tile
  static constexpr int KV = TK * D * 2;  // bytes of a K (or V) tile
  static constexpr int BARS = 2 * QT + 2 * STAGES * KV;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return (uint8_t*)(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(once, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// Store a 64 x D fp32 accumulator (times mul) as bf16 rows r0 and r0 + 8
// of a [B, S, heads, D] tensor (row_ptr(r) = the row's first element).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           bf16* row0, bf16* row8, int c4,
                                           float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dst = (r == 0 ? row0 : row8);
    if (dst == nullptr) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *(uint32_t*)(dst + 8 * j + 2 * c4) = hopper::pack_bf16(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// dK and dV for BKV kv rows of one (kv head, batch).
template <int D>
__global__ void __launch_bounds__(NT, 1)
    bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tlse,
                       const __grid_constant__ CUtensorMap tdelta,
                       const Params p) {
  using namespace hopper;
  using L = Tile<D>;
  using S = DkdvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  bf16* sK = (bf16*)base;
  bf16* sV = (bf16*)(base + S::KV);
  uint8_t* stages = base + 2 * S::KV;
  uint64_t* kv_full = (uint64_t*)(base + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BKV;  // the heaviest causal blocks come first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int nq = (p.Sq + TQ - 1) / TQ;
  const int q_begin = p.causal ? min(k0 / TQ, nq) : 0;
  const int per_head = nq - q_begin;
  const int n_tiles = G * per_head;  // (query head, q tile) pairs

  init_barriers(kv_full, full, empty);
  const int wg = hopper::warpgroup_index();
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * S::KV);
      for (int c = 0; c < L::NB; ++c) {
        tma_load_4d(sK + c * BKV * L::CB, &tk, kv_full, c * L::CB, kvh, k0,
                    b);
        tma_load_4d(sV + c * BKV * L::CB, &tv, kv_full, c * L::CB, kvh, k0,
                    b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int h = kvh * G + i / per_head;
        const int q0 = (q_begin + i % per_head) * TQ;
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::QT + 2 * TQ * 4);
        uint8_t* st = stages + s * S::STAGE;
        for (int c = 0; c < L::NB; ++c) {
          tma_load_4d(st + c * TQ * L::SWB, &tq, &full[s], c * L::CB, h, q0,
                      b);
          tma_load_4d(st + S::QT + c * TQ * L::SWB, &tdo, &full[s],
                      c * L::CB, h, q0, b);
        }
        tma_load_2d(st + 2 * S::QT, &tlse, &full[s], q0, b * p.H + h);
        tma_load_2d(st + 2 * S::QT + TQ * 4, &tdelta, &full[s], q0,
                    b * p.H + h);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns kv rows [k0 + 64 cw, + 64)
  setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int wg_first = k0 + cw * 64;
  const int kr0 = wg_first + (tid / 32) * 16 + g;  // kv rows kr0, kr0 + 8
  const float sl2 = p.scale * LOG2E;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = (q_begin + i % per_head) * TQ;
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    __syncwarp();
    const uint8_t* st = stages + s * S::STAGE;
    const bf16* sQ = (const bf16*)st;
    const bf16* sdO = (const bf16*)(st + S::QT);
    const float* sLse = (const float*)(st + 2 * S::QT);  // lse * log2(e)
    const float* sDelta = sLse + TQ;
    // every q row of the tile before every kv row of this warpgroup: P = 0
    const bool skip =
        wg_first >= p.Sk || (p.causal && q0 + TQ - 1 < wg_first);
    if (!skip) {
      float sc[TQ / 2], dp[TQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<BKV, D>(sK, cw * 64, kk),
                 desc_k<TQ, D>(sQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k<BKV, D>(sV, cw * 64, kk),
                 desc_k<TQ, D>(sdO, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool cut =
          q0 + TQ > p.Sq || (p.causal && q0 < wg_first + 63);
#pragma unroll
      for (int e = 0; e < TQ / 2; ++e) {
        const int ql = 8 * (e / 4) + 2 * c4 + (e % 2);
        float pr = exp2f(fmaf(sc[e], sl2, -sLse[ql]));
        float ds = pr * (dp[e] - sDelta[ql]);
        if (cut) {
          // the scratch rows past Sq hold no lse or delta: mask both
          const int q = q0 + ql;
          const int kv = kr0 + 8 * ((e % 4) / 2);
          if (q >= p.Sq || (p.causal && kv > q)) pr = ds = 0.f;
        }
        sc[e] = pr;  // P^T
        dp[e] = ds;  // dS^T
      }
      uint32_t pa[TQ / 16][4], da[TQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        acc_to_a(sc, kk, pa[kk]);
        acc_to_a(dp, kk, da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        wgmma_rs(dv, pa[kk], desc_mn<TQ, D>(sdO, kk * 16), 1);
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        wgmma_rs(dk, da[kk], desc_mn<TQ, D>(sQ, kk * 16), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    }
    mbar_arrive(&empty[s]);
  }

  const long rs = (long)p.KV * D;
  const long at = ((long)b * p.Sk) * rs + (long)kvh * D;
  bf16* k_row0 = kr0 < p.Sk ? (bf16*)p.dk + at + kr0 * rs : nullptr;
  bf16* k_row8 = kr0 + 8 < p.Sk ? (bf16*)p.dk + at + (kr0 + 8) * rs : nullptr;
  bf16* v_row0 = kr0 < p.Sk ? (bf16*)p.dv + at + kr0 * rs : nullptr;
  bf16* v_row8 = kr0 + 8 < p.Sk ? (bf16*)p.dv + at + (kr0 + 8) * rs : nullptr;
  store_rows<D>(dk, k_row0, k_row8, c4, p.scale);
  store_rows<D>(dv, v_row0, v_row8, c4, 1.f);
}

// dQ for BQ q rows of one (head, batch).
template <int D>
__global__ void __launch_bounds__(NT, 1)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const Params p) {
  using namespace hopper;
  using L = Tile<D>;
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  bf16* sQ = (bf16*)base;
  bf16* sdO = (bf16*)(base + S::QT);
  bf16* sK = (bf16*)(base + 2 * S::QT);  // [STAGES][TK x D]
  bf16* sV = (bf16*)(base + 2 * S::QT + STAGES * S::KV);
  uint64_t* q_full = (uint64_t*)(base + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  const int j_end = p.causal ? min(p.Sk, last_row + 1) : p.Sk;
  const int t_end = (j_end + TK - 1) / TK;

  init_barriers(q_full, full, empty);
  const int wg = hopper::warpgroup_index();
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * S::QT);
      for (int c = 0; c < L::NB; ++c) {
        tma_load_4d(sQ + c * BQ * L::CB, &tq, q_full, c * L::CB, h, q0, b);
        tma_load_4d(sdO + c * BQ * L::CB, &tdo, q_full, c * L::CB, h, q0,
                    b);
      }
      for (int t = 0; t < t_end; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::KV);
        for (int c = 0; c < L::NB; ++c) {
          tma_load_4d(sK + s * TK * D + c * TK * L::CB, &tk, &full[s],
                      c * L::CB, kvh, t * TK, b);
          tma_load_4d(sV + s * TK * D + c * TK * L::CB, &tv, &full[s],
                      c * L::CB, kvh, t * TK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns q rows [q0 + 64 cw, + 64)
  setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4;
  const int c4 = tid % 4;
  const int wg_first = q0 + cw * 64;
  const int wg_last = min(wg_first + 63, p.Sq - 1);
  const int r0 = wg_first + (tid / 32) * 16 + g;  // q rows r0, r0 + 8
  const float sl2 = p.scale * LOG2E;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const long at = ((long)b * p.H + h) * p.Sq_pad + row;
    lse2[r] = row < p.Sq ? p.lse2[at] : 0.f;
    delta[r] = row < p.Sq ? p.delta[at] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < t_end; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    __syncwarp();
    const int j0 = t * TK;
    const bool skip =
        wg_first > wg_last || (p.causal && j0 > wg_last);
    if (!skip) {
      const bf16* ks = sK + s * TK * D;
      const bf16* vs = sV + s * TK * D;
      float sc[TK / 2], dp[TK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<BQ, D>(sQ, cw * 64, kk),
                 desc_k<TK, D>(ks, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k<BQ, D>(sdO, cw * 64, kk),
                 desc_k<TK, D>(vs, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool cut =
          j0 + TK > p.Sk || (p.causal && j0 + TK - 1 > wg_first);
#pragma unroll
      for (int e = 0; e < TK / 2; ++e) {
        const int r = (e % 4) / 2;
        float pr = exp2f(fmaf(sc[e], sl2, -lse2[r]));
        if (cut) {
          const int col = j0 + 8 * (e / 4) + 2 * c4 + (e % 2);
          if (col >= p.Sk || (p.causal && col > r0 + 8 * r)) pr = 0.f;
        }
        sc[e] = pr * (dp[e] - delta[r]);  // dS
      }
      uint32_t da[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) acc_to_a(sc, kk, da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs(dq, da[kk], desc_mn<TK, D>(ks, kk * 16), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) fence_regs(da[kk]);
    }
    mbar_arrive(&empty[s]);
  }

  const long rs = (long)p.H * D;
  bf16* dq0 = (bf16*)p.dq + ((long)b * p.Sq) * rs + (long)h * D;
  store_rows<D>(dq, r0 < p.Sq ? dq0 + r0 * rs : nullptr,
                r0 + 8 < p.Sq ? dq0 + (r0 + 8) * rs : nullptr, c4, p.scale);
}

}  // namespace tc

// ------------------------------------------------------------- launchers
template <typename T, int D>
int launch_delta(const Params& p, cudaStream_t st) {
  const long rows = (long)p.B * p.Sq * p.H;
  constexpr int warps = NT_DELTA / 32;
  bwd_delta_kernel<T, D>
      <<<(unsigned)((rows + warps - 1) / warps), NT_DELTA, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const Params& p, cudaStream_t st) {
  int err = launch_delta<float, D>(p, st);
  if (err != 0) return err;
  const int smem = (int)fmak::smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fmak::bwd_dkdv_fma_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fmak::bwd_dq_fma_kernel<float, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 kv_grid((p.Sk + fmak::BKV - 1) / fmak::BKV, p.KV, p.B);
  fmak::bwd_dkdv_fma_kernel<float, D><<<kv_grid, fmak::NT, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 q_grid((p.Sq + fmak::BQ - 1) / fmak::BQ, p.H, p.B);
  fmak::bwd_dq_fma_kernel<float, D><<<q_grid, fmak::NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const Params& p, cudaStream_t st) {
  using hopper::encode_bshd;
  CUtensorMap tq64, tdo64, tk128, tv128, tlse, tdelta, tq128, tdo128, tk64,
      tv64;
  const cudaError_t bound = hopper::bind_context(p.q);
  if (bound != cudaSuccess) return (int)bound;
  const int bh = p.B * p.H;
  const int enc[10] = {
      encode_bshd(&tq64, p.q, p.B, p.Sq, p.H, D, tc::TQ),
      encode_bshd(&tdo64, p.dout, p.B, p.Sq, p.H, D, tc::TQ),
      encode_bshd(&tk128, p.k, p.B, p.Sk, p.KV, D, tc::BKV),
      encode_bshd(&tv128, p.v, p.B, p.Sk, p.KV, D, tc::BKV),
      hopper::encode_rows_f32(&tlse, p.lse2, bh, p.Sq_pad, tc::TQ),
      hopper::encode_rows_f32(&tdelta, p.delta, bh, p.Sq_pad, tc::TQ),
      encode_bshd(&tq128, p.q, p.B, p.Sq, p.H, D, tc::BQ),
      encode_bshd(&tdo128, p.dout, p.B, p.Sq, p.H, D, tc::BQ),
      encode_bshd(&tk64, p.k, p.B, p.Sk, p.KV, D, tc::TK),
      encode_bshd(&tv64, p.v, p.B, p.Sk, p.KV, D, tc::TK)};
  for (int i = 0; i < 10; ++i)
    if (enc[i] != 0) return tensor_map_error(i, enc[i]);
  int err = launch_delta<bf16, D>(p, st);
  if (err != 0) return err;
  const int smem_kv = tc::DkdvSmem<D>::BYTES;
  const int smem_q = tc::DqSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      tc::bwd_dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(tc::bwd_dq_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return (int)e;
  const dim3 kv_grid((p.Sk + tc::BKV - 1) / tc::BKV, p.KV, p.B);
  tc::bwd_dkdv_tc_kernel<D><<<kv_grid, tc::NT, smem_kv, st>>>(
      tq64, tdo64, tk128, tv128, tlse, tdelta, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 q_grid((p.Sq + tc::BQ - 1) / tc::BQ, p.H, p.B);
  tc::bwd_dq_tc_kernel<D><<<q_grid, tc::NT, smem_q, st>>>(tq128, tdo128,
                                                          tk64, tv64, p);
  return (int)cudaGetLastError();
}

enum Schedule { FMA = 0, TC = 1 };

template <int D>
int dispatch(const Params& p, int dtype, int schedule, cudaStream_t st) {
  if (schedule == FMA && dtype == 0) return launch_fma<D>(p, st);
  if (schedule == TC && dtype == 1) return launch_tc<D>(p, st);
  return ERR_SCHEDULE;
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k,
// v, o, dout, dq, dk and dv all of it); lse is fp32 [B, H, Sq]; delta and
// lse2 are fp32 scratch [B, H, Sq rounded up to 4] (lse2 only for tc).
// schedule: 0 = fma (fp32 only), 1 = tc (bf16 only), as plan_backward
// chose.  causal: 1 = key j visible to query i iff j <= i, 0 = every key
// visible.  Returns 0, the cudaError_t of the first failing launch, or a
// negative code (flash_attn_bwd_error_string names it).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, float* lse2,
                              void* dq, void* dk, void* dv, int dtype, int B,
                              int Sq, int Sk, int H, int KV, int D,
                              int causal, float scale, int schedule,
                              void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 ||
      (schedule == TC && lse2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k,  v,  o,  dout, lse,    delta, lse2,
                 dq, dk, dv, B, Sq, Sk, H, KV, causal, scale,
                 (Sq + 3) / 4 * 4};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return dispatch<32>(p, dtype, schedule, st);
    case 64: return dispatch<64>(p, dtype, schedule, st);
    case 128: return dispatch<128>(p, dtype, schedule, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return hopper::error_string(err);
}
