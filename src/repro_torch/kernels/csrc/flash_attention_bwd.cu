// K2's backward on Hopper: the gradients of causal attention, with an
// optional sliding window.
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
//      kv head (GQA), from the causal diagonal on, and, with a window W,
//      up to the last q row that sees the block's last key (its row
//      + W - 1).  Per q tile it
//      recomputes P = exp(S * scale - lse) from the forward's log-sum-exp
//      and accumulates, in fp32 registers,
//          dV += P^T dO,   dK += (P * (dO V^T - delta))^T Q * scale;
//   3. dQ: one block per (q tile, head, batch), walking the kv tiles up to
//      the diagonal (with a window W, from the first key its first row
//      sees, that row - W + 1): dQ += (P * (dO V^T - delta)) K * scale.
// Masks: causal with q_offset = 0 over the full kv length, or no mask,
// either with a sliding window (key j visible to query i iff
// j > i - W); ragged Sq and Sk; GQA by index; (D, DV) = (d, d) for d in
// {32, 64, 96, 128, 144, 192}, or MLA's (192, 128): q, k, dq, dk have
// head dim D, v, o, dO, dv head dim DV.
// A tile wholly outside the band is never loaded (the block's tile range
// is cut at both ends) or, for a warp(group) it misses, skipped; a tile
// the band's edge cuts applies the element mask, as the forward does.  So
// the work scales with S * W, not S^2: at S = 8192 and W = 4096 (mixtral)
// about 3/8 of the causal pairs are masked off.
//
// Bound on an H100 SXM at the training shape (B=8, S=1024, H=16, D=128,
// causal): q, k, v, o, dO, dQ, dK, dV once each plus lse and delta,
// 269 MB -> 0.080 ms at 3.35 TB/s; five products of 2 * D flops per
// visible (query, key) pair per head (S recomputed, dP, dV, dK, dQ), 10 * D
// in all, 85.9 GFLOP -> 0.087 ms at 989 TFLOP/s: the operations bound it,
// narrowly.  In fp32 the bytes double (0.160 ms) and the operations bound
// it: 1.283 ms on the FMA pipes (67 TFLOP/s), or 0.521 ms as 3xTF32 on the
// tensor cores (3 x 85.9 GFLOP at 494.7 TFLOP/s), the lesser of the two.
// At phi-3-vision's training shape (B=2, S=4096, H=32, D=96, causal):
// 515.5 GFLOP -> 0.521 ms against 405 MB -> 0.121 ms, the operations.
// At (192, 128) the products are 2 (3 D + 2 DV) flops a visible pair-head
// (S and dK and dQ at D, dP and dV at DV): at deepseek-v2-lite's training
// shape (B=2, S=4096, H=16, causal) 446.8 GFLOP -> 0.452 ms in bf16, 2.709
// ms as 3xTF32.  At nemotron-4-340b's (B=1, S=4096, H=96, KV=8, D=192,
// causal): 1546.6 GFLOP -> 1.564 ms in bf16.
//
// Two schedules, by dtype (plan_backward in kernels/flash_attention.py):
//
// * tc (bf16).  Kernels 2 and 3 run their products on wgmma, with a
//   producer warpgroup whose one thread brings tiles in by TMA through a
//   2-stage ring guarded by mbarriers, and two consumer warpgroups of 64
//   rows each.  dK/dV block: 128 kv rows; K and V stay in shared memory,
//   the ring brings Q, dO, lse and delta per q tile of 64 rows (32 at
//   D = 144 and at (192, 128), for the registers: tq_of; the pair's
//   dK and dQ are n192 products).  At (192, 192) dK and dV (96 fp32 a
//   thread each) do not fit the registers together beside S^T and dP^T,
//   so two launches share the work, as in tf32x3: one accumulates dK, one
//   dV (S^T again), each over 64-row q tiles.  S^T = K Q^T
//   and dP^T = V dO^T take both operands from shared memory (K-major);
//   P^T and dS^T are rounded to bf16 in registers and are the A operands
//   of dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major (the
//   transpose bit).  dQ block: 128 q rows; Q, dO, lse and delta stay, the
//   ring brings K and V per 64-row kv tile; S = Q K^T, dP = dO V^T, then
//   dQ += dS K with K read MN-major.  The element mask runs only on tiles
//   the diagonal or the ragged edge cuts; tiles wholly above the diagonal
//   for a warpgroup are skipped.
// * tf32x3 (fp32).  The same two kernels on the tensor cores through
//   warp-level mma.sync m16n8k8 in split TF32 (tf32.cuh): every product is
//   a_lo b_hi + a_hi b_lo + a_hi b_hi, which holds fp32 accuracy (a
//   single TF32 product would not hold the parity phases' 1e-4).  wgmma
//   takes TF32 operands from shared memory K-major only, so three of the
//   five products would need transposed tiles; mma.sync loads fragments
//   by index, and a transposed read is another index.  256 threads,
//   eight warps of 16 rows each:
//   - dK/dV block: 128 kv rows, K and V in shared memory; a 2-stage
//     cp.async ring (16-byte copies, zeros past Sq) brings 32-row tiles of
//     Q and dO with their lse and delta.  Per tile and warp: S^T = K Q^T,
//     dP^T = V dO^T (16 x 32 each), P^T = exp(S^T scale - lse),
//     dS^T = P^T (dP^T - delta), then dV += P^T dO, dK += dS^T Q, dK and
//     dV (16 x D each) in registers.
//   - dQ block: 128 q rows, Q and dO in shared memory, lse and delta in
//     registers; the ring brings 32-row tiles of K and V up to the
//     diagonal: S = Q K^T, dP = dO V^T, dQ += dS K.
//   P^T, dS^T and dS go from accumulator to A operand in registers (the
//   k order inside a k-step is permuted to match; tf32.cuh).  dK and dV
//   sum over every q row that sees their kv row, up to Sq of them, in the
//   tensor cores' accumulator, which truncates: they add through mma3_rn
//   (tf32.cuh), which truncates them once a k-step instead of three times
//   (over 4096 rows on an H100: 1.7e-5 relative instead of 4.5e-5, for
//   ~4% of the time).  dQ's sum drifts less (1.0e-5 over 4096 kv rows)
//   and keeps mma3.  Tiles are
//   row-major fp32 with rows of D + 4 floats: the reads along D (S, dP)
//   and the reads down the rows (dV, dK, dQ) are both free of bank
//   conflicts (banks 4g + t and 8t + g).
//   At (192, 128) the tiles and a 2-stage ring of 32 rows take over
//   250,000 bytes of shared memory in both kernels, so their stages hold
//   16 rows; and dK and dV (160 fp32 a thread) do not fit the registers
//   beside the rest, so two dK/dV launches share the work, one
//   accumulating dK (S^T, dP^T, dK) and one dV (S^T again, dV): six
//   products where one launch does five, and no spill.  At (192, 192)
//   the resident tiles alone, 128 rows of D + DV = 384 fp32 columns, take
//   200,704 bytes, so no ring fits beside them (251,136 bytes at 16-row
//   stages): the blocks hold 64 resident rows in four warps (100,352
//   bytes) and 32-row stages, and dK and dV take the two launches.
//   What bounds it: not the tensor cores but the latency of each warp's
//   chain of shared loads, splits and products, so the design buys warps:
//   at D = 128 a block takes 203,264 bytes of shared memory and the dK/dV
//   kernel 253 registers a thread (dK and dV alone 128), which leaves room
//   for one block of eight warps an SM; four warps an SM ran measurably
//   slower.  The split runs on the integer pipes (tf32.cuh): cvt.rna is a
//   conversion, at a quarter of their rate on sm_90, and was
//   measurably slower too.  The rest of the cost is the FlashAttention-2 split
//   itself: S and dP are computed in both kernels (seven products where
//   five would do with atomics).  Masks as for tc; no atomics.

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using hopper::bf16;
using hopper::ERR_SCHEDULE;
using hopper::tensor_map_error;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct Params {
  const void* q;     // [B, Sq, H, D]
  const void* k;     // [B, Sk, KV, D]
  const void* v;     // [B, Sk, KV, DV]
  const void* o;     // [B, Sq, H, DV]  the forward's output
  const void* dout;  // [B, Sq, H, DV]
  const float* lse;  // [B, H, Sq]      the forward's log-sum-exp
  float* delta;      // [B, H, Sq_pad]  scratch: rowsum(dO * O)
  float* lse2;       // [B, H, Sq_pad]  scratch: lse * log2(e), or null
  void* dq;          // [B, Sq, H, D]
  void* dk;          // [B, Sk, KV, D]
  void* dv;          // [B, Sk, KV, DV]
  int B, Sq, Sk, H, KV, causal;
  int window;  // 0: none; else key j is visible to query i iff j > i - W
  float scale;
  int Sq_pad;  // the row stride of delta and lse2: Sq rounded up to 4
};

constexpr int NT_DELTA = 128;

// Which gradients a dK/dV launch accumulates: both, or, where they do not
// fit the registers together, one each in two launches: DK_ONLY (S^T,
// dP^T, dK) and DV_ONLY (S^T, dV); the second recomputes S^T, six
// products where one launch does five.
constexpr int DK_ONLY = 1, DV_ONLY = 2, DK_DV = 3;

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] over the DV
// columns of O; one warp per row, rows in [b][i][h] order (the memory
// order of O); lse2 beside it.
template <typename T, int DV>
__global__ void __launch_bounds__(NT_DELTA) bwd_delta_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (NT_DELTA / 32) + (threadIdx.x >> 5);
  if (row >= (long)p.B * p.Sq * p.H) return;  // whole warps leave together
  const T* O = (const T*)p.o + row * DV;
  const T* dO = (const T*)p.dout + row * DV;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc += to_f(O[d]) * to_f(dO[d]);
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

// ---------------------------------------------------------------- tf32x3
namespace x3 {

using namespace tf32;

constexpr int STAGES = 2;
constexpr int SMEM_MAX = 232448;  // an H100 block's shared memory, bytes

// Bytes of a block whose `rows` resident rows (K and V of the dK/dV
// block, Q and dO of the dQ block) sit beside a 2-stage ring of tq (tk)
// rows of the others.
constexpr int dkdv_bytes(int D, int DV, int tq, int rows) {
  return 4 * (rows * (D + DV + 8) + STAGES * (tq * (D + DV + 8) + 2 * tq));
}
constexpr int dq_bytes(int D, int DV, int tk, int rows) {
  return 4 * (rows * (D + DV + 8) + STAGES * tk * (D + DV + 8));
}

// A block is eight warps of 16 rows, 128 resident rows, where those rows
// and a ring of 16-row stages fit its shared memory; else four warps, 64
// rows ((192, 192): 251,136 bytes at 128 rows, 100,352 of resident rows
// at 64).  Four warps an SM ran measurably slower at D = 128, so the
// smaller block is kept for the head dims that need it.
template <int D, int DV>
struct Block {
  static constexpr int WARPS = dkdv_bytes(D, DV, 16, 128) <= SMEM_MAX &&
                                       dq_bytes(D, DV, 16, 128) <= SMEM_MAX
                                   ? 8
                                   : 4;
  static constexpr int NT = 32 * WARPS;
  static constexpr int ROWS = 16 * WARPS;  // kv rows (dK/dV), q rows (dQ)
};

// Rows of q (dK/dV block) or kv (dQ block) a ring stage holds: 32 where
// the block's tiles and a 2-stage ring fit its shared memory, else 16
// ((192, 128): 252,416 and 251,904 bytes at 32).
template <int D, int DV>
struct DkdvSmem {
  static constexpr int ROWS = Block<D, DV>::ROWS;
  static constexpr int S = D + 4;    // row stride of K and Q, floats
  static constexpr int SV = DV + 4;  // row stride of V and dO
  static constexpr int TQ =
      dkdv_bytes(D, DV, 32, ROWS) <= SMEM_MAX ? 32 : 16;
  // a stage: Q, dO, lse, delta
  static constexpr int STAGE = TQ * (S + SV) + 2 * TQ;
  static constexpr int BYTES = dkdv_bytes(D, DV, TQ, ROWS);
  static_assert(BYTES <= SMEM_MAX, "the dK/dV block exceeds shared memory");
};

template <int D, int DV>
struct DqSmem {
  static constexpr int ROWS = Block<D, DV>::ROWS;
  static constexpr int S = D + 4;
  static constexpr int SV = DV + 4;
  static constexpr int TK = dq_bytes(D, DV, 32, ROWS) <= SMEM_MAX ? 32 : 16;
  static constexpr int STAGE = TK * (S + SV);  // K, V
  static constexpr int BYTES = dq_bytes(D, DV, TK, ROWS);
  static_assert(BYTES <= SMEM_MAX, "the dQ block exceeds shared memory");
};

// dK and dV (D / 2 and DV / 2 fp32 a thread) in one launch up to D = DV =
// 144; past that ((192, 128): 160, (192, 192): 192) they do not fit the
// registers beside the rest, and two launches share the work (DK_ONLY,
// DV_ONLY).
template <int D, int DV>
constexpr bool split_dkdv() { return D + DV > 288; }

// dK and/or dV (PART) for BKV kv rows of one (kv head, batch).  Warp w
// owns kv rows kw = k0 + 16 w .. kw + 15; its dK (16 x D) and dV (16 x DV)
// stay in registers as accumulators of 16 x 8.
template <int D, int DV, int PART>
__global__ void __launch_bounds__(Block<D, DV>::NT, 1)
    bwd_dkdv_tf32_kernel(const Params p) {
  using L = DkdvSmem<D, DV>;
  constexpr int NT = Block<D, DV>::NT;
  constexpr int BKV = L::ROWS;
  constexpr int S = L::S;
  constexpr int SV = L::SV;
  constexpr int TQ = L::TQ;
  constexpr bool DK = PART & DK_ONLY, DVP = PART & DV_ONLY;
  extern __shared__ float4 smem4[];
  float* sK = (float*)smem4;
  float* sV = sK + BKV * S;
  float* ring = sV + BKV * SV;

  const int k0 = blockIdx.x * BKV;  // the heaviest causal blocks come first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int nq = (p.Sq + TQ - 1) / TQ;
  const int q_begin = p.causal ? min(k0 / TQ, nq) : 0;
  // the last q row that sees the block's last key: key + W - 1
  const int q_end =
      p.window > 0 ? max(q_begin, min(nq, (k0 + BKV - 1 + p.window + TQ - 1)
                                              / TQ))
                   : nq;
  const int per_head = q_end - q_begin;
  const int n_tiles = G * per_head;  // (query head, q tile) pairs
  const long q_rs = (long)p.H * D;
  const long do_rs = (long)p.H * DV;
  const long kv_rs = (long)p.KV * D;
  const long v_rs = (long)p.KV * DV;
  const long kv_off = (long)b * p.Sk * kv_rs + (long)kvh * D;
  const long v_off = (long)b * p.Sk * v_rs + (long)kvh * DV;

  // tile i (query head kvh G + i / per_head, rows q0..) into stage i % 2;
  // a group is committed even when there is no tile, so that wait<1>
  // always means "tile i has landed"
  auto prefetch = [&](int i) {
    if (i < n_tiles) {
      const int h = kvh * G + i / per_head;
      const int q0 = (q_begin + i % per_head) * TQ;
      float* st = ring + (i % STAGES) * L::STAGE;
      const long q_off = (long)b * p.Sq * q_rs + (long)h * D;
      const long do_off = (long)b * p.Sq * do_rs + (long)h * DV;
      load_rows<D, TQ, NT>(st, (const float*)p.q + q_off, q_rs, q0, p.Sq);
      load_rows<DV, TQ, NT>(st + TQ * S, (const float*)p.dout + do_off,
                            do_rs, q0, p.Sq);
      if (threadIdx.x < TQ) {
        const int s = q0 + threadIdx.x;
        const bool ok = s < p.Sq;
        const long bh = (long)b * p.H + h;
        float* sl = st + TQ * (S + SV);
        cp_async4(sl + threadIdx.x, p.lse + bh * p.Sq + (ok ? s : 0), ok);
        cp_async4(sl + TQ + threadIdx.x,
                  p.delta + bh * p.Sq_pad + (ok ? s : 0), ok);
      }
    }
    cp_async_commit();
  };

  load_rows<D, BKV, NT>(sK, (const float*)p.k + kv_off, kv_rs, k0, p.Sk);
  if constexpr (DK)  // dV alone needs no V: dP^T feeds dK only
    load_rows<DV, BKV, NT>(sV, (const float*)p.v + v_off, v_rs, k0, p.Sk);
  prefetch(0);  // the first group holds K, V and tile 0
  prefetch(1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + 16 * warp;
  const float* wK = sK + 16 * warp * S;
  const float* wV = sV + 16 * warp * SV;

  // a part's unused accumulator shrinks to one fragment nothing touches
  float dk[DK ? D / 8 : 1][4], dv[DVP ? DV / 8 : 1][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int j = 0; j < (DK ? D / 8 : 1); ++j) dk[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < (DVP ? DV / 8 : 1); ++j) dv[j][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (q_begin + i % per_head) * TQ;
    const float* sQ = ring + (i % STAGES) * L::STAGE;
    const float* sdO = sQ + TQ * S;
    const float* sLse = sdO + TQ * SV;
    const float* sDelta = sLse + TQ;
    // every q row of the tile before every kv row of this warp, or past
    // the window of every one: P = 0
    const bool skip = kw >= p.Sk || (p.causal && q0 + TQ - 1 < kw) ||
                      (p.window > 0 && q0 >= kw + 15 + p.window);
    if (!skip) {
      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x TQ q columns
      float sc[TQ / 8][4], dp[TQ / 8][4];
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      if constexpr (D == DV && DK) {  // one pass over D for both
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const FragA ka = load_a<S>(wK, 0, 8 * kk);
          const FragA va = load_a<SV>(wV, 0, 8 * kk);
#pragma unroll
          for (int j = 0; j < TQ / 8; ++j) {
            mma3(sc[j], ka, load_b_nk<S>(sQ, 8 * j, 8 * kk));
            mma3(dp[j], va, load_b_nk<SV>(sdO, 8 * j, 8 * kk));
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const FragA ka = load_a<S>(wK, 0, 8 * kk);
#pragma unroll
          for (int j = 0; j < TQ / 8; ++j)
            mma3(sc[j], ka, load_b_nk<S>(sQ, 8 * j, 8 * kk));
        }
        if constexpr (DK) {
#pragma unroll
          for (int kk = 0; kk < DV / 8; ++kk) {
            const FragA va = load_a<SV>(wV, 0, 8 * kk);
#pragma unroll
            for (int j = 0; j < TQ / 8; ++j)
              mma3(dp[j], va, load_b_nk<SV>(sdO, 8 * j, 8 * kk));
          }
        }
      }
      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta); the element
      // mask only where the diagonal or the ragged edge cuts the tile
      // (rows past Sq read zeros for Q, lse and delta: masked here)
      const bool cut = q0 + TQ > p.Sq || (p.causal && q0 < kw + 15) ||
                       (p.window > 0 && q0 + TQ - 1 >= kw + p.window);
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1);
          const int kv = kw + g + 8 * (e >> 1);
          const float pr = expf(fmaf(sc[j][e], p.scale, -sLse[ql]));
          const bool off =
              cut && (q0 + ql >= p.Sq || (p.causal && kv > q0 + ql) ||
                      (p.window > 0 && q0 + ql - kv >= p.window));
          sc[j][e] = off ? 0.f : pr;
          dp[j][e] = off ? 0.f : pr * (dp[j][e] - sDelta[ql]);
        }
      // dV += P^T dO, dK += dS^T Q: the q rows are the reduction
#pragma unroll
      for (int kk = 0; kk < TQ / 8; ++kk) {
        if constexpr (D == DV && PART == DK_DV) {
          const FragA pa = acc_to_a(sc[kk]);
          const FragA da = acc_to_a(dp[kk]);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            mma3_rn(dv[j], pa, load_b_kn<SV>(sdO, 8 * kk, 8 * j));
            mma3_rn(dk[j], da, load_b_kn<S>(sQ, 8 * kk, 8 * j));
          }
        } else {
          if constexpr (DVP) {
            const FragA pa = acc_to_a(sc[kk]);
#pragma unroll
            for (int j = 0; j < DV / 8; ++j)
              mma3_rn(dv[j], pa, load_b_kn<SV>(sdO, 8 * kk, 8 * j));
          }
          if constexpr (DK) {
            const FragA da = acc_to_a(dp[kk]);
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              mma3_rn(dk[j], da, load_b_kn<S>(sQ, 8 * kk, 8 * j));
          }
        }
      }
    }
    __syncthreads();  // stage i % 2 is consumed by every warp
    prefetch(i + 2);
  }
  cp_async_wait<0>();  // a block with no tile still has K and V in flight

  // accumulator element (j, e): kv row kw + g + 8 (e / 2), column
  // 8 j + 2 t + (e % 2)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kw + g + 8 * r;
    if (row >= p.Sk) continue;
    if constexpr (DK) {
      float* dkrow = (float*)p.dk + kv_off + (long)row * kv_rs + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *(float2*)(dkrow + 8 * j) =
            make_float2(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
    }
    if constexpr (DVP) {
      float* dvrow = (float*)p.dv + v_off + (long)row * v_rs + 2 * t;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *(float2*)(dvrow + 8 * j) =
            make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// dQ for BQ q rows of one (head, batch).  Warp w owns q rows
// qw = q0 + 16 w .. qw + 15; Q and dO stay in shared memory, the ring
// brings K and V, TK rows a stage, up to the diagonal.
template <int D, int DV>
__global__ void __launch_bounds__(Block<D, DV>::NT, 1)
    bwd_dq_tf32_kernel(const Params p) {
  using L = DqSmem<D, DV>;
  constexpr int NT = Block<D, DV>::NT;
  constexpr int BQ = L::ROWS;
  constexpr int S = L::S;
  constexpr int SV = L::SV;
  constexpr int TK = L::TK;
  extern __shared__ float4 smem4[];
  float* sQ = (float*)smem4;
  float* sdO = sQ + BQ * S;
  float* ring = sdO + BQ * SV;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  const int j_end = p.causal ? min(p.Sk, last_row + 1) : p.Sk;
  const int t_end = (j_end + TK - 1) / TK;
  // the first key the block's first row sees: row - W + 1
  const int t_begin = p.window > 0 ? max(0, q0 - p.window + 1) / TK : 0;
  const int n_tiles = max(0, t_end - t_begin);
  const long q_rs = (long)p.H * D;
  const long do_rs = (long)p.H * DV;
  const long kv_rs = (long)p.KV * D;
  const long v_rs = (long)p.KV * DV;
  const long q_off = (long)b * p.Sq * q_rs + (long)h * D;
  const long do_off = (long)b * p.Sq * do_rs + (long)h * DV;
  const long kv_off = (long)b * p.Sk * kv_rs + (long)kvh * D;
  const long v_off = (long)b * p.Sk * v_rs + (long)kvh * DV;

  // kv tile t_begin + i into stage i % 2
  auto prefetch = [&](int i) {
    if (i < n_tiles) {
      float* st = ring + (i % STAGES) * L::STAGE;
      const int j0 = (t_begin + i) * TK;
      load_rows<D, TK, NT>(st, (const float*)p.k + kv_off, kv_rs, j0, p.Sk);
      load_rows<DV, TK, NT>(st + TK * S, (const float*)p.v + v_off, v_rs,
                            j0, p.Sk);
    }
    cp_async_commit();
  };

  load_rows<D, BQ, NT>(sQ, (const float*)p.q + q_off, q_rs, q0, p.Sq);
  load_rows<DV, BQ, NT>(sdO, (const float*)p.dout + do_off, do_rs, q0,
                        p.Sq);
  prefetch(0);  // the first group holds Q, dO and kv tile 0
  prefetch(1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + 16 * warp;
  const int w_last = min(qw + 15, p.Sq - 1);
  const float* wQ = sQ + 16 * warp * S;
  const float* wdO = sdO + 16 * warp * SV;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const long bh = (long)b * p.H + h;
    lse[r] = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.f;
    delta[r] = row < p.Sq ? p.delta[bh * p.Sq_pad + row] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const int j0 = (t_begin + i) * TK;
    const float* sK = ring + (i % STAGES) * L::STAGE;
    const float* sV = sK + TK * S;
    // every key of the tile past the diagonal, or before the window, of
    // every row of this warp
    const bool skip = qw > w_last || (p.causal && j0 > w_last) ||
                      (p.window > 0 && j0 + TK - 1 <= qw - p.window);
    if (!skip) {
      // S = Q K^T and dP = dO V^T: 16 q rows x TK kv columns
      float sc[TK / 8][4], dp[TK / 8][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      if constexpr (D == DV) {  // one pass over D for both
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const FragA qa = load_a<S>(wQ, 0, 8 * kk);
          const FragA oa = load_a<SV>(wdO, 0, 8 * kk);
#pragma unroll
          for (int j = 0; j < TK / 8; ++j) {
            mma3(sc[j], qa, load_b_nk<S>(sK, 8 * j, 8 * kk));
            mma3(dp[j], oa, load_b_nk<SV>(sV, 8 * j, 8 * kk));
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const FragA qa = load_a<S>(wQ, 0, 8 * kk);
#pragma unroll
          for (int j = 0; j < TK / 8; ++j)
            mma3(sc[j], qa, load_b_nk<S>(sK, 8 * j, 8 * kk));
        }
#pragma unroll
        for (int kk = 0; kk < DV / 8; ++kk) {
          const FragA oa = load_a<SV>(wdO, 0, 8 * kk);
#pragma unroll
          for (int j = 0; j < TK / 8; ++j)
            mma3(dp[j], oa, load_b_nk<SV>(sV, 8 * j, 8 * kk));
        }
      }
      const bool cut = j0 + TK > p.Sk || (p.causal && j0 + TK - 1 > qw) ||
                       (p.window > 0 && j0 <= w_last - p.window);
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = j0 + 8 * j + 2 * t + (e & 1);
          const int row = qw + g + 8 * r;
          const bool off =
              cut && (col >= p.Sk || (p.causal && col > row) ||
                      (p.window > 0 && row - col >= p.window));
          const float pr = expf(fmaf(sc[j][e], p.scale, -lse[r]));
          sc[j][e] = off ? 0.f : pr * (dp[j][e] - delta[r]);  // dS
        }
      // dQ += dS K: the kv rows are the reduction
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        const FragA da = acc_to_a(sc[kk]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          mma3(dq[j], da, load_b_kn<S>(sK, 8 * kk, 8 * j));
      }
    }
    __syncthreads();
    prefetch(i + 2);
  }
  cp_async_wait<0>();  // a block with no tile still has Q and dO in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    if (row >= p.Sq) continue;
    float* dqrow = (float*)p.dq + q_off + (long)row * q_rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *(float2*)(dqrow + 8 * j) =
          make_float2(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
  }
}

}  // namespace x3

// -------------------------------------------------------------------- tc
namespace tc {

constexpr int BKV = 128;  // dK/dV block: kv rows (two consumer warpgroups)
constexpr int BQ = 128;   // dQ block: q rows (two consumer warpgroups)
constexpr int TK = 64;    // kv rows per ring stage of the dQ block

// q rows per ring stage of the dK/dV block accumulating PART.  A consumer
// thread holds dK (D / 2 fp32) and dV (DV / 2) beside S^T and dP^T (TQ / 2
// each), then their bf16 A fragments (TQ / 4 each), under the 232
// registers setmaxnreg gives it.  The accumulators at their peak are kept
// to the 192 of D = DV = 128 at 64 rows, which fits: 64 rows up to
// D = 128 (at D = 96, 96 + 64 = 160), 32 rows at D = 144 (144 + 32; 64
// rows would need 208 and spilled) and at (192, 128) (160 + 32).
template <int D, int DV, int PART>
constexpr int tq_of() {
  return (PART & DK_ONLY ? D / 2 : 0) + (PART & DV_ONLY ? DV / 2 : 0) + 64 <=
                 192
             ? 64
             : 32;
}

// dK and dV in one launch while they fit those 192 at 32 rows; past that
// ((192, 192): 192 + 32) in two, DK_ONLY and DV_ONLY, each at 64 rows
// (96 + 64).
template <int D, int DV>
constexpr bool split_dkdv() { return (D + DV) / 2 + 32 > 192; }
constexpr int STAGES = 2;
constexpr int NT = 384;   // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;

constexpr int align1024(int n) { return (n + 1023) / 1024 * 1024; }

// Q, K (and dQ, dK) rows are D wide, V and dO (and dV) rows DV; every
// tile starts on a 1024-byte boundary, which 32 or more rows of a
// multiple of 16 columns keep.
template <int D, int DV, int PART>
struct DkdvSmem {
  static constexpr int TQ = tq_of<D, DV, PART>();
  static constexpr int K = BKV * D * 2;    // bytes of the K tile
  static constexpr int V = BKV * DV * 2;   // bytes of the V tile
  static constexpr int QT = TQ * D * 2;    // bytes of a Q tile
  static constexpr int DOT = TQ * DV * 2;  // bytes of a dO tile
  // a stage: Q, dO, then lse and delta (TQ fp32 each)
  static constexpr int STAGE = align1024(QT + DOT + 2 * TQ * 4);
  static constexpr int BARS = K + V + STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D, int DV>
struct DqSmem {
  static constexpr int QT = BQ * D * 2;    // bytes of the Q tile
  static constexpr int DOT = BQ * DV * 2;  // bytes of the dO tile
  static constexpr int KT = TK * D * 2;    // bytes of a K tile
  static constexpr int VT = TK * DV * 2;   // bytes of a V tile
  static constexpr int BARS = QT + DOT + STAGES * (KT + VT);
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
// of a [B, S, heads, D] tensor (row0, row8: each row's first element, or
// null past S).
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

// dK and/or dV (PART) for BKV kv rows of one (kv head, batch).
template <int D, int DV, int PART>
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
  using LV = Tile<DV>;
  using S = DkdvSmem<D, DV, PART>;
  constexpr int TQ = S::TQ;
  constexpr bool DK = PART & DK_ONLY, DVP = PART & DV_ONLY;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  bf16* sK = (bf16*)base;
  bf16* sV = (bf16*)(base + S::K);
  uint8_t* stages = base + S::K + S::V;
  uint64_t* kv_full = (uint64_t*)(base + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BKV;  // the heaviest causal blocks come first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int nq = (p.Sq + TQ - 1) / TQ;
  const int q_begin = p.causal ? min(k0 / TQ, nq) : 0;
  // the last q row that sees the block's last key: key + W - 1
  const int q_end =
      p.window > 0 ? max(q_begin, min(nq, (k0 + BKV - 1 + p.window + TQ - 1)
                                              / TQ))
                   : nq;
  const int per_head = q_end - q_begin;
  const int n_tiles = G * per_head;  // (query head, q tile) pairs

  init_barriers(kv_full, full, empty);
  const int wg = hopper::warpgroup_index();
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, S::K + S::V);
      for (int c = 0; c < L::NB; ++c)
        tma_load_4d(sK + c * BKV * L::CB, &tk, kv_full, c * L::CB, kvh, k0,
                    b);
      for (int c = 0; c < LV::NB; ++c)
        tma_load_4d(sV + c * BKV * LV::CB, &tv, kv_full, c * LV::CB, kvh,
                    k0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int h = kvh * G + i / per_head;
        const int q0 = (q_begin + i % per_head) * TQ;
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], S::QT + S::DOT + 2 * TQ * 4);
        uint8_t* st = stages + s * S::STAGE;
        for (int c = 0; c < L::NB; ++c)
          tma_load_4d(st + c * TQ * L::SWB, &tq, &full[s], c * L::CB, h, q0,
                      b);
        for (int c = 0; c < LV::NB; ++c)
          tma_load_4d(st + S::QT + c * TQ * LV::SWB, &tdo, &full[s],
                      c * LV::CB, h, q0, b);
        tma_load_2d(st + S::QT + S::DOT, &tlse, &full[s], q0, b * p.H + h);
        tma_load_2d(st + S::QT + S::DOT + TQ * 4, &tdelta, &full[s], q0,
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

  // a part's unused accumulator shrinks to one element nothing touches
  float dk[DK ? D / 2 : 1], dv[DVP ? DV / 2 : 1];
#pragma unroll
  for (int e = 0; e < (DK ? D / 2 : 1); ++e) dk[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (DVP ? DV / 2 : 1); ++e) dv[e] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = (q_begin + i % per_head) * TQ;
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    __syncwarp();
    const uint8_t* st = stages + s * S::STAGE;
    const bf16* sQ = (const bf16*)st;
    const bf16* sdO = (const bf16*)(st + S::QT);
    // lse * log2(e)
    const float* sLse = (const float*)(st + S::QT + S::DOT);
    const float* sDelta = sLse + TQ;
    // every q row of the tile before every kv row of this warpgroup, or
    // past the window of every one: P = 0
    const bool skip = wg_first >= p.Sk ||
                      (p.causal && q0 + TQ - 1 < wg_first) ||
                      (p.window > 0 && q0 >= wg_first + 63 + p.window);
    if (!skip) {
      float sc[TQ / 2], dp[DK ? TQ / 2 : 1];  // dP^T feeds dK only
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<BKV, D>(sK, cw * 64, kk),
                 desc_k<TQ, D>(sQ, 0, kk), kk > 0);
      if constexpr (DK) {
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          wgmma_ss(dp, desc_k<BKV, DV>(sV, cw * 64, kk),
                   desc_k<TQ, DV>(sdO, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if constexpr (DK) fence_regs(dp);
      const bool cut = q0 + TQ > p.Sq || (p.causal && q0 < wg_first + 63) ||
                       (p.window > 0 && q0 + TQ - 1 >= wg_first + p.window);
#pragma unroll
      for (int e = 0; e < TQ / 2; ++e) {
        const int ql = 8 * (e / 4) + 2 * c4 + (e % 2);
        float pr = exp2f(fmaf(sc[e], sl2, -sLse[ql]));
        float ds = 0.f;
        if constexpr (DK) ds = pr * (dp[e] - sDelta[ql]);
        if (cut) {
          // the scratch rows past Sq hold no lse or delta: mask both
          const int q = q0 + ql;
          const int kv = kr0 + 8 * ((e % 4) / 2);
          if (q >= p.Sq || (p.causal && kv > q) ||
              (p.window > 0 && q - kv >= p.window))
            pr = ds = 0.f;
        }
        sc[e] = pr;                    // P^T
        if constexpr (DK) dp[e] = ds;  // dS^T
      }
      uint32_t pa[DVP ? TQ / 16 : 1][4], da[DK ? TQ / 16 : 1][4];
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        if constexpr (DVP) acc_to_a(sc, kk, pa[kk]);
        if constexpr (DK) acc_to_a(dp, kk, da[kk]);
      }
      wgmma_fence();
      if constexpr (DVP) {
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
          wgmma_rs(dv, pa[kk], desc_mn<TQ, DV>(sdO, kk * 16), 1);
      }
      if constexpr (DK) {
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
          wgmma_rs(dk, da[kk], desc_mn<TQ, D>(sQ, kk * 16), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < (DVP ? TQ / 16 : 1); ++kk) fence_regs(pa[kk]);
#pragma unroll
      for (int kk = 0; kk < (DK ? TQ / 16 : 1); ++kk) fence_regs(da[kk]);
    }
    mbar_arrive(&empty[s]);
  }

  const long rs = (long)p.KV * D, vrs = (long)p.KV * DV;
  bf16* dk0 = (bf16*)p.dk + ((long)b * p.Sk) * rs + (long)kvh * D;
  bf16* dv0 = (bf16*)p.dv + ((long)b * p.Sk) * vrs + (long)kvh * DV;
  const bool in0 = kr0 < p.Sk, in8 = kr0 + 8 < p.Sk;
  if constexpr (DK)
    store_rows<D>(dk, in0 ? dk0 + kr0 * rs : nullptr,
                  in8 ? dk0 + (kr0 + 8) * rs : nullptr, c4, p.scale);
  if constexpr (DVP)
    store_rows<DV>(dv, in0 ? dv0 + kr0 * vrs : nullptr,
                   in8 ? dv0 + (kr0 + 8) * vrs : nullptr, c4, 1.f);
}

// dQ for BQ q rows of one (head, batch).
template <int D, int DV>
__global__ void __launch_bounds__(NT, 1)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const Params p) {
  using namespace hopper;
  using L = Tile<D>;
  using LV = Tile<DV>;
  using S = DqSmem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  bf16* sQ = (bf16*)base;
  bf16* sdO = (bf16*)(base + S::QT);
  bf16* sK = (bf16*)(base + S::QT + S::DOT);  // [STAGES][TK x D]
  // [STAGES][TK x DV]
  bf16* sV = (bf16*)(base + S::QT + S::DOT + STAGES * S::KT);
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
  // the first key the block's first row sees: row - W + 1
  const int t_begin = p.window > 0 ? max(0, q0 - p.window + 1) / TK : 0;
  const int n_tiles = max(0, t_end - t_begin);

  init_barriers(q_full, full, empty);
  const int wg = hopper::warpgroup_index();
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, S::QT + S::DOT);
      for (int c = 0; c < L::NB; ++c)
        tma_load_4d(sQ + c * BQ * L::CB, &tq, q_full, c * L::CB, h, q0, b);
      for (int c = 0; c < LV::NB; ++c)
        tma_load_4d(sdO + c * BQ * LV::CB, &tdo, q_full, c * LV::CB, h, q0,
                    b);
      for (int i = 0; i < n_tiles; ++i) {  // kv tile t_begin + i
        const int s = i % STAGES;
        const int j0 = (t_begin + i) * TK;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], S::KT + S::VT);
        for (int c = 0; c < L::NB; ++c)
          tma_load_4d(sK + s * TK * D + c * TK * L::CB, &tk, &full[s],
                      c * L::CB, kvh, j0, b);
        for (int c = 0; c < LV::NB; ++c)
          tma_load_4d(sV + s * TK * DV + c * TK * LV::CB, &tv, &full[s],
                      c * LV::CB, kvh, j0, b);
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
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    __syncwarp();
    const int j0 = (t_begin + i) * TK;
    // every key of the tile past the diagonal, or before the window, of
    // every row of this warpgroup
    const bool skip = wg_first > wg_last || (p.causal && j0 > wg_last) ||
                      (p.window > 0 && j0 + TK - 1 <= wg_first - p.window);
    if (!skip) {
      const bf16* ks = sK + s * TK * D;
      const bf16* vs = sV + s * TK * DV;
      float sc[TK / 2], dp[TK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k<BQ, D>(sQ, cw * 64, kk),
                 desc_k<TK, D>(ks, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss(dp, desc_k<BQ, DV>(sdO, cw * 64, kk),
                 desc_k<TK, DV>(vs, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool cut = j0 + TK > p.Sk ||
                       (p.causal && j0 + TK - 1 > wg_first) ||
                       (p.window > 0 && j0 <= wg_last - p.window);
#pragma unroll
      for (int e = 0; e < TK / 2; ++e) {
        const int r = (e % 4) / 2;
        float pr = exp2f(fmaf(sc[e], sl2, -lse2[r]));
        if (cut) {
          const int col = j0 + 8 * (e / 4) + 2 * c4 + (e % 2);
          const int row = r0 + 8 * r;
          if (col >= p.Sk || (p.causal && col > row) ||
              (p.window > 0 && row - col >= p.window))
            pr = 0.f;
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
template <typename T, int DV>
int launch_delta(const Params& p, cudaStream_t st) {
  const long rows = (long)p.B * p.Sq * p.H;
  constexpr int warps = NT_DELTA / 32;
  bwd_delta_kernel<T, DV>
      <<<(unsigned)((rows + warps - 1) / warps), NT_DELTA, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int DV, int PART>
int launch_dkdv_tf32x3(const Params& p, cudaStream_t st) {
  const int smem = x3::DkdvSmem<D, DV>::BYTES;
  const auto kernel = x3::bwd_dkdv_tf32_kernel<D, DV, PART>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  using B = x3::Block<D, DV>;
  const dim3 kv_grid((p.Sk + B::ROWS - 1) / B::ROWS, p.KV, p.B);
  kernel<<<kv_grid, B::NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_tf32x3(const Params& p, cudaStream_t st) {
  int err = launch_delta<float, DV>(p, st);
  if (err != 0) return err;
  if constexpr (!x3::split_dkdv<D, DV>()) {
    err = launch_dkdv_tf32x3<D, DV, DK_DV>(p, st);
  } else {  // dK and dV in two launches, for the registers
    err = launch_dkdv_tf32x3<D, DV, DK_ONLY>(p, st);
    if (err != 0) return err;
    err = launch_dkdv_tf32x3<D, DV, DV_ONLY>(p, st);
  }
  if (err != 0) return err;
  const int smem_q = x3::DqSmem<D, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      x3::bwd_dq_tf32_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  using B = x3::Block<D, DV>;
  const dim3 q_grid((p.Sq + B::ROWS - 1) / B::ROWS, p.H, p.B);
  x3::bwd_dq_tf32_kernel<D, DV><<<q_grid, B::NT, smem_q, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int DV, int PART>
int launch_dkdv_tc(const CUtensorMap& tq, const CUtensorMap& tdo,
                   const CUtensorMap& tk, const CUtensorMap& tv,
                   const CUtensorMap& tlse, const CUtensorMap& tdelta,
                   const Params& p, cudaStream_t st) {
  const int smem = tc::DkdvSmem<D, DV, PART>::BYTES;
  const auto kernel = tc::bwd_dkdv_tc_kernel<D, DV, PART>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 kv_grid((p.Sk + tc::BKV - 1) / tc::BKV, p.KV, p.B);
  kernel<<<kv_grid, tc::NT, smem, st>>>(tq, tdo, tk, tv, tlse, tdelta, p);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_tc(const Params& p, cudaStream_t st) {
  using hopper::encode_bshd;
  CUtensorMap tq64, tdo64, tk128, tv128, tlse, tdelta, tq128, tdo128, tk64,
      tv64;
  const cudaError_t bound = hopper::bind_context(p.q);
  if (bound != cudaSuccess) return (int)bound;
  const int bh = p.B * p.H;
  constexpr bool SPLIT = tc::split_dkdv<D, DV>();
  constexpr int TQ = tc::tq_of<D, DV, SPLIT ? DK_ONLY : DK_DV>();
  static_assert(!SPLIT || TQ == tc::tq_of<D, DV, DV_ONLY>(),
                "the two dK/dV launches share their q-tile tensor maps");
  const int enc[10] = {
      encode_bshd(&tq64, p.q, p.B, p.Sq, p.H, D, TQ),
      encode_bshd(&tdo64, p.dout, p.B, p.Sq, p.H, DV, TQ),
      encode_bshd(&tk128, p.k, p.B, p.Sk, p.KV, D, tc::BKV),
      encode_bshd(&tv128, p.v, p.B, p.Sk, p.KV, DV, tc::BKV),
      hopper::encode_rows_f32(&tlse, p.lse2, bh, p.Sq_pad, TQ),
      hopper::encode_rows_f32(&tdelta, p.delta, bh, p.Sq_pad, TQ),
      encode_bshd(&tq128, p.q, p.B, p.Sq, p.H, D, tc::BQ),
      encode_bshd(&tdo128, p.dout, p.B, p.Sq, p.H, DV, tc::BQ),
      encode_bshd(&tk64, p.k, p.B, p.Sk, p.KV, D, tc::TK),
      encode_bshd(&tv64, p.v, p.B, p.Sk, p.KV, DV, tc::TK)};
  for (int i = 0; i < 10; ++i)
    if (enc[i] != 0) return tensor_map_error(i, enc[i]);
  int err = launch_delta<bf16, DV>(p, st);
  if (err != 0) return err;
  if constexpr (!SPLIT) {
    err = launch_dkdv_tc<D, DV, DK_DV>(tq64, tdo64, tk128, tv128, tlse,
                                       tdelta, p, st);
  } else {  // dK and dV in two launches, for the registers
    err = launch_dkdv_tc<D, DV, DK_ONLY>(tq64, tdo64, tk128, tv128, tlse,
                                         tdelta, p, st);
    if (err != 0) return err;
    err = launch_dkdv_tc<D, DV, DV_ONLY>(tq64, tdo64, tk128, tv128, tlse,
                                         tdelta, p, st);
  }
  if (err != 0) return err;
  const int smem_q = tc::DqSmem<D, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      tc::bwd_dq_tc_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  const dim3 q_grid((p.Sq + tc::BQ - 1) / tc::BQ, p.H, p.B);
  tc::bwd_dq_tc_kernel<D, DV><<<q_grid, tc::NT, smem_q, st>>>(
      tq128, tdo128, tk64, tv64, p);
  return (int)cudaGetLastError();
}

enum Schedule { TC = 1, TF32X3 = 3 };

template <int D, int DV>
int dispatch(const Params& p, int dtype, int schedule, cudaStream_t st) {
  if (schedule == TF32X3 && dtype == 0) return launch_tf32x3<D, DV>(p, st);
  if (schedule == TC && dtype == 1) return launch_tc<D, DV>(p, st);
  return ERR_SCHEDULE;
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k,
// v, o, dout, dq, dk and dv all of it); q, k, dq and dk have head dim D,
// v, o, dout and dv DV: (D, DV) is (d, d) for d in {32, 64, 96, 128,
// 144, 192}, or (192, 128) (MLA); lse is fp32 [B, H, Sq]; delta and
// lse2 are fp32 scratch [B, H, Sq rounded up to 4] (lse2 only for tc).
// schedule: 1 = tc (bf16 only), 3 = tf32x3 (fp32 only), as plan_backward
// chose.  causal: 1 = key j visible to query i iff j <= i, 0 = every key
// visible; window: 0 = none, W > 0 = key j also needs j > i - W.  Returns
// 0, the cudaError_t of the first failing launch, or a negative code
// (flash_attn_bwd_error_string names it).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, float* lse2,
                              void* dq, void* dk, void* dv, int dtype, int B,
                              int Sq, int Sk, int H, int KV, int D, int DV,
                              int causal, int window, float scale,
                              int schedule, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || window < 0 ||
      (schedule == TC && lse2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{q,  k,  v,  o,  dout, lse,    delta,  lse2,  dq,
                 dk, dv, B,  Sq, Sk,   H,      KV,     causal, window,
                 scale, (Sq + 3) / 4 * 4};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 192 && DV == 128) return dispatch<192, 128>(p, dtype, schedule, st);
  if (D != DV) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return dispatch<32, 32>(p, dtype, schedule, st);
    case 64: return dispatch<64, 64>(p, dtype, schedule, st);
    case 96: return dispatch<96, 96>(p, dtype, schedule, st);
    case 128: return dispatch<128, 128>(p, dtype, schedule, st);
    case 144: return dispatch<144, 144>(p, dtype, schedule, st);
    case 192: return dispatch<192, 192>(p, dtype, schedule, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return hopper::error_string(err);
}
