// K2 on Hopper: causal online-softmax attention forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_kernel (pallas_call at :92, body _flash_kernel at :29).
// Same function: a q tile keeps fp32 running (acc, m, l) and streams kv
// tiles through fast memory, skipping tiles that lie wholly outside the
// masks, so no [Sq, Sk] score matrix ever reaches HBM.  What it adds over
// the TPU kernel: GQA by index (kv_head = h / (H / KV)); the q_offset form
// of causality (query i sits at position q_offset + i), a kv_len bound
// and an optional sliding window, so prefill and decode share one entry;
// ragged Sq and Sk; [B, S, H, D] strides read in place; an optional fp32
// log-sum-exp output lse[B, H, Sq] = m + log(l) of the scaled scores,
// which the backward (flash_attention_bwd.cu) recomputes from.
//
// Three schedules, chosen in Python by plan_forward
// (kernels/flash_attention.py) and passed in; none falls back to another:
//
// * tc (bf16, Sq >= 16: prefill, training, the backward's recompute).
//   A block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows, and a producer warpgroup whose one thread keeps
//   a 2-stage ring of 64-row K and V tiles full with TMA, each stage
//   guarded by a full and an empty mbarrier.  S = Q K^T runs as wgmma
//   with both operands in shared memory (K-major); the softmax scale is
//   applied to S in fp32; P is rounded to bf16 in registers and is the A
//   operand of O += P V, with V read MN-major (the transpose bit).  l sums
//   the fp32 P, before rounding, so the lse matches the plain version's.
//   The element mask runs only on tiles that the diagonal, kv_len or the
//   window cut; tiles wholly outside a warpgroup's rows are skipped.  The
//   heaviest causal q tiles launch first.  Bound at the training shape
//   (B=8, S=1024, H=16, D=128, causal): q, k, v, o once, 134 MB -> 0.040
//   ms at 3.35 TB/s against 34.4 GFLOP -> 0.035 ms at 989 TFLOP/s: bytes,
//   narrowly; both must overlap, which the ring and the two consumer
//   warpgroups are for.
// * splitkv (Sq < 16, bf16 or fp32: decode).  One query row is a
//   matrix-vector product, bound by the bytes of the cache (decode at
//   B=4, kv_len 1024: 33.6 MB -> 0.010 ms), so tensor cores do not apply;
//   what matters is enough loads in flight.  One block per (kv split,
//   head, batch x query row) streams its split's K/V rows with 16-byte
//   loads, a group of D/8 lanes a row, keeps fp32 (m, l, acc) and writes
//   them to fp32 scratch; a second kernel combines the splits (an empty
//   split, m = -1e30 and l = 0, weighs exactly 0) and writes o and lse.
// * fma (fp32, Sq >= 16).  The first, simple version of this kernel, on
//   the fp32 FMA pipes: full-fp32 products, which the fp32 parity phases
//   and the JAX reference need (a TF32 wgmma would not hold 1e-4).  One
//   block of 128 threads per (64-row q tile, head, batch), two threads a
//   query row, 32-row kv tiles staged in shared memory as fp32.  It is
//   instantiated for fp32 only: no bf16 tensor reaches it.

#include "hopper.cuh"

namespace {

using hopper::bf16;
using hopper::ERR_SCHEDULE;
using hopper::tensor_map_error;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] or null
  int B, Sq, Sk, H, KV;
  int q_offset, kv_len, causal, window;
  float scale;
  // splitkv: split s covers kv rows [split_lo + s * split_rows, + rows);
  // scratch o_part [B, H, Sq, splits, D], m_part and l_part [B, H, Sq,
  // splits], all fp32, m in log2 units
  int splits, split_lo, split_rows;
  float* o_part;
  float* m_part;
  float* l_part;
};

// ------------------------------------------------------------------- fma
namespace fmak {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // kv rows per shared-memory tile
constexpr int NT = 128;  // threads per block: two per query row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_fma_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;   // padded row strides
  constexpr int KS = D + 1;
  constexpr int PS = BK + 1;
  constexpr int DH = D / 2;   // accumulator columns per thread
  float* sQ = smem;              // [BQ][QS]  q * scale
  float* sK = sQ + BQ * QS;      // [BK][KS]
  float* sV = sK + BK * KS;      // [BK][D]
  float* sP = sV + BK * D;       // [BQ][PS]  probabilities of the tile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // query row of this thread within the tile
  const int half = tid & 1;  // kv columns half + 2j, head dims 2i + half
  const bool live = q0 + r < p.Sq;
  const int qpos = p.q_offset + q0 + r;

  // element (b, s, h, d) of a contiguous [B, S, heads, D] tensor
  const long q_rs = (long)p.H * D;
  const long kv_rs = (long)p.KV * D;
  const T* Qb = (const T*)p.q + (long)b * p.Sq * q_rs + (long)h * D;
  const T* Kb = (const T*)p.k + (long)b * p.Sk * kv_rs + (long)kvh * D;
  const T* Vb = (const T*)p.v + (long)b * p.Sk * kv_rs + (long)kvh * D;
  T* Ob = (T*)p.o + (long)b * p.Sq * q_rs + (long)h * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, dd = i % D;
    const int s = q0 + rr;
    sQ[rr * QS + dd] = s < p.Sq ? to_f(Qb[s * q_rs + dd]) * p.scale : 0.f;
  }

  // kv tiles this q tile can see: [j_begin, j_end)
  const int kv_end = min(p.kv_len, p.Sk);
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  int j_end = kv_end;
  if (p.causal) j_end = min(j_end, p.q_offset + last_row + 1);
  int j_begin = 0;
  if (p.window > 0) j_begin = max(0, p.q_offset + q0 - p.window + 1);
  j_begin = (j_begin / BK) * BK;

  float m_i = NEG_INF, l_i = 0.f;
  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += BK) {
    __syncthreads();  // the previous tile's sK, sV, sP are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int rr = i / D, dd = i % D;
      const int s = j0 + rr;
      const bool in = s < p.Sk;
      sK[rr * KS + dd] = in ? to_f(Kb[s * kv_rs + dd]) : 0.f;
      sV[rr * D + dd] = in ? to_f(Vb[s * kv_rs + dd]) : 0.f;
    }
    __syncthreads();

    float sc[BK / 2];
    float tmax = NEG_INF;
    if (live) {
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) sc[jj] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float qv = sQ[r * QS + dd];
#pragma unroll
        for (int jj = 0; jj < BK / 2; ++jj)
          sc[jj] += qv * sK[(half + 2 * jj) * KS + dd];
      }
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        const int kpos = j0 + half + 2 * jj;
        bool ok = kpos < kv_end;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        sc[jj] = ok ? sc[jj] : NEG_INF;
        tmax = fmaxf(tmax, sc[jj]);
      }
    }
    // the row's two threads are neighbouring lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_i, tmax);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
    if (live) {
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        const float pr = expf(sc[jj] - m_new);
        psum += pr;
        sP[r * PS + half + 2 * jj] = pr;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncthreads();  // the row's probabilities are all in sP

    if (live) {
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] *= alpha;
      for (int c = 0; c < BK; ++c) {
        const float pr = sP[r * PS + c];
        const float* vrow = sV + c * D + half;
#pragma unroll
        for (int i = 0; i < DH; ++i) acc[i] += pr * vrow[2 * i];
      }
    }
  }

  if (live) {
    const float l = fmaxf(l_i, 1e-30f);
    T* orow = Ob + (long)(q0 + r) * q_rs + half;
#pragma unroll
    for (int i = 0; i < DH; ++i) store(orow + 2 * i, acc[i] / l);
    if (p.lse != nullptr && half == 0)
      p.lse[((long)b * p.H + h) * p.Sq + q0 + r] = m_i + logf(l);
  }
}


}  // namespace fmak

// -------------------------------------------------------------------- tc
namespace tc {

constexpr int BQ = 128;     // query rows per block: two consumer warpgroups
constexpr int BK = 64;      // kv rows per ring stage
constexpr int STAGES = 2;
constexpr int NT = 384;     // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;

template <int D>
struct Smem {
  static constexpr int Q = BQ * D * 2;   // bytes of the Q tile
  static constexpr int KV = BK * D * 2;  // bytes of one K (or V) tile
  static constexpr int BARS = Q + 2 * STAGES * KV;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// What a consumer thread needs to mask and scale its scores: its
// warpgroup's first and last live query rows, its own rows r0 and r0 + 8
// and column pair 2 c4, the end of the visible keys and the scale in log2
// units.
struct Rows {
  int wg_first, wg_last, r0, c4, kv_end;
  float sl2;
};

// S = Q K^T for the warpgroup's 64 rows against a 64-row K tile, issued
// (not waited for): both operands K-major in shared memory.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             const bf16* sQ, const bf16* ks,
                                             int cw) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss(sc, hopper::desc_k<BQ, D>(sQ, cw * 64, kk),
                     hopper::desc_k<BK, D>(ks, 0, kk), kk > 0);
}

// One tile's online-softmax step: scale the scores to log2 units, mask
// them where the diagonal, kv_len or the window cut the tile, update the
// running max m and this thread's share of the row sums l (of the fp32 P,
// before rounding), and turn the scores into P's bf16 A fragments.
// alpha is the factor the accumulator must be rescaled by.
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             uint32_t (&pa)[BK / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Params& p, const Rows& w,
                                             int j0) {
  const bool cut = j0 + BK > w.kv_end ||
                   (p.causal && j0 + BK - 1 > p.q_offset + w.wg_first) ||
                   (p.window > 0 && j0 <= p.q_offset + w.wg_last - p.window);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = (e % 4) / 2;
    float x = sc[e] * w.sl2;
    if (cut) {
      const int qpos = p.q_offset + w.r0 + 8 * r;
      const int col = j0 + 8 * (e / 4) + 2 * w.c4 + (e % 2);
      bool ok = col < w.kv_end;
      if (p.causal) ok = ok && col <= qpos;
      if (p.window > 0) ok = ok && col > qpos - p.window;
      x = ok ? x : NEG_INF;
    }
    sc[e] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the row's four threads are neighbouring lanes
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = (e % 4) / 2;
    sc[e] = exp2f(sc[e] - m[r]);
    l[r] += sc[e];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) hopper::acc_to_a(sc, kk, pa[kk]);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  using namespace hopper;
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  bf16* sQ = (bf16*)base;
  bf16* sK = (bf16*)(base + Smem<D>::Q);  // [STAGES][BK x D]
  bf16* sV = (bf16*)(base + Smem<D>::Q + STAGES * Smem<D>::KV);
  uint64_t* q_full = (uint64_t*)(base + Smem<D>::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // heaviest causal q tiles first, so the grid's tail is short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  // kv tiles the block can see: [t_begin, t_end)
  const int kv_end = min(p.kv_len, p.Sk);
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  int j_end = kv_end;
  if (p.causal) j_end = min(j_end, p.q_offset + last_row + 1);
  int j_begin = 0;
  if (p.window > 0) j_begin = max(0, p.q_offset + q0 - p.window + 1);
  const int t_begin = j_begin / BK;
  const int t_end = (j_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = hopper::warpgroup_index();
  if (wg == 0) {
    // producer: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Smem<D>::Q);
      for (int c = 0; c < L::NB; ++c)
        tma_load_4d(sQ + c * BQ * L::CB, &tq, q_full, c * L::CB, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * Smem<D>::KV);
        bf16* kd = sK + s * BK * D;
        bf16* vd = sV + s * BK * D;
        for (int c = 0; c < L::NB; ++c) {
          tma_load_4d(kd + c * BK * L::CB, &tk, &full[s], c * L::CB, kvh,
                      t * BK, b);
          tma_load_4d(vd + c * BK * L::CB, &tv, &full[s], c * L::CB, kvh,
                      t * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows [q0 + 64 cw, + 64)
  setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int c4 = tid % 4;
  const int wg_first = q0 + cw * 64;
  const int wg_last = min(wg_first + 63, p.Sq - 1);
  const int r0 = wg_first + (tid / 32) * 16 + (tid % 32) / 4;  // and r0 + 8
  const Rows rows{wg_first, wg_last, r0, c4, kv_end, p.scale * LOG2E};

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  // the warpgroup's own tiles, [a_begin, a_end): the block's others lie
  // wholly above the diagonal or before the window of each of its rows
  int a_begin = t_begin, a_end = t_end;
  if (wg_first > wg_last) a_end = t_begin;  // every row past Sq
  if (p.causal) a_end = min(a_end, (p.q_offset + wg_last) / BK + 1);
  if (p.window > 0)
    a_begin = max(a_begin, (p.q_offset + wg_first - p.window + 1) / BK);
  a_begin = min(a_begin, t_end);
  a_end = max(min(a_end, t_end), a_begin);
  auto stage = [&](int t) { return (t - t_begin) % STAGES; };
  auto parity = [&](int t) {
    return (uint32_t)(((t - t_begin) / STAGES) & 1);
  };

  mbar_wait(q_full, 0);
  for (int t = t_begin; t < a_begin; ++t) {  // nothing to see: release
    mbar_wait(&full[stage(t)], parity(t));
    mbar_arrive(&empty[stage(t)]);
  }
  for (int t = a_begin; t < a_end; ++t) {
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float alpha[2];
    mbar_wait(&full[stage(t)], parity(t));
    __syncwarp();
    wgmma_fence();
    issue_scores<D>(sc, sQ, sK + stage(t) * BK * D, cw);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, pa, m, l, alpha, p, rows, t * BK);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e % 4) / 2];
    // O += P V: P from registers, V MN-major through the transpose bit
    const bf16* vs = sV + stage(t) * BK * D;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pa[kk], desc_mn<BK, D>(vs, kk * 16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    mbar_arrive(&empty[stage(t)]);
  }
  for (int t = a_end; t < t_end; ++t) {  // nothing to see: release
    mbar_wait(&full[stage(t)], parity(t));
    mbar_arrive(&empty[stage(t)]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    bf16* orow = (bf16*)p.o + ((long)(b * p.Sq + row) * p.H + h) * D + 2 * c4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *(uint32_t*)(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (p.lse != nullptr && c4 == 0)
      p.lse[((long)b * p.H + h) * p.Sq + row] = m[r] * LN2 + logf(lc);
  }
}

}  // namespace tc

// --------------------------------------------------------------- splitkv
namespace splitkv {

constexpr int NT = 128;
constexpr int EPL = 8;  // elements of a row per lane: 16 bytes of bf16

__device__ __forceinline__ void load_row(const bf16* src, float (&x)[EPL]) {
  const uint4 raw = *(const uint4*)src;
  const __nv_bfloat162* h2 = (const __nv_bfloat162*)&raw;
#pragma unroll
  for (int e = 0; e < EPL / 2; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load_row(const float* src, float (&x)[EPL]) {
  const float4 a = *(const float4*)src;
  const float4 c = *(const float4*)(src + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

// One block per (split, head, batch x query row): the split's partial
// (m, l, acc), unnormalised, into the scratch.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_splitkv_kernel(Params p) {
  constexpr int LPR = D / EPL;      // lanes per kv row
  constexpr int GROUPS = NT / LPR;  // kv rows read per step
  __shared__ float s_m[GROUPS], s_l[GROUPS];
  __shared__ float s_acc[GROUPS][D];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / p.Sq;
  const int i = blockIdx.z % p.Sq;
  const int kvh = h / (p.H / p.KV);
  const int qpos = p.q_offset + i;
  // this row's visible keys within the split
  int lo = p.split_lo + split * p.split_rows;
  int hi = min(lo + p.split_rows, min(p.kv_len, p.Sk));
  if (p.causal) hi = min(hi, qpos + 1);
  if (p.window > 0) lo = max(lo, qpos - p.window + 1);

  const int grp = threadIdx.x / LPR;
  const int sub = threadIdx.x % LPR;
  const long kv_rs = (long)p.KV * D;
  const long kv_off = (long)b * p.Sk * kv_rs + (long)kvh * D + sub * EPL;
  const T* Kb = (const T*)p.k + kv_off;
  const T* Vb = (const T*)p.v + kv_off;
  float qv[EPL];
  load_row((const T*)p.q + ((long)(b * p.Sq + i) * p.H + h) * D + sub * EPL,
           qv);
  const float sl2 = p.scale * LOG2E;
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] *= sl2;

  float m = NEG_INF, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  // the same trip count for every thread, so the shuffles stay converged
#pragma unroll 2
  for (int j0 = lo; j0 < hi; j0 += GROUPS) {
    const int j = j0 + grp;
    const bool valid = j < hi;
    float kf[EPL], vf[EPL];
    if (valid) {
      load_row(Kb + j * kv_rs, kf);
      load_row(Vb + j * kv_rs, vf);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
    }
    float sc = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) sc += qv[e] * kf[e];
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
    if (valid) {
      const float m_new = fmaxf(m, sc);
      const float alpha = exp2f(m - m_new);
      const float pr = exp2f(sc - m_new);
      l = l * alpha + pr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = acc[e] * alpha + pr * vf[e];
      m = m_new;
    }
  }

  // merge the block's row groups; a group that saw no key has l = 0
  if (sub == 0) {
    s_m[grp] = m;
    s_l[grp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) s_acc[grp][sub * EPL + e] = acc[e];
  __syncthreads();
  if (threadIdx.x < D) {
    float M = NEG_INF;
    for (int gi = 0; gi < GROUPS; ++gi) M = fmaxf(M, s_m[gi]);
    float Ls = 0.f, A = 0.f;
    for (int gi = 0; gi < GROUPS; ++gi) {
      const float w = exp2f(s_m[gi] - M);  // -1e30 - -1e30 = 0: no NaN
      Ls += s_l[gi] * w;
      A += s_acc[gi][threadIdx.x] * w;
    }
    const long at = ((long)(b * p.H + h) * p.Sq + i) * p.splits + split;
    p.o_part[at * D + threadIdx.x] = A;
    if (threadIdx.x == 0) {
      p.m_part[at] = M;
      p.l_part[at] = Ls;
    }
  }
}

// One block of D threads per (head, batch x query row): merge the splits,
// write o (and the lse).  An empty split has l = 0 and weighs nothing.
template <typename T, int D>
__global__ void __launch_bounds__(D) flash_fwd_combine_kernel(Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y / p.Sq;
  const int i = blockIdx.y % p.Sq;
  const long row = (long)(b * p.H + h) * p.Sq + i;  // lse[b, h, i]
  const float* mp = p.m_part + row * p.splits;
  const float* lp = p.l_part + row * p.splits;
  const float* op = p.o_part + row * p.splits * D + threadIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < p.splits; ++s) M = fmaxf(M, mp[s]);
  float Ls = 0.f, A = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float w = exp2f(mp[s] - M);
    Ls += lp[s] * w;
    A += op[(long)s * D] * w;
  }
  const float lc = fmaxf(Ls, 1e-30f);
  store((T*)p.o + ((long)(b * p.Sq + i) * p.H + h) * D + threadIdx.x,
        A / lc);
  if (p.lse != nullptr && threadIdx.x == 0)
    p.lse[row] = M * LN2 + logf(lc);
}

}  // namespace splitkv

// ------------------------------------------------------------- launchers

template <int D>
int launch_fma(const Params& p, cudaStream_t st) {
  const size_t smem = fmak::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fmak::flash_fwd_fma_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fmak::flash_fwd_fma_kernel<float, D>
      <<<dim3((p.Sq + fmak::BQ - 1) / fmak::BQ, p.H, p.B), fmak::NT, smem,
         st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const Params& p, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const cudaError_t bound = hopper::bind_context(p.q);
  if (bound != cudaSuccess) return (int)bound;
  const int enc[3] = {
      hopper::encode_bshd(&tq, p.q, p.B, p.Sq, p.H, D, tc::BQ),
      hopper::encode_bshd(&tk, p.k, p.B, p.Sk, p.KV, D, tc::BK),
      hopper::encode_bshd(&tv, p.v, p.B, p.Sk, p.KV, D, tc::BK)};
  for (int i = 0; i < 3; ++i)
    if (enc[i] != 0) return tensor_map_error(i, enc[i]);
  const int smem = tc::Smem<D>::BYTES;
  const auto kernel = tc::flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((p.Sq + tc::BQ - 1) / tc::BQ, p.H, p.B), tc::NT, smem,
           st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_splitkv(const Params& p, cudaStream_t st) {
  splitkv::flash_fwd_splitkv_kernel<T, D>
      <<<dim3(p.splits, p.H, p.B * p.Sq), splitkv::NT, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  splitkv::flash_fwd_combine_kernel<T, D>
      <<<dim3(p.H, p.B * p.Sq), D, 0, st>>>(p);
  return (int)cudaGetLastError();
}

enum Schedule { FMA = 0, TC = 1, SPLITKV = 2 };

template <int D>
int dispatch(const Params& p, int dtype, int schedule, cudaStream_t st) {
  if (schedule == FMA && dtype == 0) return launch_fma<D>(p, st);
  if (schedule == TC && dtype == 1) return launch_tc<D>(p, st);
  if (schedule == SPLITKV && dtype == 0)
    return launch_splitkv<float, D>(p, st);
  if (schedule == SPLITKV && dtype == 1)
    return launch_splitkv<bf16, D>(p, st);
  return ERR_SCHEDULE;
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// schedule: 0 = fma (fp32 only), 1 = tc (bf16 only), 2 = splitkv
// (o_part/m_part/l_part are its scratch), as plan_forward chose.  The grid
// is (q tiles, H, B) for fma and tc, each with its own tile rows, and
// (splits, H, B * Sq) for splitkv.  lse may be null.  Returns 0, a
// cudaError_t, or a negative code (flash_attn_error_string names it).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int Sq, int Sk,
                              int H, int KV, int D, int q_offset, int kv_len,
                              int causal, int window, float scale,
                              float* lse, int schedule, int splits,
                              int split_lo, int split_rows,
                              float* o_part, float* m_part, float* l_part,
                              void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || kv_len < 1 ||
      q_offset < 0 || window < 0 ||
      (schedule == SPLITKV &&
       (splits < 1 || split_rows < 1 || (long)B * Sq > 65535 ||
        o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, lse, B, Sq, Sk, H, KV, q_offset, kv_len,
                 causal, window, scale, splits, split_lo, split_rows,
                 o_part, m_part, l_part};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return dispatch<32>(p, dtype, schedule, st);
    case 64: return dispatch<64>(p, dtype, schedule, st);
    case 128: return dispatch<128>(p, dtype, schedule, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return hopper::error_string(err);
}
