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
//   warpgroups are for.  Head dims 32, 64, 96, 128, 144 and 192; at 96 and 144
//   the tiles are six and nine 16-column boxes with the 32B swizzle
//   (hopper.cuh), and O += P V is one n96 or n144 product.  Bound at
//   phi-3-vision's training shape (B=2, S=4096, H=32, D=96, causal):
//   206.2 GFLOP -> 0.208 ms at 989 TFLOP/s against 201 MB -> 0.060 ms:
//   the operations.  MLA's (D, DV) = (192, 128): Q and K
//   tiles are three 64-column boxes (128B swizzle), V and O two, so
//   S = Q K^T takes 12 k-steps and O += P V stays an n128 product; the
//   consumer's registers are D = 128's.  Bound at deepseek-v2-lite's
//   training shape (B=2, S=4096, H=16, causal): 2 (D + DV) flops a visible
//   pair-head, 171.8 GFLOP -> 0.174 ms at 989 TFLOP/s (bytes 0.050 ms).
//   nemotron-4-340b's (192, 192): V and O are three boxes too, O += P V is
//   one n192 product read MN-major over the three, and O holds 96 fp32 a
//   consumer thread (64 at (192, 128)) beside the scores' 32.  Bound at
//   its training shape (B=1, S=4096, H=96, KV=8, causal): 618.6 GFLOP ->
//   0.625 ms at 989 TFLOP/s (bytes 0.098 ms).
// * splitkv (Sq < 16, bf16 or fp32: decode).  One query row is a
//   matrix-vector product, bound by the bytes of the cache (decode at
//   B=4, kv_len 1024: 33.6 MB -> 0.010 ms), so tensor cores do not apply;
//   what matters is enough loads in flight.  One block per (kv split,
//   head, batch x query row) streams its split's K/V rows with 16-byte
//   loads, D/8 lanes a row in a group of the next power of two lanes (at
//   D = 96, 12 of 16; at D = 144, 18 of 32; at D = 192, 24 of 32: a row's
//   sum never crosses a group), keeps fp32
//   (m, l, acc) and writes
//   them to fp32 scratch; a second kernel combines the splits (an empty
//   split, m = -1e30 and l = 0, weighs exactly 0) and writes o and lse.
//   With kv_lens (int32 [B] on the device, or null) row b also stops at
//   key kv_lens[b]: the compiled serving round decodes every slot from its
//   own length under one CUDA graph, which cannot bake in a host int.  The
//   splits then span the whole horizon Sk (no host length exists to plan
//   from), so most splits of a short row are empty and weigh 0.
// * tf32x3 (fp32, Sq >= 16: the fp32 parity phases and the fp32
//   trainer, prefill and the backward's recompute).  The fp32 parity
//   phases hold the card to 1e-4 of the CPU's full-fp32 attention, which a
//   single TF32 product (~2^-11 relative) does not hold.  So the products
//   run on the tensor cores through warp-level mma.sync.m16n8k8 in split
//   TF32 (tf32.cuh): each is a_lo b_hi + a_hi b_lo + a_hi b_hi, ~2^-21
//   relative.  wgmma would take the TF32 operands of O += P V only K-major,
//   and V is MN-major here; mma.sync reads each fragment by index from a
//   padded fp32 tile, so one tile layout serves both products.  Bounds at
//   the training shape (B=8, S=1024, H=16, D=128, causal): q, k, v, o once,
//   268 MB -> 0.080 ms at 3.35 TB/s; 34.4 GFLOP -> 0.513 ms on the FMA
//   pipes (67 TFLOP/s), or 0.209 ms as three TF32 products on the tensor
//   cores (494.7 TFLOP/s), the lesser: the operations bound it.  What the
//   design does about it: a block is 256 threads, eight warps of 16 query
//   rows (128 rows of one (batch, head)), the heaviest causal q tiles
//   first.  Q is copied once by cp.async into a padded row-major tile
//   (rows of D + 4 floats); a 2-stage cp.async ring brings 64-row K and V
//   tiles (zeros past Sk) while the warps work on the other stage.  Per
//   warp and tile: S = Q K^T (16 x 64, K read as B along D), the scale
//   applied to S in fp32 after the product, the element mask only on tiles
//   the diagonal, kv_len or the window cut for that warp (tiles no row of
//   the warp sees are skipped), the online softmax over each row's four
//   lanes, then O += P V with P turned from accumulator into A operand in
//   registers (tf32.cuh's k permutation) and V read down its rows.  l sums
//   the fp32 P before the split, so the lse matches the plain version's.
//   O (D/8 x 4 fp32 a thread) stays in registers.  Both reads of the
//   padded tiles, along D and down the rows, are free of bank conflicts.
//   It is bound by the latency of each warp's chain of shared loads,
//   splits and products, not by the tensor cores' rate: one block of
//   eight warps fills an SM's registers at D = 128.  At (192, 128) Q and a
//   2-stage ring of 64-row K and V tiles would take 268,288 bytes, past
//   the block's 232,448, so the stages hold 32 kv rows (184,320 bytes):
//   that keeps the eight warps and the overlap of the ring, where 64-row
//   query blocks would halve the warps and one stage would serialise the
//   copies; it costs twice the barriers a kv row (bound at the training
//   shape: 3 x 171.8 GFLOP -> 1.042 ms as 3xTF32).  At (192, 192) the
//   64-row stages would take 301,056 bytes, the 32-row ones 200,704, and
//   O is 96 fp32 a thread.

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using hopper::bf16;
using hopper::ERR_SCHEDULE;
using hopper::tensor_map_error;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
  const int* kv_lens;  // splitkv only: [B], row b sees keys < kv_lens[b]
};

// ---------------------------------------------------------------- tf32x3
namespace x3 {

using namespace tf32;

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows a block, 16 a warp
constexpr int STAGES = 2;
constexpr int SMEM_MAX = 232448;  // an H100 block's shared memory, bytes

// Q and K rows are D wide, V rows DV.  A ring stage holds TK kv rows: 64
// where Q and a 2-stage ring of them fit a block's shared memory, else 32
// ((192, 128): 268,288 bytes at 64).  Halving the stage keeps the eight
// warps and the overlap of the ring; 64-row query blocks (four warps) or
// a one-stage ring would fit too, but give up one or the other.
constexpr int smem_bytes(int D, int DV, int tk) {
  return 4 * (BQ * (D + 4) + STAGES * tk * (D + DV + 8));
}

template <int D, int DV>
struct Smem {
  static constexpr int S = D + 4;    // row stride of Q and K, floats
  static constexpr int SV = DV + 4;  // row stride of V
  static constexpr int TK = smem_bytes(D, DV, 64) <= SMEM_MAX ? 64 : 32;
  static constexpr int STAGE = TK * (S + SV);  // K, V
  static constexpr int BYTES = smem_bytes(D, DV, TK);
  static_assert(BYTES <= SMEM_MAX, "Q and the ring exceed shared memory");
};

// O for BQ query rows of one (head, batch).  Warp w owns rows
// qw = q0 + 16 w .. qw + 15; Q stays in shared memory, the ring brings K
// and V, TK rows a stage, over the kv rows the block can see.
template <int D, int DV>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tf32_kernel(const Params p) {
  using L = Smem<D, DV>;
  constexpr int S = L::S;
  constexpr int SV = L::SV;
  constexpr int TK = L::TK;
  extern __shared__ float4 smem4[];
  float* sQ = (float*)smem4;
  float* ring = sQ + BQ * S;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long q_rs = (long)p.H * D;
  const long kv_rs = (long)p.KV * D;
  const long v_rs = (long)p.KV * DV;
  const long o_rs = (long)p.H * DV;
  const long q_off = (long)b * p.Sq * q_rs + (long)h * D;
  const long kv_off = (long)b * p.Sk * kv_rs + (long)kvh * D;
  const long v_off = (long)b * p.Sk * v_rs + (long)kvh * DV;
  const long o_off = (long)b * p.Sq * o_rs + (long)h * DV;

  // kv tiles the block can see: n_tiles of them from tile t_begin
  const int kv_end = min(p.kv_len, p.Sk);
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  int j_end = kv_end;
  if (p.causal) j_end = min(j_end, p.q_offset + last_row + 1);
  int j_begin = 0;
  if (p.window > 0) j_begin = max(0, p.q_offset + q0 - p.window + 1);
  const int t_begin = j_begin / TK;
  const int n_tiles = max(0, (j_end + TK - 1) / TK - t_begin);

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
  prefetch(0);  // the first group holds Q and kv tile 0
  prefetch(1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + 16 * warp;
  const int w_last = min(qw + 15, p.Sq - 1);
  const float* wQ = sQ + 16 * warp * S;
  // this thread's two query rows, qw + g and qw + g + 8, as positions
  const int qpos0 = p.q_offset + qw + g;

  float o[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const int j0 = (t_begin + i) * TK;
    const float* sK = ring + (i % STAGES) * L::STAGE;
    const float* sV = sK + TK * S;
    // no row of the warp sees a key of the tile: every row past Sq, every
    // key past the diagonal or before the window of each row
    const bool skip =
        qw > w_last || (p.causal && j0 > p.q_offset + w_last) ||
        (p.window > 0 && j0 + TK - 1 <= p.q_offset + qw - p.window);
    if (!skip) {
      // S = Q K^T: 16 q rows x TK kv columns
      float sc[TK / 8][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const FragA qa = load_a<S>(wQ, 0, 8 * kk);
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
          mma3(sc[j], qa, load_b_nk<S>(sK, 8 * j, 8 * kk));
      }
      // scale in fp32 after the product; the element mask only where the
      // diagonal, kv_len or the window cut the tile for this warp.
      // Element (j, e): row qw + g + 8 (e / 2), key j0 + 8 j + 2 t + e % 2
      const bool cut =
          j0 + TK > kv_end || (p.causal && j0 + TK - 1 > p.q_offset + qw) ||
          (p.window > 0 && j0 <= p.q_offset + w_last - p.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = sc[j][e] * p.scale;
          if (cut) {
            const int qpos = qpos0 + 8 * r;
            const int col = j0 + 8 * j + 2 * t + (e & 1);
            bool ok = col < kv_end;
            if (p.causal) ok = ok && col <= qpos;
            if (p.window > 0) ok = ok && col > qpos - p.window;
            x = ok ? x : NEG_INF;
          }
          sc[j][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      // online softmax over each row's four lanes (t = 0..3).  A row that
      // has seen only masked keys keeps m = -1e30 and sums garbage
      // probabilities of 1; the first visible key wipes them (alpha = 0)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          sc[j][e] = exp2f((sc[j][e] - m[r]) * LOG2E);
          l[r] += sc[j][e];  // the fp32 P, before the split
        }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
      // O += P V: the kv rows are the reduction, P the A operand straight
      // from its accumulator.  O accumulates in the tensor cores' fp32
      // accumulator, which does not round to nearest: its error grows with
      // the row's length (8.1e-6 relative over 4096 keys on an H100)
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        const FragA pa = acc_to_a(sc[kk]);
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          mma3(o[j], pa, load_b_kn<SV>(sV, 8 * kk, 8 * j));
      }
    }
    __syncthreads();  // stage i % 2 is consumed by every warp
    prefetch(i + 2);
  }
  cp_async_wait<0>();

  // accumulator element (j, e): row qw + g + 8 (e / 2), column
  // 8 j + 2 t + (e % 2)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = qw + g + 8 * r;
    if (row >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    float* orow = (float*)p.o + o_off + (long)row * o_rs + 2 * t;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *(float2*)(orow + 8 * j) =
          make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (p.lse != nullptr && t == 0)
      p.lse[((long)b * p.H + h) * p.Sq + row] = m[r] + logf(lc);
  }
}

}  // namespace x3

// -------------------------------------------------------------------- tc
namespace tc {

constexpr int BQ = 128;     // query rows per block: two consumer warpgroups
constexpr int BK = 64;      // kv rows per ring stage
constexpr int STAGES = 2;
constexpr int NT = 384;     // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;

// Q and K rows are D wide, V rows DV; every tile starts on a 1024-byte
// boundary (the swizzle atoms), which 64 rows of a multiple of 16 columns
// keep.
template <int D, int DV>
struct Smem {
  static constexpr int Q = BQ * D * 2;  // bytes of the Q tile
  static constexpr int K = BK * D * 2;  // bytes of one K tile
  static constexpr int V = BK * DV * 2;  // bytes of one V tile
  static constexpr int BARS = Q + STAGES * (K + V);
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

template <int D, int DV>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  using namespace hopper;
  using L = Tile<D>;
  using LV = Tile<DV>;
  using M = Smem<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  bf16* sQ = (bf16*)base;
  bf16* sK = (bf16*)(base + M::Q);  // [STAGES][BK x D]
  bf16* sV = (bf16*)(base + M::Q + STAGES * M::K);  // [STAGES][BK x DV]
  uint64_t* q_full = (uint64_t*)(base + M::BARS);
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
      mbar_expect_tx(q_full, M::Q);
      for (int c = 0; c < L::NB; ++c)
        tma_load_4d(sQ + c * BQ * L::CB, &tq, q_full, c * L::CB, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], M::K + M::V);
        bf16* kd = sK + s * BK * D;
        bf16* vd = sV + s * BK * DV;
        for (int c = 0; c < L::NB; ++c)
          tma_load_4d(kd + c * BK * L::CB, &tk, &full[s], c * L::CB, kvh,
                      t * BK, b);
        for (int c = 0; c < LV::NB; ++c)
          tma_load_4d(vd + c * BK * LV::CB, &tv, &full[s], c * LV::CB, kvh,
                      t * BK, b);
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

  float o[DV / 2];
#pragma unroll
  for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
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
    for (int e = 0; e < DV / 2; ++e) o[e] *= alpha[(e % 4) / 2];
    // O += P V: P from registers, V MN-major through the transpose bit
    const bf16* vs = sV + stage(t) * BK * DV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pa[kk], desc_mn<BK, DV>(vs, kk * 16), 1);
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
    bf16* orow = (bf16*)p.o + ((long)(b * p.Sq + row) * p.H + h) * DV + 2 * c4;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
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

// A kv row is read by D / EPL lanes, in a group of the next power of two
// of lanes (D = 96: 12 in a group of 16; D = 144 and 192: 18 and 24 in a
// group of 32), so the within-row sum is
// a butterfly that never crosses a group; the group's spare lanes hold
// zeros.
template <int D>
struct Lanes {
  static constexpr int USED = D / EPL;  // lanes that hold a slice of a row
  static constexpr int LPR = USED <= 4 ? 4 : USED <= 8 ? 8
                           : USED <= 16 ? 16 : 32;  // lanes per kv row
  static constexpr int GROUPS = NT / LPR;           // kv rows per step
  static_assert(D % EPL == 0 && USED <= 32, "a kv row is one warp at most");
};

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
  constexpr int LPR = Lanes<D>::LPR;
  constexpr int GROUPS = Lanes<D>::GROUPS;
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
  if (p.kv_lens != nullptr) hi = min(hi, p.kv_lens[b]);
  if (p.causal) hi = min(hi, qpos + 1);
  if (p.window > 0) lo = max(lo, qpos - p.window + 1);

  const int grp = threadIdx.x / LPR;
  const int sub = threadIdx.x % LPR;
  const bool used = sub < Lanes<D>::USED;  // a spare lane reads nothing
  const int col = used ? sub * EPL : 0;
  const long kv_rs = (long)p.KV * D;
  const long kv_off = (long)b * p.Sk * kv_rs + (long)kvh * D + col;
  const T* Kb = (const T*)p.k + kv_off;
  const T* Vb = (const T*)p.v + kv_off;
  float qv[EPL];
  load_row((const T*)p.q + ((long)(b * p.Sq + i) * p.H + h) * D + col, qv);
  if (!used)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[e] = 0.f;
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
    if (valid && used) {
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
  if (used)
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[grp][sub * EPL + e] = acc[e];
  __syncthreads();
  float M = NEG_INF;
  for (int gi = 0; gi < GROUPS; ++gi) M = fmaxf(M, s_m[gi]);
  const long at = ((long)(b * p.H + h) * p.Sq + i) * p.splits + split;
  // D may exceed the block (D = 144, 192): a thread merges every NT-th
  // column
  for (int c = threadIdx.x; c < D; c += NT) {
    float A = 0.f;
    for (int gi = 0; gi < GROUPS; ++gi)
      A += s_acc[gi][c] * exp2f(s_m[gi] - M);  // -1e30 - -1e30 = 0: no NaN
    p.o_part[at * D + c] = A;
  }
  if (threadIdx.x == 0) {
    float Ls = 0.f;
    for (int gi = 0; gi < GROUPS; ++gi) Ls += s_l[gi] * exp2f(s_m[gi] - M);
    p.m_part[at] = M;
    p.l_part[at] = Ls;
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

template <int D, int DV>
int launch_tf32x3(const Params& p, cudaStream_t st) {
  const int smem = x3::Smem<D, DV>::BYTES;
  const auto kernel = x3::flash_fwd_tf32_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((p.Sq + x3::BQ - 1) / x3::BQ, p.H, p.B), x3::NT, smem, st>>>(
      p);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_tc(const Params& p, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const cudaError_t bound = hopper::bind_context(p.q);
  if (bound != cudaSuccess) return (int)bound;
  const int enc[3] = {
      hopper::encode_bshd(&tq, p.q, p.B, p.Sq, p.H, D, tc::BQ),
      hopper::encode_bshd(&tk, p.k, p.B, p.Sk, p.KV, D, tc::BK),
      hopper::encode_bshd(&tv, p.v, p.B, p.Sk, p.KV, DV, tc::BK)};
  for (int i = 0; i < 3; ++i)
    if (enc[i] != 0) return tensor_map_error(i, enc[i]);
  const int smem = tc::Smem<D, DV>::BYTES;
  const auto kernel = tc::flash_fwd_tc_kernel<D, DV>;
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

enum Schedule { TC = 1, SPLITKV = 2, TF32X3 = 3 };

// (D, DV): q/k head dim and value head dim.  splitkv takes D == DV only
// (no path decodes through (192, 128): MLA decodes over its latent
// cache).
template <int D, int DV>
int dispatch(const Params& p, int dtype, int schedule, cudaStream_t st) {
  if (schedule == TF32X3 && dtype == 0) return launch_tf32x3<D, DV>(p, st);
  if (schedule == TC && dtype == 1) return launch_tc<D, DV>(p, st);
  if constexpr (D == DV) {
    if (schedule == SPLITKV && dtype == 0)
      return launch_splitkv<float, D>(p, st);
    if (schedule == SPLITKV && dtype == 1)
      return launch_splitkv<bf16, D>(p, st);
  }
  return ERR_SCHEDULE;
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16.  q and
// k are [B, S, heads, D], v and o [B, S, heads, DV]: (D, DV) is (d, d)
// for d in {32, 64, 96, 128, 144, 192}, or (192, 128) (MLA).
// schedule: 1 = tc (bf16 only), 2 = splitkv (D == DV only;
// o_part/m_part/l_part are its scratch), 3 = tf32x3 (fp32 only), as
// plan_forward chose.  The grid
// is (q tiles, H, B) for tc and tf32x3, 128 query rows a tile, and
// (splits, H, B * Sq) for splitkv.  lse may be null.  kv_lens may be null;
// set (int32 [B] on the device, each >= 1), it bounds row b's keys to
// [0, kv_lens[b]) on top of the other masks, and only splitkv takes it.
// Returns 0, a cudaError_t, or a negative code (flash_attn_error_string
// names it).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int Sq, int Sk,
                              int H, int KV, int D, int DV, int q_offset,
                              int kv_len,
                              int causal, int window, float scale,
                              float* lse, int schedule, int splits,
                              int split_lo, int split_rows,
                              float* o_part, float* m_part, float* l_part,
                              const int* kv_lens, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || kv_len < 1 ||
      q_offset < 0 || window < 0 ||
      (schedule == SPLITKV &&
       (splits < 1 || split_rows < 1 || (long)B * Sq > 65535 ||
        o_part == nullptr || m_part == nullptr || l_part == nullptr)) ||
      (kv_lens != nullptr && schedule != SPLITKV))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, lse, B, Sq, Sk, H, KV, q_offset, kv_len,
                 causal, window, scale, splits, split_lo, split_rows,
                 o_part, m_part, l_part, kv_lens};
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

extern "C" const char* flash_attn_error_string(int err) {
  return hopper::error_string(err);
}
