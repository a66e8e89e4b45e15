// K2 on Hopper: causal online-softmax attention forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_kernel (pallas_call at :92, body _flash_kernel at :29).
// Same schedule: a q tile keeps fp32 running (acc, m, l) and streams kv
// tiles through fast memory, skipping tiles that lie wholly above the
// causal diagonal, so no [Sq, Sk] score matrix ever reaches HBM.  What it
// adds over the TPU kernel, for the serving path of the port:
//   * GQA by index (kv_head = h / (H / KV)), no materialised repeat;
//   * the q_offset form of causality (query i sits at position
//     q_offset + i), a kv_len bound and an optional sliding window, so
//     prefill (q_offset = 0) and decode (Sq = 1, q_offset = pos,
//     kv_len = pos + 1) share one kernel that stops at kv_len instead of
//     reading the whole cache horizon;
//   * ragged Sq and Sk, masked instead of asserted;
//   * [B, S, H, D] strides read in place: no transposes;
//   * an optional fp32 log-sum-exp output, lse[B, H, Sq] = m + log(l) of
//     the scaled scores, which the backward (flash_attention_bwd.cu)
//     needs to recompute the probabilities.  Serving passes null and
//     nothing else changes.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the slice's
// shapes: a gpt2-paper-1b prefill call (B=2, S=512, H=16, D=128, bf16,
// causal) must move q, k, v and o once, 16.8 MB -> 5.0 us, and do
// 4*B*H*D*S*(S+1)/2 = 2.15 GFLOP -> 2.2 us: bytes bound it.  A decode
// call (B=4, Sq=1, kv_len ~ 500) reads 16.4 MB of cache for 16 MFLOP:
// bytes bound it by far.
//
// Design of this first version: simple and right.  One block of 128
// threads per (64-row q tile, head, batch); two threads per query row,
// each owning half of the kv columns of a tile and an interleaved half of
// the head dimension of the accumulator.  kv tiles of 32 rows are staged
// in shared memory as fp32 (rows padded by one float so column reads are
// bank-conflict free), the products run on the fp32 FMA pipes and the
// softmax statistics stay in registers.  Warps whose rows all lie past
// Sq (decode uses 1 of 64 rows) skip the arithmetic.  It reaches neither
// bound: wgmma, TMA and warp specialisation, and a split-kv decode
// schedule, are the work of later PRs; PERF.md keeps its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // kv rows per shared-memory tile
constexpr int NT = 128;  // threads per block: two per query row
constexpr float NEG_INF = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
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
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
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

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// lse may be null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int Sq, int Sk,
                              int H, int KV, int D, int q_offset, int kv_len,
                              int causal, int window, float scale,
                              float* lse, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || kv_len < 1 ||
      q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, lse, B, Sq, Sk, H, KV,
                 q_offset, kv_len, causal, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_d<float>(p, D, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
