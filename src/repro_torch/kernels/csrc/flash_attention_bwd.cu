// K2's backward on Hopper: the gradients of causal attention.
//
// The TPU package has no backward kernel: its trainer differentiates the
// plain attention (src/repro/models/layers.py: naive_attention) with XLA.
// This is the backward of the port's forward kernel
// (flash_attention.cu), a simple FlashAttention-2 scheme in three
// launches that never writes an [Sq, Sk] matrix to memory:
//   1. delta[b, h, i] = rowsum(dO * O), fp32, one warp per row;
//   2. dK and dV: one block per (kv tile, kv head, batch).  It holds its
//      kv tile in shared memory and walks the q tiles of every query head
//      that reads this kv head (GQA), from the causal diagonal on.  Per q
//      tile it recomputes P = exp(S * scale - lse) from the forward's
//      log-sum-exp and accumulates, in fp32 registers,
//          dV += P^T dO,   dK += (P * (dO V^T - delta))^T Q * scale;
//      summing over the query heads of the group needs no atomics;
//   3. dQ: one block per (q tile, head, batch), walking the kv tiles up to
//      the diagonal: dQ += (P * (dO V^T - delta)) K * scale.  No atomics.
// Masks: causal with q_offset = 0 over the full kv length, or no mask;
// ragged Sq and Sk; GQA by index; D in {32, 64, 128}; bf16 or fp32.
//
// Bound on an H100 SXM at the training shape (B=8, S=1024, H=16, D=128,
// bf16, causal): q, k, v, o, dO, dQ, dK, dV once each plus lse and delta,
// 269 MB -> 0.080 ms; 8 * D flops per visible (query, key) pair per head,
// 68.8 GFLOP -> 0.070 ms at 989 TFLOP/s: bytes bound it, narrowly.  In
// fp32 the operations bound it (1.03 ms at 67 TFLOP/s).
//
// Design of this first version: right and simple, like the forward.
// 32 x 32 tiles staged in shared memory as fp32 (rows padded by one float,
// so column reads are bank-conflict free), products on the fp32 FMA pipes,
// 128 threads a block.  In the score phase each warp owns 8 query rows and
// each lane one kv column; in the accumulation phase four threads share a
// row of the accumulator, each owning every fourth column.  It reaches
// neither bound: wgmma, TMA and a pipelined tile ring are the work of later
// PRs, and PERF.md keeps its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;   // query rows per tile
constexpr int BKV = 32;  // kv rows per tile (== the warp size: one lane each)
constexpr int NT = 128;  // threads per block
constexpr int WARPS = NT / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  const void* q;     // [B, Sq, H, D]
  const void* k;     // [B, Sk, KV, D]
  const void* v;     // [B, Sk, KV, D]
  const void* o;     // [B, Sq, H, D]   the forward's output
  const void* dout;  // [B, Sq, H, D]
  const float* lse;  // [B, H, Sq]      the forward's log-sum-exp
  float* delta;      // [B, H, Sq]      scratch: rowsum(dO * O)
  void* dq;          // [B, Sq, H, D]
  void* dk;          // [B, Sk, KV, D]
  void* dv;          // [B, Sk, KV, D]
  int B, Sq, Sk, H, KV, causal;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  // sK, sV [BKV][D+1]; sQ, sdO [BQ][D+1]; sP, sdS [BQ][BKV+1]; lse, delta
  return sizeof(float) *
         (2 * BKV * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BKV + 1) + 2 * BQ);
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp per row,
// rows in [b][i][h] order (the memory order of O).
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
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
    p.delta[((long)b * p.H + h) * p.Sq + s] = acc;
  }
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
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(Params p) {
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
    const float* delta = p.delta + ((long)b * p.H + h) * p.Sq;
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
__global__ void __launch_bounds__(NT) bwd_dq_kernel(Params p) {
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
    const long at = ((long)b * p.H + h) * p.Sq + s;
    sLse[tid] = s < p.Sq ? p.lse[at] : 0.f;
    sDelta[tid] = s < p.Sq ? p.delta[at] : 0.f;
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

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long rows = (long)p.B * p.Sq * p.H;
  bwd_delta_kernel<T, D><<<(unsigned)((rows + WARPS - 1) / WARPS), NT, 0,
                           stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = (int)smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((p.Sk + BKV - 1) / BKV, p.KV, p.B);
  bwd_dkdv_kernel<T, D><<<kv_grid, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  bwd_dq_kernel<T, D><<<q_grid, NT, smem, stream>>>(p);
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

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k,
// v, o, dout, dq, dk and dv all of it); lse and delta are fp32 [B, H, Sq].
// causal: 1 = key j visible to query i iff j <= i, 0 = every key visible.
// Returns the cudaError_t of the first failing launch (0 on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int dtype, int B, int Sq,
                              int Sk, int H, int KV, int D, int causal,
                              float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q,  k,  v,  o,  dout, lse, delta, dq,     dk,
                 dv, B, Sq, Sk, H,    KV,  causal, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_d<float>(p, D, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
