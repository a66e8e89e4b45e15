#!/usr/bin/env python3
"""Design variants of K2's fp32 kernels (``tf32x3``, forward and backward)
side by side on one card.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 tools/k2_fp32_variants.py [variant ...]

Each variant is ``csrc/`` with a few text edits to ``flash_attention.cu``
or ``flash_attention_bwd.cu`` (see :data:`VARIANTS`; ``shipped`` is the
source as it is).  All are built at once with the port's ``nvcc`` flags
into ``build/variants/<name>/`` (git-ignored), then each variant's
libraries are loaded in place of the wrappers' and:

* ptxas's registers and spills for its ``tf32`` kernel instances;
* the forward on every case of :data:`CASES`, against the plain forward
  (max abs error of the output and of the lse; limits 1e-4) and against
  the plain forward computed with split-TF32 products, the kernel's model
  (relative Frobenius error);
* the backward on :data:`BWD_CASES`, each of dq, dk and dv against the
  plain backward and against its split-TF32 model (max abs error over the
  gradient's largest value, and relative Frobenius error);
* the forward's and the backward's times at the training shape (B=8,
  S=1024, H=16, D=128, causal) and at S=4096, by CUDA events, the variants
  in turns (forward order, then reverse order);

with ``nvidia-smi``'s name and power limit.  One JSON object a line on
standard output; exits non-zero if a build fails.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
OUT = ROOT / "build" / "variants"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")


def _fwd(old: str, new: str) -> tuple[str, str, str]:
    return (SOURCES[0], old, new)


def _bwd(old: str, new: str) -> tuple[str, str, str]:
    return (SOURCES[1], old, new)


# O += P V summed a tile at a time: each 8-column block of P V in an
# accumulator of its own, added to O in fp32 (rounded to nearest)
_PARTIAL_O = _fwd('''#pragma unroll
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
''', '''      FragA pa[TK / 8];
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) pa[kk] = acc_to_a(sc[kk]);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < TK / 8; ++kk)
          mma3(pv, pa[kk], load_b_kn<SV>(sV, 8 * kk, 8 * j));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[e]);
      }
''')
_TK32 = _fwd(
    "static constexpr int TK = smem_bytes(D, DV, 64) <= SMEM_MAX ? 64 : 32;",
    "static constexpr int TK = 32;")
# variants whose tiles outgrow shared memory at MLA's (192, 128) build
# the head dims of equal widths only
_NO_PAIR = _fwd("  if (D == 192 && DV == 128) return dispatch<192, 128>(p, dtype, "
                "schedule, st);\n", "")
# Q split once into hi and lo tiles when it lands (twice its shared memory)
_QSPLIT = [
    _NO_PAIR,
    _fwd("static constexpr int BYTES = smem_bytes(D, DV, TK);",
     "static constexpr int BYTES = 4 * BQ * S + smem_bytes(D, DV, TK);"),
    _fwd("  float* ring = sQ + BQ * S;\n",
     "  float* ring = sQ + 2 * BQ * S;  // sQ hi, then lo\n"),
    _fwd('''  load_rows<D, BQ, NT>(sQ, (const float*)p.q + q_off, q_rs, q0, p.Sq);
  prefetch(0);  // the first group holds Q and kv tile 0
  prefetch(1);
''', '''  load_rows<D, BQ, NT>(sQ, (const float*)p.q + q_off, q_rs, q0, p.Sq);
  cp_async_commit();
  prefetch(0);
  prefetch(1);
  cp_async_wait<2>();
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * S; e += NT) {
    uint32_t hi, lo;
    split(sQ[e], hi, lo);
    sQ[e] = __uint_as_float(hi);
    sQ[BQ * S + e] = __uint_as_float(lo);
  }
  __syncthreads();
'''),
    _fwd("        const FragA qa = load_a<S>(wQ, 0, 8 * kk);\n",
     '''        FragA qa;
        {
          const float* ph = wQ + (lane >> 2) * S + 8 * kk + (lane & 3);
          const float* pl = ph + BQ * S;
          const int at[4] = {0, 8 * S, 4, 8 * S + 4};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            qa.hi[c] = __float_as_uint(ph[at[c]]);
            qa.lo[c] = __float_as_uint(pl[at[c]]);
          }
        }
'''),
]
# K and V split once a tile by the whole block into hi and lo tiles (twice
# the ring), in place of every warp splitting every fragment it reads
_KVSPLIT = [
    _NO_PAIR,
    _fwd("static constexpr int STAGE = TK * (S + SV);  // K, V",
     "static constexpr int STAGE = 2 * TK * (S + SV);  // K, V, lo parts"),
    _fwd("static constexpr int BYTES = smem_bytes(D, DV, TK);",
     "static constexpr int BYTES = 4 * (BQ * S + STAGES * STAGE);"),
    _fwd("// query rows a block, 16 a warp\nconstexpr int STAGES = 2;\n",
     '''// query rows a block, 16 a warp
constexpr int STAGES = 2;

template <int S>
__device__ __forceinline__ FragB b_nk_hl(const float* hi, int lo, int n0,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = hi + (n0 + (lane >> 2)) * S + k0 + (lane & 3);
  FragB f;
  f.hi[0] = __float_as_uint(p[0]);
  f.hi[1] = __float_as_uint(p[4]);
  f.lo[0] = __float_as_uint(p[lo]);
  f.lo[1] = __float_as_uint(p[lo + 4]);
  return f;
}

template <int S>
__device__ __forceinline__ FragB b_kn_hl(const float* hi, int lo, int k0,
                                         int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = hi + (k0 + 2 * (lane & 3)) * S + n0 + (lane >> 2);
  FragB f;
  f.hi[0] = __float_as_uint(p[0]);
  f.hi[1] = __float_as_uint(p[S]);
  f.lo[0] = __float_as_uint(p[lo]);
  f.lo[1] = __float_as_uint(p[lo + S]);
  return f;
}
'''),
    _fwd('''    const float* sK = ring + (i % STAGES) * L::STAGE;
    const float* sV = sK + TK * S;
''', '''    float* st = ring + (i % STAGES) * L::STAGE;
    for (int e = threadIdx.x; e < TK * (S + SV); e += NT) {
      uint32_t hi, lo;
      split(st[e], hi, lo);
      st[e] = __uint_as_float(hi);
      st[TK * (S + SV) + e] = __uint_as_float(lo);
    }
    __syncthreads();
    const float* sK = st;
    const float* sV = sK + TK * S;
'''),
    _fwd("mma3(sc[j], qa, load_b_nk<S>(sK, 8 * j, 8 * kk));",
     "mma3(sc[j], qa, b_nk_hl<S>(sK, TK * (S + SV), 8 * j, 8 * kk));"),
    _fwd("mma3(o[j], pa, load_b_kn<SV>(sV, 8 * kk, 8 * j));",
     "mma3(o[j], pa, b_kn_hl<SV>(sV, TK * (S + SV), 8 * kk, 8 * j));"),
]
# the forward's O += P V through mma3_rn, as the backward's dK and dV
_FWD_RN = _fwd("mma3(o[j], pa, load_b_kn<SV>(sV, 8 * kk, 8 * j));",
               "mma3_rn(o[j], pa, load_b_kn<SV>(sV, 8 * kk, 8 * j));")
# the backward's dK and dV straight into the tensor cores' accumulator
_BWD_TRUNC = _bwd(
    "            mma3_rn(dv[j], pa, load_b_kn<SV>(sdO, 8 * kk, 8 * j));\n"
    "            mma3_rn(dk[j], da, load_b_kn<S>(sQ, 8 * kk, 8 * j));",
    "            mma3(dv[j], pa, load_b_kn<SV>(sdO, 8 * kk, 8 * j));\n"
    "            mma3(dk[j], da, load_b_kn<S>(sQ, 8 * kk, 8 * j));")
# the backward's dQ through mma3_rn too
_BWD_DQ_RN = _bwd(
    "          mma3(dq[j], da, load_b_kn<S>(sK, 8 * kk, 8 * j));",
    "          mma3_rn(dq[j], da, load_b_kn<S>(sK, 8 * kk, 8 * j));")
# mma3_rn with all three products in the fresh accumulator: d is never
# truncated
_RN3 = ("tf32.cuh", '''#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
  mma(d, a.hi, b.hi[0], b.hi[1]);
''', '''  mma(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
''')
VARIANTS = {
    "shipped": [],
    "partial_o": [_PARTIAL_O],
    "tk32": [_TK32],
    "qsplit_tk32": [_TK32, *_QSPLIT],
    "kvsplit_tk32": [_TK32, *_KVSPLIT],
    "fwd_rn": [_FWD_RN],
    "bwd_truncating": [_BWD_TRUNC],
    "bwd_dq_rn": [_BWD_DQ_RN],
    "bwd_rn3": [_RN3],
}
# (name, (b, sq, sk, h, kv, d), options): every fp32 shape chip_smoke.py's
# forward phase runs with Sq >= 16, and a few more masks
CASES = [
    ("train", (8, 1024, 1024, 16, 16, 128), dict(causal=True)),
    ("long_4096", (1, 4096, 4096, 16, 16, 128), dict(causal=True)),
    ("prefill_500", (2, 500, 500, 16, 16, 128), dict(causal=True)),
    ("prefill_kvlen", (2, 500, 512, 16, 16, 128),
     dict(causal=True, kv_len=480)),
    ("prefill_window", (2, 512, 512, 16, 16, 128),
     dict(causal=True, window=128)),
    ("prefill_gqa", (2, 512, 512, 16, 8, 128), dict(causal=True)),
    ("prefill_d32", (2, 256, 256, 16, 16, 32), dict(causal=True)),
    ("d64_window", (1, 96, 96, 4, 2, 64), dict(causal=True, window=40)),
    ("unmasked_d32", (2, 77, 77, 4, 4, 32), dict(causal=False)),
    ("offset_window", (1, 40, 300, 4, 2, 64),
     dict(causal=True, q_offset=250, kv_len=290, window=100)),
]


# (name, (b, s, h, kv, d)): the backward at the training shape and at 4096
BWD_CASES = [
    ("train", (8, 1024, 16, 16, 128)),
    ("long_4096", (1, 4096, 16, 16, 128)),
]


def build_variant(name: str, edits) -> tuple[str, dict, dict]:
    """Copy ``csrc/``, apply ``edits``, build both sources: (name,
    {source: library}, {source: compiler output})."""
    from repro_torch.kernels import build

    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(build.CSRC, d)
    for source, old, new in edits:
        path = d / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: edit of {source} does not apply "
                             f"once: {old[:60]!r}")
        path.write_text(text.replace(old, new))
    libs, logs = {}, {}
    for source in SOURCES:
        lib = d / f"lib{Path(source).stem}.so"
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                              str(lib), str(d / source)],
                             capture_output=True, text=True)
        logs[source] = res.stdout + res.stderr
        if res.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed on {source}:\n"
                             f"{res.stderr[-3000:]}")
        libs[source] = lib
    return name, libs, logs


def bind(path: Path, like) -> ctypes.CDLL:
    """Load a variant's library with the C signatures of ``like``'s."""
    lib = ctypes.CDLL(str(path))
    for fn in ("flash_attn_fwd", "flash_attn_error_string", "flash_attn_bwd",
               "flash_attn_bwd_error_string"):
        if hasattr(like, fn):
            getattr(lib, fn).argtypes = getattr(like, fn).argtypes
            getattr(lib, fn).restype = getattr(like, fn).restype
    return lib


def main() -> None:
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import tf32_matmul

    if not torch.cuda.is_available():
        raise SystemExit("k2_fp32_variants.py: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    with ThreadPoolExecutor(len(names) + 2) as ex:
        shipped = [ex.submit(fa.load), ex.submit(fa.load_bwd)]  # signatures
        built = list(ex.map(lambda n: build_variant(n, VARIANTS[n]), names))
        fwd_like, bwd_like = (f.result() for f in shipped)
    libs = {}
    for name, paths, logs in built:
        libs[name] = (bind(paths[SOURCES[0]], fwd_like),
                      bind(paths[SOURCES[1]], bwd_like))
        print(json.dumps({"variant": name, "ptxas": {
            src: {k: v for k, v in chip_smoke.ptxas_report(log).items()
                  if "tf32" in k} for src, log in logs.items()}}),
              flush=True)

    def use(name):
        fa._lib, fa._bwd_lib = libs[name]

    tf32 = functools.partial(fa.plain, matmul=tf32_matmul)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {}
    for cname, (b, sq, sk, h, kv, d), kw in CASES:
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda")
        k = torch.randn((b, sk, kv, d), generator=gen, device="cuda")
        v = torch.randn((b, sk, kv, d), generator=gen, device="cuda")
        want, want_lse = fa.plain(q, k, v, return_lse=True, **kw)
        model = tf32(q, k, v, **kw)
        for name in names:
            use(name)
            got, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            print(json.dumps({
                "variant": name, "kernel": "fwd", "case": cname,
                "max_abs_err": err, "lse_max_abs_err": lse_err,
                "rel_err_plain": ((got - want).norm() / want.norm()).item(),
                "rel_err_model": ((got - model).norm()
                                  / model.norm()).item(),
                "ok": math.isfinite(err) and err <= 1e-4
                and lse_err <= 1e-4}), flush=True)
        del want, want_lse, model
        if cname in ("train", "long_4096"):
            timed[("fwd", cname)] = functools.partial(
                fa.flash_attention_cuda, q, k, v, **kw)
    bwd_model = functools.partial(fa.plain_bwd, matmul=tf32_matmul)
    for cname, (b, s, h, kv, d) in BWD_CASES:
        q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn((b, s, kv, d), generator=gen, device="cuda")
                for _ in range(2))
        o, lse = fa.plain(q, k, v, return_lse=True)
        o = o.contiguous()
        want = fa.plain_bwd(q, k, v, o, lse, do)
        model = bwd_model(q, k, v, o, lse, do)
        for name in names:
            use(name)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            row = {"variant": name, "kernel": "bwd", "case": cname}
            for g_name, g, w, m in zip(("dq", "dk", "dv"), got, want, model):
                row[g_name] = {
                    "max_abs_err_plain": (g - w).abs().max().item()
                    / max(w.abs().max().item(), 1.0),
                    "rel_err_plain": ((g - w).norm() / w.norm()).item(),
                    "max_abs_err_model": (g - m).abs().max().item()
                    / max(m.abs().max().item(), 1.0),
                    "rel_err_model": ((g - m).norm() / m.norm()).item()}
            print(json.dumps(row), flush=True)
            del got
        del want, model
        timed[("bwd", cname)] = functools.partial(
            fa.flash_attention_bwd_cuda, q, k, v, o, lse, do)
    for (kernel, cname), fn in timed.items():
        times = {n: [] for n in names}
        for name in names + names[::-1]:
            use(name)
            times[name].append(chip_smoke.time_ms(fn, 10))
        for name, ts in times.items():
            print(json.dumps({"variant": name, "kernel": kernel,
                              "case": cname, "ms": sum(ts) / len(ts),
                              "turns_ms": ts}), flush=True)
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)


if __name__ == "__main__":
    main()
