#!/usr/bin/env python3
"""How faithfully ``torch.profiler`` records the device work of a span on
one card.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/profile_window.py [markers] [rounds]

* ``markers``: for ``--seconds`` (default 120), one profiled span every
  ~4 s, between which the card runs unprofiled bf16 GEMMs.  Each span
  holds ten marked kernels 50 ms apart, launched after a synchronisation
  and followed by one; spans alternate between tight (no idle time around
  the markers) and padded by 1 s of idle time on each side.  Per span: the
  markers the profile holds and each one's start against the host clock
  just before its launch (a faithful record starts a few us after it).
* ``rounds``: gpt2-paper-1b (20 layers) served by the compiled engine
  under 8 and 2 GiB, prompts 512/512/500/500, ``--tokens`` (default 120)
  new tokens each; every decode round after the graph's capture is
  profiled on its own, as ``chip_smoke.compiled_run`` profiles one, and
  the K2 split-kv kernels it holds are counted against the graph's.

One JSON object a line on standard output, the card's name and power
limit first, a summary line per mode last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def device_starts(prof) -> list[int]:
    """Start (ns, the profiler's clock) of each device event it kept."""
    from torch.autograd import DeviceType

    return sorted(ev.start_ns() for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() == DeviceType.CUDA)


def markers(seconds: float) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.monotonic()
    rows, i = [], 0
    while time.monotonic() - t0 < seconds:
        pad = (0.0, 1.0)[i % 2]
        i += 1
        torch.cuda.synchronize()
        launched = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(10):
                torch.cuda.synchronize()
                launched.append(time.time_ns())
                x.mul_(1.0)
                torch.cuda.synchronize()
                time.sleep(0.05)
            time.sleep(pad)
        starts = device_starts(prof)
        # each kept marker against the launch it lies nearest to
        offsets = [min((s - h for h in launched), key=abs) / 1e3
                   for s in starts]
        row = dict(mode="markers", t_s=time.monotonic() - t0, pad_s=pad,
                   kept=len(starts), offsets_us=offsets)
        rows.append(row)
        emit(row)
        t1 = time.monotonic()
        while time.monotonic() - t1 < 4:
            for _ in range(20):
                a @ a
            torch.cuda.synchronize()
    for pad in (0.0, 1.0):
        mine = [r for r in rows if r["pad_s"] == pad]
        offs = [abs(o) for r in mine for o in r["offsets_us"]]
        emit(dict(mode="markers_summary", pad_s=pad, spans=len(mine),
                  spans_with_every_marker=sum(r["kept"] == 10 for r in mine),
                  spans_with_none=sum(r["kept"] == 0 for r in mine),
                  spans_partial=sum(0 < r["kept"] < 10 for r in mine),
                  max_abs_offset_us=max(offs, default=None)))


def rounds(tokens: int) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import get_config, model_class
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.serve import CompiledServingEngine

    build.build_all([fa.SOURCE, fa.BWD_SOURCE])
    fa.load()
    cfg = get_config("gpt2-paper-1b")
    params = chip_smoke.card_params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (512, 512, 500, 500)]
    census = Counter()
    for gib in (8, 2):
        eng = CompiledServingEngine(
            model_class(cfg), cfg, device="cuda",
            device_memory_bytes=gib * chip_smoke.GIB, max_seq_len=1024,
            policy="opt", prefetch=True, init_params=params)
        for p in prompts:
            eng.submit(p, tokens)
        while True:
            graph = eng.decode_graph
            if graph is None or graph.graph is None:
                if eng.step_round() is None:
                    break
                continue
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                m = eng.step_round()
                torch.cuda.synchronize()
            if m is None:
                break
            seen = chip_smoke.splitkv_calls(prof)
            census[(gib, seen, graph.k2_calls)] += 1
            emit(dict(mode="rounds", budget_gib=gib, splitkv_kept=seen,
                      graph_k2_calls=graph.k2_calls,
                      device_events=len(device_starts(prof))))
        del eng
        torch.cuda.empty_cache()
    emit(dict(mode="rounds_summary", census=[
        dict(budget_gib=g, splitkv_kept=s, graph_k2_calls=k, rounds=n)
        for (g, s, k), n in sorted(census.items())]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("modes", nargs="*", metavar="{markers,rounds}",
                    help="default: both")
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--tokens", type=int, default=120)
    args = ap.parse_args()
    modes = args.modes or ["markers", "rounds"]
    if set(modes) - {"markers", "rounds"}:
        ap.error(f"unknown modes {modes}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_window.py: needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(dict(mode="card", nvidia_smi=card.strip(), torch=torch.__version__))
    for mode in modes:
        {"markers": lambda: markers(args.seconds),
         "rounds": lambda: rounds(args.tokens)}[mode]()


if __name__ == "__main__":
    main()
