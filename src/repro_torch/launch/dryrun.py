"""Dry-run of the port's runtime at the production mesh, on the meta
device (``repro.launch.dryrun`` twin): every (arch x input shape x mesh)
traced without a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # single-pod 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Writes one JSON record per run to ``results/dryrun_torch/``.

**Where it runs.**  The reference compiles each step for 512 placeholder
CPU devices and reads XLA's analyses.  The port simulates every rank in
one process on one device, so the dry-run builds the
:class:`~repro_torch.runtime.step.ChunkedRuntime` at the production mesh
(:func:`~repro_torch.launch.mesh.make_production_mesh`) on the **meta
device** and runs the train, prefill or decode step of
:mod:`repro_torch.runtime.driver` once on meta stores.  Nothing is
allocated on any real device: a meta tensor has a shape, a dtype and no
data.  K1 and K2 take their shape-only branch there
(:mod:`repro_torch.kernels.ops`), which counts each call and its work.

**The trace** runs under one dispatch mode that keeps three counts:

* the products' FLOPs by ``torch.utils.flop_counter.FlopCounterMode``'s
  own formulas (its ``flop_registry``: matrix products and the like;
  elementwise work has no FLOPs there), to which the K2 calls add their
  analytic FLOPs.  One mode instead of ``FlopCounterMode`` beside it: each
  operator then passes through one Python mode, not two (the trace ran
  1.6x faster); the tests hold the count to ``FlopCounterMode``'s;
* each operator's input and output bytes (views and bare allocations move
  none), plus K1's and K2's analytic bytes: an unfused upper bound,
  standing in for XLA's "bytes accessed" of a fused module;
* the live bytes of every storage the trace makes (a weak reference to
  each storage ends its bytes), over the stores already on the device:
  the simulated device's peak.

**One data rank.**  The data ranks are symmetric: each runs the same step
on its own rows.  A 16 x 16 trace of all of them would run 16 times the
same work, so by default the train step runs data rank 0's share alone
(ADAM still updates every shard), and the serving steps one data rank's
rows of the batch.  A device's numbers are then the trace's: the step's
FLOPs and bytes over the tp model ranks the data rank simulates, ADAM's
over every data and model rank's shard, the collectives as
:class:`~repro_torch.models.layers.CollectiveCounter` counts them a
device.  ``simulated_device_bytes`` (what one card simulating every rank
holds) is the larger of ADAM's peak and the step's peak plus the gradient
sums the full simulation keeps beside a later rank's FWD and BWD: one set
over the data ranks of a pod when there are several, and one over the
pods.  ``ranks="all"`` traces every data rank instead (the tests hold the
two against each other at the smoke mesh: FLOPs, ADAM's bytes,
collectives and calls equal, the peak within 10%).

**The record** keeps the reference's keys where they mean the same thing
(``params_total``, ``params_active``, ``per_device_bytes``, ``flops``,
``hbm_bytes``, ``collective_link_bytes``, ``compute_s``, ``memory_s``,
``collective_s``, ``dominant``, ``model_flops_per_device``,
``useful_ratio``, ``collectives`` by kind); ``lower_s`` and ``compile_s``
become one ``trace_s``.  Added: ``simulated_device_bytes``, ``k1_calls``
and ``k2_calls`` (forward and backward) of the traced step, and
``tp_psum_bytes`` (:func:`repro_torch.runtime.driver.build_train_step`).
``per_device_bytes`` is one device's share: the device-resident stores
(param stores and the optimizer state's device part) over tp x dp, and
the rest of the traced data rank's peak (its caches, activations and
gradients) over its tp model ranks.  The simulation computes an
activation that the ranks hold identically once, so that part of the
share undercounts it; the layouts' padding counts in full (a layer's
chunks are padded to a multiple of the data ranks).

**Pricing.**  Compute and HBM at :data:`~repro_torch.analysis.roofline.
H100_SXM`'s datasheet rates; each mesh axis's link bytes at the rate of
:data:`~repro_torch.analysis.roofline.H100_NODES` (NVLink within a node of
eight, the node's network across nodes; datasheet figures): the model axis
of 16 crosses two nodes, so every axis of the production mesh runs at the
network's rate.  These are predictions, not measurements.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# allocations that write nothing: no bytes moved
_ALLOC = {_aten.empty.memory_format, _aten.empty_like.default,
          _aten.empty_strided.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class _Trace(TorchDispatchMode):
    """Each operator's FLOPs (``flops``) and input + output bytes
    (``moved``), and the live bytes of the storages it makes (``peak``
    over ``base``, the bytes of the storages registered before the
    trace)."""

    def __init__(self, resident):
        super().__init__()
        # by part of the step: "step" (FWD and BWD, or a serving step) and
        # "adam" (the optimizer update of every shard)
        self.part = "step"
        self.flops = {"step": 0, "adam": 0}
        self.moved = {"step": 0.0, "adam": 0.0}
        self._known = {}
        self.base = 0
        for t in _tensors(resident):
            st = t.untyped_storage()
            if st._cdata not in self._known:
                self._known[st._cdata] = None
                self.base += st.nbytes()
        self.live = self.base
        self.peaks = {"step": self.base, "adam": self.base}

    def _free(self, key, n):
        self.live -= n
        self._known.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:  # its input's storage: no bytes, nothing new
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops[self.part] += count(*args, **kwargs, out_val=out)
        if func not in _ALLOC:
            self.moved[self.part] += _nbytes((args, kwargs, out))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known[key] = weakref.ref(
                st, lambda _r, k=key, n=n: self._free(k, n))
            self.live += n
            self.peaks[self.part] = max(self.peaks[self.part], self.live)
        return out


def trace(fn, resident, rt=None) -> dict:
    """Run ``fn()`` once under the counters (module docstring).
    ``resident``: the tensors on the device before the step (the
    stores); ``rt``: a runtime whose ADAM is counted apart.  -> by part
    ("step", "adam") the flops (products; K2's in the step) and bytes
    (operators; K2's in the step, K1's in ADAM), ``op_flops`` (the
    products alone), the device's base and peak live bytes, the kernel
    calls, seconds."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    mode = _Trace(resident)
    if rt is not None:
        real = rt.adam_update

        def adam_update(*a, **kw):
            mode.part = "adam"
            try:
                return real(*a, **kw)
            finally:
                mode.part = "step"
        rt.adam_update = adam_update
    try:
        with ops.counting() as kw, mode:
            fn()
    finally:
        if rt is not None:
            del rt.adam_update
    k2_flops = sum(w["flops"] for n, w in kw.work.items() if n != "k1")
    k2_bytes = sum(w["bytes"] for n, w in kw.work.items() if n != "k1")
    k1 = kw.work.get("k1", {"flops": 0.0, "bytes": 0.0})
    return dict(flops={"step": mode.flops["step"] + k2_flops,
                       "adam": mode.flops["adam"] + k1["flops"]},
                bytes={"step": mode.moved["step"] + k2_bytes,
                       "adam": mode.moved["adam"] + k1["bytes"]},
                op_flops=float(sum(mode.flops.values())),
                base_bytes=mode.base, peaks=mode.peaks,
                peak_bytes=max(mode.peaks.values()),
                calls=dict(kw.calls), seconds=time.perf_counter() - t0)


def _meta_stores(rt):
    """Param and optimizer-state stores on meta, as the runtime lays them
    out (no values: a dry-run reads shapes only)."""
    ps = {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
          for k, t in rt.store_specs().items()}
    os_ = {name: {k: {part: torch.empty(t.shape, dtype=t.dtype,
                                        device="meta")
                      for part, t in parts.items()}
                  for k, parts in streams.items()}
           for name, streams in rt.os_specs().items()}
    return ps, os_


def _local_batch(rt, b: int) -> int:
    """One data rank's rows of a batch of ``b`` (the whole batch when the
    data ranks do not divide it: the reference replicates it)."""
    n = rt.ctx.dp * rt.ctx.pods
    return b // n if b % n == 0 else b


def trace_step(rt, shape, *, ranks: str = "one") -> dict:
    """Trace one step of ``shape`` on ``rt`` (a meta runtime): the
    :func:`trace` counts, the collectives a device
    (``{kind: {...}}`` and link bytes by mesh axis), ``tp_psum_bytes``
    for a train step, and the device byte figures of the module
    docstring.  ``ranks``: "one" data rank's share, or "all"."""
    from repro_torch.configs.base import InputShape
    from repro_torch.runtime import driver

    if rt.device.type != "meta":
        raise ValueError(f"a dry-run traces on the meta device, not "
                         f"{rt.device}")
    if ranks not in ("one", "all"):
        raise ValueError(f"ranks={ranks!r}")
    ctx = rt.ctx
    counter = ctx.counter
    ps, os_ = _meta_stores(rt)
    os_dev = [p["dev"] for s in os_.values() for p in s.values()]
    one = ranks == "one"
    extra_sets = 0
    b = shape.global_batch
    if shape.kind == "train":
        step, args, _ = driver.build_train_step(rt, shape)
        batch = {k: v for k, v in args[2].items() if k != "global_tokens"}
        batch["global_tokens"] = float(args[2]["tokens"].numel())
        if one:
            full = rt.batch_shards
            rt.batch_shards = lambda b: [[full(b)[0][0]]]
            extra_sets = int(ctx.dp > 1) + int(ctx.pods > 1)
        out = {}

        def run():
            out["m"] = step(ps, os_, batch, 0)[2]
        try:
            t = trace(run, (ps, os_dev), rt)
        finally:
            if one:
                del rt.batch_shards
        t["tp_psum_bytes"] = out["m"]["collectives"]["tp_psum_bytes"]
    else:
        b = _local_batch(rt, shape.global_batch) if one \
            else shape.global_batch
        local = InputShape(shape.name, shape.seq_len, b, shape.kind)
        counter.reset()
        if shape.kind == "prefill":
            step, (_, bspecs) = driver.build_prefill_step(rt, local)
            batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                     for k, v in bspecs.items()}
            t = trace(lambda: step(ps, batch), ps)
        else:
            step, args = driver.build_decode_step(rt, local)
            caches = args[1]
            token = torch.empty(args[2].shape, dtype=torch.int64,
                                device="meta")
            t = trace(lambda: step(ps, caches, token, shape.seq_len - 1),
                      (ps, caches))
        t["tp_psum_bytes"] = None
    t["collectives"], t["axis_link_bytes"] = counter.per_device()
    nbytes = _nbytes(ps)
    t["store_bytes"] = nbytes + (_nbytes(os_dev) if shape.kind == "train"
                                 else 0)
    if shape.kind == "train":
        # the gradient sums the full simulation holds beside a later
        # rank's FWD and BWD (ADAM runs once, after every rank): a set is
        # the param stores' bytes
        t["simulated_device_bytes"] = max(
            t["peaks"]["adam"], t["peaks"]["step"] + extra_sets * nbytes)
    else:
        # the serving steps run the global batch at once: every data
        # rank's rows beside the traced one's
        t["simulated_device_bytes"] = t["store_bytes"] + (
            t["peak_bytes"] - t["store_bytes"]) * shape.global_batch / b
    # a device's share: the stores over every model and data rank, the
    # rest of the traced data rank's peak (its caches, activations and
    # gradients) over its model ranks
    above = t["peak_bytes"] - t["store_bytes"]
    t["per_device_bytes"] = (t["store_bytes"] / (ctx.tp * ctx.dp)
                             + above / ctx.tp)
    t["ranks_traced"] = 1 if one else ctx.dp * ctx.pods
    return t


def axis_rates(rt) -> dict:
    """Each mesh axis's link rate on :data:`~repro_torch.analysis.roofline.
    H100_NODES`, in rank order (model innermost, then data, then pods)."""
    from repro_torch.analysis.roofline import H100_NODES

    tp, dp = rt.ctx.tp, rt.ctx.dp
    return {"model": H100_NODES.axis_bw(tp, 1),
            "data": H100_NODES.axis_bw(dp, tp),
            "pod": H100_NODES.axis_bw(rt.ctx.pods, tp * dp)}


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool,
               options=None, verbose: bool = True) -> dict:
    """Trace ``arch`` (at full size) on ``shape_name`` at the production
    mesh and return the record of the module docstring."""
    from repro_torch.configs import get_config, model_class
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rt = ChunkedRuntime(model_class(cfg), cfg, mesh,
                        options or RuntimeOptions())
    mesh_name = "x".join(str(n) for n in mesh.shape.values())
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "multi_pod": multi_pod}
    if shape_name not in cfg.supported_shapes():
        return {**head, "status": "skipped",
                "reason": "full-attention arch: long_500k skipped, as the "
                          "reference skips it"}
    if shape.kind == "decode" and not rt.model.supports_decode:
        return {**head, "status": "skipped", "reason": "no decode step"}
    rec = {**head, "status": "ok", **record(rt, shape)}
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] trace "
              f"{rec['trace_s']:.1f} s: flops={rec['flops']:.4g} "
              f"bytes={rec['hbm_bytes']:.4g} per_device="
              f"{rec['per_device_bytes'] / 1e9:.2f} GB simulated="
              f"{rec['simulated_device_bytes'] / 1e9:.2f} GB k2="
              f"{rec['k2_calls']} k1={rec['k1_calls']}")
        print(f"  roofline: compute={rec['compute_s']:.4g}s "
              f"memory={rec['memory_s']:.4g}s collective="
              f"{rec['collective_s']:.4g}s dominant={rec['dominant']} "
              f"useful={rec['useful_ratio']:.3f}")
    return rec


def record(rt, shape, *, ranks: str = "one") -> dict:
    """The dry-run's record of one step of ``shape`` on the meta runtime
    ``rt`` (its mesh and options as given)."""
    from repro_torch.analysis import roofline

    t = trace_step(rt, shape, ranks=ranks)
    n_tot, n_act = roofline.count_params(rt)
    chips = rt.ctx.tp * rt.ctx.dp * rt.ctx.pods
    mf = roofline.model_flops(rt, shape, n_tot, n_act) / chips
    # a device's share: the traced data rank(s) simulate tp model ranks
    # in the step; ADAM updates every data and model rank's shard
    per = t["ranks_traced"] * rt.ctx.tp
    shards = rt.ctx.dp * rt.ctx.tp
    flops = t["flops"]["step"] / per + t["flops"]["adam"] / shards
    hbm = t["bytes"]["step"] / per + t["bytes"]["adam"] / shards
    rl = roofline.analyze(
        flops=flops, hbm_bytes=hbm, collectives=t["collectives"],
        axis_link_bytes=t["axis_link_bytes"], axis_bw=axis_rates(rt),
        model_flops_per_device=mf, memory_stats={})
    calls = t["calls"]
    return {
        "chips": chips, "params_total": n_tot, "params_active": n_act,
        "trace_s": t["seconds"], "ranks_traced": t["ranks_traced"],
        "per_device_bytes": t["per_device_bytes"],
        "simulated_device_bytes": t["simulated_device_bytes"],
        "resident_bytes": t["base_bytes"], "store_bytes": t["store_bytes"],
        "peak_bytes": t["peak_bytes"],
        "flops": rl.flops, "op_flops": t["op_flops"] / per,
        "adam_hbm_bytes": t["bytes"]["adam"] / shards,
        "hbm_bytes": rl.hbm_bytes,
        "collective_link_bytes": rl.collective_link_bytes,
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "collective_s": rl.collective_s, "dominant": rl.dominant,
        "model_flops_per_device": mf, "useful_ratio": rl.useful_ratio,
        "collectives": t["collectives"],
        "axis_link_bytes": t["axis_link_bytes"],
        "k1_calls": calls.get("k1", 0),
        "k2_calls": {"fwd": calls.get("k2_fwd", 0),
                     "bwd": calls.get("k2_bwd", 0)},
        "tp_psum_bytes": t["tp_psum_bytes"],
    }


def main() -> None:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.runtime.step import RuntimeOptions

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--gather-policy", default="layer",
                    choices=["layer", "step"])
    ap.add_argument("--os-host-fraction", type=float, default=0.0)
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    args = ap.parse_args()

    options = RuntimeOptions(gather_policy=args.gather_policy,
                             os_host_fraction=args.os_host_fraction,
                             remat=args.remat)
    archs = [a for a in ARCH_IDS if not a.startswith("gpt2-paper")] \
        if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2pod' if mp else '1pod'}"
                try:
                    rec = dryrun_one(arch, shape, multi_pod=mp,
                                     options=options)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                (outdir / f"{tag}.json").write_text(json.dumps(rec,
                                                               indent=1))
                print(f"{tag}: {rec['status']}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
