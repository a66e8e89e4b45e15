"""State init, batch specs and the train step of the port's runtime
(``repro.runtime.driver`` twin).

The reference wraps the runtime's local step in ``shard_map`` and ``jit``
with explicit shardings, ``pinned_host`` memory kinds for the
host-resident optimizer-state groups.  The port places its stores by
hand: param stores and the device parts of the optimizer state on the
runtime's device, the host parts in pinned CPU memory when that device is
a card (in plain CPU memory otherwise, as the reference's CPU backend
keeps them).
"""

from __future__ import annotations

import torch

from repro_torch.core import zero
from repro_torch.core.engine import to_device_batch
from repro_torch.models.api import tree_map
from repro_torch.runtime.step import STREAMS, ChunkedRuntime


def train_batch_specs(rt: ChunkedRuntime, shape):
    """-> (specs, pspecs, n_tokens): the batch's shapes and dtypes (meta
    tensors), the axes each dim shards over, and the global token count.
    Dense language models only (the port's model zoo).  The batch shards
    over the data ranks; the reference replicates one that does not
    divide, the port refuses it."""
    cfg = rt.cfg
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"arch_type {cfg.arch_type!r} is not "
                                  f"ported yet")
    b, s = shape.global_batch, shape.seq_len
    if b % rt.ctx.dp:
        raise ValueError(f"the global batch {b} must divide over the "
                         f"{rt.ctx.dp} data ranks")
    ba = ("data",) if rt.ctx.dp > 1 else None
    tok = torch.empty((b, s), dtype=torch.int64, device="meta")
    specs = {"tokens": tok, "labels": tok,
             "global_tokens": torch.empty((), dtype=torch.float32,
                                          device="meta")}
    pspecs = {"tokens": (ba, None), "labels": (ba, None),
              "global_tokens": ()}
    return specs, pspecs, float(b * s)


def _host_part(t: torch.Tensor, rt: ChunkedRuntime,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """A contiguous copy of ``t`` where the runtime keeps host-resident
    optimizer state: pinned CPU memory on a card, CPU memory otherwise."""
    out = torch.empty(t.shape, dtype=dtype or t.dtype,
                      pin_memory=rt.device.type == "cuda")
    return out.copy_(t)


def _dev_part(t: torch.Tensor, rt: ChunkedRuntime,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """A contiguous copy of ``t`` on the runtime's device."""
    return torch.empty(t.shape, dtype=dtype or t.dtype,
                       device=rt.device).copy_(t)


def place_state(rt: ChunkedRuntime, pstores: dict, osstores: dict):
    """Put stores (e.g. read from a checkpoint or converted from the
    reference) where the runtime keeps them; every part becomes its own
    contiguous tensor."""
    p = {name: _dev_part(t, rt) for name, t in pstores.items()}
    os_ = {name: {k: {"dev": _dev_part(parts[k]["dev"], rt),
                      "host": _host_part(parts[k]["host"], rt)}
                  for k in STREAMS}
           for name, parts in osstores.items()}
    _check_shapes(rt, p, os_)
    return p, os_


def _check_shapes(rt, pstores, osstores) -> None:
    for name in rt.layouts:
        want = rt.store_shape(name)
        if tuple(pstores[name].shape) != want:
            raise ValueError(f"param store {name}: shape "
                             f"{tuple(pstores[name].shape)}, layout {want}")
        for part, n in zip(("dev", "host"), rt.os_split(name)):
            for k in STREAMS:
                got = tuple(osstores[name][k][part].shape)
                if got != rt.store_shape(name, n):
                    raise ValueError(f"os store {name}/{k}/{part}: shape "
                                     f"{got}, layout "
                                     f"{rt.store_shape(name, n)}")


def build_train_step(rt: ChunkedRuntime, shape, *, timed: bool = False):
    """-> (step, arg specs, placement).

    ``step(pstores, osstores, batch, step_idx) -> (pstores, osstores,
    metrics)`` updates the stores in place.  ``batch`` is a dict of numpy
    arrays or tensors of ``shape``'s global batch (as ``make_batch_fn``
    gives it).  ``metrics``: ``loss`` and ``aux_loss`` (0-d tensors),
    the h2d/d2h bytes of the host-resident optimizer state, and the
    collective bytes a rank would move (:meth:`ChunkedRuntime.
    collective_bytes`).  With ``timed``, the step also reports
    ``fwd_bwd_s`` and ``adam_s``, each ended by a device synchronise."""
    local = rt.train_step_fn(timed=timed)
    bspecs, _, _ = train_batch_specs(rt, shape)
    want = tuple(bspecs["tokens"].shape)

    def step(pstores, osstores, batch, step_idx):
        batch = to_device_batch(batch, rt.device)
        if tuple(batch["tokens"].shape) != want:
            raise ValueError(f"batch tokens {tuple(batch['tokens'].shape)},"
                             f" the step was built for {want}")
        return local(pstores, osstores, batch, step_idx)

    args = (rt.store_specs(), rt.os_specs(), bspecs,
            torch.empty((), dtype=torch.int32, device="meta"))
    dev = rt.device
    placement = {"param": dev, "os_dev": dev,
                 "os_host": "pinned cpu" if dev.type == "cuda" else "cpu"}
    return step, args, placement


def init_state(rt: ChunkedRuntime, seed: int = 0, *, params=None):
    """Materialise the param and optimizer-state chunk stores.

    ``params`` (the model's param tree, e.g. from the reference through
    ``params_from_jax``) defaults to ``rt.model.init_params`` drawn from
    ``seed``.  As in the reference, the fp32 master weights are the param
    store read as fp32 (not the fp32 init), and m, v start at zero."""
    if params is None:
        params = rt.model.init_params(torch.Generator().manual_seed(seed))
    dev = rt.device
    pstores = {"stem": zero.flatten_to_store(
        rt.layouts["stem"], params["stem"], device=dev)[None]}
    for g in rt.model.groups():
        lay, stacked = rt.layouts[g.name], params["groups"][g.name]
        store = torch.empty(rt.store_shape(g.name)[1:], dtype=lay.dtype,
                            device=dev)
        for i in range(g.length):
            store[i] = zero.flatten_to_store(
                lay, tree_map(lambda t, _i=i: t[_i], stacked), device=dev)
        pstores[g.name] = store[None]
    osstores = {}
    for name, p in pstores.items():
        dev_g, _ = rt.os_split(name)
        head, tail = zero.split_groups(p, dev_g)
        f32 = torch.float32
        osstores[name] = {
            "p32": {"dev": _dev_part(head, rt, f32),
                    "host": _host_part(tail, rt, f32)},
            "m": {"dev": torch.zeros(head.shape, device=dev),
                  "host": _host_part(torch.zeros(tail.shape), rt)},
            "v": {"dev": torch.zeros(head.shape, device=dev),
                  "host": _host_part(torch.zeros(tail.shape), rt)},
        }
    return pstores, osstores
