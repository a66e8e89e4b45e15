"""State init, batch specs and the train step of the port's runtime
(``repro.runtime.driver`` twin).

The reference wraps the runtime's local step in ``shard_map`` and ``jit``
with explicit shardings, ``pinned_host`` memory kinds for the
host-resident optimizer-state groups.  The port places its stores by
hand: param stores and the device parts of the optimizer state on the
runtime's device, the host parts in pinned CPU memory when that device is
a card (in plain CPU memory otherwise, as the reference's CPU backend
keeps them).

The serving half builds the runtime's serving steps
(:meth:`~repro_torch.runtime.step.ChunkedRuntime.prefill_step_fn` and the
rest) over shapes the reference's specs name, and the compiled serving
round's :func:`build_round_decode_step`: on a card, one CUDA graph per
padded slot count (:class:`RoundDecodeGraph`), where the reference has one
``jit`` entry per padded shape; on the CPU the same step runs eagerly, so
the compile counts mean the same thing on both devices.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.analysis.costmodel import analyze_pair
from repro_torch.core import zero
from repro_torch.core.engine import to_device_batch
from repro_torch.models.api import _stack, flatten_with_paths, tree_map, \
    unflatten
from repro_torch.models.tp import join_ranks, split_for_tp
from repro_torch.runtime.step import STREAMS, ChunkedRuntime


# the batch inputs whose shape a step checks: the tokens, and the stub
# frontends' embeddings of the audio and vlm families
MODALITY_INPUTS = ("tokens", "frames", "patch_embeds")


def _frames_spec(rt: ChunkedRuntime, b: int, frames: int):
    """The stub audio frontend's frame embeddings [B, frames,
    frontend_dim], fp32, split along the tokens' batch axes."""
    return (torch.empty((b, frames, rt.cfg.frontend_dim),
                        dtype=torch.float32, device="meta"),
            (_batch_axes(rt, b), None, None))


def _patches_spec(rt: ChunkedRuntime, b: int):
    """The stub vision frontend's patch embeddings [B, num_patches,
    vision_dim], fp32, split along the tokens' batch axes."""
    return (torch.empty((b, rt.cfg.num_patches, rt.cfg.vision_dim),
                        dtype=torch.float32, device="meta"),
            (_batch_axes(rt, b), None, None))


def _text_len(rt: ChunkedRuntime, s: int) -> int:
    """Token positions of a sequence of ``s``: for the vlm family the
    ``num_patches`` patch positions lead and the text takes the rest."""
    if rt.cfg.arch_type != "vlm":
        return s
    if s <= rt.cfg.num_patches:
        raise ValueError(f"sequence {s} leaves no text after "
                         f"{rt.cfg.num_patches} patches")
    return s - rt.cfg.num_patches


def train_batch_specs(rt: ChunkedRuntime, shape):
    """-> (specs, pspecs, n_tokens): the batch's shapes and dtypes (meta
    tensors), the axes each dim shards over, and the global token count.
    Tokens and labels, and for the audio family the frame embeddings of
    ``min(encoder_frames, S)`` frames, as the reference's; for the vlm
    family the ``num_patches`` patch embeddings, with tokens, labels and
    the count over the ``S - num_patches`` text positions.  The batch
    shards over the data ranks when they divide it, and is replicated
    otherwise (the reference's ``batch_axes``): every rank then runs the
    whole batch, and the losses and gradients sum over the ranks as
    usual."""
    b, s = shape.global_batch, shape.seq_len
    st = _text_len(rt, s)
    ba = _batch_axes(rt, b)
    tok = torch.empty((b, st), dtype=torch.int64, device="meta")
    specs = {"tokens": tok, "labels": tok,
             "global_tokens": torch.empty((), dtype=torch.float32,
                                          device="meta")}
    pspecs = {"tokens": (ba, None), "labels": (ba, None),
              "global_tokens": ()}
    if rt.cfg.arch_type == "audio":
        specs["frames"], pspecs["frames"] = _frames_spec(
            rt, b, min(rt.cfg.encoder_frames, s))
    if rt.cfg.arch_type == "vlm":
        specs["patch_embeds"], pspecs["patch_embeds"] = _patches_spec(rt, b)
    return specs, pspecs, float(b * st)


def _host_part(t: torch.Tensor, rt: ChunkedRuntime,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """A contiguous copy of ``t`` where the runtime keeps host-resident
    optimizer state: pinned CPU memory on a card, CPU memory on the CPU,
    the meta device for a meta runtime (a dry-run allocates nothing)."""
    if rt.device.type == "meta":
        return torch.empty(t.shape, dtype=dtype or t.dtype, device="meta")
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
    collective bytes a rank would move: the chunks' (:meth:`ChunkedRuntime.
    collective_bytes`), ``tp_bytes``, the model axis's activation psums
    for ``shape`` as the reference's cost model counts them (0 at tp=1),
    and ``tp_psum_bytes`` (the port's own field): ``tp_bytes`` plus the
    link bytes a device moved in this step's reductions that the
    reference does not make, counted as they ran
    (:class:`~repro_torch.models.layers.CollectiveCounter`: the gated
    norm's psum of Mamba2 and mLSTM, each pass).
    With ``timed``, the step also reports ``fwd_bwd_s`` and ``adam_s``,
    each ended by a device synchronise."""
    local = rt.train_step_fn(timed=timed)
    coll = {**rt.collective_bytes(), "tp_bytes": analyze_pair(
        rt.cfg, shape, dp=rt.ctx.dp, tp=rt.ctx.tp, pods=rt.ctx.pods,
        remat=rt.opt.remat,
        ep_combine_first=rt.opt.moe_combine_first).tp_bytes}
    bspecs, _, _ = train_batch_specs(rt, shape)
    want = {key: tuple(bspecs[key].shape) for key in MODALITY_INPUTS
            if key in bspecs}

    def step(pstores, osstores, batch, step_idx):
        batch = to_device_batch(batch, rt.device)
        for key, shp in want.items():
            if tuple(batch[key].shape) != shp:
                raise ValueError(f"batch {key} {tuple(batch[key].shape)}, "
                                 f"the step was built for {shp}")
        counter = rt.ctx.counter
        counter.reset()
        pstores, osstores, metrics = local(pstores, osstores, batch,
                                           step_idx)
        extra = counter.extra_link_bytes / max(counter.ranks, 1)
        return pstores, osstores, {**metrics, "collectives": dict(
            coll, tp_psum_bytes=coll["tp_bytes"] + extra)}

    args = (rt.store_specs(), rt.os_specs(), bspecs,
            torch.empty((), dtype=torch.int32, device="meta"))
    dev = rt.device
    placement = {"param": dev, "os_dev": dev,
                 "os_host": {"cuda": "pinned cpu", "meta": "meta"}.get(
                     dev.type, "cpu")}
    return step, args, placement


def param_stores(rt: ChunkedRuntime, params) -> dict:
    """The param chunk stores of a global (tp=1) param tree, on the
    runtime's device: ``{"stem": [tp, G, p, S], group: [tp, L, G, p,
    S]}`` in the param dtype, model rank r's slot holding its
    :func:`~repro_torch.models.tp.split_for_tp` shard."""
    dev, tp = rt.device, rt.ctx.tp
    axes = rt.tp_axes
    pstores = {name: torch.empty(rt.store_shape(name), dtype=lay.dtype,
                                 device=dev)
               for name, lay in rt.layouts.items()}
    for r in range(tp):
        zero.flatten_to_store(
            rt.layouts["stem"], split_for_tp(params["stem"], axes["stem"],
                                             tp, r),
            out=pstores["stem"][r])
    for g in rt.model.groups():
        lay, stacked = rt.layouts[g.name], params["groups"][g.name]
        store = pstores[g.name]
        for r in range(tp):
            local = split_for_tp(stacked, axes["groups"][g.name], tp, r,
                                 shift=1)
            for i in range(g.length):
                zero.flatten_to_store(
                    lay, tree_map(lambda t, _i=i: t[_i], local),
                    out=store[r, i])
    return pstores


def global_params(rt: ChunkedRuntime, stores) -> dict:
    """The inverse of :func:`param_stores`: ``[tp, ...]`` stores of the
    runtime's layouts (the params, or an optimizer-state stream with its
    parts merged) -> the global (tp=1) tree ``{"stem": ..., "groups":
    {name: [L, ...]}}`` in the stores' dtype: each sharded leaf's ranks
    joined by the model's split rule (:func:`~repro_torch.models.tp.
    join_ranks`; a padded vocab keeps its padding rows), each replicated
    leaf rank 0's copy."""
    def tree(name, ranks):
        pairs = [flatten_with_paths(zero.unflatten_from_flat(
            rt.layouts[name], zero.gather_store(s))) for s in ranks]
        axes = [a for _, a in flatten_with_paths(rt._axes(name))]
        return unflatten([p for p, _ in pairs[0]], [
            pairs[0][i][1] if a is None
            else join_ranks([pr[i][1] for pr in pairs], a)
            for i, a in enumerate(axes)])

    return {"stem": tree("stem", list(stores["stem"])),
            "groups": {g.name: _stack([tree(g.name, list(
                stores[g.name][:, i])) for i in range(g.length)])
                for g in rt.model.groups()}}


def init_state(rt: ChunkedRuntime, seed: int = 0, *, params=None):
    """Materialise the param and optimizer-state chunk stores.

    ``params``, the model's GLOBAL (tp=1) param tree (e.g. from the
    reference through ``params_from_jax``), defaults to the tp=1 model's
    ``init_params`` drawn from ``seed``, so every tp starts from the same
    weights; each model rank's store holds its shard of it.  As in the
    reference, the fp32 master weights are the param store read as fp32
    (not the fp32 init), and m, v start at zero."""
    if params is None:
        model = rt.model if rt.ctx.tp == 1 else type(rt.model)(
            rt.cfg, dataclasses.replace(rt.ctx, tp=1))
        params = model.init_params(torch.Generator().manual_seed(seed))
    dev = rt.device
    pstores = param_stores(rt, params)
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _batch_axes(rt: ChunkedRuntime, b: int):
    """The axes a batch of ``b`` shards over (the reference's
    ``batch_axes``): ``(pod, data)`` when both divide it, else ``data``
    when the data ranks do, else none (replicated)."""
    pods, dp = rt.ctx.pods, rt.ctx.dp
    axes = []
    if pods > 1 and b % (pods * dp) == 0:
        axes.append("pod")
    if dp > 1 and b % ((pods if axes else 1) * dp) == 0:
        axes.append("data")
    return tuple(axes) or None


def _cache_groups(rt: ChunkedRuntime):
    return [g for g in rt.model.groups()
            if g.init_cache is not None and g.decode is not None]


def cache_batch_axes(g, horizon: int):
    """Each leaf of one layer's decode cache -> its batch axis: the one
    axis that grows when the cache is built for two sequences instead of
    one.  It leads for attention caches; zamba's unit cache stacks its
    mamba layers' states ahead of it (``[shared_interval, B, ...]``)."""
    one = flatten_with_paths(g.init_cache(1, horizon, device="meta"))
    two = flatten_with_paths(g.init_cache(2, horizon, device="meta"))
    axes = []
    for (path, a), (_, b) in zip(one, two):
        diff = [i for i, (m, n) in enumerate(zip(a.shape, b.shape))
                if m != n]
        if len(diff) != 1:
            raise ValueError(f"group {g.name}: cache leaf {path} has no "
                             f"single batch axis ({tuple(a.shape)} vs "
                             f"{tuple(b.shape)})")
        axes.append(diff[0])
    return unflatten([p for p, _ in one], axes)


def cache_specs(rt: ChunkedRuntime, shape):
    """Decode caches' shapes and dtypes (meta tensors) and the axes each
    dim shards over: ``{group: tree of [tp, L, <one layer's cache>]}``;
    tp over ``model``, the batch axis (:func:`cache_batch_axes`) over the
    data ranks."""
    b, s = shape.global_batch, shape.seq_len
    ba = _batch_axes(rt, b)
    specs, pspecs = {}, {}
    for g in _cache_groups(rt):
        one = g.init_cache(b, s, device="meta")
        lead = (rt.ctx.tp, g.length)
        specs[g.name] = tree_map(
            lambda t: torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                                  device="meta"), one)
        pairs = flatten_with_paths(one)
        axes = [a for _, a in flatten_with_paths(cache_batch_axes(g, s))]
        pspecs[g.name] = unflatten([p for p, _ in pairs], [
            ("model", None) + tuple(ba if i == ax else None
                                    for i in range(t.ndim))
            for (_, t), ax in zip(pairs, axes)])
    return specs, pspecs


def decode_input_specs(rt: ChunkedRuntime, shape) -> dict:
    """(spec, axes) of the decode step's token, position and caches."""
    b = shape.global_batch
    caches, cache_ps = cache_specs(rt, shape)
    return {
        "token": (torch.empty((b, 1), dtype=torch.int64, device="meta"),
                  (_batch_axes(rt, b), None)),
        "pos": (torch.empty((), dtype=torch.int32, device="meta"), ()),
        "caches": (caches, cache_ps),
    }


def _tokens(x, device) -> torch.Tensor:
    """Token ids (numpy or a tensor) as int64 on ``device`` (an array is
    copied: it may be read-only, as one from ``np.asarray`` of a JAX
    array is)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x, dtype=np.int64))
    return t.to(device=device, dtype=torch.int64)


def build_prefill_step(rt: ChunkedRuntime, shape):
    """-> (step, (store specs, batch specs)).  ``step(pstores, batch)
    -> (logits [B, 1, V], caches [tp, L, B, S, ...])``; ``batch["tokens"]``
    is [B, S] (numpy or a tensor), and for the audio family
    ``batch["frames"]`` the [B, min(encoder_frames, 1500), frontend_dim]
    frame embeddings, as the reference's.  For the vlm family ``S``
    counts the ``num_patches`` patch positions too: ``batch["tokens"]``
    is [B, S - num_patches] beside ``batch["patch_embeds"]`` [B,
    num_patches, vision_dim], and the caches hold all S positions."""
    local = rt.prefill_step_fn()
    b, s = shape.global_batch, shape.seq_len
    st = _text_len(rt, s)
    bspecs = {"tokens": torch.empty((b, st), dtype=torch.int64,
                                    device="meta")}
    if rt.cfg.arch_type == "audio":
        bspecs["frames"] = _frames_spec(
            rt, b, min(rt.cfg.encoder_frames, 1500))[0]
    if rt.cfg.arch_type == "vlm":
        bspecs["patch_embeds"] = _patches_spec(rt, b)[0]

    def step(pstores, batch):
        tokens = _tokens(batch["tokens"], rt.device)
        if tuple(tokens.shape) != (b, st):
            raise ValueError(f"tokens {tuple(tokens.shape)}, the step was "
                             f"built for {(b, st)}")
        inputs = {"tokens": tokens}
        for key in MODALITY_INPUTS[1:]:
            if key not in bspecs:
                continue
            t = to_device_batch({key: batch[key]}, rt.device)[key]
            if tuple(t.shape) != tuple(bspecs[key].shape):
                raise ValueError(f"{key} {tuple(t.shape)}, the step was "
                                 f"built for {tuple(bspecs[key].shape)}")
            inputs[key] = t
        return local(pstores, inputs)

    return step, (rt.store_specs(), bspecs)


def build_decode_step(rt: ChunkedRuntime, shape):
    """-> (step, arg specs).  ``step(pstores, caches, token [B, 1], pos)
    -> (next tokens [B], new caches)``."""
    local = rt.decode_step_fn()
    di = decode_input_specs(rt, shape)

    def step(pstores, caches, token, pos):
        return local(pstores, caches, _tokens(token, rt.device), int(pos))

    args = (rt.store_specs(), di["caches"][0], di["token"][0], di["pos"][0])
    return step, args


def round_cache_specs(rt: ChunkedRuntime, slots: int, horizon: int):
    """Slot caches' shapes and dtypes (meta tensors) and axes for the
    compiled serving round: ``{group: tree of [tp, L, <one layer's cache
    with S_slots at its batch axis>]}`` — ``[tp, L, S_slots, C, KV, hd]``
    for attention, ``[tp, L, shared_interval, S_slots, ...]`` for zamba's
    stacked mamba states — so a layer's slice is a batched cache whose
    row s is slot s's sequence (see :mod:`repro_torch.runtime.step`).  The
    slot axis is replicated: serving runs host-driven, on one device."""
    specs, pspecs = {}, {}
    for g in _cache_groups(rt):
        pairs = flatten_with_paths(g.init_cache(1, horizon, device="meta"))
        axes = [a for _, a in flatten_with_paths(
            cache_batch_axes(g, horizon))]
        lead = (rt.ctx.tp, g.length)
        paths = [p for p, _ in pairs]
        specs[g.name] = unflatten(paths, [
            torch.empty(lead + tuple(slots if i == ax else n
                                     for i, n in enumerate(t.shape)),
                        dtype=t.dtype, device="meta")
            for (_, t), ax in zip(pairs, axes)])
        pspecs[g.name] = unflatten(paths, [
            ("model", None) + (None,) * t.ndim for _, t in pairs])
    return specs, pspecs


class RoundDecodeGraph:
    """The compiled round's decode step on a card: one CUDA graph for one
    padded slot count, over static input buffers (``tokens [S, 1]``,
    ``pos [S]``) and the persistent slot caches and param stores it was
    captured against.

    The first call copies its inputs into the static buffers and runs the
    step once, eagerly, on a side stream: that is both the warm-up the
    capture needs (lazy initialisation, no allocation inside capture) and
    this round's decode, whose in-place cache writes are exactly one
    decode's.  Then the step is captured, which runs nothing.  Every later
    call copies its inputs and replays the graph.  A capture that fails
    raises; nothing falls back to the eager step.

    K2 forward calls recorded into the graph count in
    ``flash_attention.captured``, not ``launches``: :attr:`k2_calls` is
    their number, :attr:`replays` the replays so far (each launches them
    all), and :attr:`device_ms` the device time of each replay (CUDA
    events around it)."""

    def __init__(self, step, slots: int, device: torch.device):
        self._step = step
        self.device = device
        self.tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                  device=device)
        self.pos = torch.zeros((slots,), dtype=torch.int64, device=device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None
        self.k2_calls = 0
        self.replays = 0
        self.warmup_s = 0.0  # host clock: the eager first call + capture
        self._events: list = []

    def __call__(self, pstores, caches, tokens, pos):
        self.tokens.copy_(tokens)
        self.pos.copy_(pos)
        if self.graph is None:
            return self._capture(pstores, caches), caches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self._events.append((start, end))
        self.replays += 1
        return self.out, caches

    def _capture(self, pstores, caches):
        from repro_torch.kernels import flash_attention as fa

        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first, _ = self._step(pstores, caches, self.tokens, self.pos)
        cur.wait_stream(side)
        first.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        before = fa.captured
        with torch.cuda.graph(graph):
            self.out, _ = self._step(pstores, caches, self.tokens, self.pos)
        self.k2_calls = fa.captured - before
        self.graph = graph
        self.warmup_s = time.perf_counter() - t0
        return first

    @property
    def device_ms(self) -> list[float]:
        """Device ms of each replay so far (synchronises)."""
        torch.cuda.synchronize(self.device)
        return [s.elapsed_time(e) for s, e in self._events]

    def release(self) -> None:
        """Drop the graph, its memory pool and the static buffers (the
        slot count grew: this shape is never replayed again)."""
        self.graph = self.out = self.tokens = self.pos = None


def build_round_decode_step(rt: ChunkedRuntime, slots: int, horizon: int):
    """-> (round decode step, slot-cache specs).

    ``step(pstores, caches, tokens [S, 1], pos [S]) -> (tokens [S],
    caches)``: ONE call advances every padded slot from its own position,
    updating the slot caches in place.  On a card the step is a
    :class:`RoundDecodeGraph` (captured at its first call); on the CPU the
    same step function runs eagerly.  One step serves one padded slot
    count (and horizon): membership changes within it never rebuild it."""
    local = rt.round_decode_step_fn()
    specs, _ = round_cache_specs(rt, slots, horizon)
    if rt.device.type == "cuda":
        return RoundDecodeGraph(local, slots, rt.device), specs

    def step(pstores, caches, tokens, pos):
        return local(pstores, caches, _tokens(tokens, rt.device),
                     _tokens(pos, rt.device))

    return step, specs


def build_round_prefill_step(rt: ChunkedRuntime, cohort: int,
                             prompt_len: int):
    """-> cohort prefill: ``step(pstores, tokens [K, S_prompt]) -> (first
    tokens [K], caches [tp, L, K, S_prompt, ...])``.  One step serves one
    (padded cohort, prompt length); it runs eagerly on either device."""
    local = rt.round_prefill_step_fn()

    def step(pstores, tokens):
        tokens = _tokens(tokens, rt.device)
        if tuple(tokens.shape) != (cohort, prompt_len):
            raise ValueError(f"tokens {tuple(tokens.shape)}, the step was "
                             f"built for {(cohort, prompt_len)}")
        return local(pstores, tokens)

    return step


def slot_page_range(slot: int, total_layers: int,
                    pages_per_slot: int) -> range:
    """Chunk-id range padded batch slot ``slot`` pins its kv pages into:
    ``pages_per_slot`` ids per flattened layer, slots laid out
    contiguously.  With one page per slot (unpaged horizon) this is
    ``[slot*total_layers, (slot+1)*total_layers)``."""
    w = total_layers * pages_per_slot
    return range(slot * w, (slot + 1) * w)


def slot_page_chunk_id(slot: int, total_layers: int, pages_per_slot: int,
                       flat_layer: int, page: int) -> int:
    """Chunk id of one (slot, layer, page) kv tensor inside
    :func:`slot_page_range`: layer-major, page-minor, so a layer's pages
    are contiguous."""
    return (slot * total_layers * pages_per_slot
            + flat_layer * pages_per_slot + page)


def init_caches(rt: ChunkedRuntime, shape) -> dict:
    """Zero-filled decode caches ``[tp, L, B, C, ...]`` on the runtime's
    device (whisper's cross cache at its fixed ``encoder_frames`` rows)."""
    specs, _ = cache_specs(rt, shape)
    return {name: tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                 device=rt.device), tree)
            for name, tree in specs.items()}


def grow_caches(rt: ChunkedRuntime, caches, prefill_len: int, horizon: int,
                decode_shape) -> dict:
    """Pad prefill-emitted caches to a decode horizon (zeros past each
    leaf's current extent).  Shrinking raises.  Lengths count every cached
    position: for the vlm family the patches' and the text's.  Whisper's
    cross cache
    holds ``encoder_frames`` rows at every horizon (its prefill reads
    ``min(encoder_frames, 1500)`` frames, all of them at the shipped
    configs), so it passes through as it is."""
    target, _ = cache_specs(rt, decode_shape)

    def pad(cur, tgt):
        if tuple(cur.shape) == tuple(tgt.shape):
            return cur
        if cur.ndim != tgt.ndim or any(
                a > b for a, b in zip(cur.shape, tgt.shape)):
            raise ValueError(f"cannot grow cache {tuple(cur.shape)} -> "
                             f"{tuple(tgt.shape)}")
        out = torch.zeros(tgt.shape, dtype=cur.dtype, device=cur.device)
        out[tuple(slice(0, n) for n in cur.shape)] = cur
        return out

    out = {}
    for name, tree in caches.items():
        cur = flatten_with_paths(tree)
        tgt = [t for _, t in flatten_with_paths(target[name])]
        out[name] = unflatten([p for p, _ in cur],
                              [pad(c, t) for (_, c), t in zip(cur, tgt)])
    return out
