"""Compiled serving plane of the port (``repro.runtime.serve`` twin): the
continuous-batching round as one CUDA graph over padded slots.

:class:`CompiledServingEngine` keeps the ENTIRE host-side brain of the
eager :class:`~repro_torch.core.serving.ServingEngine` (admission, the
round's reference sequence, OPT eviction moments, the schedule
prefetcher's staging, the transfer timeline) and replaces only the
compute: one **round decode step** over padded active-sequence slots,
captured on a card as one CUDA graph per padded slot count
(:class:`repro_torch.runtime.driver.RoundDecodeGraph`) and replayed every
round, plus one **cohort prefill** per admission cohort, run eagerly
through a step cached per (padded cohort, prompt length), instead of the
eager engine's per-layer dispatch.  This is the paper's thesis applied to
serving: chunk decisions live on the host between rounds; the device runs
dense, uninterrupted compute.  On the CPU the same step functions run
eagerly through the same keyed caches, so ``decode_compile_count`` and
``prefill_compile_count`` mean the same thing on both devices.

Slot model
----------
Active sequences bind to **padded batch slots** (the lowest free slot).
Slot caches are persistent tensors ``[tp, L, S_slots, C, KV, hd]`` (the
slot axis where a layer cache's batch axis is: zamba's stacked mamba
states are ``[tp, L, shared_interval, S_slots, ...]``; see
:mod:`repro_torch.runtime.step`); the padded slot count grows in powers of
two from 2 and never shrinks, so the decode graph is captured again only
when the concurrency high-water mark crosses a power of two: membership
changes within a padded shape never recapture.  On growth the slot caches
are re-made one size up and the old graph, with its memory pool, is
released.  Slot ``s`` pins its kv pages to the chunk-id range
:func:`~repro_torch.runtime.driver.slot_page_range`, reserved in the kv
stream's :class:`~repro_torch.core.chunk.DynamicChunkMap` at bind time, so
a paged sequence's late pages land on their precomputed ids and default
allocation never collides with a live slot's range.

Round ordering
--------------
Each round runs the decode step over ALL padded slots *before* writing the
round's prefill rows.  Free, stale and newly bound slots decode garbage,
harmlessly: every slot is an independent row, the host ignores their
tokens, and a newly bound slot's row is overwritten by the prefill scatter
before that slot's first real decode.  The graph needs no active mask, so
it does not depend on membership.  Each slot reads its own length from the
card (K2's ``kv_lens``): a graph cannot bake in a host int.

Plan boundary
-------------
The pool is the memory model: payload traffic, OPT eviction, prefetch and
timeline stalls are replayed against the exact op order the plan
registered (:meth:`CompiledServingEngine._replay_round_ops`, the
reference's choreography), while the authoritative cache bytes live in the
slot caches and the params in the runtime's bf16 (param-dtype) stores.  The
pool is the port's real :class:`~repro_torch.core.memory.HeteroMemory`, so
its moves are real copies, timed apart from the compute (the ``compiled``
telemetry track's ``compute`` and ``replay`` spans, and
:attr:`CompiledServingEngine.round_times`).  The decode graph reads only
the param stores, the slot caches and its static inputs, never a pool
payload, so the replay's copies on the pool's copy stream need no event
against it.  Like the reference's, the replay touches one kv page at a
time, where the eager engine pins a decode batch's tail pages together: the
counters equal the eager engine's run with ``max_decode_batch=1`` (and the
same prefill cap), and can differ from a batched eager run by a few
eviction choices, in both packages alike.  Tokens equal the eager
engine's; the eager engine remains the semantics oracle.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.serving import ServeRequest, ServingEngine
from repro_torch.core.state import TensorState
from repro_torch.models.api import flatten_with_paths, unflatten
from repro_torch.models.layers import AxisCtx
from repro_torch.runtime import driver

_MIN_SLOTS = 2  # smallest padded shape (no recapture at 1 -> 2)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class CompiledServingEngine(ServingEngine):
    """Continuous batching with compiled round steps over padded slots."""

    def __init__(self, model_cls, cfg, *, seed: int = 0, init_params=None,
                 **kw):
        if not kw.get("manage_kv", True):
            raise ValueError(
                "CompiledServingEngine serves the managed kv stream; use "
                "the eager ServingEngine for the unmanaged baseline")
        if init_params is None:
            # the base engine's draw: both planes start from identical
            # parameters
            init_params = model_cls(cfg, AxisCtx()).init_params(
                torch.Generator().manual_seed(seed))
        super().__init__(model_cls, cfg, seed=seed, init_params=init_params,
                         **kw)

        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions

        self._rt = ChunkedRuntime(model_cls, cfg,
                                  make_smoke_mesh(1, 1, device=self.device),
                                  RuntimeOptions())
        self._pstores = driver.param_stores(self._rt, init_params)
        # each slot-cache leaf's slot axis: its layer cache's batch axis,
        # behind the leading [tp, L]
        self._slot_axis = {
            g.name: {path: 2 + ax for path, ax in flatten_with_paths(
                driver.cache_batch_axes(g, self.max_seq_len))}
            for g in self._decode_groups}

        # slot <-> request binding (the slot index is also the chunk-id
        # base of its kv pages)
        self._slots: list[int | None] = []
        self._slot_of: dict[int, int] = {}
        self._padded = 0
        self._slot_caches: dict | None = None  # {group: tree [tp, L, S, ..]}
        # step caches: a new step only for a new padded shape
        self._decode_steps: dict[int, object] = {}
        self._prefill_steps: dict[tuple[int, int], object] = {}
        # host clock per round: the decode call (inputs in, tokens read),
        # the prefill calls with their scatter, and the pool replay
        self.round_times: list[dict] = []

    def _place_stem(self, stem):
        """No fp32 copy of the stem on the device: the compiled steps read
        it from the runtime's param stores (``_pstores``), and the eager
        engine's copy would sit unused beside them (37.75 GB at
        nemotron-4-340b's widths).  ``stem_bytes`` is then 0; the stores'
        bytes hold the stem."""
        return {}

    # ------------------------------------------------------------- compiles
    @property
    def decode_compile_count(self) -> int:
        """How many padded slot shapes the round decode step was built
        (on a card: captured) for."""
        return len(self._decode_steps)

    @property
    def prefill_compile_count(self) -> int:
        return len(self._prefill_steps)

    @property
    def padded_slots(self) -> int:
        return self._padded

    @property
    def decode_graph(self):
        """The current padded shape's :class:`~repro_torch.runtime.driver.
        RoundDecodeGraph` on a card (None on the CPU, or before the first
        decode)."""
        step = self._decode_steps.get(self._padded)
        return step if isinstance(step, driver.RoundDecodeGraph) else None

    # ---------------------------------------------------------------- slots
    def _bind_slot(self, rid: int) -> int:
        for s, r in enumerate(self._slots):
            if r is None:
                self._slots[s] = rid
                self._slot_of[rid] = s
                return s
        self._slots.append(rid)
        self._slot_of[rid] = len(self._slots) - 1
        return len(self._slots) - 1

    def _map_request_kv(self, req: ServeRequest) -> None:
        """Bind the request to the lowest free slot and reserve the slot's
        page-id range: every page the sequence will ever map lands at its
        precomputed id, so nothing about the pool layout (or any captured
        shape) depends on WHICH sequences are live."""
        slot = self._bind_slot(req.rid)
        self.kv_mgr.cmap.reserve_ids(driver.slot_page_range(
            slot, self._total_layers, self._pages_per_seq))
        super()._map_request_kv(req)

    def _map_page(self, rid: int, gname: str, layer: int, page: int) -> None:
        cid = driver.slot_page_chunk_id(
            self._slot_of[rid], self._total_layers, self._pages_per_seq,
            self._flat_layer[(gname, layer)], page)
        self.kv_mgr.add_tensor(self._kv_name(rid, gname, layer, page),
                               (self._kv_chunk_elems,), chunk_id=cid)

    def _retire_finished(self) -> int:
        done = [r.rid for r in self._active
                if len(r.generated) >= r.max_new_tokens]
        n = super()._retire_finished()
        for rid in done:
            slot = self._slot_of.pop(rid)
            self._slots[slot] = None  # stale rows overwritten on re-bind
        return n

    def _prefill_batchable(self) -> bool:
        # the cohort prefill keeps every sequence on its own row
        return True

    def _ensure_slot_capacity(self) -> None:
        s = max(_MIN_SLOTS, _next_pow2(len(self._slots)))
        if self._slot_caches is not None and s <= self._padded:
            return
        specs, _ = driver.round_cache_specs(self._rt, s, self.max_seq_len)
        grown = {}
        for gname, tree in specs.items():
            new = {}
            old = (dict(flatten_with_paths(self._slot_caches[gname]))
                   if self._slot_caches is not None else {})
            for path, spec in flatten_with_paths(tree):
                t = torch.zeros(spec.shape, dtype=spec.dtype,
                                device=self.device)
                if path in old:
                    t.narrow(self._slot_axis[gname][path], 0,
                             self._padded).copy_(old[path])
                new[path] = t
            grown[gname] = unflatten(list(new), list(new.values()))
        # the old shape's graph reads the old caches: it is never replayed
        # again, so its pool and buffers go now
        for step in self._decode_steps.values():
            if isinstance(step, driver.RoundDecodeGraph):
                step.release()
        self._slot_caches = grown
        self._padded = s

    # ------------------------------------------------------ compiled phases
    def _compiled_decode(self, decode_reqs) -> None:
        fn = self._decode_steps.get(self._padded)
        if fn is None:
            fn, _ = driver.build_round_decode_step(
                self._rt, self._padded, self.max_seq_len)
            self._decode_steps[self._padded] = fn
        tokens = np.zeros((self._padded, 1), np.int64)
        pos = np.zeros((self._padded,), np.int64)
        for r in decode_reqs:
            s = self._slot_of[r.rid]
            tokens[s, 0] = r.generated[-1]
            pos[s] = r.pos
        toks, self._slot_caches = fn(self._pstores, self._slot_caches,
                                     torch.from_numpy(tokens),
                                     torch.from_numpy(pos))
        toks = toks.tolist()
        for r in decode_reqs:
            r.generated.append(int(toks[self._slot_of[r.rid]]))
            r.pos += 1
            self.total_decode_tokens += 1

    def _compiled_prefill(self, cohort) -> None:
        k = len(cohort)
        sp = int(cohort[0].prompt.size)
        kpad = _next_pow2(k)
        fn = self._prefill_steps.get((kpad, sp))
        if fn is None:
            fn = driver.build_round_prefill_step(self._rt, kpad, sp)
            self._prefill_steps[(kpad, sp)] = fn
        rows = np.stack([r.prompt for r in cohort]
                        + [cohort[0].prompt] * (kpad - k))
        toks, caches = fn(self._pstores, rows)
        # each real row's prefill cache into its slot's row (zeros past
        # the prompt, as the reference pads it to the horizon); padding
        # rows only keep the step's shape a power of two and are dropped
        for gname, tree in caches.items():
            dst = dict(flatten_with_paths(self._slot_caches[gname]))
            for path, src in flatten_with_paths(tree):
                ax = self._slot_axis[gname][path]
                for j, r in enumerate(cohort):
                    row = dst[path].select(ax, self._slot_of[r.rid])[0]
                    part = src.select(ax, j)[0]
                    row.zero_()
                    row[tuple(slice(0, n) for n in part.shape)] = part
        toks = toks.tolist()
        for j, r in enumerate(cohort):
            r.pos = sp
            r.generated.append(int(toks[j]))
            self.total_prefill_tokens += sp

    # --------------------------------------------------------- pool replay
    def _replay_round_ops(self, cohorts, decode_reqs) -> None:
        """Walk the planned op order against the pool: the access/release
        choreography of the eager engine around its compute, one kv page
        at a time, so chunk placement, h2d/d2h traffic, OPT eviction,
        prefetch staging and timeline stalls evolve under the identical
        reference sequence.  Payload contents are not written: the
        authoritative cache bytes live in the slot caches; the pool is the
        placement/traffic model (as it is for the compiled trainer)."""
        for cohort in cohorts:
            for g in self._decode_groups:
                for i in range(g.length):
                    self._begin_op(("param", g.name, i))
                    names = self._group_tensor_names[g.name][i]
                    for n in names:
                        self.params_mgr.access_tensor(n, "device")
                    self._release_layer(names)
                    for req in cohort:
                        self._replay_kv(req, g.name, i)
        if decode_reqs:
            for g in self._decode_groups:
                for i in range(g.length):
                    self._begin_op(("param", g.name, i))
                    names = self._group_tensor_names[g.name][i]
                    for n in names:
                        self.params_mgr.access_tensor(n, "device")
                    # params stay COMPUTE-pinned while the kv chunks
                    # cycle under them, as in the eager sweep
                    for req in decode_reqs:
                        self._replay_kv(req, g.name, i)
                    self._release_layer(names)

    def _replay_kv(self, req: ServeRequest, gname: str, layer: int) -> None:
        for p in range(self._req_pages[req.rid]):
            name = self._kv_name(req.rid, gname, layer, p)
            self._begin_op(("kv", req.rid, gname, layer, p))
            self.kv_mgr.access_tensor(name, "device")
            self.kv_mgr.release_tensor(name, TensorState.HOLD)

    # ----------------------------------------------------------- the round
    def _execute_round(self, cohorts, batches) -> None:
        """Compiled round: decode ALL padded slots from their pre-prefill
        caches (one graph replay on a card), then prefill this round's
        admission cohorts and scatter their rows, then replay the plan
        against the pool.  The compute order differs from the plan's
        (prefill-first) op order on purpose: the plan order only drives
        the memory model, and decoding before the prefill scatter is what
        makes free-slot garbage harmless."""
        self._ensure_slot_capacity()
        decode_reqs = [r for b in batches for r in b]
        tel = self.pool.telemetry
        track = self.tenant.qualify("compiled")
        rank = self.pool.telemetry_rank
        if tel is not None:
            # two phases a round: the compute (decode + prefill) and the
            # pool replay, where every move/eviction event is emitted
            tel.begin_span(track, "compute", ts=self.pool._now(),
                           tenant=self.tenant.name, rank=rank)
        t0 = time.perf_counter()
        if decode_reqs:
            self._compiled_decode(decode_reqs)
        t1 = time.perf_counter()
        for cohort in cohorts:
            self._compiled_prefill(cohort)
        t2 = time.perf_counter()
        if tel is not None:
            tel.switch_span(track, "replay", ts=self.pool._now(),
                            tenant=self.tenant.name, rank=rank)
        self._replay_round_ops(cohorts, decode_reqs)
        if self.device.type == "cuda":
            # the replay's copies are queued on the pool's streams: end
            # its span when they are done
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        if tel is not None:
            tel.close_span(track, ts=self.pool._now(), rank=rank)
        self.round_times.append(dict(decode_s=t1 - t0, prefill_s=t2 - t1,
                                     replay_s=t3 - t2))
