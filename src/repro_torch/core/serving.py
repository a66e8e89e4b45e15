"""Chunk-managed serving plane of the port: the KV cache as a managed
stream with continuous batching, over a pool whose device tier is real.

This is ``repro.core.serving.ServingEngine`` on PyTorch.  Both kinds of
serving state live in one :class:`~repro_torch.core.memory.HeteroMemory`
pool:

  * **params** — the chunk stream, read-only here.  The stem (embedding
    / LM head, final norm) stays outside chunk management, as in the
    reference: it is copied to the engine's device once at construction,
    outside the pool budget (as fp32 — its values are the param dtype's,
    so every product is the reference's);
  * **kv** — the dynamically populated stream: each admitted sequence
    owns one chunk per (block-group, layer, page), mapped at admission
    and unmapped at completion.  A fresh chunk's first access zero-fills,
    which is exactly an empty decode cache.

Each round plans its exact (moment, stream, chunk) reference sequence as
the OPT eviction future and the prefetcher's queue, then executes it
layer-major; the plan, the counters, the victims and the OOM points are
the reference's exactly (the parity tests compare them per round).
What differs is that the bytes are real and stay on the device: layer
params are tensor views into chunk payloads, caches are loaded and
stored with device-side copies, and the only host read of a round is the
greedy token ids.  On a CUDA engine every attention runs the
hand-written flash-attention kernel.

Not ported yet: the unmanaged-KV baseline (``manage_kv=False``), the
transfer ``timeline=`` (it needs the reference's TPU cost model), shared
pools (``pool=``/``tenant=``) and ``telemetry=`` spans, and the compiled
and distributed serving engines.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.chunk import (
    TensorSpec,
    build_chunk_map,
    build_kv_chunk_map,
    pages_for,
    search_chunk_size,
)
from repro_torch.core.manager import ChunkManager
from repro_torch.core.memory import acquire_pool
from repro_torch.core.state import TensorState
from repro_torch.models.api import Model, flatten_with_paths, tree_map, unflatten
from repro_torch.models.layers import AxisCtx, greedy_token


def _leaves_with_names(tree, prefix: str) -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs named ``prefix + jax.tree_util.keystr(path)``
    (e.g. ``layers.0['attn']['wq']``) in JAX's order — the reference
    engine's leaf names, so chunk placements line up byte for byte."""
    return [(prefix + "".join(f"[{k!r}]" for k in path), leaf)
            for path, leaf in flatten_with_paths(tree)]


def swap_headroom_bytes(*stream_chunk_bytes: int) -> int:
    """Admission swap margin shared by every admission bound: with every
    tier packed exactly full no eviction can land anywhere and paging
    deadlocks, so each bound leaves room to swap the largest chunk among
    the streams it co-schedules."""
    if not stream_chunk_bytes:
        raise ValueError("at least one stream's chunk size is required")
    return max(int(b) for b in stream_chunk_bytes)


@dataclasses.dataclass
class ServeRequest:
    """One inference request's lifecycle through the admission queue."""

    rid: int
    prompt: np.ndarray  # [S] int32 token ids
    max_new_tokens: int
    state: str = "queued"  # queued -> active -> done
    pos: int = 0  # positions already written into the KV cache
    generated: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeRoundMetrics:
    """One continuous-batching round (admission + prefill + decode)."""

    round_index: int
    admitted: int
    completed: int
    active: int
    queued: int
    prefill_tokens: int
    decode_tokens: int
    h2d_bytes: int
    d2h_bytes: int
    hidden_h2d_bytes: int
    critical_h2d_bytes: int
    prefetch_hits: int
    demand_misses: int
    peak_device_bytes: int  # pool device high-water mark this round
    wall_s: float  # host clock, ending after the round's token read
    # batched calls per layer this round: one prefill per cohort, one
    # decode per batch (each runs every layer's attention once)
    prefill_cohorts: int = 0
    decode_batches: int = 0

    @property
    def tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens


class ServingEngine:
    """Eager prefill/decode over the chunked heterogeneous memory pool."""

    def __init__(
        self,
        model_cls,
        cfg,
        *,
        device: str | torch.device = "cuda",
        device_memory_bytes: int | None = None,
        host_memory_bytes: int | None = None,
        slow_memory_bytes: int | None = None,
        policy: str = "opt",
        chunk_size: int | None = None,
        max_seq_len: int = 128,
        page_tokens: int | None = None,
        prefetch: bool = True,
        prefetch_lookahead: int = 8,
        max_decode_batch: int | None = None,
        max_prefill_batch: int | None = None,
        seed: int = 0,
        init_params: Any | None = None,
    ) -> None:
        self.cfg = cfg
        self.ctx = AxisCtx()  # single device
        self.model: Model = model_cls(cfg, self.ctx)
        self.max_seq_len = max_seq_len
        if page_tokens is not None:
            page_tokens = int(page_tokens)
            if page_tokens < 1:
                raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self._page_tokens = page_tokens
        self._lease = acquire_pool(
            device_memory_bytes=device_memory_bytes,
            host_memory_bytes=host_memory_bytes,
            slow_memory_bytes=slow_memory_bytes,
            policy=policy, device=device)
        self.pool = self._lease.pool
        self.device = self.pool.device
        self.tenant = self._lease.tenant
        self.device_capacity = self._lease.device_bytes
        self.host_capacity = self._lease.host_bytes
        self.slow_capacity = self._lease.slow_bytes
        self._decode_groups = [g for g in self.model.groups()
                               if g.decode is not None]
        if len(self._decode_groups) != len(self.model.groups()):
            raise ValueError("every block group must define decode/prefill "
                             "to serve with the chunk-managed engine")
        for g in self._decode_groups:
            if g.prefill is None or g.init_cache is None:
                raise ValueError(f"group {g.name} lacks prefill/init_cache")

        # ---- param chunk stream (read-only); stem copied to the device --
        params = init_params if init_params is not None \
            else self.model.init_params(torch.Generator().manual_seed(seed))
        self._stem = tree_map(
            lambda t: t.to(self.device, torch.float32), params["stem"])
        self.stem_bytes = sum(t.numel() * t.element_size()
                              for _, t in flatten_with_paths(self._stem))
        named: list[tuple[str, torch.Tensor]] = []
        self._group_tensor_names: dict[str, list[list[str]]] = {}
        self._layer_paths: dict[str, list[tuple]] = {}
        for g in self.model.groups():
            stacked = params["groups"][g.name]
            self._layer_paths[g.name] = [
                p for p, _ in flatten_with_paths(stacked)]
            per_layer: list[list[str]] = []
            for i in range(g.length):
                pairs = _leaves_with_names(
                    tree_map(lambda t, _i=i: t[_i], stacked),
                    f"{g.name}.{i}")
                per_layer.append([n for n, _ in pairs])
                named.extend(pairs)
            self._group_tensor_names[g.name] = per_layer
        specs = [TensorSpec(n, tuple(v.shape)) for n, v in named]
        if chunk_size is None:
            chunk_size = search_chunk_size(specs, align=256).chunk_size
        self.cmap = build_chunk_map(specs, chunk_size)
        self.params_mgr = self._lease.stream("param", self.cmap)
        for name, val in named:
            self.params_mgr.access_tensor(name, "host").copy_(val)
            self.params_mgr.release_tensor(name, TensorState.HOLD)
        del named, params
        self._layer_chunks = {
            (g.name, i): sorted({self.cmap.placement(n).chunk_id
                                 for n in self._group_tensor_names[g.name][i]})
            for g in self.model.groups() for i in range(g.length)
        }
        self._param_stream_bytes = (
            self.cmap.num_payload_chunks * self.params_mgr.chunk_bytes)
        self._param_floor_bytes = max(
            len(c) for c in self._layer_chunks.values()
        ) * self.params_mgr.chunk_bytes

        # ---- KV layout: one (group, layer, page) cache per chunk --------
        # template = init_cache(1, max_seq_len) flattened (shapes only, on
        # the meta device); a chunk holds the leaves concatenated (k then
        # v).  Unpaged, one page spans the horizon; paged, each chunk
        # holds a page_tokens-wide slice of every leaf's position axis.
        self._cache_tmpl: dict[str, Any] = {}
        self._batchable: dict[str, bool] = {}
        self._page_axes: dict[str, list[int]] = {}
        max_numel = 1
        for g in self._decode_groups:
            flat = flatten_with_paths(g.init_cache(1, max_seq_len,
                                                   device="meta"))
            paths = [p for p, _ in flat]
            shapes = [tuple(l.shape) for _, l in flat]
            dtypes = [l.dtype for _, l in flat]
            numels = [int(np.prod(s)) for s in shapes]
            self._cache_tmpl[g.name] = (paths, shapes, dtypes, numels)
            if page_tokens is None:
                max_numel = max(max_numel, sum(numels))
            else:
                # position axis per leaf: the one axis that grows by
                # exactly 1 when the cache is built for one more position
                grown = [tuple(l.shape) for _, l in flatten_with_paths(
                    g.init_cache(1, max_seq_len + 1, device="meta"))]
                axes: list[int] = []
                for sa, sb in zip(shapes, grown):
                    diff = [ax for ax, (a, b) in enumerate(zip(sa, sb))
                            if a != b]
                    if (len(sa) != len(sb) or len(diff) != 1
                            or sb[diff[0]] - sa[diff[0]] != 1):
                        raise ValueError(
                            f"group {g.name} has a cache leaf without a "
                            f"clean position axis ({sa} vs {sb} for one "
                            f"extra position); this arch cannot serve "
                            f"with paged KV")
                    axes.append(diff[0])
                self._page_axes[g.name] = axes
                width = min(page_tokens, max_seq_len)
                page_numel = sum((n // s[ax]) * width
                                 for s, n, ax in zip(shapes, numels, axes))
                max_numel = max(max_numel, page_numel)
            # batched decode packs sequences along the cache's leading
            # axis: only when every leaf leads with the batch dim
            self._batchable[g.name] = all(
                len(s) >= 1 and s[0] == 1 for s in shapes)
        self._kv_chunk_elems = build_kv_chunk_map(
            max_numel, page_tokens=page_tokens).chunk_size
        self.kv_chunk_bytes = self._kv_chunk_elems * 4  # fp32 payloads
        self._total_layers = sum(g.length for g in self._decode_groups)
        # one sequence's whole managed KV footprint at the full horizon
        self._pages_per_seq = pages_for(max_seq_len, page_tokens)
        self.kv_seq_bytes = (self._pages_per_seq * self._total_layers
                             * self.kv_chunk_bytes)

        floor = (self._param_floor_bytes + self.kv_chunk_bytes
                 + swap_headroom_bytes(self.kv_chunk_bytes))
        self.device_floor_bytes = floor  # the least budget this engine takes
        if self.device_capacity < floor:
            raise ValueError(
                f"device budget {self.device_capacity} below the serving "
                f"working-set floor {floor} (one layer's param chunks plus "
                f"two kv chunks)")

        self.kv_mgr: ChunkManager | None = None
        self.prefetcher = (self._lease.prefetcher(lookahead=prefetch_lookahead)
                           if prefetch else None)

        # batched decode: same-position active sequences pack into ONE
        # g.decode call per layer, capped so the batch's COMPUTE-pinned kv
        # chunks plus the layer's params leave one chunk of swap headroom
        if max_decode_batch is None:
            fit = (self.device_capacity - self._param_floor_bytes
                   - swap_headroom_bytes(self.kv_chunk_bytes)
                   ) // max(self.kv_chunk_bytes, 1)
            max_decode_batch = max(1, min(8, int(fit)))
        self.max_decode_batch = max(1, int(max_decode_batch))
        if max_prefill_batch is None:
            max_prefill_batch = self.max_decode_batch
        self.max_prefill_batch = max(1, int(max_prefill_batch))

        self._queue: deque[ServeRequest] = deque()
        self._active: list[ServeRequest] = []
        self._req_pages: dict[int, int] = {}  # rid -> mapped pages/(g,layer)
        self._page_layout_cache: dict[tuple[str, int], list] = {}
        self._done: dict[int, ServeRequest] = {}
        self._next_rid = 0
        self._moment = 0
        self._planned: deque[tuple[int, tuple]] = deque()
        self.rounds = 0
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        self.peak_concurrency = 0

    # --------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        """Queue a request; returns its id.  The admission loop activates
        it once the pool can hold its KV alongside the current load."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # the last generated token is never fed back, so the cache holds
        # prompt + (max_new_tokens - 1) positions
        if prompt.size + max_new_tokens - 1 > self.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens "
                f"exceeds max_seq_len {self.max_seq_len}")
        probe = ServeRequest(rid=-1, prompt=prompt,
                             max_new_tokens=max_new_tokens)
        if not self._admissible(0, probe):
            raise ValueError(
                "request can never be admitted: one sequence's KV plus the "
                "param working set exceeds the configured budgets")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(ServeRequest(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens))
        return rid

    def _pages_for(self, positions: int) -> int:
        return pages_for(positions, self._page_tokens)

    def _kv_commit_bytes(self, req: ServeRequest) -> int:
        """One request's full-lifetime managed KV footprint: the pages
        that exist at its final decode position, per (group, layer)."""
        pages = self._pages_for(int(req.prompt.size) + req.max_new_tokens - 1)
        return pages * self._total_layers * self.kv_chunk_bytes

    def _admissible(self, n_active: int,
                    req: ServeRequest | None = None) -> bool:
        """Can the pool hold the param stream plus the running KV
        commitment and one more sequence's?  Managed KV may spill, so the
        bound is the total across every pool tier."""
        if self.host_capacity is None:
            return True  # unbounded host tier
        headroom = swap_headroom_bytes(
            self.params_mgr.chunk_bytes, self.kv_chunk_bytes)
        active_kv = sum(self._kv_commit_bytes(r)
                        for r in self._active) if n_active else 0
        cand = (self._kv_commit_bytes(req) if req is not None
                else self.kv_seq_bytes)
        need = self._param_stream_bytes + headroom + active_kv + cand
        total = (self.device_capacity + self.host_capacity
                 + (self.slow_capacity or 0))
        return need <= total

    def _admit(self) -> list[ServeRequest]:
        newly: list[ServeRequest] = []
        while self._queue and self._admissible(len(self._active),
                                               self._queue[0]):
            req = self._queue.popleft()
            req.state = "active"
            self._ensure_kv_stream()
            self._map_request_kv(req)
            self._active.append(req)
            newly.append(req)
        self.peak_concurrency = max(self.peak_concurrency, len(self._active))
        return newly

    def _map_request_kv(self, req: ServeRequest) -> None:
        """Map enough kv pages per (group, layer) to cover the prompt;
        decode appends pages as the position crosses page boundaries."""
        pages = self._pages_for(int(req.prompt.size))
        self._req_pages[req.rid] = pages
        for g in self._decode_groups:
            for i in range(g.length):
                for p in range(pages):
                    self._map_page(req.rid, g.name, i, p)

    def _map_page(self, rid: int, gname: str, layer: int, page: int) -> None:
        self.kv_mgr.add_tensor(
            self._kv_name(rid, gname, layer, page), (self._kv_chunk_elems,))

    def _ensure_pages(self, req: ServeRequest) -> None:
        """Decode writes position ``req.pos`` this round: append page
        chunks (zero-filled on first access) when the write crosses a
        page boundary.  A no-op on unpaged streams."""
        need = self._pages_for(req.pos + 1)
        have = self._req_pages[req.rid]
        if need <= have:
            return
        for g in self._decode_groups:
            for i in range(g.length):
                for p in range(have, need):
                    self._map_page(req.rid, g.name, i, p)
        self._req_pages[req.rid] = need

    def _ensure_kv_stream(self) -> None:
        """(Re)register the kv stream, dropped whenever the engine fully
        drains."""
        if self.kv_mgr is None:
            self.kv_mgr = self._lease.stream(
                "kv", build_kv_chunk_map(self._kv_chunk_elems,
                                         page_tokens=self._page_tokens))

    @staticmethod
    def _kv_name(rid: int, gname: str, layer: int, page: int = 0) -> str:
        return f"kv.{rid}.{gname}.{layer}.{page}"

    # ------------------------------------------------------------- schedule
    def _prefill_cohorts(self, newly) -> list[list[ServeRequest]]:
        """Pack newly admitted requests into prefill cohorts: same prompt
        length, admission order inside a length class (stable sort),
        capped at ``max_prefill_batch``."""
        cap = (self.max_prefill_batch if all(self._batchable.values())
               else 1)
        cohorts: list[list[ServeRequest]] = []
        for req in sorted(newly, key=lambda r: int(r.prompt.size)):
            if (cohorts and cohorts[-1][0].prompt.size == req.prompt.size
                    and len(cohorts[-1]) < cap):
                cohorts[-1].append(req)
            else:
                cohorts.append([req])
        return cohorts

    def _round_ops(self, cohorts, decode_reqs) -> list[tuple]:
        """The round's exact op order: per admission cohort a layer-major
        prefill pass (each member's kv pages stored under the layer's
        params), then one layer-major decode sweep over the running set
        (params fetched once per layer per round, every active sequence's
        kv pages visited under that fetch)."""
        ops: list[tuple] = []
        for cohort in cohorts:
            for g in self._decode_groups:
                for i in range(g.length):
                    ops.append(("param", g.name, i))
                    for req in cohort:
                        for p in range(self._req_pages[req.rid]):
                            ops.append(("kv", req.rid, g.name, i, p))
        if decode_reqs:
            for g in self._decode_groups:
                for i in range(g.length):
                    ops.append(("param", g.name, i))
                    for req in decode_reqs:
                        for p in range(self._req_pages[req.rid]):
                            ops.append(("kv", req.rid, g.name, i, p))
        return ops

    def _plan_round(self, cohorts, decode_reqs) -> None:
        """Register this round's reference schedule (plus a synthetic
        next round) as the OPT eviction future and the prefetcher's
        staging queue."""
        newly = [r for c in cohorts for r in c]
        ops = self._round_ops(cohorts, decode_reqs)
        survivors = [r for r in decode_reqs + newly
                     if len(r.generated) + 1 < r.max_new_tokens]
        future = self._round_ops([], survivors or (decode_reqs + newly))
        param_sched: dict[int, list[int]] = {}
        kv_sched: dict[int, list[int]] = {}
        refs: list[tuple[int, str, int]] = []
        self._planned.clear()
        m = self._moment
        for k, op in enumerate(ops + future):
            if op[0] == "param":
                for cid in self._layer_chunks[(op[1], op[2])]:
                    param_sched.setdefault(cid, []).append(m + k)
                    refs.append((m + k, self.params_mgr.name, cid))
            else:
                cid = self.kv_mgr.cmap.placement(
                    self._kv_name(op[1], op[2], op[3], op[4])).chunk_id
                kv_sched.setdefault(cid, []).append(m + k)
                refs.append((m + k, self.kv_mgr.name, cid))
            if k < len(ops):
                self._planned.append((m + k, op))
        self._moment = m + len(ops) + len(future)
        self.pool.register_moments(self.params_mgr.name, param_sched)
        if self.kv_mgr is not None:
            self.pool.register_moments(self.kv_mgr.name, kv_sched)
        if self.prefetcher is not None:
            self.prefetcher.install(refs)

    def _begin_op(self, op: tuple) -> None:
        """Advance the moment cursor to the next planned op (the executor
        must walk exactly the planned order) and stage upcoming
        references ahead of it."""
        m, planned = self._planned.popleft()
        if planned != op:
            raise RuntimeError(f"executed op {op} but the plan says {planned}")
        self.tenant.set_moment(m)
        if self.prefetcher is not None:
            self.prefetcher.advance(m)

    # -------------------------------------------------------- cache chunks
    def _page_layout(self, gname: str, page: int):
        """Per-leaf layout of one page chunk: ``(slice_tuple, local_shape,
        offset, numel)``; ``slice_tuple`` cuts the page's position window
        out of the full-horizon template leaf, ``offset``/``numel`` locate
        its flattened payload inside the chunk."""
        key = (gname, page)
        out = self._page_layout_cache.get(key)
        if out is not None:
            return out
        _, shapes, _, numels = self._cache_tmpl[gname]
        out = []
        off = 0
        if self._page_tokens is None:
            for s, n in zip(shapes, numels):
                out.append((tuple(slice(None) for _ in s), s, off, n))
                off += n
        else:
            lo = page * self._page_tokens
            hi = min(lo + self._page_tokens, self.max_seq_len)
            for s, ax in zip(shapes, self._page_axes[gname]):
                local = tuple(hi - lo if j == ax else d
                              for j, d in enumerate(s))
                sl = tuple(slice(lo, hi) if j == ax else slice(None)
                           for j in range(len(s)))
                n = int(np.prod(local))
                out.append((sl, local, off, n))
                off += n
        self._page_layout_cache[key] = out
        return out

    @staticmethod
    def _write_window(dst: torch.Tensor, leaf: torch.Tensor, sl,
                      tshape: tuple[int, ...]) -> None:
        """``dst[...] = pad(leaf, tshape)[sl]`` without building the
        padded leaf: the part of ``leaf`` inside the window is copied
        (cast to the payload's fp32), the rest of the window is zeroed."""
        if any(a > b for a, b in zip(leaf.shape, tshape)):
            raise ValueError(f"cache leaf {tuple(leaf.shape)} exceeds "
                             f"template {tshape}")
        src, part = [], []
        for s, dlen, llen in zip(sl, dst.shape, leaf.shape):
            lo = s.start or 0
            top = min(lo + dlen, llen)
            if top <= lo:
                dst.zero_()
                return
            src.append(slice(lo, top))
            part.append(slice(0, top - lo))
        region = leaf[tuple(src)]
        if tuple(region.shape) != tuple(dst.shape):
            dst.zero_()
        dst[tuple(part)] = region

    def _store_prefill_cache(self, rid: int, gname: str, layer: int,
                             cache) -> None:
        """Write a freshly prefilled layer cache into the request's page
        chunks — one planned op per page, each FREE access zero-filled."""
        _, shapes, _, _ = self._cache_tmpl[gname]
        leaves = [l for _, l in flatten_with_paths(cache)]
        for p in range(self._req_pages[rid]):
            self._begin_op(("kv", rid, gname, layer, p))
            name = self._kv_name(rid, gname, layer, p)
            view = self.kv_mgr.access_tensor(name, "device")
            for leaf, ts, (sl, local, off, n) in zip(
                    leaves, shapes, self._page_layout(gname, p)):
                self._write_window(view[off:off + n].view(local), leaf, sl,
                                   ts)
            self.kv_mgr.release_tensor(name, TensorState.HOLD)

    def _store_decode_cache(self, rid: int, gname: str, layer: int,
                            cache) -> None:
        """Write back after a decode step.  The new position lives on the
        tail page, so only the tail (still COMPUTE from the load) is
        rewritten; cold pages were already released."""
        tail = self._req_pages[rid] - 1
        name = self._kv_name(rid, gname, layer, tail)
        if self.kv_mgr.tensor_state(name) is TensorState.COMPUTE:
            view = self.kv_mgr.tensor_view(name)
        else:
            view = self.kv_mgr.access_tensor(name, "device")
        _, shapes, _, _ = self._cache_tmpl[gname]
        for (_, leaf), ts, (sl, local, off, n) in zip(
                flatten_with_paths(cache), shapes,
                self._page_layout(gname, tail)):
            self._write_window(view[off:off + n].view(local), leaf, sl, ts)
        self.kv_mgr.release_tensor(name, TensorState.HOLD)

    def _load_cache(self, rid: int, gname: str, layer: int):
        """Visit the request's page chunks in order and rebuild the
        full-horizon layer cache on the device.  Cold (non-tail) pages
        are copied out and released HOLD at once; the tail page stays
        COMPUTE for the in-place write-back."""
        paths, shapes, dtypes, numels = self._cache_tmpl[gname]
        pages = self._req_pages[rid]
        if self._page_tokens is None:
            # one page spans the horizon: read the chunk in place
            self._begin_op(("kv", rid, gname, layer, 0))
            view = self.kv_mgr.access_tensor(
                self._kv_name(rid, gname, layer, 0), "device")
            leaves = []
            off = 0
            for shape, dtype, n in zip(shapes, dtypes, numels):
                leaves.append(view[off:off + n].view(shape).to(dtype))
                off += n
            return unflatten(paths, leaves)
        fulls = [torch.zeros(s, dtype=torch.float32, device=self.device)
                 for s in shapes]
        for p in range(pages):
            self._begin_op(("kv", rid, gname, layer, p))
            name = self._kv_name(rid, gname, layer, p)
            view = self.kv_mgr.access_tensor(name, "device")
            for full, (sl, local, off, n) in zip(
                    fulls, self._page_layout(gname, p)):
                full[sl] = view[off:off + n].view(local)
            if p < pages - 1:
                self.kv_mgr.release_tensor(name, TensorState.HOLD)
        # positions beyond the mapped pages stay zero, as in an unpaged
        # chunk
        return unflatten(paths, [f.to(dt) for f, dt in zip(fulls, dtypes)])

    def _stack_caches(self, gname: str, caches: list):
        paths = self._cache_tmpl[gname][0]
        cols = zip(*[[l for _, l in flatten_with_paths(c)] for c in caches])
        return unflatten(paths, [torch.cat(col) for col in cols])

    # ------------------------------------------------------------ layer ops
    def _access_layer(self, gname: str, layer: int):
        """The layer's params as views into their (device-resident) chunk
        payloads — no copy; the views are dropped before the release."""
        names = self._group_tensor_names[gname][layer]
        views = [self.params_mgr.access_tensor(n, "device") for n in names]
        return names, unflatten(self._layer_paths[gname], views)

    def _release_layer(self, names) -> None:
        for n in names:
            self.params_mgr.release_tensor(n, TensorState.HOLD)

    # ------------------------------------------------------------- phases
    def _prefill_cohort(self, cohort: list[ServeRequest], stem):
        """Prefill one admission cohort in a single layer-major pass (one
        param fetch per layer per cohort); each member's cache rows are
        sliced back out and stored into its kv chunks.  Returns the
        cohort's first generated tokens as a device tensor."""
        k = len(cohort)
        tokens = torch.from_numpy(
            np.stack([r.prompt for r in cohort], axis=0)).to(
                self.device, torch.long)
        batch = {"tokens": tokens}
        x, extras = self.model.embed(stem, batch)
        for g in self._decode_groups:
            x, extras = self.model.between_groups(
                g.name, x, extras, stem, batch)
            for i in range(g.length):
                self._begin_op(("param", g.name, i))
                names, ptree = self._access_layer(g.name, i)
                x, cache = g.prefill(ptree, x, extras, self.ctx)
                del ptree
                self._release_layer(names)
                for j, req in enumerate(cohort):
                    cj = cache if k == 1 else tree_map(
                        lambda t, _j=j: t[_j:_j + 1], cache)
                    self._store_prefill_cache(req.rid, g.name, i, cj)
        logits = self.model.head_logits(stem, x[:, -1:, :])
        for req in cohort:
            req.pos = int(req.prompt.size)
            self.total_prefill_tokens += int(req.prompt.size)
        return greedy_token(logits, self.cfg.vocab_size, self.ctx)

    def _decode_batches(self, decode_reqs) -> list[list[ServeRequest]]:
        """Pack the running set into decode batches: same-position
        sequences in admission order (stable sort), capped at
        ``max_decode_batch``."""
        batches: list[list[ServeRequest]] = []
        for req in sorted(decode_reqs, key=lambda r: r.pos):
            if (batches and batches[-1][0].pos == req.pos
                    and len(batches[-1]) < self.max_decode_batch):
                batches[-1].append(req)
            else:
                batches.append([req])
        return batches

    def _decode_round(self, batches, stem):
        """One layer-major decode sweep: params fetched once per layer
        per round; same-position sequences decode as ONE batched
        ``g.decode`` call.  Returns the new tokens as a device tensor."""
        decode_reqs = [r for b in batches for r in b]
        last = torch.tensor([[r.generated[-1]] for r in decode_reqs],
                            dtype=torch.long).to(self.device)
        xs: dict[int, list] = {}
        for j, req in enumerate(decode_reqs):
            x = self.model.embed_decode(stem, last[j:j + 1], req.pos, None)
            xs[req.rid] = [x, self.model.decode_extras(stem, x)]
        for g in self._decode_groups:
            for i in range(g.length):
                self._begin_op(("param", g.name, i))
                names, ptree = self._access_layer(g.name, i)
                for batch in batches:
                    batched = (len(batch) > 1 and self._batchable[g.name]
                               and all(xs[r.rid][1] is None for r in batch))
                    if not batched:
                        for req in batch:
                            cache = self._load_cache(req.rid, g.name, i)
                            st = xs[req.rid]
                            y, c2 = g.decode(ptree, st[0], cache, req.pos,
                                             st[1], self.ctx)
                            self._store_decode_cache(req.rid, g.name, i, c2)
                            st[0] = y
                        continue
                    caches = [self._load_cache(req.rid, g.name, i)
                              for req in batch]
                    xcat = torch.cat([xs[r.rid][0] for r in batch], dim=0)
                    y, c2 = g.decode(ptree, xcat,
                                     self._stack_caches(g.name, caches),
                                     batch[0].pos, None, self.ctx)
                    del caches
                    for j, req in enumerate(batch):
                        self._store_decode_cache(
                            req.rid, g.name, i,
                            tree_map(lambda t, _j=j: t[_j:_j + 1], c2))
                        xs[req.rid][0] = y[j:j + 1]
                del ptree
                self._release_layer(names)
        toks = []
        for req in decode_reqs:
            logits = self.model.head_logits(stem, xs[req.rid][0])
            toks.append(greedy_token(logits, self.cfg.vocab_size, self.ctx))
            req.pos += 1
            self.total_decode_tokens += 1
        return torch.cat(toks)

    def _retire_finished(self) -> int:
        done = [r for r in self._active
                if len(r.generated) >= r.max_new_tokens]
        for req in done:
            req.state = "done"
            self._active.remove(req)
            self._done[req.rid] = req
            pages = self._req_pages.pop(req.rid)
            for g in self._decode_groups:
                for i in range(g.length):
                    for p in range(pages):
                        self.kv_mgr.remove_tensor(
                            self._kv_name(req.rid, g.name, i, p))
        if not self._active and not self._queue and self.kv_mgr is not None:
            # full drain: drop the kv stream; the next admission
            # re-registers it from scratch
            self.pool.unregister_stream(self.kv_mgr.name)
            self.kv_mgr = None
        return len(done)

    # ------------------------------------------------------------------ run
    def step_round(self) -> ServeRoundMetrics | None:
        """One continuous-batching round: admit, prefill the newly
        admitted, decode one token for everyone else, retire finished
        sequences.  Returns None when there is nothing to do."""
        if not self._queue and not self._active:
            return None
        t0 = time.perf_counter()
        st0, pf0 = self.tenant.snapshot()
        prefill0 = self.total_prefill_tokens
        decode0 = self.total_decode_tokens
        newly = self._admit()
        newly_ids = {r.rid for r in newly}
        # group admissions and the running set FIRST: the plan's reference
        # order must equal the execution order
        cohorts = self._prefill_cohorts(newly)
        batches = self._decode_batches(
            [r for r in self._active if r.rid not in newly_ids])
        decode_reqs = [r for b in batches for r in b]
        for req in decode_reqs:
            self._ensure_pages(req)
        self._plan_round(cohorts, decode_reqs)
        self._execute_round(cohorts, batches)
        completed = self._retire_finished()
        self.rounds += 1
        pf = self.tenant.prefetch
        met = ServeRoundMetrics(
            round_index=self.rounds - 1,
            admitted=len(newly),
            completed=completed,
            active=len(self._active),
            queued=len(self._queue),
            prefill_tokens=self.total_prefill_tokens - prefill0,
            decode_tokens=self.total_decode_tokens - decode0,
            h2d_bytes=self.tenant.stats.h2d_bytes - st0.h2d_bytes,
            d2h_bytes=self.tenant.stats.d2h_bytes - st0.d2h_bytes,
            hidden_h2d_bytes=pf.hidden_h2d_bytes - pf0.hidden_h2d_bytes,
            critical_h2d_bytes=pf.critical_h2d_bytes - pf0.critical_h2d_bytes,
            prefetch_hits=pf.hits - pf0.hits,
            demand_misses=pf.demand_misses - pf0.demand_misses,
            peak_device_bytes=self.tenant.take_step_peak_device_bytes(),
            wall_s=time.perf_counter() - t0,
            prefill_cohorts=len(cohorts),
            decode_batches=len(batches),
        )
        return met

    def _execute_round(self, cohorts, batches) -> None:
        """Run one planned round: per-cohort prefill passes, then the
        layer-major decode sweep.  The new tokens stay on the device
        until one read at the end — the round's only host round trip."""
        outs: list[tuple[list[ServeRequest], torch.Tensor]] = []
        for cohort in cohorts:
            outs.append((cohort, self._prefill_cohort(cohort, self._stem)))
        if batches:
            outs.append(([r for b in batches for r in b],
                         self._decode_round(batches, self._stem)))
        if not outs:
            return
        ids = torch.cat([t for _, t in outs]).tolist()
        for req, tok in zip([r for reqs, _ in outs for r in reqs], ids):
            req.generated.append(int(tok))

    def run(self, max_rounds: int = 10_000) -> list[ServeRoundMetrics]:
        """Round until every submitted request has completed."""
        out: list[ServeRoundMetrics] = []
        while self._queue or self._active:
            if len(out) >= max_rounds:
                raise RuntimeError(
                    f"serving did not drain within {max_rounds} rounds "
                    f"({len(self._active)} active, {len(self._queue)} queued)")
            out.append(self.step_round())
        return out

    # ------------------------------------------------------------- results
    def result(self, rid: int) -> list[int]:
        """Generated token ids of a completed request."""
        return list(self._done[rid].generated)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def queued_count(self) -> int:
        return len(self._queue)

    def device_bytes_in_use(self) -> int:
        """This tenant's device bytes (the pool total on an owned pool)."""
        return self.tenant.device_bytes_used()

    def check_invariants(self) -> None:
        self.pool.check_invariants()
        if self.kv_mgr is not None:
            expect = sum(self._req_pages[r.rid]
                         for r in self._active) * self._total_layers
            assert self.kv_mgr.cmap.num_payload_chunks == expect, (
                self.kv_mgr.cmap.num_payload_chunks, expect)
        if self.tenant.is_default:
            assert self.device_bytes_in_use() <= self.device_capacity, (
                self.device_bytes_in_use(), self.device_capacity)
