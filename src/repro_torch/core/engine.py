"""PatrickStarEngine of the port — the paper's eager trainer on PyTorch.

This is ``repro.core.engine.PatrickStarEngine`` over a
:class:`~repro_torch.core.memory.HeteroMemory` whose device tier is real
(HBM on a CUDA engine).  Everything the reference decides — the chunk
layout, the warm-up trace, OPT victims, prefetch staging, device-aware
placement of optimizer state, the activation chunk stream, the OOM
points — is decided the same way on the same trace, so every
:class:`EngineMetrics` byte and count equals the reference's (the CPU
parity tests check it step by step).  What differs:

  * **Params are views.**  A layer's params are tensor views into its
    param chunk payloads (the chunk is the storage; the reference copies
    at the numpy->jax boundary instead).  Grad reuse (Fig. 6) overwrites
    those payloads, so a layer's grads are all computed by
    ``torch.autograd.grad`` before any is written back.
  * **FWD keeps no graph.**  Forward runs under ``torch.no_grad()``; only
    the layer inputs survive, through the activation stream.  Each BWD
    layer recomputes its forward under ``torch.enable_grad()`` on leaf
    tensors (the reference's ``jax.vjp``), as do the head and the
    embedding.
  * **ADAM runs where the plan puts it.**  A device-placed optimizer group
    updates on the card through K1 (:func:`repro_torch.kernels.ops.
    chunked_adam`, weight decay 0 — the eager engine's own semantics): it
    updates p32, m and v in place and writes the new params straight into
    the param payload, which is also the grad K1 reads.  A host-placed
    group updates on the CPU in the engine's own code, as the reference
    does with numpy — the paper's CPU ADAM.  The stem (embedding, final
    norm) lives on the engine's device outside the pool and keeps each
    leaf's dtype, with per-leaf moments, as in the reference.
  * On a CUDA engine every attention runs K2 (forward and backward
    kernels).  A CPU engine (``device="cpu"``) runs the plain versions;
    that is what the parity tests do.

The class doubles as the **single-rank core of the rank-parallel plane**
(Section 7), as the reference's does: constructed with ``nproc > 1`` it
owns only the chunk shard of its ``rank`` (rank r owns chunk ``g*p + r``
of every communication group), keeps non-owned chunks in the RELEASED
remote lifecycle, and delegates the chunk-group all-gather and
reduce-scatter to a ``collective`` (the driver in
:mod:`repro_torch.core.distributed`), which interleaves the phase methods
below across ranks in lock-step.  ``nproc=1`` runs exactly as before.

With ``timeline=`` (a :class:`~repro_torch.core.timeline.
TransferTimeline`), every tier move and collective is also priced on a
simulated clock: after the warm-up the engine installs per-moment
compute durations from :mod:`repro_torch.analysis.costmodel` under the
timeline's ``hardware``, and each step's :class:`EngineMetrics` carries
its :class:`~repro_torch.core.timeline.StepTimeline`.  The clock sees
only bytes, moments and durations, so it is identical on the CPU and on
the card; ``bandwidth_aware_prefetch`` lets the prefetcher choose how
deep and how early to stage against it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.chunk import (
    TensorSpec,
    build_act_chunk_map,
    build_chunk_map,
    search_chunk_size,
)
from repro_torch.core.manager import ChunkManager
from repro_torch.core.memory import (
    HeteroMemory,
    OutOfMemory,
    Tenant,
    acquire_pool,
)
from repro_torch.core.placement import PlacementPlan, plan_placement
from repro_torch.core.serving import _leaves_with_names
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.state import ChunkState, TensorState
from repro_torch.core.timeline import StepTimeline, TransferTimeline
from repro_torch.core.tracer import RuntimeMemoryTracer
from repro_torch.kernels import ops
from repro_torch.models.api import Model, flatten_with_paths, tree_map, unflatten
from repro_torch.models.layers import AxisCtx


@dataclasses.dataclass
class EngineMetrics:
    fwd_s: float = 0.0
    bwd_s: float = 0.0
    adam_s: float = 0.0
    loss: float = 0.0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    adam_h2d_bytes: int = 0
    adam_d2h_bytes: int = 0
    # overlap accounting (schedule-driven prefetch, post-warm-up):
    # every H2D byte this step is either hidden (staged ahead of its use,
    # overlappable with compute) or critical-path (a demand miss).
    hidden_h2d_bytes: int = 0
    critical_h2d_bytes: int = 0
    prefetch_hits: int = 0
    demand_misses: int = 0
    # high-water mark of the unified pool's device tier THIS step (the
    # pool keeps the cumulative lifetime mark separately)
    peak_device_bytes: int = 0
    # transfer-timeline decomposition of this step's simulated wall time
    # (step == compute + h2d_stall + d2h_stall + gather_stall); None when
    # the engine runs without a timeline.
    timeline: StepTimeline | None = None

    @property
    def total_s(self) -> float:
        return self.fwd_s + self.bwd_s + self.adam_s

    @property
    def moved_bytes(self) -> int:
        return self.h2d_bytes + self.d2h_bytes + self.adam_h2d_bytes + self.adam_d2h_bytes

    @property
    def prefetch_hit_rate(self) -> float:
        total = self.prefetch_hits + self.demand_misses
        return self.prefetch_hits / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class _ActRef:
    """A checkpointed layer input parked in the activation chunk stream
    (instead of held live on the device): only the chunk name and the
    original shape/dtype survive until the mirrored BWD read
    re-materializes it."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class _StepState:
    """Mutable per-step context threaded through the phase methods."""

    batch: dict
    met: EngineMetrics
    h2d0: int
    d2h0: int
    pf0: Any
    t0: float = 0.0
    stem: Any = None
    x: Any = None
    extras: Any = None
    # (group, layer, x | _ActRef) per checkpointed layer input
    saved: list = dataclasses.field(default_factory=list)
    gx: Any = None
    stem_grad: list | None = None  # one grad per stem leaf, leaf order
    # cotangents of the extras' differentiable leaves, summed over the
    # layers that read them: {index in flatten_with_paths(extras): grad}
    extras_grad: dict = dataclasses.field(default_factory=dict)
    # the extras each group ran with (``between_groups`` may change them)
    group_extras: dict = dataclasses.field(default_factory=dict)
    # per boundary group (``Model.boundaries``): the checkpointed input of
    # its ``between_groups`` (x | _ActRef) and the extras that came with it
    entries: dict = dataclasses.field(default_factory=dict)


def to_device_batch(batch: dict, device) -> dict:
    """Host batch (numpy arrays / scalars, as ``make_batch_fn`` gives)
    -> tensors on ``device``; integer ids become int64 and 0-d values
    Python scalars.  A read-only array (e.g. ``np.asarray`` of a JAX
    array) is copied first: ``torch.from_numpy`` would share memory that
    may not be written."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
            continue
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = a.item()
            continue
        if not a.flags.writeable:
            a = a.copy()
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _grads(outputs, inputs, grad_outputs=None) -> list[torch.Tensor]:
    """``torch.autograd.grad`` with zeros for inputs the outputs do not
    depend on (JAX's vjp returns zeros there)."""
    got = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, got)]


def _leaf(t: torch.Tensor) -> torch.Tensor:
    """A leaf sharing ``t``'s storage that autograd differentiates."""
    return t.detach().requires_grad_(True)


def _extras_leaves(extras):
    """``extras`` with each floating tensor made a leaf (:func:`_leaf`):
    (the tree, those tensors' indices in ``flatten_with_paths(extras)``,
    the leaves).  A tree without one (None, for most models) comes back
    as it is."""
    pairs = flatten_with_paths(extras)
    flat = [t for _, t in pairs]
    idx = [k for k, t in enumerate(flat)
           if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not idx:
        return extras, [], []
    for k in idx:
        flat[k] = _leaf(flat[k])
    return unflatten([p for p, _ in pairs], flat), idx, [flat[k]
                                                          for k in idx]


def _adam_direction(g, m, v, *, beta1, beta2, eps, bias_corr1, bias_corr2):
    """ADAM's moments, updated in place on the fp32 ``m`` and ``v``, and
    the bias-corrected step direction they give (weight decay 0)."""
    m.mul_(beta1).add_(g, alpha=1 - beta1)
    v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
    return (m / bias_corr1).div_((v / bias_corr2).sqrt_().add_(eps))


def host_adam(grad, p32, m, v, *, lr, beta1, beta2, eps, bias_corr1,
              bias_corr2) -> None:
    """The paper's CPU ADAM for a host-placed optimizer group, in place on
    the host payloads (the reference engine's numpy update, weight decay
    0), then the updated fp32 params copied back into the param chunk,
    which held the grad."""
    p32.sub_(_adam_direction(grad, m, v, beta1=beta1, beta2=beta2, eps=eps,
                             bias_corr1=bias_corr1, bias_corr2=bias_corr2),
             alpha=lr)
    grad.copy_(p32)


class PatrickStarEngine:
    def __init__(
        self,
        model_cls,
        cfg,
        *,
        device: str | torch.device = "cuda",
        device_memory_bytes: int | None = None,
        host_memory_bytes: int | None = None,
        slow_memory_bytes: int | None = None,
        pool: HeteroMemory | None = None,
        tenant: Tenant | None = None,
        policy: str = "opt",
        chunk_size: int | None = None,
        warmup_chunk_fraction: float = 0.2,
        lr: float = 1e-3,
        betas: tuple[float, float] = (0.9, 0.95),
        eps: float = 1e-8,
        seed: int = 0,
        device_aware_placement: bool = True,
        embedding_on_host: bool = True,
        prefetch: bool = True,
        prefetch_lookahead: int = 6,
        timeline: TransferTimeline | None = None,
        telemetry: "Telemetry | None" = None,
        bandwidth_aware_prefetch: bool = True,
        manage_activations: bool = True,
        strict_device_budget: bool = False,
        nproc: int = 1,
        rank: int = 0,
        collective: "Any | None" = None,
        init_params: "Any | None" = None,
    ) -> None:
        if nproc > 1 and collective is None:
            raise ValueError(
                "nproc > 1 needs a collective (the rank-parallel driver in "
                "repro_torch.core.distributed) to fetch remote chunks")
        self.cfg = cfg
        self.ctx = AxisCtx()  # single device, no mesh axes
        self.model: Model = model_cls(cfg, self.ctx)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.device_aware_placement = device_aware_placement
        self.nproc = nproc
        self.rank = rank
        self.collective = collective

        # ---- ONE heterogeneous memory space shared by all streams --------
        # (Sections 6.2, 8): param (grads reuse its payloads), param fp32,
        # momentum and variance are views of a single pool with a single
        # device budget.  With pool= (+ tenant=) the engine joins a shared
        # pool as one tenant and the budget args become planning shares.
        self._lease = acquire_pool(
            pool=pool, tenant=tenant,
            device_memory_bytes=device_memory_bytes,
            host_memory_bytes=host_memory_bytes,
            slow_memory_bytes=slow_memory_bytes,
            policy=policy, timeline=timeline, device=device)
        self.pool = self._lease.pool
        self.device = self.pool.device
        self.tenant = self._lease.tenant
        if telemetry is not None:
            self.pool.set_telemetry(telemetry)
        self.policy = self.pool.policy
        # transfer timeline (optional): every tier move / collective is
        # enqueued on finite-bandwidth DMA lanes and each step's report
        # decomposes its simulated time into compute + per-lane stalls
        self.timeline = self._lease.timeline
        device_share = self._lease.device_bytes
        if device_share is None:
            raise ValueError(
                "the trainer needs a device budget: pass "
                "device_memory_bytes= or give its tenant a "
                "device_budget_bytes soft budget")

        params = init_params if init_params is not None \
            else self.model.init_params(torch.Generator().manual_seed(seed))
        # paper 8.2: embedding params are NOT chunk-managed.  The stem
        # lives on the engine's device, each leaf in its own dtype.
        stem_pairs = flatten_with_paths(params["stem"])
        self._stem_paths = [p for p, _ in stem_pairs]
        self._stem = [t.to(self.device, copy=True) for _, t in stem_pairs]
        self._stem_m: list[torch.Tensor] | None = None  # ADAM moments (lazy)
        self._stem_v: list[torch.Tensor] | None = None
        self.embedding_on_host = embedding_on_host

        # ---- chunk stream over all block-group tensors, model order -----
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
                    tree_map(lambda t, _i=i: t[_i], stacked), f"{g.name}.{i}")
                per_layer.append([n for n, _ in pairs])
                named.extend(pairs)
            self._group_tensor_names[g.name] = per_layer
        self._groups = {g.name: g for g in self.model.groups()}

        specs = [TensorSpec(n, tuple(v.shape)) for n, v in named]
        if chunk_size is None:
            chunk_size = search_chunk_size(specs, nproc=nproc,
                                           align=256).chunk_size
        self.cmap = build_chunk_map(specs, chunk_size, nproc=nproc)
        self.params_mgr = self._lease.stream("param", self.cmap)
        self.os_mgrs = {
            name: self._lease.stream(name, self.cmap)
            for name in ("p32", "m", "v")
        }
        # tracer over the device (this tenant's share of it)
        self.tracer = RuntimeMemoryTracer(
            device_share, warmup_chunk_fraction=warmup_chunk_fraction)
        # the chunkable budget never drops below one operator's working
        # set: the largest layer's param chunks (plus, under nproc > 1, one
        # communication group pinned while its all-gather is in flight),
        # and the four per-stream chunks pinned together during one ADAM
        # chunk update
        max_layer_chunks = max(
            len({self.cmap.placement(n).chunk_id for n in layer})
            for layers in self._group_tensor_names.values() for layer in layers)
        self._model_floor_bytes = max(max_layer_chunks + max(nproc, 1), 5) \
            * self.params_mgr.chunk_bytes
        self.pool.set_chunkable_memory_fn(self._chunkable_budget,
                                          tenant=self.tenant,
                                          basis_bytes=device_share)

        # ---- activation chunk stream (the fifth managed stream) ---------
        # Checkpointed layer inputs become chunks in the same pool: written
        # once in FWD, read once at the mirrored BWD layer, then freed.
        # Built lazily at the first forward_embed (batch-shape dependent).
        self.manage_activations = manage_activations
        # strict mode: refuse to clamp the chunkable budget up to the
        # working-set floor; raise OutOfMemory instead
        self.strict_device_budget = strict_device_budget
        self.act_mgr: ChunkManager | None = None
        self.act_cmap = None
        self._act_numel = 0
        self._batch_sig: tuple | None = None
        self._batch_tokens_shape: tuple[int, int] = (1, 1)
        # schedule-driven prefetcher (installed after the warm-up; OPT only)
        self.prefetcher = self._lease.prefetcher(
            lookahead=prefetch_lookahead,
            bandwidth_aware=bandwidth_aware_prefetch) if prefetch else None

        # initialize payloads: param stream + param fp32 copies, m and v
        # zero, for the chunks THIS rank owns (every chunk when nproc ==
        # 1); tensors in non-owned chunks enter the RELEASED lifecycle
        for name, val in named:
            if self.cmap.chunk_owner(self.cmap.placement(name).chunk_id) != rank:
                continue
            self.params_mgr.access_tensor(name, "host").copy_(val)
            self.params_mgr.release_tensor(name, TensorState.HOLD)
            self.os_mgrs["p32"].access_tensor(name, "host").copy_(val)
            self.os_mgrs["p32"].release_tensor(name, TensorState.HOLD)
            for s in ("m", "v"):
                self.os_mgrs[s].access_tensor(name, "host")
                self.os_mgrs[s].release_tensor(name, TensorState.HOLD)
        del named, params
        if nproc > 1:
            for c in range(self.cmap.num_chunks):
                if self.cmap.chunk_owner(c) != rank and self.cmap.chunk_tensors(c):
                    self.params_mgr.mark_released(c)

        self.step_count = 0
        self.placement: PlacementPlan | None = None
        self._live_activation_bytes = 0

    # ------------------------------------------------------------------ utils
    def _moment(self, op: str, phase: str) -> None:
        m = self.tracer.record_moment(op, phase, self._live_activation_bytes)
        self.tenant.set_moment(m)
        tel = self.pool.telemetry
        if tel is not None:
            tel.switch_span(self.tenant.qualify("moments"), f"{op}:{phase}",
                            ts=self.pool._now(), moment=m,
                            tenant=self.tenant.name,
                            rank=self.pool.telemetry_rank)
        # schedule-driven prefetch: stage the next-k chunk references
        # before the operator at this moment runs (their H2D overlaps it)
        if self.prefetcher is not None and not self.tracer.warmup:
            self.prefetcher.advance(m)
        # the driver's gather prefetcher walks the same moment cursor,
        # advanced once per lock-step moment from the LAST rank: it runs
        # each layer after all others, so a group is then either released
        # on every rank or resident on every rank (never mixed)
        if self.collective is not None and self.rank == self.nproc - 1 \
                and not self.tracer.warmup:
            self.collective.advance_prefetch(m)

    def _stem_tree(self, leaves) -> dict:
        return unflatten(self._stem_paths, leaves)

    # ------------------------------------------------------ activation stream
    def _chunkable_budget(self) -> int:
        """Device bytes the pool may use for chunks right now: the traced
        chunkable memory, floored at one operator's working set.  In strict
        mode the floor is a feasibility CHECK, not a clamp."""
        floor = self._model_floor_bytes + self._act_floor_bytes()
        dyn = self.tracer.chunkable_memory()
        if dyn < floor and self.strict_device_budget and not self.tracer.warmup:
            raise OutOfMemory(
                f"strict device budget: chunkable memory {dyn} at the "
                f"current moment is below the working-set floor {floor} "
                f"(device {self.tracer.device_total_bytes} bytes cannot "
                f"hold this batch's non-model footprint plus one "
                f"operator's chunks)")
        return max(dyn, floor)

    def _act_floor_bytes(self) -> int:
        """Act chunks co-resident with one operator: the input being
        written (FWD) or read (BWD) plus one staged neighbour."""
        return 2 * self.act_mgr.chunk_bytes if self.act_mgr is not None else 0

    def _ensure_act_stream(self, x) -> None:
        """(Re)build the act stream for this batch's activation shape."""
        if not self.manage_activations:
            return
        numel = x.numel()
        if self.act_mgr is not None and numel == self._act_numel:
            return
        if self.act_mgr is not None:
            # batch shape changed: the act chunk layout is stale
            self.pool.unregister_stream(self.tenant.qualify("act"))
        names = []
        for g in self.model.groups():
            if g.name in self.model.boundaries:
                # the boundary's input: the previous group's last output
                names.append(f"act.{g.name}.entry")
            names.extend(f"act.{g.name}.{i}" for i in range(g.length))
        self.act_cmap = build_act_chunk_map(names, numel)
        self.act_mgr = self._lease.stream("act", self.act_cmap)
        self._act_numel = numel

    def _save_activation(self, gname: str, layer: int | str, x):
        """FWD half of the act lifecycle: park the checkpointed input in
        its act chunk (FREE -> COMPUTE -> HOLD_AFTER_FWD) and return the
        reference stored in ``st.saved``; hold the live tensor when the
        stream is off, the shape does not match, or admission is refused
        (the reference's rules exactly)."""
        if self.act_mgr is None or x.numel() != self._act_numel:
            return x
        cb = self.act_mgr.chunk_bytes
        budget = self.pool.device_budget()
        host_cap = self.pool.host_capacity
        slow_cap = self.pool.slow_capacity
        if (budget is not None and host_cap is not None
                and self.pool.device_bytes_used() + cb > budget
                and self.pool.host_bytes_used() + cb > host_cap
                and (slow_cap is None
                     or self.pool.slow_bytes_used() + cb > slow_cap)):
            # Fig. 10's dual-constrained corner: refuse up-front and hold
            # the input live, counted as non-model bytes
            return x
        name = f"act.{gname}.{layer}"
        try:
            view = self.act_mgr.access_tensor(name, "device")
        except OutOfMemory:
            return x
        if self.tracer.warmup:
            self.tracer.record_chunk_use(
                self.act_cmap.placement(name).chunk_id, stream="act")
        view.copy_(x.reshape(-1))
        self.act_mgr.release_tensor(name, TensorState.HOLD_AFTER_FWD)
        return _ActRef(name, tuple(x.shape), x.dtype)

    def _fetch_activation(self, saved):
        """BWD half: re-materialize the checkpointed input from its act
        chunk (HOLD_AFTER_FWD -> COMPUTE -> FREE; read once, then the
        payload is dropped)."""
        if not isinstance(saved, _ActRef):
            return saved
        if self.tracer.warmup:
            self.tracer.record_chunk_use(
                self.act_cmap.placement(saved.name).chunk_id, stream="act")
        try:
            view = self.act_mgr.access_tensor(saved.name, "device")
        except OutOfMemory:
            # dual-tight budgets can refuse the H2D move; the data must
            # still be read — consume it where it is
            view = self.act_mgr.tensor_view(saved.name)
            self.act_mgr.force_tensor_state(saved.name, TensorState.COMPUTE)
        # fp32 chunk payload -> original dtype (exact for fp32, an exact
        # round trip for bf16), copied out before the payload is dropped
        x_in = view.reshape(saved.shape).to(self.device, saved.dtype,
                                            copy=True)
        self.act_mgr.release_tensor(saved.name, TensorState.FREE)
        return x_in

    def _fetch_layer_groups(self, gname: str, layer: int) -> None:
        """Demand half of Algorithm 1 line 12: any chunk of this layer
        still in the RELEASED remote lifecycle pulls in its whole
        communication group by all-gather before the operator runs."""
        if self.collective is None:
            return
        timed = self.pool.timeline is not None
        groups: set[int] = set()
        for n in self._group_tensor_names[gname][layer]:
            chunk_id = self.cmap.placement(n).chunk_id
            if timed:
                groups.add(self.cmap.comm_group(chunk_id))
            if self.params_mgr.chunk_state(chunk_id) is ChunkState.RELEASED:
                self.collective.fetch_group(self.cmap.comm_group(chunk_id))
        if timed:
            # this operator consumes the layer's groups: a prefetched
            # gather still on the collective lane stalls it for the rest
            for grp in sorted(groups):
                self.pool.timeline.wait_for(("gather", grp))

    def _access_layer(self, gname: str, layer: int, mgr: ChunkManager,
                      dev: str, record: bool = True):
        """The layer's params as views into its chunk payloads."""
        names = self._group_tensor_names[gname][layer]
        views = []
        for n in names:
            if record and self.tracer.warmup:
                self.tracer.record_chunk_use(
                    self.cmap.placement(n).chunk_id, stream=mgr.name)
            views.append(mgr.access_tensor(n, dev))
        return names, views

    def _release_layer(self, names, mgr: ChunkManager, state: TensorState):
        for n in names:
            mgr.release_tensor(n, state)

    def _groups_completing(self, gname: str, layer: int,
                           state: TensorState) -> list[int]:
        """Communication groups this layer touches whose every tensor has
        now reached ``state`` (Algorithm 2's post-FWD/BWD group check)."""
        groups = sorted({
            self.cmap.tensor_comm_group(n)
            for n in self._group_tensor_names[gname][layer]})
        return [g for g in groups
                if self.params_mgr.comm_group_state_complete(g, state)]

    def _release_remote_of_group(self, group: int) -> None:
        """Algorithm 1 line 18: after the group's post-FWD transition the
        non-owned chunk replicas drop back to RELEASED (their payloads are
        freed; no view of them outlives this).  The driver is told, so
        the gather prefetcher retires the group's slot once every rank has
        dropped it."""
        for c in self.cmap.comm_group_chunk_ids(group):
            if self.cmap.chunk_owner(c) != self.rank and self.cmap.chunk_tensors(c):
                self.params_mgr.mark_released(c)
        if self.collective is not None:
            self.collective.retire_group(group)

    # ------------------------------------------------------------ step phases
    def begin_step(self, batch: dict) -> _StepState:
        # a batch-shape change invalidates the traced non-model curve, the
        # OPT schedules and the act chunk layout: re-arm the warm-up
        sig = tuple(sorted(
            (k, tuple(getattr(v, "shape", ()))) for k, v in batch.items()))
        if self._batch_sig is not None and sig != self._batch_sig:
            self.tracer.warmup = True
            if self.timeline is not None:
                # the traced moments (and their durations) are stale;
                # re-installed after the re-warm-up
                self.timeline.install_durations(
                    {}, tenant=self.tenant.timeline_ns)
        self._batch_sig = sig
        tok = batch.get("tokens")
        if tok is not None and getattr(tok, "ndim", 0) >= 2:
            self._batch_tokens_shape = (int(tok.shape[0]), int(tok.shape[1]))
        self.tracer.begin_iteration()
        tel = self.pool.telemetry
        if tel is not None:
            tel.begin_span(self.tenant.qualify("step"),
                           f"step{self.step_count}", ts=self.pool._now(),
                           tenant=self.tenant.name,
                           rank=self.pool.telemetry_rank)
        st0, pf0 = self.tenant.snapshot()
        return _StepState(
            batch=to_device_batch(batch, self.device), met=EngineMetrics(),
            h2d0=st0.h2d_bytes, d2h0=st0.d2h_bytes, pf0=pf0)

    def forward_embed(self, st: _StepState) -> None:
        st.t0 = time.perf_counter()
        st.stem = self._stem_tree(self._stem)
        with torch.no_grad():
            st.x, st.extras = self.model.embed(st.stem, st.batch)
        self._ensure_act_stream(st.x)
        self._live_activation_bytes += _nbytes(st.x)

    def forward_group_start(self, st: _StepState, gname: str) -> None:
        boundary = gname in self.model.boundaries
        if boundary:
            # the previous group's output leaves the stream here: keep it
            # as a layer input is kept, for the boundary's BWD piece
            saved = self._save_activation(gname, "entry", st.x)
            st.entries[gname] = (saved, st.extras)
            if isinstance(saved, _ActRef):
                self._live_activation_bytes -= _nbytes(st.x)
        with torch.no_grad():
            st.x, st.extras = self.model.between_groups(
                gname, st.x, st.extras, st.stem, st.batch)
        if boundary:
            self._live_activation_bytes += _nbytes(st.x) + sum(
                _nbytes(t) for _, t in flatten_with_paths(st.extras)
                if isinstance(t, torch.Tensor) and t.is_floating_point())
        st.group_extras[gname] = st.extras

    def forward_layer(self, st: _StepState, g, i: int) -> None:
        self._moment(f"{g.name}.{i}", "FWD")
        self._fetch_layer_groups(g.name, i)
        names, views = self._access_layer(g.name, i, self.params_mgr,
                                          "device")
        x_in = st.x
        saved = self._save_activation(g.name, i, x_in)
        st.saved.append((g.name, i, saved))
        with torch.no_grad():
            st.x, _aux = g.apply(unflatten(self._layer_paths[g.name], views),
                                 x_in, st.extras, self.ctx)
        self._live_activation_bytes += _nbytes(st.x)
        if isinstance(saved, _ActRef):
            # the checkpointed input now lives in the act chunk plane
            self._live_activation_bytes -= _nbytes(x_in)
        del views
        self._release_layer(names, self.params_mgr, TensorState.HOLD_AFTER_FWD)
        # a communication group whose every tensor is now HOLD_AFTER_FWD
        # is done with forward: its remote replicas are released
        if self.nproc > 1:
            for grp in self._groups_completing(
                    g.name, i, TensorState.HOLD_AFTER_FWD):
                self._release_remote_of_group(grp)
        self._moment(f"{g.name}.{i}.end", "FWD")

    def end_forward(self, st: _StepState) -> None:
        self._sync()
        st.met.fwd_s = time.perf_counter() - st.t0

    def begin_backward(self, st: _StepState) -> None:
        st.t0 = time.perf_counter()
        # reset param states to HOLD before BWD (Section 6.2); RELEASED
        # remote replicas stay released until their group is re-gathered
        self.params_mgr.reset_states(TensorState.HOLD)
        leaves = [_leaf(t) for t in self._stem]
        xx = _leaf(st.x)
        with torch.enable_grad():
            loss = self.model.head_loss(self._stem_tree(leaves), xx, st.batch)
            grads = _grads(loss, leaves + [xx])
        st.met.loss = float(loss.detach())
        st.stem_grad, st.gx = grads[:-1], grads[-1]
        st.x = None

    def backward_layer(self, st: _StepState, idx: int) -> list[int]:
        """Run BWD for ``st.saved[idx]``; returns the communication groups
        that completed HOLD_AFTER_BWD on this rank (the driver
        reduce-scatters them once every rank has finished the layer)."""
        g, i, saved = st.saved[idx]
        grp = self._groups[g]
        self._moment(f"{g}.{i}", "BWD")
        self._fetch_layer_groups(g, i)
        x_in = self._fetch_activation(saved)
        names, views = self._access_layer(g, i, self.params_mgr, "device")
        # activation checkpointing: recompute the layer's forward on leaf
        # tensors, then every grad at once — the params are views into the
        # payloads the grads are about to overwrite
        leaves = [_leaf(t) for t in views]
        x_leaf = _leaf(x_in)
        # the extras' floating tensors (zamba's shared block from the stem,
        # the embedding output x0, whisper's enc_out) are leaves too: their
        # cotangents reach the stem in backward_boundary or backward_embed
        extras, ex_idx, ex_leaves = _extras_leaves(
            st.group_extras.get(g, st.extras))
        own = leaves + [x_leaf]
        with torch.enable_grad():
            y, _aux = grp.apply(unflatten(self._layer_paths[g], leaves),
                                x_leaf, extras, self.ctx)
            got = torch.autograd.grad(y, own + ex_leaves,
                                      grad_outputs=st.gx, allow_unused=True)
        # zeros where the output does not depend on a param or x (JAX's
        # vjp); an extra this layer does not read adds nothing
        grads = [torch.zeros_like(t) if gv is None else gv
                 for t, gv in zip(own, got)]
        for k, eg in zip(ex_idx, got[len(own):]):
            if eg is not None:
                acc = st.extras_grad.get(k)
                st.extras_grad[k] = eg if acc is None else acc + eg
        del got, own, ex_leaves, extras
        st.gx = grads[-1]
        # grad reuses the param chunk payload (Fig. 6): after BWD of this
        # operator the param values are overwritten in place
        for view, gleaf in zip(views, grads[:-1]):
            view.copy_(gleaf)
        del views, leaves, grads, y
        self._release_layer(names, self.params_mgr, TensorState.HOLD_AFTER_BWD)
        if not isinstance(saved, _ActRef):
            # chunk-managed inputs were uncounted at save time; only live
            # (fallback-held) inputs still contribute to the footprint
            self._live_activation_bytes -= max(_nbytes(x_in), 0)
        done = self._groups_completing(g, i, TensorState.HOLD_AFTER_BWD) \
            if self.nproc > 1 else []
        self._moment(f"{g}.{i}.end", "BWD")
        return done

    def backward_boundary(self, st: _StepState, idx: int) -> None:
        """After BWD of ``st.saved[idx]``: if that was the first layer of a
        group in ``Model.boundaries``, differentiate the ``between_groups``
        before it (recomputed from its checkpointed input).  Its
        cotangents are ``st.gx`` (the group's input) and ``st.extras_grad``
        (the extras it gave the group); it yields the previous group's
        output cotangent (the new ``st.gx``), the stem's share (whisper:
        the token embedding and ``enc_norm``) and the cotangents of the
        extras that came into it (the new ``st.extras_grad``).  A no-op
        everywhere else.  The reference's eager trainer hands the decoder
        input's cotangent to the encoder instead (ROADMAP §3)."""
        g, i, _ = st.saved[idx]
        if i != 0 or g not in st.entries:
            return
        saved, ex_in = st.entries.pop(g)
        x_in = self._fetch_activation(saved)
        leaves = [_leaf(t) for t in self._stem]
        x_leaf = _leaf(x_in)
        extras, ex_idx, ex_leaves = _extras_leaves(ex_in)
        own = leaves + [x_leaf]
        with torch.enable_grad():
            x_out, ex_out = self.model.between_groups(
                g, x_leaf, extras, self._stem_tree(leaves), st.batch)
            outs, cots = [x_out], [st.gx]
            out_flat = [t for _, t in flatten_with_paths(ex_out)]
            for k, eg in sorted(st.extras_grad.items()):
                outs.append(out_flat[k])
                cots.append(eg)
            got = torch.autograd.grad(outs, own + ex_leaves,
                                      grad_outputs=cots, allow_unused=True)
        grads = [torch.zeros_like(t) if gv is None else gv
                 for t, gv in zip(own, got)]
        st.stem_grad = [a + b for a, b in zip(st.stem_grad, grads[:-1])]
        st.gx = grads[-1]
        st.extras_grad = {k: eg for k, eg in zip(ex_idx, got[len(own):])
                          if eg is not None}
        if not isinstance(saved, _ActRef):
            self._live_activation_bytes -= _nbytes(x_in)

    def backward_embed(self, st: _StepState) -> None:
        """Close the gradient path through the embedding: the head's
        gradient covers final norm + LM head, the layer loop (with
        :meth:`backward_boundary` between groups) ends with ``gx = d loss
        / d x_embed``, and the extras' cotangents (summed over the layers)
        flow back through ``embed``'s extras into the stem — zamba's
        shared block (a stem leaf itself) and ``x0`` (the embedding output
        again); whisper's frontend (``frontend_proj``, ``enc_pos``)."""
        leaves = [_leaf(t) for t in self._stem]
        with torch.enable_grad():
            x, extras = self.model.embed(self._stem_tree(leaves), st.batch)
            outs, cots = [x], [st.gx]
            if st.extras_grad:
                flat = [t for _, t in flatten_with_paths(extras)]
                for k, eg in sorted(st.extras_grad.items()):
                    outs.append(flat[k])
                    cots.append(eg)
            grads = _grads(outs, leaves, cots)
        st.stem_grad = [a + b for a, b in zip(st.stem_grad, grads)]
        st.gx = None
        st.extras_grad = {}

    def end_backward(self, st: _StepState) -> None:
        self._sync()
        st.met.bwd_s = time.perf_counter() - st.t0
        st.met.h2d_bytes = self.tenant.stats.h2d_bytes - st.h2d0
        st.met.d2h_bytes = self.tenant.stats.d2h_bytes - st.d2h0

    def adam_chunks(self, st: _StepState) -> None:
        """Chunked ADAM over the chunks THIS rank owns (Section 7: "the
        ADAM stage is executed locally" — after the reduce-scatter the
        owner's grad chunk holds the cross-rank sum)."""
        st.t0 = time.perf_counter()
        a_h2d0, a_d2h0 = (self.tenant.stats.h2d_bytes,
                          self.tenant.stats.d2h_bytes)
        b1, b2 = self.betas
        t = self.step_count + 1
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t
        dev_groups = self.placement.os_device_groups if self.placement else 0
        for g_idx in range(self.cmap.num_comm_groups):
            # device-aware operator placement: the first `dev_groups` OS
            # chunk groups update on the device (margin space), the rest on
            # the host
            comp_dev = "device" if g_idx < dev_groups else "host"
            for chunk_id in self.cmap.comm_group_chunk_ids(g_idx):
                if self.nproc > 1 and self.cmap.chunk_owner(chunk_id) != self.rank:
                    continue
                if not self.cmap.chunk_tensors(chunk_id):
                    continue
                self._adam_chunk(chunk_id, comp_dev, bc1, bc2)
        self._sync()
        st.met.adam_h2d_bytes = self.tenant.stats.h2d_bytes - a_h2d0
        st.met.adam_d2h_bytes = self.tenant.stats.d2h_bytes - a_d2h0
        st.met.adam_s = time.perf_counter() - st.t0

    def _adam_chunk(self, chunk_id: int, comp_dev: str,
                    bc1: float, bc2: float) -> None:
        b1, b2 = self.betas
        self._moment(f"adam.{chunk_id}", "ADAM")
        if self.tracer.warmup:
            for s in ("param", "p32", "m", "v"):
                self.tracer.record_chunk_use(chunk_id, stream=s, dev=comp_dev)
        # the grad chunk (reusing the param chunk payload) and the three
        # optimizer-state chunks must co-reside for the update, so pin them
        # as they arrive.  Each arrival waits for a staged copy of its
        # payload (the record's event) before anything reads it.
        quad = [self.params_mgr, self.os_mgrs["p32"],
                self.os_mgrs["m"], self.os_mgrs["v"]]
        pinned = []
        try:
            payloads = []
            for smgr in quad:
                payloads.append(smgr.prepare_payload(chunk_id, comp_dev))
                smgr.pin(chunk_id)
                pinned.append(smgr)
            grad_payload, p32, m, v = payloads
            if comp_dev == "device":
                # K1: the updated fp32 params go straight back into the
                # param payload, which is also the grad it reads
                ops.chunked_adam(p32, m, v, grad_payload, out=grad_payload,
                                 lr=self.lr, beta1=b1, beta2=b2,
                                 eps=self.eps, weight_decay=0.0,
                                 bias_corr1=bc1, bias_corr2=bc2)
            else:
                host_adam(grad_payload, p32, m, v, lr=self.lr, beta1=b1,
                          beta2=b2, eps=self.eps, bias_corr1=bc1,
                          bias_corr2=bc2)
        finally:
            for smgr in pinned:
                smgr.unpin(chunk_id)
        for tn in self.cmap.chunk_tensors(chunk_id):
            self.params_mgr.force_tensor_state(tn.name, TensorState.HOLD)

    def update_stem(self, stem_grad) -> None:
        """Stem (embedding + norms) update on its own device — ADAM with
        per-leaf fp32 moments, the same hyperparameters and bias correction
        as the chunked streams; each leaf keeps its dtype."""
        b1, b2 = self.betas
        t = self.step_count + 1
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t
        if self._stem_m is None:
            self._stem_m = [torch.zeros_like(p, dtype=torch.float32)
                            for p in self._stem]
            self._stem_v = [torch.zeros_like(p, dtype=torch.float32)
                            for p in self._stem]
        for i, (p, gv) in enumerate(zip(self._stem, stem_grad)):
            # the moments read a bf16 grad as fp32 without a copy of it
            upd = _adam_direction(gv, self._stem_m[i],
                                  self._stem_v[i], beta1=b1, beta2=b2,
                                  eps=self.eps, bias_corr1=bc1,
                                  bias_corr2=bc2)
            self._stem[i] = (p - self.lr * upd).to(p.dtype)

    def end_step(self, st: _StepState) -> EngineMetrics:
        met = st.met
        # ----------------------------------- overlap / prefetch accounting
        pf = self.tenant.prefetch
        met.hidden_h2d_bytes = pf.hidden_h2d_bytes - st.pf0.hidden_h2d_bytes
        met.critical_h2d_bytes = pf.critical_h2d_bytes - st.pf0.critical_h2d_bytes
        met.prefetch_hits = pf.hits - st.pf0.hits
        met.demand_misses = pf.demand_misses - st.pf0.demand_misses
        met.peak_device_bytes = self.tenant.take_step_peak_device_bytes()

        # ----------------------------------------------- end of iteration
        self._live_activation_bytes = 0
        if self.tracer.warmup:
            self.tracer.end_warmup()
            self._plan_placement()
            # per-stream OPT schedules over *device* references; the
            # warm-up ran all ADAM on the host, so promote the host-side
            # refs of groups the plan just moved onto the device
            promote: dict[str, set[int]] = {}
            if self.placement is not None and self.placement.os_device_groups:
                dev_chunks = self.placement.os_device_chunk_ids(self.cmap)
                promote = {s: dev_chunks for s in ("param", "p32", "m", "v")}
            by_stream = self.tracer.schedule_by_stream(promote_chunks=promote)
            self.params_mgr.register_moments(by_stream.get("param", {}))
            for name, m in self.os_mgrs.items():
                m.register_moments(by_stream.get(name, {}))
            if self.act_mgr is not None:
                self.act_mgr.register_moments(by_stream.get("act", {}))
            if self.prefetcher is not None:
                # tracer stream labels are tenant-local; the pool's
                # stream registry keys are tenant-qualified
                self.prefetcher.install(
                    [(m, self.tenant.qualify(s), c) for m, s, c in
                     self.tracer.reference_sequence(by_stream)])
        if self.timeline is not None:
            met.timeline = self.timeline.take_step()
            if not self.tracer.warmup and not self.timeline.has_durations_for(
                    self.tenant.timeline_ns):
                # first post-warm-up install (and re-install after a
                # batch-shape re-warm-up): the traced moments now exist
                self.timeline.install_durations(
                    self._moment_durations(),
                    tenant=self.tenant.timeline_ns)
        tel = self.pool.telemetry
        if tel is not None:
            # close AFTER take_step so the span end covers the drain
            # stalls booked inside it
            ts = self.pool._now()
            rank = self.pool.telemetry_rank
            tel.close_span(self.tenant.qualify("moments"), ts=ts, rank=rank)
            tel.close_span(self.tenant.qualify("step"), ts=ts, rank=rank)
            tel.snapshot(
                f"{self.tenant.name}:step{self.step_count}", ts=ts,
                rank=rank, loss=met.loss,
                h2d_bytes=self.tenant.stats.h2d_bytes - st.h2d0,
                d2h_bytes=self.tenant.stats.d2h_bytes - st.d2h0,
                hidden_h2d_bytes=met.hidden_h2d_bytes,
                critical_h2d_bytes=met.critical_h2d_bytes,
                prefetch_hits=met.prefetch_hits,
                demand_misses=met.demand_misses,
                peak_device_bytes=met.peak_device_bytes)
        self.step_count += 1
        return met

    def _moment_durations(self) -> dict[int, float]:
        """Per-moment compute durations for the transfer timeline, from
        the analytical cost model over this batch shape on the timeline's
        card."""
        from repro_torch.analysis.costmodel import train_operator_costs

        b, s = self._batch_tokens_shape
        costs = train_operator_costs(
            self.cfg, hw=self.timeline.hardware, global_batch=b, seq_len=s,
            num_layer_ops=sum(g.length for g in self.model.groups()),
            chunk_bytes=self.params_mgr.chunk_bytes)
        return self.tracer.duration_schedule(costs.of_moment)

    def _sync(self) -> None:
        """Phase times are host-clock spans that end when the card has
        finished the phase's work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ step
    def step(self, batch: dict) -> EngineMetrics:
        """One fused FWD+BWD+ADAM iteration."""
        st = self.begin_step(batch)
        self.forward_embed(st)
        for g in self.model.groups():
            self.forward_group_start(st, g.name)
            for i in range(g.length):
                self.forward_layer(st, g, i)
        self.end_forward(st)
        self.begin_backward(st)
        for idx in range(len(st.saved) - 1, -1, -1):
            self.backward_layer(st, idx)
            self.backward_boundary(st, idx)
        self.backward_embed(st)
        self.end_backward(st)
        self.adam_chunks(st)
        self.update_stem(st.stem_grad)
        st.stem_grad = None
        return self.end_step(st)

    # -------------------------------------------------------------- placement
    def _plan_placement(self) -> None:
        if not self.device_aware_placement:
            self.placement = None
            return
        layer0 = self._group_tensor_names[self.model.groups()[0].name][0]
        working = sum(
            int(np.prod(self.cmap.placement(n).shape)) * 4 for n in layer0)
        margin = self.tracer.margin_space(working * 2)
        # per-rank model bytes: this rank owns 1 chunk of each group's
        # nproc, so the local param bytes scale by 1/nproc
        self.placement = plan_placement(
            margin_bytes=margin,
            num_local_groups=self.cmap.num_comm_groups,
            chunk_size_elems=self.cmap.chunk_size,
            param_fp16_local_bytes=self.cmap.capacity * 4 // max(self.nproc, 1),
            device_total_bytes=self.tracer.device_total_bytes,
            peak_nonmodel_bytes=self.tracer.peak_nonmodel_bytes,
            vocab_size=self.cfg.vocab_size, hidden=self.cfg.d_model,
            batch_tokens=0,
            act_working_bytes=self._act_floor_bytes(),
            host_capacity_bytes=self._lease.host_bytes,
            slow_capacity_bytes=self._lease.slow_bytes,
        )


def initialize_engine(model_func: Callable[[], tuple], config: dict):
    """Paper Listing 1:  model, optimizer = initialize_engine(...)

    ``model_func`` returns (model_cls, cfg); ``config`` carries the
    memory and optimizer settings (and ``device``, ``"cuda"`` by default).
    The returned engine exposes the familiar loop surface: ``loss =
    model(batch); model.backward(loss); optimizer.step()`` — internally
    one fused :meth:`PatrickStarEngine.step`.
    """
    model_cls, cfg = model_func()
    engine = PatrickStarEngine(model_cls, cfg, **config)

    class _ModelFacade:
        def __init__(self, eng):
            self._eng = eng
            self._pending = None

        def __call__(self, batch):
            self._pending = batch
            return self  # loss proxy; materialized in backward()

        def backward(self, _loss_proxy):
            self._metrics = self._eng.step(self._pending)
            self.loss = self._metrics.loss

    class _OptimizerFacade:
        def __init__(self, eng):
            self._eng = eng

        def zero_grad(self):
            pass  # grads live in reused chunks; nothing to zero

        def step(self):
            pass  # fused into engine.step (ADAM stage)

    return _ModelFacade(engine), _OptimizerFacade(engine)
