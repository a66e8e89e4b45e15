"""Rank-parallel eager memory plane of the port — chunked ZeRO in the
PatrickStar runtime (paper Section 7, Figs. 8/9, Algorithms 1-2).

This is ``repro.core.distributed`` on PyTorch.  :class:`DistributedPatrickStarEngine`
simulates ``nproc`` ranks in one process, on one device.  Each rank is a
full :class:`~repro_torch.core.engine.PatrickStarEngine` (its own
:class:`~repro_torch.core.memory.HeteroMemory` budget, copy stream,
tracer, prefetcher and placement) that owns chunk ``g*p + r`` of every
communication group:

  * **init**: a rank fills param, p32, m and v only for its owned chunks;
    every non-owned chunk starts RELEASED (no local payload).
  * **FWD/BWD fetch** (Algorithm 1): the first COMPUTE access to a
    RELEASED chunk all-gathers its whole communication group — every rank
    pins its own chunk on the device and materializes the other p-1
    replicas, booking ``(p-1) * chunk_bytes`` received per rank in its
    pool's collective ledger.  After the group's post-FWD transition the
    replicas drop back to RELEASED.
  * **grad reduce-scatter** (Algorithm 2 + Fig. 6): grads overwrite the
    param replicas on every rank; when a group reaches HOLD_AFTER_BWD
    everywhere, the driver sums the p replicas onto the owner's payload
    (owner first, then the other ranks in increasing order — the
    reference's association), releases the others and books
    ``(p-1) * chunk_bytes`` sent per rank.
  * **ADAM** runs on local shards (K1 on a rank's owned device-placed
    groups); the stem stays replicated and its grads all-reduce, counted
    separately.
  * **gather prefetch**: after warm-up, rank 0's traced schedule drives a
    :class:`~repro_torch.core.memory.GatherPrefetcher` that issues
    upcoming group gathers ahead of their operator (hidden bytes).

**What a collective is here.**  There is one card and no NCCL: a gather
is a device copy from the owner's payload into each replica's landing
pad, a reduce-scatter a sum of replicas into the owner's payload.  The
ledgers book what the wire would carry, byte for byte the reference's;
they are counts, not a link's time.  Each rank's pool has its own copy
stream and per-record staging events, so every cross-pool read first
waits for the source record's pending copy; a sum whose operands sit on
different tiers (a replica in pinned host memory, the owner's payload in
HBM) brings the operand to the accumulator's device through a temporary
and books no pool move, as the reference books none.

:class:`DistributedServingEngine` is the rank-sharded serving fleet:
``nproc`` independent :class:`~repro_torch.core.serving.ServingEngine`
cores, sequences placed round-robin, with zero collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.core.engine import EngineMetrics, PatrickStarEngine
from repro_torch.core.memory import CollectiveStats, GatherPrefetcher
from repro_torch.core.state import ChunkState
from repro_torch.models.layers import AxisCtx


@dataclasses.dataclass
class DistributedStepMetrics:
    """One lock-step iteration across all ranks.  Collective byte counts
    are PER RANK (they are symmetric by construction — every rank sends
    and receives the same chunk count per group)."""

    loss: float  # global loss: sum of per-shard losses (1/global_tokens)
    rank_metrics: list[EngineMetrics]
    allgather_bytes: int = 0
    reduce_scatter_bytes: int = 0
    allreduce_bytes: int = 0
    hidden_allgather_bytes: int = 0
    critical_allgather_bytes: int = 0

    @property
    def chunk_collective_bytes(self) -> int:
        """The quantity the paper's 6(p-1)/p*M model predicts."""
        return self.allgather_bytes + self.reduce_scatter_bytes

    @property
    def moved_bytes(self) -> int:
        """Per-step H2D+D2H over all ranks (the offload plane)."""
        return sum(m.moved_bytes for m in self.rank_metrics)


class DistributedPatrickStarEngine:
    """nproc-rank chunked-ZeRO driver over per-rank PatrickStar cores.

    ``timeline_factory=`` gives each rank its own transfer timeline (the
    gathers land on its collective lane); the gather prefetcher plans
    against rank 0's, since lock-step ranks keep identical clocks.
    ``pools=``/``tenants=`` (one entry a rank, as the reference's) make
    each rank a tenant of that rank's shared pool (co-tenancy: a serving
    fleet on the same per-rank pools)."""

    def __init__(
        self,
        model_cls,
        cfg,
        *,
        nproc: int,
        device: str | torch.device = "cuda",
        device_memory_bytes: int,  # PER-RANK device budget
        host_memory_bytes: int | None = None,
        slow_memory_bytes: int | None = None,
        policy: str = "opt",
        chunk_size: int | None = None,
        lr: float = 1e-3,
        betas: tuple[float, float] = (0.9, 0.95),
        eps: float = 1e-8,
        seed: int = 0,
        device_aware_placement: bool = True,
        prefetch: bool = True,
        prefetch_lookahead: int = 6,
        gather_lookahead: int = 2,
        timeline_factory: "Callable[[], Any] | None" = None,
        telemetry: "Any | None" = None,
        bandwidth_aware_prefetch: bool = True,
        manage_activations: bool = True,
        strict_device_budget: bool = False,
        pools: "list | None" = None,
        tenants: "list | None" = None,
        init_params: "Any | None" = None,
    ) -> None:
        if nproc < 2:
            raise ValueError("nproc must be >= 2 (use PatrickStarEngine)")
        # co-tenancy: one shared pool (+ tenant handle) PER RANK — each
        # simulated rank owns its own device, so a co-resident serving
        # fleet shares memory rank-to-rank, never across ranks
        for arg, label in ((pools, "pools"), (tenants, "tenants")):
            if arg is not None and len(arg) != nproc:
                raise ValueError(f"{label}= needs one entry per rank "
                                 f"({len(arg)} != nproc {nproc})")
        self.nproc = nproc
        self.device = resolve_device(device)
        # ONE init for all ranks (the paper's replicated init); each core
        # copies what it owns into its chunk payloads.  Rank 0 also runs
        # the chunk-size search once; the others reuse its layout.
        if init_params is None:
            init_params = model_cls(cfg, AxisCtx()).init_params(
                torch.Generator().manual_seed(seed))

        def make_core(r, csize):
            return PatrickStarEngine(
                model_cls, cfg, device=self.device,
                device_memory_bytes=device_memory_bytes,
                host_memory_bytes=host_memory_bytes,
                slow_memory_bytes=slow_memory_bytes,
                pool=pools[r] if pools is not None else None,
                tenant=tenants[r] if tenants is not None else None,
                policy=policy, chunk_size=csize,
                lr=lr, betas=betas, eps=eps, seed=seed,
                device_aware_placement=device_aware_placement,
                prefetch=prefetch, prefetch_lookahead=prefetch_lookahead,
                timeline=timeline_factory() if timeline_factory else None,
                bandwidth_aware_prefetch=bandwidth_aware_prefetch,
                manage_activations=manage_activations,
                strict_device_budget=strict_device_budget,
                nproc=nproc, rank=r, collective=self,
                init_params=init_params)

        rank0 = make_core(0, chunk_size)
        self.ranks = [rank0] + [
            make_core(r, rank0.cmap.chunk_size) for r in range(1, nproc)]
        del init_params
        # rank-tag each core's telemetry (explicit hub or the default one
        # its pool picked up) so every event names its rank
        for r, core in enumerate(self.ranks):
            tel = telemetry if telemetry is not None else core.pool.telemetry
            if tel is not None:
                core.pool.set_telemetry(tel, rank=r)
        self.cmap = rank0.cmap
        if any(c.cmap != self.cmap for c in self.ranks[1:]):
            raise AssertionError("rank cores disagree on the chunk layout")
        # the gather prefetcher projects against rank 0's timeline (lock-
        # step execution keeps every rank's clock identical); a staged
        # gather moves (p-1) chunks onto every rank's collective lane.
        # Without a timeline it runs its fixed-depth mode.
        self.gather_prefetcher = GatherPrefetcher(
            lambda grp: self.fetch_group(grp, hidden=True),
            lookahead=gather_lookahead,
            timeline=rank0.timeline if bandwidth_aware_prefetch else None,
            group_bytes=(nproc - 1) * rank0.params_mgr.chunk_bytes,
        ) if gather_lookahead > 0 else None
        self.step_count = 0

    # ----------------------------------------------------------- collectives
    def _ready(self, r: int, c: int, *, on_host: bool) -> torch.Tensor:
        """Rank ``r``'s payload of chunk ``c``, safe to read: after its
        pending staged copy or eviction (the record's event in that rank's
        pool) — on the current stream for a device reader, on the host
        for a host reader."""
        core = self.ranks[r]
        rec = core.params_mgr._records[c]
        core.pool._settle(rec, on_host=on_host)
        return rec.payload

    def fetch_group(self, group: int, *, hidden: bool = False) -> bool:
        """Chunk-granular all-gather of one communication group
        (Algorithm 1 ``FetchRemoteChunks`` / Fig. 9).

        Every rank brings its OWN chunk of the group on-device and pins it
        for the duration (line 11-12); every rank then materializes the
        p-1 non-owned replicas and copies the owners' bytes in.  Received
        bytes — ``(p-1) * chunk_bytes`` per rank, padding chunks included
        — land in the pool's collective ledger, classified hidden
        (prefetched) or critical-path (demand).  Returns True iff a gather
        actually ran (resident groups are a no-op, so the gather
        prefetcher can probe freely)."""
        cmap = self.cmap
        payload_ids = [c for c in cmap.comm_group_chunk_ids(group)
                       if cmap.chunk_tensors(c)]
        # all-or-nothing: a collective is only well-defined when EVERY
        # rank's non-owned replicas of the group are released (a mixed
        # state means some rank is still mid-phase on the group; the
        # demand fetch runs once the phase transition completes)
        released = [
            core.params_mgr.chunk_state(c) is ChunkState.RELEASED
            for r, core in enumerate(self.ranks)
            for c in payload_ids if cmap.chunk_owner(c) != r]
        if not (released and all(released)):
            return False
        chunk_bytes = self.ranks[0].params_mgr.chunk_bytes
        pinned: list[tuple[int, int]] = []
        try:
            # owners first: the collective reads their payloads
            for c in payload_ids:
                o = cmap.chunk_owner(c)
                self.ranks[o].params_mgr.prepare_payload(c, "device")
                self.ranks[o].params_mgr.pin(c)
                pinned.append((o, c))
            for r, core in enumerate(self.ranks):
                for c in payload_ids:
                    o = cmap.chunk_owner(c)
                    if o == r:
                        continue
                    dst = core.params_mgr.materialize_chunk(c, "device",
                                                            pin=True)
                    pinned.append((r, c))
                    dst.copy_(self._ready(o, c, on_host=False))
                core.pool.account_allgather(
                    (self.nproc - 1) * chunk_bytes, hidden=hidden,
                    group=group)
        finally:
            for r, c in pinned:
                self.ranks[r].params_mgr.unpin(c)
        return True

    def reduce_scatter_group(self, group: int) -> None:
        """Algorithm 2 gradient path: the p grad replicas of every chunk
        in the group SUM onto the owner's payload (the per-shard losses
        already carry 1/global_tokens, so summing is the global
        reduction); non-owned replicas then drop back to RELEASED.  Sent
        bytes per rank: ``(p-1) * chunk_bytes``."""
        cmap = self.cmap
        chunk_bytes = self.ranks[0].params_mgr.chunk_bytes
        for c in cmap.comm_group_chunk_ids(group):
            if not cmap.chunk_tensors(c):
                continue
            o = cmap.chunk_owner(c)
            on_host = self.ranks[o].params_mgr._records[c].location != "device"
            acc = self._ready(o, c, on_host=on_host)
            for r in range(self.nproc):
                if r == o:
                    continue
                # a replica on another tier comes over in a temporary
                # (not a pool move: the reference books none)
                acc += self._ready(r, c, on_host=on_host).to(
                    acc.device, non_blocking=not on_host)
        for r, core in enumerate(self.ranks):
            for c in cmap.comm_group_chunk_ids(group):
                if cmap.chunk_owner(c) != r and cmap.chunk_tensors(c):
                    core.params_mgr.mark_released(c)
            core.pool.account_reduce_scatter((self.nproc - 1) * chunk_bytes)
        self.retire_group(group)

    def retire_group(self, group: int) -> None:
        """Once EVERY rank's non-owned replicas of ``group`` are back in
        RELEASED, the group's staged-gather slot is retired (the gather
        prefetcher's in-flight cap bounds replicas actually held)."""
        if self.gather_prefetcher is None:
            return
        cmap = self.cmap
        ids = [c for c in cmap.comm_group_chunk_ids(group)
               if cmap.chunk_tensors(c)]
        if all(core.params_mgr.chunk_state(c) is ChunkState.RELEASED
               for r, core in enumerate(self.ranks)
               for c in ids if cmap.chunk_owner(c) != r):
            self.gather_prefetcher.retire(group)

    def advance_prefetch(self, moment: int) -> None:
        """Called by the last rank's moment cursor: stage upcoming group
        gathers."""
        if self.gather_prefetcher is not None:
            self.gather_prefetcher.advance(moment)

    # ------------------------------------------------------------------ step
    def _split_batch(self, batch: dict) -> list[dict]:
        b = int(batch["tokens"].shape[0])
        if b % self.nproc:
            raise ValueError(
                f"batch dim {b} must divide evenly over nproc={self.nproc}")
        per = b // self.nproc

        def shard(x, r):
            if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == b:
                return x[r * per:(r + 1) * per]
            return x  # scalars (global_tokens) replicate

        return [{k: shard(v, r) for k, v in batch.items()}
                for r in range(self.nproc)]

    def step(self, batch: dict) -> DistributedStepMetrics:
        """One lock-step data-parallel iteration: the single-rank engine's
        math on the full batch (grads sum across shards, losses carry
        1/global_tokens)."""
        cores = self.ranks
        shards = self._split_batch(batch)
        # per-rank ledgers are symmetric by construction; rank 0's delta
        # is the step's per-rank figure
        col0 = dataclasses.replace(cores[0].pool.collectives)
        warmup = cores[0].tracer.warmup

        sts = [core.begin_step(sh) for core, sh in zip(cores, shards)]

        # per-rank phase spans (fwd/bwd/adam) on each core's hub
        def _phase(label: str | None) -> None:
            for core in cores:
                tel = core.pool.telemetry
                if tel is None:
                    continue
                if label is None:
                    tel.close_span("phase", ts=core.pool._now(),
                                   rank=core.pool.telemetry_rank)
                else:
                    tel.switch_span("phase", label, ts=core.pool._now(),
                                    rank=core.pool.telemetry_rank)

        # ------------------------------------------------------------ forward
        _phase("fwd")
        for core, st in zip(cores, sts):
            core.forward_embed(st)
        for g in cores[0].model.groups():
            for core, st in zip(cores, sts):
                core.forward_group_start(st, g.name)
            for i in range(g.length):
                for core, st in zip(cores, sts):
                    core.forward_layer(st, g, i)
        for core, st in zip(cores, sts):
            core.end_forward(st)

        # ----------------------------------------------------------- backward
        _phase("bwd")
        for core, st in zip(cores, sts):
            core.begin_backward(st)
        for idx in range(len(sts[0].saved) - 1, -1, -1):
            done = [core.backward_layer(st, idx)
                    for core, st in zip(cores, sts)]
            # symmetric model + lock-step => identical completion sets
            assert all(d == done[0] for d in done[1:]), done
            for grp in done[0]:
                self.reduce_scatter_group(grp)
            for core, st in zip(cores, sts):
                core.backward_boundary(st, idx)
        for core, st in zip(cores, sts):
            core.backward_embed(st)
            core.end_backward(st)

        # -------------------------------- stem grad all-reduce (off-plane)
        # summed in rank order, as the reference associates it
        total_stem = sts[0].stem_grad
        for st in sts[1:]:
            total_stem = [a + b for a, b in zip(total_stem, st.stem_grad)]
        for st in sts:
            st.stem_grad = None
        # fp32 bytes a ring all-reduce moves, whatever the leaf's dtype
        stem_bytes = sum(g.numel() * 4 for g in total_stem)
        ar_bytes = 2 * (self.nproc - 1) * stem_bytes // self.nproc  # ring
        for core in cores:
            core.pool.account_allreduce(ar_bytes)

        # --------------------------------------------------------------- ADAM
        _phase("adam")
        for core, st in zip(cores, sts):
            core.adam_chunks(st)
        cores[0].update_stem(total_stem)
        del total_stem
        for core in cores[1:]:
            # replicated stem: share rank 0's list, which update_stem
            # rebinds item by item
            core._stem = cores[0]._stem

        _phase(None)
        mets = [core.end_step(st) for core, st in zip(cores, sts)]
        if warmup and self.gather_prefetcher is not None:
            self.gather_prefetcher.install(
                cores[0].tracer.gather_reference_sequence(self.cmap))

        d0 = self._collective_delta(cores[0].pool.collectives, col0)
        self.step_count += 1
        return DistributedStepMetrics(
            loss=float(sum(m.loss for m in mets)),
            rank_metrics=mets,
            allgather_bytes=d0.allgather_bytes,
            reduce_scatter_bytes=d0.reduce_scatter_bytes,
            allreduce_bytes=d0.allreduce_bytes,
            hidden_allgather_bytes=d0.hidden_allgather_bytes,
            critical_allgather_bytes=d0.critical_allgather_bytes,
        )

    @staticmethod
    def _collective_delta(now: CollectiveStats,
                          before: CollectiveStats) -> CollectiveStats:
        return CollectiveStats(**{
            f.name: getattr(now, f.name) - getattr(before, f.name)
            for f in dataclasses.fields(CollectiveStats)})

    # ------------------------------------------------------------- inspection
    @property
    def collectives(self) -> list[CollectiveStats]:
        """Cumulative per-rank collective ledgers."""
        return [core.pool.collectives for core in self.ranks]

    def check_invariants(self) -> None:
        for core in self.ranks:
            core.pool.check_invariants()
        # exactly one authoritative (owner) replica per payload chunk
        for c in range(self.cmap.num_chunks):
            if not self.cmap.chunk_tensors(c):
                continue
            o = self.cmap.chunk_owner(c)
            assert self.ranks[o].params_mgr._records[c].payload is not None, (
                f"owner rank {o} of chunk {c} has no payload")


# ---------------------------------------------------------------------------
# Rank-sharded serving fleet
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetRoundMetrics:
    """One lock-step serving round across all ranks (``None`` entries are
    ranks that had nothing to do this round)."""

    round_index: int
    rank_metrics: list  # ServeRoundMetrics | None, indexed by rank

    def _sum(self, field: str) -> int:
        return sum(getattr(m, field) for m in self.rank_metrics
                   if m is not None)

    @property
    def admitted(self) -> int:
        return self._sum("admitted")

    @property
    def completed(self) -> int:
        return self._sum("completed")

    @property
    def active(self) -> int:
        return self._sum("active")

    @property
    def queued(self) -> int:
        return self._sum("queued")

    @property
    def prefill_tokens(self) -> int:
        return self._sum("prefill_tokens")

    @property
    def decode_tokens(self) -> int:
        return self._sum("decode_tokens")

    @property
    def tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def peak_device_bytes(self) -> int:
        """Worst per-rank pool device high-water mark this round — the
        per-rank budget every rank must individually respect."""
        return max((m.peak_device_bytes for m in self.rank_metrics
                    if m is not None), default=0)


class DistributedServingEngine:
    """Rank-sharded serving: ``nproc`` independent serving cores advanced
    in lock-step rounds, sequences placed round-robin at submit time.

    Where the trainer shards *chunks* across ranks, the fleet shards
    *sequences*: every rank holds a full read-only param replica and its
    own sequences' KV pages, so scaling out multiplies concurrent-sequence
    capacity at a fixed per-rank budget with ZERO collectives (asserted in
    :meth:`check_invariants` against each rank's collective ledger).
    """

    def __init__(
        self,
        model_cls,
        cfg,
        *,
        nproc: int,
        device: str | torch.device = "cuda",
        device_memory_bytes: int,  # PER-RANK device budget
        host_memory_bytes: int | None = None,
        compiled: bool = False,
        seed: int = 0,
        pools: "list | None" = None,
        tenants: "list | None" = None,
        init_params: "Any | None" = None,
        **engine_kw,
    ) -> None:
        if nproc < 1:
            raise ValueError(f"nproc must be >= 1, got {nproc}")
        # co-tenancy: one shared pool (+ tenant handle) PER RANK — each
        # simulated rank owns its own device, so a co-resident fleet
        # shares memory rank-to-rank, never across ranks
        for arg, label in ((pools, "pools"), (tenants, "tenants")):
            if arg is not None and len(arg) != nproc:
                raise ValueError(f"{label}= needs one entry per rank "
                                 f"({len(arg)} != nproc {nproc})")
        self.nproc = nproc
        device = resolve_device(device)
        if compiled:
            from repro_torch.runtime.serve import CompiledServingEngine
            engine_cls = CompiledServingEngine
        else:
            from repro_torch.core.serving import ServingEngine
            engine_cls = ServingEngine

        # ONE init for all ranks: the fleet replicates parameters (and
        # rank 0's searched chunk size is reused by every rank)
        if init_params is None:
            init_params = model_cls(cfg, AxisCtx()).init_params(
                torch.Generator().manual_seed(seed))

        def make_core(r, csize):
            return engine_cls(
                model_cls, cfg, device=device,
                device_memory_bytes=device_memory_bytes,
                host_memory_bytes=host_memory_bytes,
                pool=pools[r] if pools is not None else None,
                tenant=tenants[r] if tenants is not None else None,
                chunk_size=csize, seed=seed, init_params=init_params,
                **engine_kw)

        rank0 = make_core(0, engine_kw.pop("chunk_size", None))
        self.ranks = [rank0] + [make_core(r, rank0.cmap.chunk_size)
                                for r in range(1, nproc)]
        del init_params
        # rank-tag each core's hub so fleet traces separate per rank
        for r, core in enumerate(self.ranks):
            tel = core.pool.telemetry
            if tel is not None:
                core.pool.set_telemetry(tel, rank=r)
        self._placement: dict[int, tuple[int, int]] = {}  # gid -> (rank, rid)
        self._next_gid = 0
        self._rr = 0
        self.rounds = 0

    # --------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        """Queue a request on the next rank round-robin; returns a fleet-
        global id.  KV for the sequence lives only on that rank."""
        rank = self._rr
        self._rr = (self._rr + 1) % self.nproc
        local = self.ranks[rank].submit(prompt, max_new_tokens)
        gid = self._next_gid
        self._next_gid += 1
        self._placement[gid] = (rank, local)
        return gid

    # ------------------------------------------------------------------ run
    def step_round(self) -> FleetRoundMetrics | None:
        """Advance every rank one continuous-batching round in lock-step.
        Returns ``None`` when the whole fleet is drained."""
        ms = [core.step_round() for core in self.ranks]
        if all(m is None for m in ms):
            return None
        self.rounds += 1
        return FleetRoundMetrics(round_index=self.rounds - 1,
                                 rank_metrics=ms)

    def run(self, max_rounds: int = 10_000) -> list[FleetRoundMetrics]:
        """Round until every submitted request has completed."""
        out: list[FleetRoundMetrics] = []
        while any(c.queued_count or c.active_count for c in self.ranks):
            if len(out) >= max_rounds:
                raise RuntimeError(
                    f"fleet did not drain within {max_rounds} rounds")
            m = self.step_round()
            assert m is not None
            out.append(m)
        return out

    # ------------------------------------------------------------- results
    def result(self, gid: int) -> list[int]:
        rank, rid = self._placement[gid]
        return self.ranks[rank].result(rid)

    @property
    def active_count(self) -> int:
        return sum(c.active_count for c in self.ranks)

    @property
    def queued_count(self) -> int:
        return sum(c.queued_count for c in self.ranks)

    @property
    def peak_concurrency(self) -> int:
        """Fleet-wide concurrent-sequence capacity actually reached: the
        sum of per-rank high-water marks (ranks admit independently)."""
        return sum(c.peak_concurrency for c in self.ranks)

    @property
    def total_decode_tokens(self) -> int:
        return sum(c.total_decode_tokens for c in self.ranks)

    @property
    def total_prefill_tokens(self) -> int:
        return sum(c.total_prefill_tokens for c in self.ranks)

    def check_invariants(self) -> None:
        for r, core in enumerate(self.ranks):
            core.check_invariants()
            col = core.pool.collectives
            moved = (col.allgather_bytes + col.reduce_scatter_bytes
                     + col.allreduce_bytes)
            assert moved == 0, (
                f"rank {r} booked {moved} collective bytes — serving KV "
                f"and params must stay rank-local")
