"""Unified heterogeneous memory space (PatrickStar Sections 6.2, 8).

The paper's central design point is that **all** model-data chunks — param
fp16, param fp32, momentum and variance — live in ONE CPU+GPU
heterogeneous memory space with a single device budget, orchestrated by
the warm-up statistics.  :class:`HeteroMemory` is that space: it owns the
device/host byte budgets, incremental usage counters, the unified
:class:`TransferStats`, and the eviction policies (opt/lru/fifo), while
:class:`~repro_torch.core.manager.ChunkManager` is a per-stream *view* that
registers its chunks with the pool.  Eviction therefore sees cross-stream
pressure: admitting a param chunk may push an optimizer-state chunk to the
host, exactly as in the paper's single space — the seed's
one-full-budget-per-stream managers could jointly oversubscribe the
device 4x and never competed with each other.

On top of the pool sits :class:`SchedulePrefetcher`, the schedule-driven
half of the design (the overlap technique of ZeRO-Infinity / AutoHete):
after the warm-up iteration the tracer's moment schedule is a total order
of future chunk references, so at every moment the next-k references can
be *staged* onto the device ahead of the operator that needs them.  The
container has no real async copy engine, so staging is simulated-async:
every H2D transfer is classified as **hidden** (issued by the prefetcher
ahead of demand, i.e. overlappable with compute) or **critical-path**
(a demand miss the operator must wait for).  Staging runs only on OPT
pools (it consumes the same future-reference schedule) and is
conservative: into free space, or by replaying the exact eviction Belady
would perform at the avoided miss (a victim not needed before the staged
chunk's use and farthest as seen from that moment among ALL residents);
when no such victim exists it refuses to stage.  On the engine's
scan-shaped traces this conserves total transfer volume exactly
(asserted in benchmarks/eviction.py), converting critical-path bytes
into hidden bytes instead of adding traffic; on arbitrary interleavings
residency can still shift between stage and use, and the prefetcher's
in-flight cap bounds the excess.

Eviction (Section 8.3): when the device tier cannot host an incoming
chunk, evict a HOLD-like, unpinned chunk of *any* stream.  Policies:

  "opt"   Belady's OPT using the *future* reference moments collected by
          the runtime memory tracer in the warm-up iteration — evict the
          chunk whose next use is farthest in the future (the paper's
          choice).  Schedules are per-stream: an OS chunk is only
          referenced again at its ADAM moment, a param chunk at its next
          FWD/BWD/ADAM use.
  "lru"   least recently used (classic; no future knowledge).
  "fifo"  first-in-first-out.

Chunks in COMPUTE state or explicitly pinned (collective communication in
flight, Algorithm 1 lines 12/18) are never evicted.

**Port: the tiers are real.**  Every decision above — victims, counters,
staging choices, OOM points — is the reference's, byte for byte.  What
changes is that a payload is a torch tensor that really lives on its
tier and every move is a real copy:

  * the ``"device"`` tier holds tensors on the pool's ``device`` (HBM on
    a CUDA pool); the ``"host"`` and ``"slow"`` tiers hold CPU tensors,
    pinned on a CUDA pool so copies can run asynchronously;
  * the first access of a FREE chunk allocates zeros — that zero-filled
    chunk IS the empty KV cache of the serving plane, so a reused buffer
    is never handed out dirty;
  * demand moves and evictions are ``non_blocking`` copies on the
    current stream;
  * :meth:`HeteroMemory.stage` copies on a dedicated copy stream, which
    first waits on the current stream (the destination buffer may have
    been freed by an eviction whose readers are still queued) and then
    records an event on the record; every consumer of the payload — the
    ``ensure_on`` hit path, an eviction, a release — waits on that event
    before touching or dropping it.

A CPU pool (``device="cpu"``) keeps the same tiers on CPU tensors, so the
parity tests run without a card.  The rank-parallel plane's ledger
(:meth:`HeteroMemory.account_allgather`, ``account_reduce_scatter``,
``account_allreduce``) and :class:`GatherPrefetcher` are the reference's:
the ranks are simulated in one process, so a collective is a copy between
two pools on the same device and the ledger books what the wire would
carry.  :mod:`repro_torch.core.distributed` makes those copies.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import Counter
from typing import TYPE_CHECKING, Callable, Iterable, Literal

import torch

from repro_torch import resolve_device
from repro_torch.core.state import ChunkState
from repro_torch.core.telemetry import Telemetry, default_hub
from repro_torch.core.timeline import TransferTimeline

if TYPE_CHECKING:  # pragma: no cover - import cycle with manager.py
    from repro_torch.core.manager import ChunkManager, _ChunkRecord

Device = Literal["device", "host", "slow"]
EvictionPolicy = Literal["opt", "lru", "fifo"]

# Tier stack, fastest first.  "slow" is the NVMe-class tier behind host
# memory (ZeRO-Infinity direction); it only exists on pools constructed
# with ``slow_capacity_bytes``.  Chunks move between ADJACENT tiers only:
# device<->host over the h2d/d2h lanes, host<->slow over h2s/s2h — a
# slow-resident chunk reaches the device via a two-hop route through host.
TIER_ORDER: tuple[Device, ...] = ("device", "host", "slow")

# DMA lane for a single-hop move between adjacent tiers.
_LINKS: dict[tuple[Device, Device], str] = {
    ("host", "device"): "h2d",
    ("device", "host"): "d2h",
    ("host", "slow"): "h2s",
    ("slow", "host"): "s2h",
}

_NEVER = 2**62  # "no known future use" sentinel for OPT


class OutOfMemory(RuntimeError):
    """Neither tier can host the chunk (the DeepSpeed failure mode, Fig. 10)."""


@dataclasses.dataclass
class TransferStats:
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    h2d_count: int = 0
    d2h_count: int = 0
    # host<->slow lanes; identically zero on two-tier pools
    h2s_bytes: int = 0
    s2h_bytes: int = 0
    h2s_count: int = 0
    s2h_count: int = 0

    @property
    def total_bytes(self) -> int:
        return self.h2d_bytes + self.d2h_bytes + self.h2s_bytes + self.s2h_bytes

    def reset(self) -> None:
        self.h2d_bytes = self.d2h_bytes = 0
        self.h2d_count = self.d2h_count = 0
        self.h2s_bytes = self.s2h_bytes = 0
        self.h2s_count = self.s2h_count = 0


@dataclasses.dataclass
class CollectiveStats:
    """Cross-rank communication ledger of one rank's pool (Section 7).

    Sits alongside :class:`TransferStats` (H2D/D2H is the *offload* plane,
    collectives are the *inter-process* plane): ``allgather_bytes`` counts
    bytes this rank RECEIVES fetching remote chunks ((p-1) chunks per
    communication group, padding included — exactly what a tiled
    ``lax.all_gather`` of the [G, p, S] store moves), and
    ``reduce_scatter_bytes`` counts grad bytes this rank SENDS to chunk
    owners ((p-1) non-owned chunks per group).  Both conventions make a
    rank's per-step total equal the paper's analytic 3(p-1)/p * M model
    (asserted in benchmarks/comm_volume.py).  ``allreduce_bytes`` tracks
    the stem (embedding/norm) grad all-reduce, which the paper keeps
    OUTSIDE chunk management (Section 8.2) — kept in a separate counter so
    the chunked-volume parity stays exact.  Like H2D bytes, all-gather
    bytes are split hidden (staged ahead by the gather prefetcher,
    overlappable) vs critical-path (a demand fetch the operator waits on).
    """

    allgather_bytes: int = 0
    reduce_scatter_bytes: int = 0
    allreduce_bytes: int = 0
    allgather_count: int = 0
    reduce_scatter_count: int = 0
    hidden_allgather_bytes: int = 0
    critical_allgather_bytes: int = 0

    @property
    def chunk_collective_bytes(self) -> int:
        """Chunked-plane volume (the analytic model's 3(p-1)/p * M)."""
        return self.allgather_bytes + self.reduce_scatter_bytes

    @property
    def total_bytes(self) -> int:
        return self.chunk_collective_bytes + self.allreduce_bytes

    def reset(self) -> None:
        self.allgather_bytes = self.reduce_scatter_bytes = 0
        self.allreduce_bytes = 0
        self.allgather_count = self.reduce_scatter_count = 0
        self.hidden_allgather_bytes = self.critical_allgather_bytes = 0


@dataclasses.dataclass
class PrefetchStats:
    """Overlap accounting for the simulated-async staging queue.

    Every H2D byte is either *hidden* (issued by the prefetcher before the
    consuming operator, overlappable with compute) or *critical-path* (a
    demand miss).  ``hidden + critical == TransferStats.h2d_bytes`` holds
    at all times.
    """

    hidden_h2d_bytes: int = 0
    critical_h2d_bytes: int = 0
    hits: int = 0  # device access found the chunk already staged
    demand_misses: int = 0  # device access had to move the chunk itself
    staged_transfers: int = 0  # H2D transfers issued by the prefetcher
    wasted_stages: int = 0  # staged chunks evicted before first use

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.demand_misses
        return self.hits / total if total else 0.0

    def reset(self) -> None:
        self.hidden_h2d_bytes = self.critical_h2d_bytes = 0
        self.hits = self.demand_misses = 0
        self.staged_transfers = self.wasted_stages = 0


_DEFAULT_TENANT = "default"


class Tenant:
    """One consumer of a shared :class:`HeteroMemory` pool (Angel-PTM
    direction: a single memory manager hosting many jobs).

    A tenant sits between the pool and its :class:`ChunkManager` streams:
    every stream registers under exactly one tenant, and the pool keeps a
    tenant-scoped mirror of the accounting it already keeps per stream —
    :class:`TransferStats`, :class:`PrefetchStats`, per-tier usage and the
    device high-water marks.  Two knobs give the co-tenancy semantics:

    ``priority``
        Victim selection shields higher-priority tenants: as long as such
        a tenant sits *within* its soft budget on a tier, a lower-priority
        tenant's demand can never evict its chunks there (serving's
        latency-critical kv pages outrank the trainer's cold optimizer
        states).  Same-or-higher-priority requesters see no shield.
    ``*_budget_bytes`` (per tier, all optional)
        *Soft* budgets.  They do not gate admission — the pool's tiers are
        one shared space with a common overflow region — but they anchor
        the eviction policy twice: within-budget residency of a
        higher-priority tenant is protected (above), and chunks of a
        tenant *over* its soft budget are reclaimed first, so the overflow
        region drains before anyone's in-budget residency is touched.

    Every pool starts with the ``"default"`` tenant (priority 0, no
    budgets); single-tenant pools never leave it, and with only the
    default tenant registered every rule above degenerates to the
    historical single-owner behavior bit-for-bit (same victims, same
    counters, same OOM points).

    Each tenant also owns a *moment cursor*: OPT schedules are per-stream
    and stream names are tenant-qualified (:meth:`qualify`), so one
    tenant's warm-up clock never positions another tenant's chunks in
    time — cross-tenant OPT comparisons normalize to distance-from-own-
    cursor instead of absolute moments.
    """

    def __init__(
        self,
        pool: "HeteroMemory",
        name: str,
        *,
        priority: int = 0,
        device_budget_bytes: int | None = None,
        host_budget_bytes: int | None = None,
        slow_budget_bytes: int | None = None,
    ) -> None:
        self.pool = pool
        self.name = name
        self.priority = priority
        self.device_budget_bytes = device_budget_bytes
        self.host_budget_bytes = host_budget_bytes
        self.slow_budget_bytes = slow_budget_bytes
        self.stats = TransferStats()
        self.prefetch = PrefetchStats()
        self._device_used = 0
        self._host_used = 0
        self._slow_used = 0
        self.peak_device_bytes = 0
        self._step_peak_device_bytes = 0
        self.current_moment = 0

    @property
    def is_default(self) -> bool:
        return self.name == _DEFAULT_TENANT

    @property
    def timeline_ns(self) -> str | None:
        """Moment namespace on a shared :class:`TransferTimeline` (the
        default tenant uses the unnamed namespace — byte-compatible with
        single-tenant pools that never mention tenants)."""
        return None if self.is_default else self.name

    def qualify(self, stream: str) -> str:
        """Pool-wide stream name for this tenant's ``stream``.  Identity
        for the default tenant (historical names), ``"tenant:stream"``
        otherwise — two engines can then both own a "param" stream."""
        return stream if self.is_default else f"{self.name}:{stream}"

    # ------------------------------------------------------------ accounting
    def device_bytes_used(self) -> int:
        return self._device_used

    def host_bytes_used(self) -> int:
        return self._host_used

    def slow_bytes_used(self) -> int:
        return self._slow_used

    def bytes_used(self, dev: Device) -> int:
        if dev == "device":
            return self._device_used
        return self._host_used if dev == "host" else self._slow_used

    def soft_budget(self, dev: Device) -> int | None:
        if dev == "device":
            return self.device_budget_bytes
        return (self.host_budget_bytes if dev == "host"
                else self.slow_budget_bytes)

    def over_budget(self, dev: Device) -> bool:
        """Holding more than the soft budget on this tier (no budget
        configured -> never over: nothing staked out, nothing to drain)."""
        b = self.soft_budget(dev)
        return b is not None and self.bytes_used(dev) > b

    def protected_on(self, dev: Device) -> bool:
        """Within a *configured* soft budget on this tier: lower-priority
        tenants cannot evict this tenant's chunks there."""
        b = self.soft_budget(dev)
        return b is not None and self.bytes_used(dev) <= b

    def take_step_peak_device_bytes(self) -> int:
        """Tenant-scoped analogue of the pool method: high-water mark since
        the previous call, re-armed at current usage."""
        peak = self._step_peak_device_bytes
        self._step_peak_device_bytes = self._device_used
        return peak

    def snapshot(self) -> tuple[TransferStats, PrefetchStats]:
        """Point-in-time copies of this tenant's transfer and prefetch
        counters — the per-step delta baseline both engines take."""
        return (dataclasses.replace(self.stats),
                dataclasses.replace(self.prefetch))

    # -------------------------------------------------------------- schedule
    def set_moment(self, moment: int) -> None:
        """Advance this tenant's moment cursor (and its namespace on the
        shared timeline).  Other tenants' clocks are untouched."""
        self.current_moment = moment
        if self.pool.timeline is not None:
            self.pool.timeline.advance_to_moment(moment,
                                                 tenant=self.timeline_ns)


class HeteroMemory:
    """The shared tiered (device/host[/slow]) chunk memory space.

    Streams (:class:`ChunkManager` views) register themselves; the pool
    owns every byte-accounting and movement decision.  Usage counters are
    incremental — ``device_bytes_used`` is O(1), not a scan — and are
    mirrored per-stream on each manager.

    By default the space is the paper's two-tier device/host budget.
    Passing ``slow_capacity_bytes`` appends an NVMe-class third tier
    behind host memory (the ZeRO-Infinity direction): host evictions
    demote to the slow tier instead of bouncing back to the device, and a
    slow-resident chunk promotes on demand via a two-hop s2h + h2d route.
    ``slow_capacity_bytes=None`` keeps the pool behavior-identical to the
    two-tier space.

    ``device`` is where the device tier's payloads live (``"cuda"`` by
    default; ``"cpu"`` keeps every tier on the CPU for the parity tests).
    """

    def __init__(
        self,
        *,
        device_capacity_bytes: int | None = None,
        host_capacity_bytes: int | None = None,
        slow_capacity_bytes: int | None = None,
        policy: EvictionPolicy = "opt",
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # side stream for staged (prefetched) H2D copies; created lazily
        self._copy_stream: torch.cuda.Stream | None = None
        self.device_capacity = device_capacity_bytes
        self.host_capacity = host_capacity_bytes
        self.slow_capacity = slow_capacity_bytes
        # ordered tier stack, fastest first; the slow tier exists only
        # when given a capacity (an unbounded NVMe tier would make the
        # unbounded host tier unreachable as an eviction target).
        self.tiers: tuple[Device, ...] = (
            TIER_ORDER if slow_capacity_bytes is not None
            else TIER_ORDER[:2])
        self.policy: EvictionPolicy = policy
        self.stats = TransferStats()  # unified, all streams
        self.prefetch = PrefetchStats()
        # cross-rank communication ledger (all zeros for single-rank pools)
        self.collectives = CollectiveStats()
        self._streams: dict[str, "ChunkManager"] = {}
        self._device_used = 0
        self._host_used = 0
        self._slow_used = 0
        # prefetchers holding installed reference queues over this pool;
        # unregister_stream drops their refs so recycled DynamicChunkMap
        # ids of a later stream never collide with stale entries.
        self._prefetchers: list["SchedulePrefetcher"] = []
        self.peak_device_bytes = 0  # cumulative (lifetime) high-water mark
        self._step_peak_device_bytes = 0  # high-water mark since last take_
        # clock advances on every access; used by LRU/FIFO and as the
        # "moment" cursor for OPT when no tracer moments are registered.
        self._clock = 0
        # OPT future-reference schedules, one per stream:
        # stream -> chunk_id -> sorted list of reference moments.
        self._moments: dict[str, dict[int, list[int]]] = {}
        # tenants: every stream belongs to exactly one.  The pool starts
        # with the "default" tenant (priority 0, no soft budgets);
        # single-tenant pools never leave it and keep the historical
        # single-owner behavior bit-for-bit.
        self._default_tenant = Tenant(self, _DEFAULT_TENANT)
        self._tenants: dict[str, Tenant] = {
            _DEFAULT_TENANT: self._default_tenant}
        # cross-tenant eviction ledger: (victim_tenant, requesting_tenant)
        # -> chunks demoted.  The co-tenancy protection guarantee is
        # checkable as evictions[(hi, lo)] == 0 while ``hi`` stays within
        # its soft budgets (asserted in benchmarks/cotenancy.py).
        self.evictions: Counter[tuple[str, str]] = Counter()
        # optional callbacks letting each tenant's tracer shrink the
        # device tier by its live non-model footprint; the deduction is
        # measured against that tenant's device share.
        self._chunkable_fns: dict[
            str, tuple[Tenant, Callable[[], int | None], int | None]] = {}
        # tenants whose soft budget shielded candidates in the most recent
        # victim scan — names a multi-tenant OOM refusal in make_room.
        self._blocked_by: set[str] = set()
        # chunks brought to device by the prefetcher, awaiting their use
        self._staged: set[tuple[str, int]] = set()
        # optional transfer timeline: every tier move is enqueued on a
        # finite-bandwidth DMA engine and hidden bytes in excess of the
        # consuming operator's compute window surface as stall seconds.
        self.timeline: TransferTimeline | None = None
        # >0 while the staging path runs: evictions it cascades are
        # overlappable (issued ahead of demand), not consumer waits.
        self._staging = 0
        # telemetry hub (None == disabled, one predicate per call site).
        # An explicit set_telemetry wins; the module-level default hub —
        # installed e.g. by the benchmark runner's --trace-dir — is
        # picked up at construction so unmodified call sites emit too.
        self.telemetry: Telemetry | None = default_hub()
        self.telemetry_rank: int | None = None
        if self.telemetry is not None:
            self.telemetry.attach_pool(self)

    # --------------------------------------------------------------- tenants
    @property
    def default_tenant(self) -> Tenant:
        return self._default_tenant

    @property
    def tenants(self) -> dict[str, Tenant]:
        return dict(self._tenants)

    @property
    def _current_moment(self) -> int:
        """Historical single-tenant cursor — the default tenant's clock."""
        return self._default_tenant.current_moment

    def create_tenant(
        self,
        name: str,
        *,
        priority: int = 0,
        device_budget_bytes: int | None = None,
        host_budget_bytes: int | None = None,
        slow_budget_bytes: int | None = None,
    ) -> Tenant:
        """Add a named tenant with per-tier soft budgets and an eviction
        priority (see :class:`Tenant`).  Streams register under it via
        ``ChunkManager(..., tenant=)`` / :meth:`PoolLease.stream`."""
        if not name or ":" in name:
            raise ValueError(
                f"invalid tenant name {name!r} (non-empty, no ':')")
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        t = Tenant(self, name, priority=priority,
                   device_budget_bytes=device_budget_bytes,
                   host_budget_bytes=host_budget_bytes,
                   slow_budget_bytes=slow_budget_bytes)
        self._tenants[name] = t
        return t

    def staged_count(self, tenant: Tenant | None = None) -> int:
        """In-flight staged chunks, pool-wide or for one tenant (the
        prefetcher in-flight caps are per tenant on shared pools — one
        tenant's staging burst must not throttle another's)."""
        if tenant is None:
            return len(self._staged)
        return sum(1 for s, _c in self._staged
                   if s in self._streams and self._streams[s].tenant is tenant)

    # --------------------------------------------------------------- streams
    def register_stream(self, mgr: "ChunkManager",
                        tenant: Tenant | None = None) -> None:
        if mgr.name in self._streams:
            raise ValueError(f"stream name {mgr.name!r} already registered")
        t = tenant or self._default_tenant
        if t.pool is not self:
            raise ValueError(
                f"tenant {t.name!r} belongs to a different pool")
        mgr.tenant = t
        self._streams[mgr.name] = mgr

    def unregister_stream(self, name: str) -> None:
        """Detach a stream and release every byte it holds (used when the
        activation stream is rebuilt for a new batch shape: act chunk
        layouts are batch-dependent, unlike the four model-data streams).
        Installed prefetcher queues drop the stream's references too — a
        later stream reusing the name (and recycled chunk ids) must never
        be staged off a stale schedule."""
        mgr = self._streams.pop(name, None)
        if mgr is None:
            raise KeyError(
                f"stream {name!r} is not registered with this pool "
                f"(known streams: {sorted(self._streams)})")
        for rec in mgr._records:
            if rec.payload is not None:
                self._uncharge(mgr, rec.location, mgr.chunk_bytes)
                self._settle(rec)
                rec.payload = None
                rec.location = None
            self._staged.discard((name, rec.chunk_id))
            if self.timeline is not None:
                self.timeline.cancel((name, rec.chunk_id))
        self._moments.pop(name, None)
        for pf in self._prefetchers:
            pf.drop_stream(name)

    @property
    def streams(self) -> dict[str, "ChunkManager"]:
        return dict(self._streams)

    # ------------------------------------------------------------ accounting
    def device_bytes_used(self) -> int:
        return self._device_used

    def host_bytes_used(self) -> int:
        return self._host_used

    def slow_bytes_used(self) -> int:
        return self._slow_used

    def _charge(self, mgr: "ChunkManager", dev: Device, nbytes: int) -> None:
        t = mgr.tenant
        if dev == "device":
            self._device_used += nbytes
            mgr._device_used += nbytes
            t._device_used += nbytes
            if mgr._device_used > mgr._peak_device_used:
                mgr._peak_device_used = mgr._device_used
            if t._device_used > t.peak_device_bytes:
                t.peak_device_bytes = t._device_used
            if t._device_used > t._step_peak_device_bytes:
                t._step_peak_device_bytes = t._device_used
            if self._device_used > self.peak_device_bytes:
                self.peak_device_bytes = self._device_used
            if self._device_used > self._step_peak_device_bytes:
                self._step_peak_device_bytes = self._device_used
        elif dev == "host":
            self._host_used += nbytes
            mgr._host_used += nbytes
            t._host_used += nbytes
        else:
            self._slow_used += nbytes
            mgr._slow_used += nbytes
            t._slow_used += nbytes

    def _uncharge(self, mgr: "ChunkManager", dev: Device, nbytes: int) -> None:
        t = mgr.tenant
        if dev == "device":
            self._device_used -= nbytes
            mgr._device_used -= nbytes
            t._device_used -= nbytes
        elif dev == "host":
            self._host_used -= nbytes
            mgr._host_used -= nbytes
            t._host_used -= nbytes
        else:
            self._slow_used -= nbytes
            mgr._slow_used -= nbytes
            t._slow_used -= nbytes

    def take_step_peak_device_bytes(self) -> int:
        """Device-tier high-water mark since the previous call, then re-arm
        at the *current* usage — per-step (not cumulative) peak, so
        benchmarks see per-phase pressure instead of a monotone max."""
        peak = self._step_peak_device_bytes
        self._step_peak_device_bytes = self._device_used
        return peak

    def check_invariants(self) -> None:
        """Recompute usage from the records and compare with the O(1)
        counters, and assert no tier budget is exceeded (test/debug hook;
        never needed on the hot path)."""
        dev = host = slow = 0
        by_tenant: dict[str, list[int]] = {
            name: [0, 0, 0] for name in self._tenants}
        for mgr in self._streams.values():
            mdev = mhost = mslow = 0
            for rec in mgr._records:
                if rec.payload is None:
                    continue
                if rec.location == "device":
                    mdev += mgr.chunk_bytes
                elif rec.location == "host":
                    mhost += mgr.chunk_bytes
                else:
                    mslow += mgr.chunk_bytes
            assert mdev == mgr._device_used, (mgr.name, mdev, mgr._device_used)
            assert mhost == mgr._host_used, (mgr.name, mhost, mgr._host_used)
            assert mslow == mgr._slow_used, (mgr.name, mslow, mgr._slow_used)
            acc = by_tenant[mgr.tenant.name]
            acc[0] += mdev
            acc[1] += mhost
            acc[2] += mslow
            dev += mdev
            host += mhost
            slow += mslow
        # tenant mirrors agree with their streams' sums, and the tenants'
        # sums agree with the pool totals (per-tenant counters sum to pool
        # usage — the co-tenancy accounting invariant).
        for name, t in self._tenants.items():
            tdev, thost, tslow = by_tenant[name]
            assert tdev == t._device_used, (name, tdev, t._device_used)
            assert thost == t._host_used, (name, thost, t._host_used)
            assert tslow == t._slow_used, (name, tslow, t._slow_used)
        assert dev == self._device_used, (dev, self._device_used)
        assert host == self._host_used, (host, self._host_used)
        assert slow == self._slow_used, (slow, self._slow_used)
        # bound against the STATIC capacities: host->device spills may by
        # design exceed the dynamic chunkable budget of the current moment
        # (margin-space overflow), and that budget also legally shrinks
        # between an admission and this check.
        if self.device_capacity is not None:
            assert self._device_used <= self.device_capacity, (
                self._device_used, self.device_capacity)
        if self.host_capacity is not None:
            assert self._host_used <= self.host_capacity, (
                self._host_used, self.host_capacity)
        if self.slow_capacity is not None:
            assert self._slow_used <= self.slow_capacity, (
                self._slow_used, self.slow_capacity)

    # ------------------------------------------------------------ collectives
    def account_allgather(self, nbytes: int, *, hidden: bool = False,
                          group: int | None = None) -> None:
        """Book bytes this rank received in a chunk-group all-gather.
        ``hidden`` marks a prefetcher-staged gather (overlappable), else
        the fetch is on the consuming operator's critical path.  With a
        timeline attached the gather also lands on the collective lane:
        a hidden gather's rendezvous key is ``("gather", group)`` — the
        consuming layer waits on it, so a gather issued too late for its
        overlap window surfaces as gather-stall seconds."""
        self.collectives.allgather_bytes += nbytes
        self.collectives.allgather_count += 1
        if hidden:
            self.collectives.hidden_allgather_bytes += nbytes
        else:
            self.collectives.critical_allgather_bytes += nbytes
        if self.timeline is not None:
            key = ("gather", group) if (hidden and group is not None) else None
            self.timeline.record_collective(nbytes, critical=not hidden,
                                            key=key)
        tel = self.telemetry
        if tel is not None:
            ts, dur = self._last_window()
            tel.collective("allgather", nbytes=nbytes, stream="param",
                           tenant=None, hidden=hidden, ts=ts, dur=dur,
                           moment=self._current_moment,
                           rank=self.telemetry_rank, group=group)

    def account_reduce_scatter(self, nbytes: int) -> None:
        """Book grad bytes this rank sent to chunk owners (Algorithm 2).
        On the timeline the reduce-scatter is overlappable (the paper
        overlaps it with remaining BWD compute); it still occupies the
        collective lane, so it delays any gather queued behind it."""
        self.collectives.reduce_scatter_bytes += nbytes
        self.collectives.reduce_scatter_count += 1
        if self.timeline is not None:
            self.timeline.record_collective(nbytes, critical=False)
        tel = self.telemetry
        if tel is not None:
            ts, dur = self._last_window()
            tel.collective("reduce_scatter", nbytes=nbytes, stream="param",
                           tenant=None, hidden=True, ts=ts, dur=dur,
                           moment=self._current_moment,
                           rank=self.telemetry_rank)

    def account_allreduce(self, nbytes: int) -> None:
        """Book non-chunk (stem) grad all-reduce bytes."""
        self.collectives.allreduce_bytes += nbytes
        if self.timeline is not None:
            self.timeline.record_collective(nbytes, critical=False,
                                            stream="stem")
        tel = self.telemetry
        if tel is not None:
            ts, dur = self._last_window()
            tel.collective("allreduce", nbytes=nbytes, stream="stem",
                           tenant=None, hidden=True, ts=ts, dur=dur,
                           moment=self._current_moment,
                           rank=self.telemetry_rank)

    # -------------------------------------------------------------- schedule
    def register_moments(self, stream: str, moments: dict[int, list[int]]) -> None:
        """Install a stream's warm-up reference schedule for OPT eviction."""
        self._moments[stream] = {c: sorted(ms) for c, ms in moments.items()}

    def set_moment(self, moment: int) -> None:
        """Advance the *default tenant's* moment cursor (the single-tenant
        entry point; engines on named tenants call their
        :meth:`Tenant.set_moment`)."""
        self._default_tenant.set_moment(moment)

    def set_timeline(self, timeline: TransferTimeline | None) -> None:
        """Attach a transfer timeline: every tier move (and collective)
        from here on is enqueued on its DMA engines."""
        self.timeline = timeline
        if timeline is not None and self.telemetry is not None:
            timeline.set_telemetry(self.telemetry, rank=self.telemetry_rank)

    def set_telemetry(self, telemetry: Telemetry | None, *,
                      rank: int | None = None) -> None:
        """Attach a telemetry hub: every tier move, eviction decision,
        prefetch phase, collective and OOM from here on emits a
        structured event, and the hub's flight recorder is appended to
        OutOfMemory reports.  ``rank`` tags every event (and Chrome-trace
        track) on distributed pools.  Re-pointing a pool (e.g. an explicit
        ``telemetry=`` overriding an adopted default hub) detaches it from
        the previous hub so each hub's counter ground truth covers exactly
        the pools whose events it holds."""
        if self.telemetry is not None and self.telemetry is not telemetry:
            self.telemetry.detach_pool(self)
        self.telemetry = telemetry
        self.telemetry_rank = rank
        if telemetry is not None:
            telemetry.attach_pool(self)
        if self.timeline is not None:
            self.timeline.set_telemetry(telemetry, rank=rank)

    def _now(self) -> float | None:
        """Event timestamp: the simulated clock when a timeline is
        attached, None (moment-index ordering) otherwise."""
        return self.timeline.now if self.timeline is not None else None

    def _last_window(self) -> tuple[float | None, float]:
        """(start ts, duration) of the transfer the timeline recorded
        last — the slice the matching telemetry event occupies."""
        if self.timeline is None:
            return None, 0.0
        start, end = self.timeline.last_window
        return start, end - start

    def set_chunkable_memory_fn(self, fn: Callable[[], int | None],
                                tenant: Tenant | None = None,
                                basis_bytes: int | None = None) -> None:
        """Tracer hook: returns the device bytes currently usable for the
        tenant's chunks.  On shared pools each tenant installs its own fn;
        the shortfall it reports (vs ``basis_bytes``, the device share the
        fn measures against — its lease/planning share) shrinks the
        pool-wide admission budget."""
        t = tenant or self._default_tenant
        self._chunkable_fns[t.name] = (t, fn, basis_bytes)

    def device_budget(self) -> int | None:
        if not self._chunkable_fns:
            return self.device_capacity
        if self.device_capacity is None:
            # unbounded tier: the throttle IS the budget (tightest wins)
            dyns = [fn() for _t, fn, _b in self._chunkable_fns.values()]
            dyns = [d for d in dyns if d is not None]
            return min(dyns) if dyns else None
        # each tenant's fn reports its chunkable bytes against its own
        # device share (the basis registered with the fn, else its soft
        # budget, else the whole tier); the shortfall is that tenant's
        # live non-model footprint and shrinks the shared tier for
        # everyone.  Single tenant: basis == cap, and
        # cap - max(0, cap - dyn) == min(cap, dyn), the historical value.
        budget = self.device_capacity
        for t, fn, basis in self._chunkable_fns.values():
            dyn = fn()
            if dyn is None:
                continue
            if basis is None:
                basis = t.device_budget_bytes
            if basis is None:
                basis = self.device_capacity
            budget -= max(0, basis - dyn)
        return budget

    def _next_use(self, stream: str, chunk_id: int, at: int | None = None) -> int:
        ms = self._moments.get(stream, {}).get(chunk_id)
        if not ms:
            return _NEVER  # never used again -> perfect victim
        if at is None:
            # the stream's own tenant clock: one tenant's schedule is
            # meaningless under another tenant's moment cursor
            mgr = self._streams.get(stream)
            at = (mgr.tenant.current_moment if mgr is not None
                  else self._default_tenant.current_moment)
        # bisect_left: a reference AT the query moment is still upcoming
        # (several chunks share one operator moment and are accessed in
        # sequence after it is recorded) — treating it as past would mark
        # a chunk the running operator needs as a perfect victim.
        i = bisect.bisect_left(ms, at)
        return ms[i] if i < len(ms) else _NEVER

    # --------------------------------------------------------------- paging
    def tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- payloads
    def _alloc(self, dev: Device, numel: int, dtype: torch.dtype, *,
               zero: bool) -> torch.Tensor:
        """A chunk buffer on tier ``dev``: HBM for the device tier of a
        CUDA pool, (pinned, on a CUDA pool) CPU memory otherwise."""
        make = torch.zeros if zero else torch.empty
        if dev == "device":
            return make(numel, dtype=dtype, device=self.device)
        return make(numel, dtype=dtype, pin_memory=self._cuda)

    def _settle(self, rec: "_ChunkRecord", *, on_host: bool = False) -> None:
        """Order the caller after the payload's pending asynchronous copy:
        the current stream waits on it (device consumers, and any drop of
        the buffer, whose memory the allocator may hand out next), or the
        host blocks on it (CPU reads of a freshly evicted payload)."""
        ev = rec.ready
        if ev is None:
            return
        rec.ready = None
        if on_host:
            ev.synchronize()
        else:
            torch.cuda.current_stream(self.device).wait_event(ev)

    def _copy_payload(self, rec: "_ChunkRecord", to_dev: Device, *,
                      staged: bool) -> None:
        """Move ``rec``'s bytes to a new buffer on ``to_dev`` (the real
        copy behind the bookkeeping in :meth:`_move`).  Staged H2D copies
        run on the copy stream and leave an event on the record; demand
        moves and evictions are ordered on the current stream."""
        src = rec.payload
        host_to_host = rec.location != "device" and to_dev != "device"
        self._settle(rec, on_host=host_to_host)
        dst = self._alloc(to_dev, src.numel(), src.dtype, zero=False)
        if not self._cuda or host_to_host:
            dst.copy_(src)
        elif staged:
            cur = torch.cuda.current_stream(self.device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            # the destination may be memory an eviction just freed while
            # its readers are still queued on the current stream
            self._copy_stream.wait_stream(cur)
            with torch.cuda.stream(self._copy_stream):
                dst.copy_(src, non_blocking=True)
            rec.ready = torch.cuda.Event()
            rec.ready.record(self._copy_stream)
        else:
            dst.copy_(src, non_blocking=True)
            if to_dev != "device":
                # the host bytes are valid once the stream gets here
                rec.ready = torch.cuda.Event()
                rec.ready.record(torch.cuda.current_stream(self.device))
        rec.payload = dst

    def ensure_on(self, mgr: "ChunkManager", chunk_id: int, dev: Device) -> "_ChunkRecord":
        """Demand paging: bring a stream's chunk to ``dev`` (Algorithm 1).
        On return the payload is usable on ``dev``: a device consumer's
        stream waits on a staged copy, a host consumer on an eviction."""
        rec = self._ensure_on(mgr, chunk_id, dev)
        self._settle(rec, on_host=dev != "device")
        return rec

    def _ensure_on(self, mgr: "ChunkManager", chunk_id: int, dev: Device) -> "_ChunkRecord":
        rec = mgr._records[chunk_id]
        now = self.tick()
        rec.last_use = now
        key = (mgr.name, chunk_id)
        if rec.payload is None:
            self.make_room(dev, mgr.chunk_bytes, exclude=key)
            # zero-fill is semantic: a fresh kv chunk IS an empty cache
            rec.payload = self._alloc(dev, mgr.cmap.chunk_size, mgr.dtype,
                                      zero=True)
            rec.location = dev
            rec.arrival = now
            self._charge(mgr, dev, mgr.chunk_bytes)
            return rec
        if rec.location != dev:
            if key in self._staged:
                # staged chunks live on the device, so this move is d2h:
                # the chunk was pulled host-side before its device use and
                # the staged H2D will be re-paid later — a wasted stage.
                for pf in (self.prefetch, mgr.tenant.prefetch):
                    pf.wasted_stages += 1
                self._staged.discard(key)
                if self.timeline is not None:
                    self.timeline.cancel(key)
                tel = self.telemetry
                if tel is not None:
                    tel.prefetch("stale", stream=mgr.name,
                                 tenant=mgr.tenant.name, chunk_id=chunk_id,
                                 nbytes=mgr.chunk_bytes, ts=self._now(),
                                 moment=mgr.tenant.current_moment,
                                 rank=self.telemetry_rank, why="left-device")
            # moves run between adjacent tiers only: a slow<->device
            # demand routes through host (s2h + h2d, both legs waited on).
            # Pin across the route: ``exclude`` shields the chunk from
            # direct victim picks, but an eviction CASCADE excludes only
            # its own incoming chunk — without the pin it could demote
            # this record off its mid-route tier (e.g. the h2d leg's
            # make_room bouncing it host->slow right before the move).
            rec.pinned += 1
            try:
                for hop in self._route(rec.location, dev):
                    # the chunk vacates its source tier as it lands on
                    # the next: let the capacity checks along the
                    # eviction cascade see those bytes as in flight,
                    # else a full mid-route tier deadlocks on the
                    # chunk's own (pinned, departing) residency
                    src = rec.location
                    self._uncharge(mgr, src, mgr.chunk_bytes)
                    try:
                        self.make_room(hop, mgr.chunk_bytes, exclude=key)
                    finally:
                        self._charge(mgr, src, mgr.chunk_bytes)
                    self._move(mgr, rec, hop, kind="demand")
            finally:
                rec.pinned -= 1
        elif dev == "device" and key in self._staged:
            for pf in (self.prefetch, mgr.tenant.prefetch):
                pf.hits += 1
            self._staged.discard(key)
            if self.timeline is not None:
                # the consumer arrived: a staged transfer still on the
                # wire stalls it for the remainder — hidden bytes beyond
                # the overlap window surface instead of disappearing.
                self.timeline.wait_for(key)
            tel = self.telemetry
            if tel is not None:
                tel.prefetch("hit", stream=mgr.name, tenant=mgr.tenant.name,
                             chunk_id=chunk_id, nbytes=mgr.chunk_bytes,
                             ts=self._now(),
                             moment=mgr.tenant.current_moment,
                             rank=self.telemetry_rank)
        return rec

    def release_payload(self, mgr: "ChunkManager", chunk_id: int) -> None:
        """Drop a chunk's payload and release its bytes (tensors all FREE)."""
        rec = mgr._records[chunk_id]
        if rec.payload is not None:
            self._uncharge(mgr, rec.location, mgr.chunk_bytes)
            self._settle(rec)
        rec.payload = None
        rec.location = None
        self._staged.discard((mgr.name, chunk_id))
        if self.timeline is not None:
            self.timeline.cancel((mgr.name, chunk_id))

    def _capacity(self, dev: Device) -> int | None:
        """Admission budget of a tier (device is dynamically throttled)."""
        if dev == "device":
            return self.device_budget()
        return self.host_capacity if dev == "host" else self.slow_capacity

    def _static_capacity(self, dev: Device) -> int | None:
        """Hard tier bound, ignoring the dynamic device throttle (the
        spill-destination limit: margin-space overflow may exceed the
        chunkable budget of the moment but never the physical tier)."""
        if dev == "device":
            return self.device_capacity
        return self.host_capacity if dev == "host" else self.slow_capacity

    def _used(self, dev: Device) -> int:
        if dev == "device":
            return self._device_used
        return self._host_used if dev == "host" else self._slow_used

    def _route(self, from_dev: Device, to_dev: Device) -> list[Device]:
        """Hop sequence from ``from_dev`` to ``to_dev`` walking adjacent
        tiers (device<->host<->slow): one hop between neighbours, two via
        host for the slow<->device pair."""
        if {from_dev, to_dev} == {"device", "slow"}:
            return ["host", to_dev]
        return [to_dev]

    def _evict_target(self, from_dev: Device) -> Device:
        """Eviction demotes one tier down the stack; the bottom tier
        bounces back up (two-tier: host->device, the paper's margin-space
        overflow; three-tier: slow->host)."""
        i = self.tiers.index(from_dev)
        return self.tiers[i + 1] if i + 1 < len(self.tiers) else self.tiers[i - 1]

    def _account_transfer(self, mgr: "ChunkManager", *, link: str) -> None:
        for st in (self.stats, mgr.stats, mgr.tenant.stats):
            if link == "h2d":
                st.h2d_bytes += mgr.chunk_bytes
                st.h2d_count += 1
            elif link == "d2h":
                st.d2h_bytes += mgr.chunk_bytes
                st.d2h_count += 1
            elif link == "h2s":
                st.h2s_bytes += mgr.chunk_bytes
                st.h2s_count += 1
            else:
                st.s2h_bytes += mgr.chunk_bytes
                st.s2h_count += 1

    def _move(
        self,
        mgr: "ChunkManager",
        rec: "_ChunkRecord",
        to_dev: Device,
        *,
        kind: str,  # "demand" | "evict" | "stage"
        after: float | None = None,
    ) -> float | None:
        """The single tier-move point: the real copy, transfer stats, the
        hidden/critical H2D split, byte counters, location and arrival.
        ``hidden + critical == h2d`` holds because every H2D goes through
        here with exactly one classification.  Moves span exactly one DMA
        link (adjacent tiers); multi-hop routes chain calls, passing the
        previous leg's returned completion time as ``after`` so the
        timeline serializes the legs.  Returns the timeline completion
        time of this leg (None without a timeline)."""
        link = _LINKS[(rec.location, to_dev)]
        self._account_transfer(mgr, link=link)
        if link == "h2d":
            for pf in (self.prefetch, mgr.tenant.prefetch):
                if kind == "stage":
                    pf.hidden_h2d_bytes += mgr.chunk_bytes
                    pf.staged_transfers += 1
                else:
                    # demand misses and evictions bounced back to the
                    # device are traffic the consuming operator waits on
                    pf.critical_h2d_bytes += mgr.chunk_bytes
                    if kind == "demand":
                        pf.demand_misses += 1
        end: float | None = None
        if self.timeline is not None:
            key = (mgr.name, rec.chunk_id)
            if link == "h2d":
                if kind == "stage":
                    end = self.timeline.record_h2d(
                        mgr.chunk_bytes, stream=mgr.name, critical=False,
                        key=key, start_after=after)
                else:
                    end = self.timeline.record_h2d(
                        mgr.chunk_bytes, stream=mgr.name, critical=True,
                        start_after=after)
            elif link == "s2h":
                # the fetch direction of the slow lane: a demand promotion
                # waits on it; a staged two-hop overlaps (the h2d leg
                # chained ``after`` it carries the rendezvous key).
                end = self.timeline.record_s2h(
                    mgr.chunk_bytes, stream=mgr.name,
                    critical=kind != "stage" and self._staging == 0,
                    start_after=after)
            else:
                # d2h / h2s, the demotion directions: issued by the
                # staging path (making room ahead of demand) they are
                # overlappable; a demand-path eviction blocks the
                # admission that triggered it.
                record = (self.timeline.record_d2h if link == "d2h"
                          else self.timeline.record_h2s)
                end = record(mgr.chunk_bytes, stream=mgr.name,
                             critical=self._staging == 0, start_after=after)
        tel = self.telemetry
        if tel is not None:
            # "bounce": an eviction moving UP the tier stack (the
            # bottom-tier overflow escape, e.g. host->device on two-tier
            # pools) rather than demoting down it.
            cause = ("bounce" if kind == "evict"
                     and TIER_ORDER.index(to_dev)
                     < TIER_ORDER.index(rec.location) else kind)
            if link == "h2d":
                crit = kind != "stage"
            elif link == "s2h":
                crit = kind != "stage" and self._staging == 0
            else:
                crit = self._staging == 0
            ts, dur = self._last_window()
            tel.move(link, stream=mgr.name, tenant=mgr.tenant.name,
                     chunk_id=rec.chunk_id, nbytes=mgr.chunk_bytes,
                     cause=cause, critical=crit, ts=ts, dur=dur,
                     moment=mgr.tenant.current_moment,
                     rank=self.telemetry_rank)
            if link == "h2d" and kind == "demand":
                tel.prefetch("miss", stream=mgr.name, tenant=mgr.tenant.name,
                             chunk_id=rec.chunk_id, nbytes=mgr.chunk_bytes,
                             ts=ts, moment=mgr.tenant.current_moment,
                             rank=self.telemetry_rank)
        self._copy_payload(rec, to_dev, staged=kind == "stage")
        self._uncharge(mgr, rec.location, mgr.chunk_bytes)
        rec.location = to_dev
        self._charge(mgr, to_dev, mgr.chunk_bytes)
        rec.arrival = self.tick()
        return end

    def _usage_report(self) -> str:
        """Per-tier, per-stream usage breakdown for OutOfMemory messages.
        On multi-tenant pools streams group under their tenant, each
        tenant annotated with its tier usage (and soft budget when set) —
        a refusal must be explainable per tenant, not just per stream."""
        lines = []
        multi = len(self._tenants) > 1
        for dev in self.tiers:
            cap = self._static_capacity(dev)
            if multi:
                groups = []
                for tname, t in sorted(self._tenants.items()):
                    per_t = ", ".join(
                        f"{name}={self._stream_used(mgr, dev)}"
                        for name, mgr in sorted(self._streams.items())
                        if mgr.tenant is t)
                    if not per_t:
                        continue
                    budget = t.soft_budget(dev)
                    used = t.bytes_used(dev)
                    head = (f"{tname}[{used}/{budget}]" if budget is not None
                            else f"{tname}[{used}]")
                    groups.append(f"{head}: {per_t}")
                per = "; ".join(groups)
            else:
                per = ", ".join(
                    f"{name}={self._stream_used(mgr, dev)}"
                    for name, mgr in sorted(self._streams.items()))
            lines.append(
                f"  {dev}: used={self._used(dev)}"
                f"/{'unbounded' if cap is None else cap}"
                + (f" ({per})" if per else ""))
        return "tier usage by stream:\n" + "\n".join(lines)

    @staticmethod
    def _stream_used(mgr: "ChunkManager", dev: Device) -> int:
        if dev == "device":
            return mgr._device_used
        return mgr._host_used if dev == "host" else mgr._slow_used

    def _oom(self, reason: str, detail: str) -> OutOfMemory:
        """Build an :class:`OutOfMemory`: the usage report as always, plus
        — with a hub attached — an ``oom`` event (naming any shielding
        tenants) and the flight recorder's last 32 events, so eviction-
        shield deadlocks are diagnosable post-mortem."""
        msg = f"{detail}\n{self._usage_report()}"
        tel = self.telemetry
        if tel is not None:
            tel.oom(reason, ts=self._now(), rank=self.telemetry_rank,
                    blocked_by=sorted(self._blocked_by))
            msg = f"{msg}\n{tel.flight_report(32)}"
        return OutOfMemory(msg)

    def make_room(
        self, dev: Device, nbytes: int, *, exclude: tuple[str, int]
    ) -> None:
        # the requesting tenant — the incoming chunk's owner — drives the
        # priority shield at this hop
        emgr = self._streams.get(exclude[0])
        req = emgr.tenant if emgr is not None else self._default_tenant
        # a requester with a soft budget on this tier keeps ITSELF inside
        # it when it can: its own coldest chunks demote first — the
        # eviction pressure a solo engine's pool cap exerts, reproduced
        # against the tenant share on shared pools (otherwise a budgeted
        # tenant would sprawl into the peer's headroom and its "budgets
        # hold" guarantee would be vacuous).  Soft: with no own victim
        # the overflow stands; budgets never hard-gate admission.
        budget = req.soft_budget(dev)
        if budget is not None:
            rounds = sum(len(m._records) for m in self._streams.values()) + 1
            while req.bytes_used(dev) + nbytes > budget and rounds > 0:
                victim = self._pick_victim(dev, exclude=exclude, within=req)
                if victim is None:
                    break
                rounds -= 1
                self._evict(*victim, from_dev=dev, by=req)
        cap = self._capacity(dev)
        if cap is None:
            return
        # bound the loop: with every other tier full an eviction can bounce
        # its cascade right back (net-zero progress), so "no progress in
        # #chunks rounds" is a genuine capacity failure, not bad luck.
        rounds = sum(len(m._records) for m in self._streams.values()) + 1
        while self._used(dev) + nbytes > cap:
            victim = self._pick_victim(dev, exclude=exclude, by=req)
            if victim is None:
                blocked = ""
                if self._blocked_by:
                    blocked = (
                        "; candidates remain but are shielded by the soft "
                        "budget of higher-priority tenant(s): "
                        + ", ".join(sorted(self._blocked_by)))
                raise self._oom(
                    "no-evictable",
                    f"unified pool: cannot fit {nbytes} bytes on {dev}: "
                    f"used={self._used(dev)} cap={cap} and no evictable "
                    f"chunk (every resident is pinned, in COMPUTE, or the "
                    f"incoming chunk itself){blocked}")
            if rounds <= 0:
                raise self._oom(
                    "no-progress",
                    f"unified pool: cannot fit {nbytes} bytes on {dev}: "
                    f"used={self._used(dev)} cap={cap}; evictable chunks "
                    f"remain but eviction made no net progress (cascades "
                    f"bounce between full tiers)")
            rounds -= 1
            self._evict(*victim, from_dev=dev, by=req)

    def _evictable(
        self, dev: Device, exclude: tuple[str, int],
        by: Tenant | None = None,
        within: "Tenant | None" = None,
    ) -> list[tuple["ChunkManager", "_ChunkRecord"]]:
        out = []
        self._blocked_by = set()
        for mgr in self._streams.values():
            if within is not None and mgr.tenant is not within:
                # self-eviction-to-budget scan: only the requester's own
                # residency is a candidate
                continue
            for rec in mgr._records:
                if (mgr.name, rec.chunk_id) == exclude:
                    continue
                if rec.payload is None or rec.location != dev:
                    continue
                if rec.pinned > 0:
                    continue
                if mgr.chunk_state(rec.chunk_id) is ChunkState.COMPUTE:
                    continue
                t = mgr.tenant
                if (by is not None and t is not by
                        and t.priority > by.priority and t.protected_on(dev)):
                    # priority shield: a higher-priority tenant within its
                    # soft budget never loses a chunk to a lower-priority
                    # tenant's demand
                    self._blocked_by.add(t.name)
                    continue
                out.append((mgr, rec))
        return out

    def _pick_victim(
        self, dev: Device, *, exclude: tuple[str, int],
        by: Tenant | None = None,
        within: "Tenant | None" = None,
    ) -> tuple["ChunkManager", "_ChunkRecord"] | None:
        cands = self._evictable(dev, exclude, by, within)
        if not cands:
            return None
        # tenants over their soft budget give up chunks first (the shared
        # overflow region drains before anyone's in-budget residency);
        # single-tenant pools never configure budgets, so the urgency key
        # is constant and the historical ordering — ties included — is
        # preserved exactly.
        if self.policy == "fifo":
            return min(cands, key=lambda mr: (
                0 if mr[0].tenant.over_budget(dev) else 1, mr[1].arrival))
        if self.policy == "lru":
            return min(cands, key=lambda mr: (
                0 if mr[0].tenant.over_budget(dev) else 1, mr[1].last_use))
        # OPT / Belady: farthest next use according to the tracer
        # schedule.  Cross-tenant moment clocks are incomparable absolute
        # values (a serving tenant's moments grow without bound while a
        # trainer's reset each step), so compare the *distance* from each
        # chunk's own tenant cursor — a constant offset within one tenant,
        # hence argmax- and tie-break-identical on single-tenant pools.
        return max(cands, key=lambda mr: (
            0 if not mr[0].tenant.over_budget(dev) else 1,
            self._next_use(mr[0].name, mr[1].chunk_id)
            - mr[0].tenant.current_moment))

    def _evict(
        self,
        mgr: "ChunkManager",
        rec: "_ChunkRecord",
        *,
        from_dev: Device,
        by: Tenant | None = None,
        _depth: int = 0,
    ) -> None:
        if _depth > sum(len(m._records) for m in self._streams.values()):
            # cascades bouncing between full tiers would otherwise
            # recurse forever; this is a genuine capacity fail
            raise self._oom(
                "cascade-cycle",
                "unified pool: eviction cascade cycled — every tier full")
        key = (mgr.name, rec.chunk_id)
        if key in self._staged:
            for pf in (self.prefetch, mgr.tenant.prefetch):
                pf.wasted_stages += 1
            self._staged.discard(key)
            if self.timeline is not None:
                self.timeline.cancel(key)
            tel = self.telemetry
            if tel is not None:
                tel.prefetch("stale", stream=mgr.name, tenant=mgr.tenant.name,
                             chunk_id=rec.chunk_id, nbytes=mgr.chunk_bytes,
                             ts=self._now(),
                             moment=mgr.tenant.current_moment,
                             rank=self.telemetry_rank, why="evicted")
        if mgr.chunk_state(rec.chunk_id) is ChunkState.FREE:
            self.release_payload(mgr, rec.chunk_id)
            return
        if by is not None:
            # who-demoted-whom ledger (FREE releases above lose nothing
            # and are not evictions in the accountable sense)
            self.evictions[(mgr.tenant.name, by.name)] += 1
        to_dev = self._evict_target(from_dev)
        tel = self.telemetry
        if tel is not None:
            vt = mgr.tenant
            tel.evict(victim=vt.name,
                      requester=by.name if by is not None else vt.name,
                      policy=self.policy,
                      urgency=("over-budget" if vt.over_budget(from_dev)
                               else "in-budget"),
                      stream=mgr.name, chunk_id=rec.chunk_id,
                      nbytes=mgr.chunk_bytes, src=from_dev, dst=to_dev,
                      ts=self._now(), moment=vt.current_moment,
                      rank=self.telemetry_rank)
        # spill destination bound: a bottom-tier bounce (two-tier:
        # host->device, the paper's margin-space overflow of Fig. 10's
        # host-too-small case) is limited by the *static* tier capacity,
        # not by the dynamic chunkable budget that throttles ordinary
        # admissions.  Cascade size-aware: with heterogeneous per-stream
        # chunk sizes one small victim can leave the destination still
        # over budget, so keep evicting until the incoming chunk actually
        # fits (a single-victim cascade silently overflowed the tier).
        cap = self._static_capacity(to_dev)
        if cap is not None:
            rounds = sum(len(m._records) for m in self._streams.values()) + 1
            while self._used(to_dev) + mgr.chunk_bytes > cap:
                # at this hop the incoming chunk is the demoted victim, so
                # ITS tenant is the requester for the priority shield
                victim = self._pick_victim(to_dev, exclude=key,
                                           by=mgr.tenant)
                if victim is None:
                    raise self._oom(
                        "target-full",
                        f"unified pool: eviction target {to_dev} full and "
                        f"no victim")
                if rounds <= 0:
                    raise self._oom(
                        "target-no-progress",
                        f"unified pool: eviction target {to_dev} full and "
                        f"cascades make no net progress")
                rounds -= 1
                self._evict(*victim, from_dev=to_dev, by=mgr.tenant,
                            _depth=_depth + 1)
        self._move(mgr, rec, to_dev, kind="evict")

    # -------------------------------------------------------------- staging
    def stage(self, stream: str, chunk_id: int) -> bool:
        """Simulated-async prefetch: move a chunk to the device ahead of its
        use, classifying the H2D as *hidden*.  OPT-policy pools only —
        staging is driven by the future-reference schedule, and letting it
        evict under lru/fifo would inject that future knowledge into the
        baseline policies (and skew their measured volume).

        Conservative: stages only into free space, or by replaying the
        eviction demand paging would perform at the chunk's use moment
        ``t`` — a victim must not be referenced before ``t`` (else staging
        would thrash a sooner-needed chunk), must be the farthest-next-use
        *as seen from t* among ALL device residents (Belady's pick at the
        avoided miss), and otherwise staging is refused.  On the engine's
        scan-shaped traces this conserves total transfer volume exactly
        (asserted in benchmarks/eviction.py); on arbitrary interleavings
        residency can still shift between the stage and the use, so the
        in-flight cap in :class:`SchedulePrefetcher` bounds any excess.
        Returns True if the chunk is on-device and marked staged."""
        if self.policy != "opt":
            return False
        mgr = self._streams.get(stream)
        if mgr is None:
            return False  # dynamic stream unregistered after refs installed
        if not 0 <= chunk_id < len(mgr._records):
            # a stale reference from before the stream was rebuilt: a new
            # stream reusing the name may have fewer chunks than the ids
            # an old schedule mentions (DynamicChunkMap recycles ids)
            return False
        rec = mgr._records[chunk_id]
        key = (stream, chunk_id)
        if rec.payload is None or rec.location == "device":
            return False  # nothing to hide (materialization moves no bytes)
        if mgr.chunk_state(chunk_id) is ChunkState.FREE:
            return False
        t_use = self._next_use(stream, chunk_id)
        if t_use == _NEVER:
            return False  # no known future device use: nothing to front-run
        self._staging += 1
        try:
            return self._stage_locked(mgr, rec, key, t_use)
        finally:
            self._staging -= 1

    def _stage_locked(self, mgr: "ChunkManager", rec: "_ChunkRecord",
                      key: tuple[str, int], t_use: int) -> bool:
        # a budgeted tenant's staging makes room against the TIGHTER of
        # the shared tier cap and its own device soft budget — speculative
        # prefetch must not sprawl past the share its demand path defends
        budget = mgr.tenant.soft_budget("device")

        def _need_room() -> bool:
            cap = self._capacity("device")
            if cap is not None and self._used("device") + mgr.chunk_bytes > cap:
                return True
            return (budget is not None
                    and mgr.tenant.bytes_used("device") + mgr.chunk_bytes
                    > budget)

        while _need_room():
            # one sweep over device residents: collect the best evictable
            # victim (not needed before t_use, farthest as seen from it)
            # and the farthest-from-t_use value over ALL residents — if
            # any unevictable resident beats the victim, demand paging at
            # t_use would pick that one instead, so refuse to diverge.
            best: tuple["ChunkManager", "_ChunkRecord"] | None = None
            best_at_use = -1
            resident_max = -1
            for omgr in self._streams.values():
                if omgr.tenant is not mgr.tenant:
                    # staging stays tenant-scoped: a tenant's warm-up
                    # prefetch reasons in its own moment clock and must
                    # never reclaim another tenant's residency — cross-
                    # tenant space is taken only on the demand path, under
                    # the priority shield.
                    continue
                for orec in omgr._records:
                    if orec.payload is None or orec.location != "device":
                        continue
                    if (omgr.name, orec.chunk_id) == key:
                        continue
                    nu_at_use = self._next_use(
                        omgr.name, orec.chunk_id, at=t_use)
                    resident_max = max(resident_max, nu_at_use)
                    if self._next_use(omgr.name, orec.chunk_id) <= t_use:
                        continue  # needed before the staged chunk's use
                    if orec.pinned > 0:
                        continue
                    if omgr.chunk_state(orec.chunk_id) is ChunkState.COMPUTE:
                        continue
                    if nu_at_use > best_at_use:
                        best_at_use = nu_at_use
                        best = (omgr, orec)
            if best is None or best_at_use < resident_max:
                return False
            self._evict(*best, from_dev="device", by=mgr.tenant)
        # a slow-resident chunk needs a two-hop stage: s2h onto the host,
        # then h2d chained after it on the timeline.  Host room is made
        # under the staging flag, so any demotions it cascades stay
        # overlappable.
        after: float | None = None
        if rec.location == "slow":
            self.make_room("host", mgr.chunk_bytes, exclude=key)
            after = self._move(mgr, rec, "host", kind="stage")
        self._move(mgr, rec, "device", kind="stage", after=after)
        self._staged.add(key)
        tel = self.telemetry
        if tel is not None:
            tel.prefetch("issue", stream=mgr.name, tenant=mgr.tenant.name,
                         chunk_id=rec.chunk_id, nbytes=mgr.chunk_bytes,
                         ts=self._now(), moment=mgr.tenant.current_moment,
                         rank=self.telemetry_rank, use_at=t_use)
        return True


class SchedulePrefetcher:
    """Schedule-driven staging queue over a :class:`HeteroMemory` pool.

    After warm-up the tracer yields the iteration's full reference
    sequence ``(moment, stream, chunk_id)``.  ``advance(m)`` stages every
    reference in the window ``(m, m + lookahead]`` — the next-k chunk
    references per stream — before the operator at moment ``m`` runs, so
    their H2D transfers overlap that operator's compute (simulated-async:
    the pool books them as hidden bytes).

    **Bandwidth-aware mode** (``timeline=`` set and durations installed):
    issue depth and issue *time* are chosen against the timeline's
    projected idle windows instead of the fixed ``lookahead`` /
    ``max_inflight``.  Walking upcoming references in schedule order, a
    reference is staged now iff its projected completion (H2D queue
    backlog + wire time) fits inside the compute window until its use
    moment — i.e. the transfer is *actually hidable* — or it is within
    the base ``lookahead`` anyway (an imminent reference gains partial
    overlap even when it cannot fully hide).  The walk stops at the
    first reference that is neither: issuing it now would only park a
    late transfer and occupy memory.  Byte volume stays neutral — every
    stage still goes through the pool's conservative ``stage()`` rule —
    but lead time adapts to bandwidth, which is what cuts stall seconds
    (asserted in benchmarks/timeline.py)."""

    def __init__(
        self, pool: HeteroMemory, *, lookahead: int = 6, max_inflight: int = 2,
        timeline: TransferTimeline | None = None, bw_inflight_cap: int = 16,
        bw_horizon: int = 64, tenant: Tenant | None = None,
    ) -> None:
        self.pool = pool
        # the tenant whose schedule this queue serves: in-flight caps
        # count only its staged chunks and the bandwidth-aware policy
        # reads its moment namespace on a shared timeline.  None (the
        # historical single-owner construction) behaves pool-wide.
        self.tenant = tenant
        self._ns = tenant.timeline_ns if tenant is not None else None
        self.lookahead = lookahead
        # staged-but-not-yet-consumed chunks are capped: staging far past
        # the working set only parks chunks where the next demand miss
        # evicts them again (wasted transfers on tight budgets).
        self.max_inflight = max_inflight
        self.timeline = timeline
        # bandwidth-aware mode still bounds device residency, just looser:
        # depth is chosen by the overlap window, the cap is the backstop.
        self.bw_inflight_cap = bw_inflight_cap
        self.bw_horizon = bw_horizon  # max refs scanned per advance
        self._moments: list[int] = []
        self._refs: list[tuple[int, str, int]] = []
        # the pool tells us when a stream detaches so the queue never
        # stages a later same-named stream off a stale schedule
        pool._prefetchers.append(self)

    @property
    def installed(self) -> bool:
        return bool(self._refs)

    def install(self, refs: Iterable[tuple[int, str, int]]) -> None:
        """``refs``: (moment, stream, chunk_id) for one whole iteration."""
        self._refs = sorted(refs)
        self._moments = [m for m, _, _ in self._refs]

    def drop_stream(self, stream: str) -> None:
        """Forget every queued reference of a detached stream (called by
        :meth:`HeteroMemory.unregister_stream`): a rebuilt stream reusing
        the name recycles chunk ids, so stale refs could stage the wrong
        chunk."""
        if not self._refs:
            return
        self._refs = [r for r in self._refs if r[1] != stream]
        self._moments = [m for m, _, _ in self._refs]

    @property
    def bandwidth_aware(self) -> bool:
        return (self.timeline is not None
                and self.timeline.has_durations_for(self._ns))

    def advance(self, moment: int) -> int:
        """Stage upcoming references; returns how many chunks were staged."""
        if not self._refs or self.lookahead <= 0:
            return 0
        if self.bandwidth_aware:
            return self._advance_bandwidth_aware(moment)
        lo = bisect.bisect_right(self._moments, moment)
        hi = bisect.bisect_right(self._moments, moment + self.lookahead)
        staged = 0
        for m, stream, chunk_id in self._refs[lo:hi]:
            if self.pool.staged_count(self.tenant) >= self.max_inflight:
                break
            if self.pool.stage(stream, chunk_id):
                staged += 1
        return staged

    def _advance_bandwidth_aware(self, moment: int) -> int:
        tl = self.timeline
        assert tl is not None
        lo = bisect.bisect_right(self._moments, moment)
        staged = 0
        for m, stream, chunk_id in self._refs[lo:lo + self.bw_horizon]:
            if self.pool.staged_count(self.tenant) >= self.bw_inflight_cap:
                break
            mgr = self.pool._streams.get(stream)
            if mgr is None or not 0 <= chunk_id < len(mgr._records):
                continue
            if (stream, chunk_id) in self.pool._staged:
                continue
            ready = tl.projected_ready_s("h2d", mgr.chunk_bytes)
            if mgr._records[chunk_id].location == "slow":
                # two-hop stage: the chunk must first cross the slow lane,
                # so its projected landing sums both links' backlogs
                ready += tl.projected_ready_s("s2h", mgr.chunk_bytes)
            if ready <= tl.time_until(m, tenant=self._ns):
                # fits inside the projected idle window before its use
                if self.pool.stage(stream, chunk_id):
                    staged += 1
            elif m <= moment + self.lookahead:
                # imminent: cannot fully hide, but issuing now still
                # converts part of the wait into overlap
                if self.pool.stage(stream, chunk_id):
                    staged += 1
            else:
                # neither hidable nor imminent: the H2D queue is already
                # saturated past this reference's window — stop issuing
                break
        return staged


class GatherPrefetcher:
    """Schedule-driven staging of upcoming remote-group *all-gathers*.

    The distributed eager plane has a second kind of fetch the paper
    overlaps with compute (Section 7 / Fig. 9): a chunk whose owner is a
    remote rank arrives by collective, not by H2D.  After warm-up, the
    tracer's reference sequence tells us which communication group every
    upcoming operator reads, so the driver can issue the group's
    all-gather ahead of the consuming operator — those bytes are booked
    *hidden* in :class:`CollectiveStats`, while demand gathers triggered
    inside an access are *critical-path*.  ``fetch_group(group)`` is the
    driver's collective (it must return True iff a gather actually ran;
    resident groups return False and don't count against the in-flight
    cap).

    The in-flight cap is **global across calls**, mirroring
    :class:`SchedulePrefetcher`'s ``pool._staged`` check: a staged gather
    materializes (p-1)/p of a whole group on every rank and those bytes
    stay resident until the group's replicas are dropped after its
    post-FWD/BWD transition, so the driver must :meth:`retire` the group
    at that drop — only then does a staging slot free up.  (A per-call
    counter would let up to ``lookahead`` unconsumed groups pile up
    across consecutive ``advance()`` calls, silently exceeding the
    documented memory bound.)

    In **bandwidth-aware mode** (``timeline=`` plus ``group_bytes``) the
    issue depth follows the collective lane's projected idle window, the
    same policy as :class:`SchedulePrefetcher`: gather a group ahead iff
    its wire time fits the compute until its consuming moment (or it is
    within the base lookahead), stop at the first group that is neither.
    The in-flight *memory* bound still applies via ``bw_inflight_cap``
    (each staged gather holds (p-1)/p of a group on every rank)."""

    def __init__(
        self,
        fetch_group: Callable[[int], bool],
        *,
        lookahead: int = 2,
        max_inflight: int = 1,
        timeline: TransferTimeline | None = None,
        group_bytes: int = 0,
        bw_inflight_cap: int = 4,
        bw_horizon: int = 16,
    ) -> None:
        self.fetch_group = fetch_group
        self.lookahead = lookahead
        # a staged gather materializes (p-1)/p of a whole group on every
        # rank at once, so in-flight gathers are capped much tighter than
        # in-flight H2D stages.
        self.max_inflight = max_inflight
        self.timeline = timeline
        self.group_bytes = group_bytes
        self.bw_inflight_cap = bw_inflight_cap
        self.bw_horizon = bw_horizon
        self._moments: list[int] = []
        self._refs: list[tuple[int, int]] = []
        # groups staged by this prefetcher whose replicas are still held
        # (gathered, not yet dropped post-FWD/BWD) — the in-flight set
        # the cap bounds.
        self._inflight: set[int] = set()

    @property
    def installed(self) -> bool:
        return bool(self._refs)

    @property
    def inflight(self) -> frozenset[int]:
        """Staged-but-not-yet-dropped groups (test/debug surface)."""
        return frozenset(self._inflight)

    def install(self, group_refs: Iterable[tuple[int, int]]) -> None:
        """``group_refs``: (moment, comm_group) of one whole iteration —
        one entry per (moment, group), already deduplicated."""
        self._refs = sorted(set(group_refs))
        self._moments = [m for m, _ in self._refs]
        self._inflight.clear()

    def retire(self, group: int) -> None:
        """The staged group's replicas were dropped (post-FWD release or
        post-BWD reduce-scatter): its staging slot frees up."""
        self._inflight.discard(group)

    @property
    def bandwidth_aware(self) -> bool:
        return (self.timeline is not None and self.timeline.has_durations
                and self.group_bytes > 0)

    def advance(self, moment: int) -> int:
        """Gather upcoming remote groups; returns how many gathers ran."""
        if not self._refs or self.lookahead <= 0:
            return 0
        if self.bandwidth_aware:
            return self._advance_bandwidth_aware(moment)
        lo = bisect.bisect_right(self._moments, moment)
        hi = bisect.bisect_right(self._moments, moment + self.lookahead)
        fetched = 0
        for _m, group in self._refs[lo:hi]:
            if len(self._inflight) >= self.max_inflight:
                break
            if group in self._inflight:
                continue
            if self.fetch_group(group):
                self._inflight.add(group)
                fetched += 1
        return fetched

    def _advance_bandwidth_aware(self, moment: int) -> int:
        tl = self.timeline
        assert tl is not None
        lo = bisect.bisect_right(self._moments, moment)
        fetched = 0
        for m, group in self._refs[lo:lo + self.bw_horizon]:
            if len(self._inflight) >= self.bw_inflight_cap:
                break
            if group in self._inflight:
                continue
            ready = tl.projected_ready_s("coll", self.group_bytes)
            if ready <= tl.time_until(m) or m <= moment + self.lookahead:
                if self.fetch_group(group):
                    self._inflight.add(group)
                    fetched += 1
            else:
                break
        return fetched


@dataclasses.dataclass
class PoolLease:
    """One engine's handle on a :class:`HeteroMemory` pool.

    Both engines build their memory plane through :func:`acquire_pool`
    so the owned-pool path (budget args -> private ``HeteroMemory``) and
    the external-pool path (shared pool + :class:`Tenant`) cannot drift:
    the lease resolves the tier *shares* the engine should plan against
    (tenant soft budgets, falling back to the pool caps), constructs its
    tenant-tagged streams, and installs its tenant-scoped prefetcher.

    ``device_bytes``/``host_bytes``/``slow_bytes`` are the engine's
    planning shares — for an owned pool they equal the pool caps; for a
    shared pool they are the tenant's soft budgets (the pool itself only
    enforces the hard tier caps; shares bound *planning*, the overflow
    region absorbs transients).
    """

    pool: "HeteroMemory"
    tenant: Tenant
    device_bytes: int | None
    host_bytes: int | None
    slow_bytes: int | None
    timeline: TransferTimeline | None
    owned: bool

    def qualify(self, stream: str) -> str:
        return self.tenant.qualify(stream)

    def stream(self, name, cmap, *, dtype=torch.float32):
        """A :class:`ChunkManager` on this lease's pool under its tenant
        (the manager tenant-qualifies ``name`` itself)."""
        from repro_torch.core.manager import ChunkManager

        return ChunkManager(cmap, dtype=dtype, name=name,
                            pool=self.pool, tenant=self.tenant)

    def prefetcher(self, *, lookahead: int,
                   bandwidth_aware: bool = True) -> SchedulePrefetcher | None:
        """Tenant-scoped OPT prefetcher (None under lru/fifo policies —
        they have no schedule to follow)."""
        if self.pool.policy != "opt":
            return None
        return SchedulePrefetcher(
            self.pool, lookahead=lookahead,
            timeline=self.timeline if bandwidth_aware else None,
            tenant=self.tenant)


def acquire_pool(
    *,
    pool: "HeteroMemory | None" = None,
    tenant: Tenant | None = None,
    device_memory_bytes: int | None = None,
    host_memory_bytes: int | None = None,
    slow_memory_bytes: int | None = None,
    policy: EvictionPolicy = "opt",
    timeline: TransferTimeline | None = None,
    device: str | torch.device = "cuda",
) -> PoolLease:
    """Resolve an engine's memory plane to a :class:`PoolLease`.

    Two modes, one construction path (so they cannot drift):

    * **Owned** (``pool=None``): build a private :class:`HeteroMemory`
      from the budget args — the historical single-tenant constructor
      path, running on the pool's default tenant.
    * **External** (``pool=`` given): join a shared pool under
      ``tenant`` (default tenant if omitted).  The budget args then only
      *override* the engine's planning shares; tier capacities belong to
      the pool, and the timeline must already be attached to it.
    """
    if pool is None:
        if tenant is not None:
            raise ValueError("tenant= requires an external pool=")
        if device_memory_bytes is None:
            raise ValueError(
                "an owned pool needs device_memory_bytes= (pass pool= to "
                "join an existing one)")
        pool = HeteroMemory(
            device_capacity_bytes=device_memory_bytes,
            host_capacity_bytes=host_memory_bytes,
            slow_capacity_bytes=slow_memory_bytes,
            policy=policy, device=device)
        if timeline is not None:
            pool.set_timeline(timeline)
        return PoolLease(pool, pool.default_tenant, device_memory_bytes,
                         host_memory_bytes, slow_memory_bytes,
                         timeline, owned=True)
    t = tenant if tenant is not None else pool.default_tenant
    if t.pool is not pool:
        raise ValueError(
            f"tenant {t.name!r} belongs to a different pool")
    if timeline is not None and timeline is not pool.timeline:
        raise ValueError(
            "external pools own their timeline: attach it with "
            "pool.set_timeline() before constructing engines on it")
    dev = (device_memory_bytes if device_memory_bytes is not None
           else t.device_budget_bytes)
    if dev is None:
        dev = pool.device_capacity
    host = (host_memory_bytes if host_memory_bytes is not None
            else t.host_budget_bytes)
    if host is None:
        host = pool.host_capacity
    slow = (slow_memory_bytes if slow_memory_bytes is not None
            else t.slow_budget_bytes)
    if slow is None:
        slow = pool.slow_capacity
    return PoolLease(pool, t, dev, host, slow, pool.timeline, owned=False)
