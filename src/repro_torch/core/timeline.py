"""Transfer timeline: a two-queue DMA model with stall accounting.

The pool's staging machinery classifies every H2D byte *hidden* (issued
ahead of demand, overlappable with compute) or *critical-path* (a demand
miss) — a classification, not a performance model.  Whether "hidden"
bytes are actually hidden depends on whether they fit inside the
consuming operator's compute window at the available CPU<->GPU bandwidth
(the overlap analysis PatrickStar Section 7 / Fig. 9 and ZeRO-Infinity's
bandwidth-centric design reason about).  :class:`TransferTimeline` makes
that temporal: it models the accelerator's DMA engines as FIFO queues of
finite bandwidth and advances a simulated clock moment-by-moment against
per-operator compute durations derived from
:mod:`repro_torch.analysis.costmodel` under the timeline's
:attr:`TransferTimeline.hardware` (the card whose links it models, so an
engine prices its operators with the same constants).

Engines (one FIFO queue each, issue order preserved):

  ``h2d``   host->device stages and demand fetches;
  ``d2h``   device->host evictions and host-placed ADAM pulls;
  ``h2s``   host->slow demotions onto the NVMe-class third tier;
  ``s2h``   slow->host promotions (the first leg of a two-hop fetch —
            the chained h2d leg starts only after it lands);
  ``coll``  the collective lane (group all-gathers, grad reduce-scatter,
            the stem all-reduce) of the distributed plane.

Clock rules — every advance of ``now`` is classified exactly once, so
the per-step decomposition ``step == compute + h2d_stall + d2h_stall +
gather_stall`` holds *by construction* and is asserted as a conservation
law in tests:

  * **compute**: entering moment ``m+1`` adds moment ``m``'s operator
    duration (transfers recorded while the cursor sat at ``m`` were
    issued at the operator's start, so they overlap its compute).
  * **critical transfer**: the consumer waits for the transfer's queue
    position AND its wire time — ``now`` jumps to the transfer's end,
    the jump is booked as stall on that engine (and per stream, per
    moment).  A backlog of earlier (hidden) transfers on the same engine
    therefore delays a critical one: DMA-engine contention.
  * **late hidden transfer**: a staged chunk (or prefetched gather) hit
    by its consumer before the wire finished stalls for the remainder —
    hidden bytes in excess of the overlap window *surface* instead of
    disappearing.
  * **end-of-step drain**: residual queue backlog (e.g. D2H evictions
    still in flight) is waited out engine-by-engine in completion order,
    each booked the marginal wait beyond the previous — concurrent
    drains are never double-counted.

Under infinite bandwidth (the default: ``bandwidth=None``) every
transfer takes zero seconds, every stall is exactly ``0.0`` and step
time equals summed compute — the degenerate case the property tests pin.

The timeline also answers the *planning* queries the bandwidth-aware
prefetchers ask (:class:`~repro_torch.core.memory.SchedulePrefetcher` /
:class:`~repro_torch.core.memory.GatherPrefetcher` with ``timeline=``):
``projected_ready_s`` (queue delay + wire time of a would-be transfer)
vs ``time_until`` (summed compute between now and the reference's
moment) decides how deep and how early to issue — instead of the fixed
``lookahead/max_inflight`` heuristic.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Hashable

from repro_torch.analysis.roofline import H100_SXM, Hardware


def _is_infinite(bandwidth: float | None) -> bool:
    return bandwidth is None or math.isinf(bandwidth)


@dataclasses.dataclass
class DmaEngine:
    """One FIFO transfer queue of finite (or infinite) bandwidth."""

    name: str
    bandwidth: float | None = None  # bytes/second; None == infinite
    busy_until: float = 0.0

    def transfer_seconds(self, nbytes: int) -> float:
        if _is_infinite(self.bandwidth):
            return 0.0
        return nbytes / float(self.bandwidth)

    def enqueue(self, now: float, nbytes: int,
                start_after: float | None = None) -> float:
        """FIFO issue: starts when the queue drains (and, for the second
        leg of a chained two-hop transfer, not before ``start_after`` —
        the first leg's completion), returns the end."""
        start = max(now, self.busy_until)
        if start_after is not None:
            start = max(start, start_after)
        end = start + self.transfer_seconds(nbytes)
        self.busy_until = end
        return end


@dataclasses.dataclass
class StepTimeline:
    """One step's (or serving round's) wall-clock decomposition."""

    compute_s: float = 0.0
    h2d_stall_s: float = 0.0
    d2h_stall_s: float = 0.0
    h2s_stall_s: float = 0.0
    s2h_stall_s: float = 0.0
    gather_stall_s: float = 0.0
    # simulated wall seconds this step actually took (now - step start);
    # equals compute_s + stall_s up to float associativity
    wall_s: float = 0.0
    stall_by_stream: dict[str, float] = dataclasses.field(default_factory=dict)
    stall_by_moment: dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def stall_s(self) -> float:
        return (self.h2d_stall_s + self.d2h_stall_s + self.h2s_stall_s
                + self.s2h_stall_s + self.gather_stall_s)

    @property
    def step_s(self) -> float:
        """The decomposed step time: compute + per-engine stalls."""
        return self.compute_s + self.stall_s


# stall bucket per engine name
_STALL_FIELD = {"h2d": "h2d_stall_s", "d2h": "d2h_stall_s",
                "h2s": "h2s_stall_s", "s2h": "s2h_stall_s",
                "coll": "gather_stall_s"}

_DRAIN_STREAM = "(drain)"


@dataclasses.dataclass
class _Schedule:
    """One moment namespace: a cursor plus its compute-duration table.

    Multi-tenant pools give each non-default tenant its own namespace
    (keyed by tenant name; the default tenant keeps the unnamed ``None``
    namespace), because tenants' moment ids are independent clocks — the
    trainer's moment 7 and the server's moment 7 are unrelated operators.
    The DMA engines stay *shared* across namespaces: the lanes are the
    physical contention point, so one tenant's backlog delays another's
    critical fetch exactly as it would a sibling stream's."""

    cur: int | None = None
    durations: dict[int, float] = dataclasses.field(default_factory=dict)
    order: list[int] = dataclasses.field(default_factory=list)
    prefix: list[float] = dataclasses.field(default_factory=lambda: [0.0])

    def rebuild(self) -> None:
        self.order = sorted(self.durations)
        acc = 0.0
        self.prefix = [0.0]
        for m in self.order:
            acc += self.durations[m]
            self.prefix.append(acc)


class TransferTimeline:
    """Two DMA queues + a collective lane advanced against compute.

    Attach to a pool with :meth:`HeteroMemory.set_timeline`; the pool
    forwards every tier move and the moment cursor.  Per-operator
    compute durations are installed after the warm-up iteration
    (:meth:`install_durations`, moment -> seconds) or extended
    round-by-round on the serving plane (:meth:`extend_durations`).

    Every schedule method takes ``tenant=`` (a namespace name, ``None``
    for the historical unnamed namespace): co-resident tenants keep
    independent moment clocks over the *same* DMA engines, so the
    bandwidth-aware issue policy sees both tenants' projected windows
    through one ``projected_ready_s`` while ``time_until`` answers
    against the asking tenant's own schedule."""

    def __init__(
        self,
        *,
        h2d_bandwidth: float | None = None,
        d2h_bandwidth: float | None = None,
        h2s_bandwidth: float | None = None,
        s2h_bandwidth: float | None = None,
        collective_bandwidth: float | None = None,
        hardware: Hardware = H100_SXM,
    ) -> None:
        # the card whose operators the engines price against this
        # timeline (its compute and HBM rates; the lanes' bandwidths are
        # the arguments above)
        self.hardware = hardware
        self.h2d = DmaEngine("h2d", h2d_bandwidth)
        self.d2h = DmaEngine("d2h", d2h_bandwidth)
        # slow-tier (NVMe-class) lanes; idle on two-tier pools
        self.h2s = DmaEngine("h2s", h2s_bandwidth)
        self.s2h = DmaEngine("s2h", s2h_bandwidth)
        self.coll = DmaEngine("coll", collective_bandwidth)
        self._engines = {"h2d": self.h2d, "d2h": self.d2h,
                         "h2s": self.h2s, "s2h": self.s2h, "coll": self.coll}
        self.now = 0.0
        self._step_start = 0.0
        # moment namespaces (None == the historical unnamed one); the
        # engines above are shared across all of them
        self._sched: dict[str | None, _Schedule] = {None: _Schedule()}
        # namespace of the last-advanced cursor: stalls recorded between
        # advances are attributed to that tenant's current moment
        self._active: str | None = None
        # in-flight overlappable transfers awaiting their consumer:
        # key -> (engine name, completion time, stream)
        self._pending: dict[Hashable, tuple[str, float, str]] = {}
        self._step = StepTimeline()
        # telemetry hub (None == disabled: one predicate per call site);
        # the pool's set_telemetry propagates here with its rank tag
        self.telemetry = None
        self.telemetry_rank: int | None = None
        # (start, end) of the most recent _record — the pool reads it
        # right after recording a move to timestamp the telemetry event
        self.last_window: tuple[float, float] = (0.0, 0.0)
        # whole-run per-lane stall seconds (never reset by take_step):
        # the conservation ground truth the event log is checked against
        self.total_stalls: dict[str, float] = {n: 0.0 for n in self._engines}

    @classmethod
    def calibrated(cls, hw: Hardware = H100_SXM) -> "TransferTimeline":
        """Timeline with every lane at ``hw``'s link rates (h2d/d2h the
        pinned host link, the slow-tier lanes ``hw.slow_bw``, collectives
        ``hw.collective_bw``) and its operators priced on ``hw``, so
        simulated stalls come out in absolute seconds of that card.
        Without measured rates it uses the recorded ones of
        :data:`~repro_torch.analysis.roofline.H100_SXM`."""
        return cls(h2d_bandwidth=hw.h2d_bw, d2h_bandwidth=hw.d2h_bw,
                   h2s_bandwidth=hw.slow_bw, s2h_bandwidth=hw.slow_bw,
                   collective_bandwidth=hw.collective_bw, hardware=hw)

    def set_telemetry(self, telemetry, *, rank: int | None = None) -> None:
        if self.telemetry is not None and self.telemetry is not telemetry:
            self.telemetry.detach_timeline(self)
        self.telemetry = telemetry
        self.telemetry_rank = rank
        if telemetry is not None:
            telemetry.attach_timeline(self)

    # ------------------------------------------------------------- durations
    def _ns(self, tenant: str | None) -> _Schedule:
        ns = self._sched.get(tenant)
        if ns is None:
            ns = self._sched[tenant] = _Schedule()
        return ns

    @property
    def has_durations(self) -> bool:
        return any(ns.durations for ns in self._sched.values())

    def has_durations_for(self, tenant: str | None = None) -> bool:
        """Whether *this tenant's* namespace has a compute schedule (the
        bandwidth-aware prefetcher gate: another tenant's durations say
        nothing about this tenant's overlap windows)."""
        ns = self._sched.get(tenant)
        return ns is not None and bool(ns.durations)

    def install_durations(self, durations: dict[int, float],
                          tenant: str | None = None) -> None:
        """Replace the moment -> compute-seconds schedule (training: one
        iteration's moments, reused every step)."""
        ns = self._ns(tenant)
        ns.durations = dict(durations)
        ns.rebuild()

    def extend_durations(self, durations: dict[int, float],
                         tenant: str | None = None) -> None:
        """Merge additional moments (serving: each round plans fresh,
        strictly increasing moments)."""
        ns = self._ns(tenant)
        ns.durations.update(durations)
        ns.rebuild()

    def duration_of(self, moment: int, tenant: str | None = None) -> float:
        ns = self._sched.get(tenant)
        return ns.durations.get(moment, 0.0) if ns is not None else 0.0

    # ----------------------------------------------------------------- clock
    def advance_to_moment(self, moment: int,
                          tenant: str | None = None) -> None:
        """Moment cursor moved: the previous operator's compute elapsed.
        Each tenant namespace keeps its own cursor; the simulated clock
        (and the shared engines behind it) advances for everyone."""
        ns = self._ns(tenant)
        if ns.cur is not None and moment != ns.cur:
            self._run_compute(ns, ns.cur, tenant)
        ns.cur = moment
        self._active = tenant

    def _run_compute(self, ns: _Schedule, moment: int,
                     tenant: str | None) -> None:
        dur = ns.durations.get(moment, 0.0)
        if dur > 0.0:
            tel = self.telemetry
            if tel is not None:
                tel.compute(moment=moment, seconds=dur, tenant=tenant,
                            ts=self.now, rank=self.telemetry_rank)
            self.now += dur
            self._step.compute_s += dur

    def _stall(self, engine: str, stream: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        cur = self._sched[self._active].cur if self._active in self._sched \
            else None
        tel = self.telemetry
        if tel is not None:
            tel.stall(engine, stream=stream, seconds=seconds, ts=self.now,
                      moment=cur, rank=self.telemetry_rank)
        self.total_stalls[engine] += seconds
        self.now += seconds
        setattr(self._step, _STALL_FIELD[engine],
                getattr(self._step, _STALL_FIELD[engine]) + seconds)
        by_s = self._step.stall_by_stream
        by_s[stream] = by_s.get(stream, 0.0) + seconds
        if cur is not None:
            by_m = self._step.stall_by_moment
            by_m[cur] = by_m.get(cur, 0.0) + seconds

    # -------------------------------------------------------------- transfers
    def record_h2d(self, nbytes: int, *, stream: str, critical: bool,
                   key: Hashable | None = None,
                   start_after: float | None = None) -> float:
        return self._record("h2d", nbytes, stream=stream, critical=critical,
                            key=key, start_after=start_after)

    def record_d2h(self, nbytes: int, *, stream: str, critical: bool,
                   key: Hashable | None = None,
                   start_after: float | None = None) -> float:
        return self._record("d2h", nbytes, stream=stream, critical=critical,
                            key=key, start_after=start_after)

    def record_h2s(self, nbytes: int, *, stream: str, critical: bool,
                   key: Hashable | None = None,
                   start_after: float | None = None) -> float:
        return self._record("h2s", nbytes, stream=stream, critical=critical,
                            key=key, start_after=start_after)

    def record_s2h(self, nbytes: int, *, stream: str, critical: bool,
                   key: Hashable | None = None,
                   start_after: float | None = None) -> float:
        return self._record("s2h", nbytes, stream=stream, critical=critical,
                            key=key, start_after=start_after)

    def record_collective(self, nbytes: int, *, critical: bool,
                          stream: str = "param",
                          key: Hashable | None = None) -> float:
        return self._record("coll", nbytes, stream=stream, critical=critical,
                            key=key)

    def _record(self, engine: str, nbytes: int, *, stream: str,
                critical: bool, key: Hashable | None,
                start_after: float | None = None) -> float:
        eng = self._engines[engine]
        start = max(self.now, eng.busy_until)
        if start_after is not None:
            start = max(start, start_after)
        end = eng.enqueue(self.now, nbytes, start_after)
        self.last_window = (start, end)
        if critical:
            # the consumer waits for queue position + wire time (FIFO:
            # hidden backlog ahead of it delays it — engine contention)
            self._stall(engine, stream, end - self.now)
        elif key is not None:
            self._pending[key] = (engine, end, stream)
        return end

    def wait_for(self, key: Hashable) -> float:
        """The consumer of an overlappable transfer arrived: stall for
        whatever wire time remains (0 if it already landed).  No-op for
        unknown keys."""
        rec = self._pending.pop(key, None)
        if rec is None:
            return 0.0
        engine, end, stream = rec
        late = end - self.now
        self._stall(engine, stream, late)
        return max(late, 0.0)

    def cancel(self, key: Hashable) -> None:
        """Drop a pending transfer's rendezvous (wasted stage: the chunk
        was evicted / released before its consumer arrived)."""
        self._pending.pop(key, None)

    # ------------------------------------------------------------- planning
    def projected_ready_s(self, engine: str, nbytes: int) -> float:
        """Seconds from now until a transfer issued now would land:
        current queue backlog + its own wire time."""
        eng = self._engines[engine]
        return max(0.0, eng.busy_until - self.now) + eng.transfer_seconds(nbytes)

    def time_until(self, moment: int, tenant: str | None = None) -> float:
        """Summed compute seconds between the tenant's current cursor and
        ``moment`` — the overlap window a transfer issued now can hide
        inside (includes the current operator's own duration: transfers
        issue at operator start)."""
        ns = self._sched.get(tenant)
        if ns is None or ns.cur is None or not ns.order:
            return 0.0
        i = bisect.bisect_left(ns.order, ns.cur)
        j = bisect.bisect_left(ns.order, moment)
        if j <= i:
            return 0.0
        return ns.prefix[j] - ns.prefix[i]

    # ----------------------------------------------------------------- steps
    def take_step(self) -> StepTimeline:
        """Close the step: flush every namespace's current operator's
        compute (under the coarse co-tenancy interleave at most one
        cursor is armed at a time), drain residual queue backlog
        (marginal attribution in completion order), return this step's
        decomposition and re-arm."""
        for tenant, ns in self._sched.items():
            if ns.cur is not None:
                self._run_compute(ns, ns.cur, tenant)
                ns.cur = None
        for eng in sorted(self._engines.values(), key=lambda e: e.busy_until):
            self._stall(eng.name, _DRAIN_STREAM, eng.busy_until - self.now)
        rep = self._step
        rep.wall_s = self.now - self._step_start
        tel = self.telemetry
        if tel is not None:
            # the mark closes a per-step event segment and carries the
            # step's lane totals, so event-derived per-step stalls can be
            # compared against the StepTimeline bit-for-bit
            tel.mark("take_step", ts=self.now, rank=self.telemetry_rank,
                     compute_s=rep.compute_s, h2d_stall_s=rep.h2d_stall_s,
                     d2h_stall_s=rep.d2h_stall_s,
                     h2s_stall_s=rep.h2s_stall_s,
                     s2h_stall_s=rep.s2h_stall_s,
                     gather_stall_s=rep.gather_stall_s, wall_s=rep.wall_s)
        self._step = StepTimeline()
        self._step_start = self.now
        return rep

    def prune_durations_before(self, moment: int,
                               tenant: str | None = None) -> None:
        """Drop duration entries for moments < ``moment`` (the serving
        plane's moments increase forever; training reuses one iteration's
        ids and never calls this)."""
        ns = self._ns(tenant)
        ns.durations = {m: d for m, d in ns.durations.items() if m >= moment}
        ns.rebuild()
