"""Unified telemetry plane for the chunk memory system.

Every subsystem emits structured :class:`TelemetryEvent` records into one
:class:`Telemetry` hub: chunk moves per DMA hop (``h2d``/``d2h``/``h2s``/
``s2h`` with stream, tenant, chunk id, bytes and *cause* — demand / evict /
stage / bounce), tensor state transitions, eviction decisions (victim,
requester, policy, urgency), prefetch lifecycle (issue / hit / miss /
stale), collectives, stall and compute segments from the transfer
timeline, and begin/end *span* events for steps, moments, serving rounds
and per-rank phases.

Clock semantics
---------------
Events are timestamped on the :class:`~repro_torch.core.timeline.TransferTimeline`
simulated clock (seconds) whenever a timeline is attached at the emit
site; sites with no timeline record ``ts=None`` and rely on the moment
index (and the global sequence number) for ordering.  The Chrome-trace
exporter uses the simulated clock when every placeable event carries one,
and falls back to sequence-number timestamps otherwise — the decision is
global, so timestamps are always monotone per track.

Conservation
------------
The event log is *falsifiable*: byte totals derived from move events must
equal the pool's :class:`~repro_torch.core.memory.TransferStats` counters
exactly, stall seconds derived from stall events must equal the
:class:`~repro_torch.core.timeline.StepTimeline` lanes exactly, and the
hidden/critical H2D split derived from move causes must equal
:class:`~repro_torch.core.memory.PrefetchStats`.  ``assert_conservation()``
checks all of it against every attached pool/timeline and raises on any
mismatch.  Byte counters are integers (exact by construction); stall
fields are float left-folds of the *same* number sequence in the same
order on both sides, so they are bit-identical too.

Cost discipline: a disabled hub (``telemetry=None``, the default
everywhere) costs exactly one predicate per call site, keeping every
existing code path byte-identical.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter, deque
from typing import Any

MOVE_LANES = ("h2d", "d2h", "h2s", "s2h")
ALL_LANES = MOVE_LANES + ("coll",)
PREFETCH_PHASES = ("issue", "hit", "miss", "stale")


@dataclasses.dataclass
class TelemetryEvent:
    """One structured record in the event log.

    ``kind`` is the taxonomy bucket (move / evict / oom / prefetch /
    collective / state / stall / compute / span / snapshot / mark);
    ``name`` is the kind-specific subject (the lane for moves/stalls, the
    prefetch phase, the collective op, the span track, ...).  ``attrs``
    holds kind-specific details (cause, victim, policy, ph, ...).
    """

    seq: int
    kind: str
    name: str
    ts: float | None = None
    dur: float = 0.0
    moment: int | None = None
    stream: str | None = None
    tenant: str | None = None
    rank: int | None = None
    chunk_id: int | None = None
    nbytes: int = 0
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def format(self) -> str:
        """One human-readable flight-recorder line."""
        if self.ts is not None:
            clock = f"t={self.ts:.6f}s"
        elif self.moment is not None:
            clock = f"m={self.moment}"
        else:
            clock = f"#{self.seq}"
        bits = [f"[{clock}]", self.kind, self.name]
        if self.rank is not None:
            bits.append(f"rank={self.rank}")
        if self.tenant is not None:
            bits.append(f"tenant={self.tenant}")
        if self.stream is not None:
            bits.append(f"stream={self.stream}")
        if self.chunk_id is not None:
            bits.append(f"chunk={self.chunk_id}")
        if self.nbytes:
            bits.append(f"bytes={self.nbytes}")
        if self.dur:
            bits.append(f"dur={self.dur:.6f}s")
        bits.extend(f"{k}={v}" for k, v in self.attrs.items())
        return " ".join(bits)


class Telemetry:
    """The hub: an append-only event log plus a bounded ring buffer
    (the flight recorder) and per-step metric snapshots.

    ``capture_states`` gates tensor state-transition events, by far the
    most voluminous kind — benchmarks exporting long traces turn them
    off; tests that assert on them leave the default on.
    """

    def __init__(self, *, ring_capacity: int = 256,
                 capture_states: bool = True) -> None:
        self.events: list[TelemetryEvent] = []
        self.ring: deque[TelemetryEvent] = deque(maxlen=ring_capacity)
        self.snapshots: list[dict[str, Any]] = []
        self.capture_states = capture_states
        self._seq = 0
        self._pools: list[Any] = []
        self._timelines: list[Any] = []
        self._spans: dict[tuple[int | None, str], list[TelemetryEvent]] = {}

    # ------------------------------------------------------------ registry
    def attach_pool(self, pool: Any) -> None:
        if not any(p is pool for p in self._pools):
            self._pools.append(pool)

    def detach_pool(self, pool: Any) -> None:
        self._pools = [p for p in self._pools if p is not pool]

    def attach_timeline(self, timeline: Any) -> None:
        if not any(t is timeline for t in self._timelines):
            self._timelines.append(timeline)

    def detach_timeline(self, timeline: Any) -> None:
        self._timelines = [t for t in self._timelines if t is not timeline]

    # ---------------------------------------------------------------- emit
    def emit(self, kind: str, name: str, *, ts: float | None = None,
             dur: float = 0.0, moment: int | None = None,
             stream: str | None = None, tenant: str | None = None,
             rank: int | None = None, chunk_id: int | None = None,
             nbytes: int = 0, **attrs: Any) -> TelemetryEvent:
        ev = TelemetryEvent(
            seq=self._seq, kind=kind, name=name, ts=ts, dur=dur,
            moment=moment, stream=stream, tenant=tenant, rank=rank,
            chunk_id=chunk_id, nbytes=nbytes, attrs=attrs)
        self._seq += 1
        self.events.append(ev)
        self.ring.append(ev)
        return ev

    # -------------------------------------------------------- typed events
    def move(self, lane: str, *, stream: str, tenant: str | None,
             chunk_id: int, nbytes: int, cause: str, critical: bool,
             ts: float | None = None, dur: float = 0.0,
             moment: int | None = None,
             rank: int | None = None) -> TelemetryEvent:
        assert lane in MOVE_LANES, lane
        return self.emit("move", lane, ts=ts, dur=dur, moment=moment,
                         stream=stream, tenant=tenant, rank=rank,
                         chunk_id=chunk_id, nbytes=nbytes, cause=cause,
                         critical=critical)

    def evict(self, *, victim: str, requester: str, policy: str,
              urgency: str, stream: str, chunk_id: int, nbytes: int,
              src: str, dst: str, ts: float | None = None,
              moment: int | None = None,
              rank: int | None = None) -> TelemetryEvent:
        return self.emit("evict", victim, ts=ts, moment=moment,
                         stream=stream, tenant=victim, rank=rank,
                         chunk_id=chunk_id, nbytes=nbytes,
                         requester=requester, policy=policy,
                         urgency=urgency, src=src, dst=dst)

    def prefetch(self, phase: str, *, stream: str, tenant: str | None,
                 chunk_id: int | None = None, nbytes: int = 0,
                 ts: float | None = None, moment: int | None = None,
                 rank: int | None = None, **attrs: Any) -> TelemetryEvent:
        assert phase in PREFETCH_PHASES, phase
        return self.emit("prefetch", phase, ts=ts, moment=moment,
                         stream=stream, tenant=tenant, rank=rank,
                         chunk_id=chunk_id, nbytes=nbytes, **attrs)

    def collective(self, op: str, *, nbytes: int, stream: str,
                   tenant: str | None, hidden: bool = False,
                   ts: float | None = None, dur: float = 0.0,
                   moment: int | None = None, rank: int | None = None,
                   **attrs: Any) -> TelemetryEvent:
        return self.emit("collective", op, ts=ts, dur=dur, moment=moment,
                         stream=stream, tenant=tenant, rank=rank,
                         nbytes=nbytes, hidden=hidden, **attrs)

    def state(self, tensor: str, *, old: str, new: str, stream: str,
              tenant: str | None, chunk_id: int,
              ts: float | None = None, moment: int | None = None,
              rank: int | None = None) -> TelemetryEvent | None:
        if not self.capture_states:
            return None
        return self.emit("state", tensor, ts=ts, moment=moment,
                         stream=stream, tenant=tenant, rank=rank,
                         chunk_id=chunk_id, old=old, new=new)

    def stall(self, lane: str, *, stream: str, seconds: float,
              ts: float | None = None, moment: int | None = None,
              tenant: str | None = None,
              rank: int | None = None) -> TelemetryEvent:
        return self.emit("stall", lane, ts=ts, dur=seconds, moment=moment,
                         stream=stream, tenant=tenant, rank=rank)

    def compute(self, *, moment: int, seconds: float,
                tenant: str | None = None, ts: float | None = None,
                rank: int | None = None) -> TelemetryEvent:
        return self.emit("compute", f"m{moment}", ts=ts, dur=seconds,
                         moment=moment, tenant=tenant, rank=rank)

    def oom(self, reason: str, *, stream: str | None = None,
            tenant: str | None = None, blocked_by: list[str] | None = None,
            ts: float | None = None, moment: int | None = None,
            rank: int | None = None, **attrs: Any) -> TelemetryEvent:
        return self.emit("oom", reason, ts=ts, moment=moment,
                         stream=stream, tenant=tenant, rank=rank,
                         blocked_by=list(blocked_by or ()), **attrs)

    def mark(self, name: str, *, ts: float | None = None,
             rank: int | None = None, **attrs: Any) -> TelemetryEvent:
        return self.emit("mark", name, ts=ts, rank=rank, **attrs)

    # ----------------------------------------------------------- span API
    def begin_span(self, track: str, label: str, *,
                   ts: float | None = None, moment: int | None = None,
                   tenant: str | None = None,
                   rank: int | None = None) -> TelemetryEvent:
        ev = self.emit("span", track, ts=ts, moment=moment, tenant=tenant,
                       rank=rank, ph="B", label=label)
        self._spans.setdefault((rank, track), []).append(ev)
        return ev

    def end_span(self, track: str, *, ts: float | None = None,
                 rank: int | None = None) -> TelemetryEvent:
        stack = self._spans.get((rank, track))
        assert stack, f"end_span on empty track {track!r} (rank={rank})"
        begin = stack.pop()
        return self.emit("span", track, ts=ts, rank=rank, ph="E",
                         label=begin.attrs["label"])

    def switch_span(self, track: str, label: str, *,
                    ts: float | None = None, moment: int | None = None,
                    tenant: str | None = None,
                    rank: int | None = None) -> TelemetryEvent:
        """End the open span on ``track`` (if any) and begin ``label``."""
        if self._spans.get((rank, track)):
            self.end_span(track, ts=ts, rank=rank)
        return self.begin_span(track, label, ts=ts, moment=moment,
                               tenant=tenant, rank=rank)

    def close_span(self, track: str, *, ts: float | None = None,
                   rank: int | None = None) -> None:
        if self._spans.get((rank, track)):
            self.end_span(track, ts=ts, rank=rank)

    def open_spans(self) -> list[tuple[int | None, str, str]]:
        return [(rank, track, ev.attrs["label"])
                for (rank, track), stack in self._spans.items()
                for ev in stack]

    # ----------------------------------------------------------- snapshots
    def snapshot(self, label: str, *, ts: float | None = None,
                 rank: int | None = None,
                 **metrics: Any) -> dict[str, Any]:
        snap = {"label": label, "ts": ts, "rank": rank, **metrics}
        self.snapshots.append(snap)
        self.emit("snapshot", label, ts=ts, rank=rank, **metrics)
        return snap

    # ----------------------------------------------------- flight recorder
    def flight_record(self, n: int = 32) -> list[TelemetryEvent]:
        return list(self.ring)[-n:]

    def flight_report(self, n: int = 32) -> str:
        evs = self.flight_record(n)
        if not evs:
            return "flight recorder: (empty)"
        lines = [f"flight recorder (last {len(evs)} events):"]
        lines.extend("  " + ev.format() for ev in evs)
        return "\n".join(lines)

    # ------------------------------------------------------ derived totals
    def lane_bytes(self) -> dict[str, int]:
        """Per-lane transferred bytes derived from move events."""
        out = {lane: 0 for lane in MOVE_LANES}
        for ev in self.events:
            if ev.kind == "move":
                out[ev.name] += ev.nbytes
        return out

    def lane_counts(self) -> dict[str, int]:
        out = {lane: 0 for lane in MOVE_LANES}
        for ev in self.events:
            if ev.kind == "move":
                out[ev.name] += 1
        return out

    def h2d_split(self) -> tuple[int, int]:
        """(hidden, critical) H2D bytes derived from move causes: staged
        transfers ride the prefetch lane, everything else is critical."""
        hidden = critical = 0
        for ev in self.events:
            if ev.kind == "move" and ev.name == "h2d":
                if ev.attrs.get("cause") == "stage":
                    hidden += ev.nbytes
                else:
                    critical += ev.nbytes
        return hidden, critical

    def stall_totals(self) -> dict[str, float]:
        """Per-lane stall seconds derived from stall events, accumulated
        in event order (the same left-fold the timeline performs)."""
        out = {lane: 0.0 for lane in ALL_LANES}
        for ev in self.events:
            if ev.kind == "stall":
                out[ev.name] += ev.dur
        return out

    def compute_total(self) -> float:
        total = 0.0
        for ev in self.events:
            if ev.kind == "compute":
                total += ev.dur
        return total

    def collective_bytes(self) -> dict[str, int]:
        out: Counter[str] = Counter()
        for ev in self.events:
            if ev.kind == "collective":
                out[ev.name] += ev.nbytes
        return dict(out)

    def prefetch_counts(self) -> dict[str, int]:
        """Prefetch lifecycle event counts; each phase maps 1:1 onto a
        :class:`~repro_torch.core.memory.PrefetchStats` counter (issue ->
        staged_transfers, hit -> hits, miss -> demand_misses, stale ->
        wasted_stages)."""
        out = {phase: 0 for phase in PREFETCH_PHASES}
        for ev in self.events:
            if ev.kind == "prefetch":
                out[ev.name] += 1
        return out

    def step_segments(self) -> list[list[TelemetryEvent]]:
        """Split the log into per-step segments on ``take_step`` marks.
        Each segment *includes* its closing mark (which carries the
        StepTimeline lane totals for exact per-step comparison)."""
        segs: list[list[TelemetryEvent]] = []
        cur: list[TelemetryEvent] = []
        for ev in self.events:
            cur.append(ev)
            if ev.kind == "mark" and ev.name == "take_step":
                segs.append(cur)
                cur = []
        if cur:
            segs.append(cur)
        return segs

    # --------------------------------------------------------- validation
    def counter_totals(self) -> dict[str, Any]:
        """Ground-truth totals aggregated over every attached pool and
        timeline — the numbers the event log must conserve."""
        bytes_ = {lane: 0 for lane in MOVE_LANES}
        counts = {lane: 0 for lane in MOVE_LANES}
        hidden = critical = 0
        pf_counts = {phase: 0 for phase in PREFETCH_PHASES}
        coll: Counter[str] = Counter()
        for pool in self._pools:
            st = pool.stats
            for lane in MOVE_LANES:
                bytes_[lane] += getattr(st, f"{lane}_bytes")
                counts[lane] += getattr(st, f"{lane}_count")
            pf = pool.prefetch
            hidden += pf.hidden_h2d_bytes
            critical += pf.critical_h2d_bytes
            pf_counts["issue"] += pf.staged_transfers
            pf_counts["hit"] += pf.hits
            pf_counts["miss"] += pf.demand_misses
            pf_counts["stale"] += pf.wasted_stages
            cs = pool.collectives
            coll["allgather"] += cs.allgather_bytes
            coll["reduce_scatter"] += cs.reduce_scatter_bytes
            coll["allreduce"] += cs.allreduce_bytes
        stalls = {lane: 0.0 for lane in ALL_LANES}
        for tl in self._timelines:
            for lane, s in tl.total_stalls.items():
                stalls[lane] += s
        return {"lane_bytes": bytes_, "lane_counts": counts,
                "hidden_h2d_bytes": hidden, "critical_h2d_bytes": critical,
                "prefetch_counts": pf_counts,
                "collective_bytes": {k: v for k, v in coll.items() if v},
                "stall_seconds": stalls}

    def assert_conservation(self) -> None:
        """Event-derived totals must equal the attached counters EXACTLY.

        Bytes are ints; stall seconds match bit-for-bit because both
        sides accumulate the identical float sequence in the same order.
        """
        truth = self.counter_totals()
        got_bytes = self.lane_bytes()
        assert got_bytes == truth["lane_bytes"], (
            f"lane byte conservation violated: events={got_bytes} "
            f"counters={truth['lane_bytes']}")
        got_counts = self.lane_counts()
        assert got_counts == truth["lane_counts"], (
            f"lane count conservation violated: events={got_counts} "
            f"counters={truth['lane_counts']}")
        hidden, critical = self.h2d_split()
        assert hidden == truth["hidden_h2d_bytes"], (
            f"hidden h2d {hidden} != {truth['hidden_h2d_bytes']}")
        assert critical == truth["critical_h2d_bytes"], (
            f"critical h2d {critical} != {truth['critical_h2d_bytes']}")
        got_pf = self.prefetch_counts()
        assert got_pf == truth["prefetch_counts"], (
            f"prefetch conservation violated: events={got_pf} "
            f"counters={truth['prefetch_counts']}")
        got_coll = self.collective_bytes()
        assert got_coll == truth["collective_bytes"], (
            f"collective conservation violated: events={got_coll} "
            f"counters={truth['collective_bytes']}")
        ranks = [tl.telemetry_rank for tl in self._timelines]
        if len(set(ranks)) == len(ranks):
            # each timeline's stall events form an uninterleaved (per
            # rank) subsequence, so the event-order fold reproduces the
            # timeline's own accumulation bit-for-bit: assert EXACT
            # per-timeline equality.
            for tl in self._timelines:
                got = {lane: 0.0 for lane in ALL_LANES}
                for ev in self.events:
                    if ev.kind == "stall" and ev.rank == tl.telemetry_rank:
                        got[ev.name] += ev.dur
                assert got == tl.total_stalls, (
                    f"stall conservation violated (rank="
                    f"{tl.telemetry_rank}): events={got} "
                    f"counters={tl.total_stalls}")
        else:
            # several timelines share a rank key (e.g. sequential runs
            # logged into one hub): summing across them re-associates the
            # float fold, so allow rounding at the last bits only.
            import math

            got_stalls = self.stall_totals()
            for lane in ALL_LANES:
                assert math.isclose(
                    got_stalls[lane], truth["stall_seconds"][lane],
                    rel_tol=1e-9, abs_tol=1e-12), (
                    f"stall conservation violated on {lane}: "
                    f"events={got_stalls[lane]} "
                    f"counters={truth['stall_seconds'][lane]}")

    def assert_balanced_spans(self) -> None:
        """Every begin has a matching end and no track interleaves."""
        stacks: dict[tuple[int | None, str], list[str]] = {}
        for ev in self.events:
            if ev.kind != "span":
                continue
            key = (ev.rank, ev.name)
            if ev.attrs["ph"] == "B":
                stacks.setdefault(key, []).append(ev.attrs["label"])
            else:
                stack = stacks.get(key)
                assert stack, f"unmatched span end on {key}: {ev.format()}"
                top = stack.pop()
                assert top == ev.attrs["label"], (
                    f"interleaved spans on {key}: end {ev.attrs['label']!r}"
                    f" while {top!r} open")
        leftovers = {k: v for k, v in stacks.items() if v}
        assert not leftovers, f"unclosed spans: {leftovers}"

    # ------------------------------------------------------- chrome export
    def chrome_trace(self) -> dict[str, Any]:
        """Export the log as Chrome ``trace_event`` JSON (object format),
        viewable in Perfetto / chrome://tracing.  Tracks: one per DMA
        lane (rank-prefixed under distributed engines), a ``wall`` track
        perfectly tiled by compute and stall slices, B/E span tracks for
        steps / moments / rounds / per-rank phases, and instant tracks
        for evictions, prefetch lifecycle, state flips, OOMs and marks.
        """
        placeable = ("move", "collective", "stall", "compute", "span")
        use_clock = all(ev.ts is not None for ev in self.events
                        if ev.kind in placeable)
        if use_clock:
            # Several timelines logging into one hub each start their
            # simulated clock at zero; if that would make any track's
            # timestamps regress, fall back to sequence numbers.
            base_track = {"collective": "dma:coll", "stall": "wall",
                          "compute": "wall"}
            last: dict[tuple[int | None, str], float] = {}
            for ev in self.events:
                if ev.kind not in placeable:
                    continue
                tr = base_track.get(ev.kind) or (
                    f"dma:{ev.name}" if ev.kind == "move" else ev.name)
                key = (ev.rank, tr)
                if ev.ts < last.get(key, float("-inf")):
                    use_clock = False
                    break
                last[key] = ev.ts

        def us(ev: TelemetryEvent) -> float:
            base = ev.ts if use_clock else float(ev.seq)
            return base * 1e6

        pid = 1
        tids: dict[str, int] = {}
        out: list[dict[str, Any]] = []

        def tid(track: str) -> int:
            t = tids.get(track)
            if t is None:
                t = tids[track] = len(tids) + 1
                out.append({"ph": "M", "pid": pid, "tid": t,
                            "name": "thread_name",
                            "args": {"name": track}})
            return t

        def track(ev: TelemetryEvent, base: str) -> str:
            return f"rank{ev.rank}/{base}" if ev.rank is not None else base

        for ev in self.events:
            if ev.kind == "move":
                out.append({
                    "ph": "X", "pid": pid,
                    "tid": tid(track(ev, f"dma:{ev.name}")),
                    "ts": us(ev), "dur": ev.dur * 1e6 if use_clock else 0.0,
                    "cat": "move",
                    "name": f"{ev.attrs['cause']} {ev.stream}#{ev.chunk_id}",
                    "args": {"lane": ev.name, "stream": ev.stream,
                             "tenant": ev.tenant, "chunk": ev.chunk_id,
                             "bytes": ev.nbytes, "cause": ev.attrs["cause"],
                             "critical": ev.attrs["critical"]}})
            elif ev.kind == "collective":
                out.append({
                    "ph": "X", "pid": pid,
                    "tid": tid(track(ev, "dma:coll")),
                    "ts": us(ev), "dur": ev.dur * 1e6 if use_clock else 0.0,
                    "cat": "collective", "name": ev.name,
                    "args": {"op": ev.name, "stream": ev.stream,
                             "tenant": ev.tenant, "bytes": ev.nbytes,
                             "hidden": ev.attrs.get("hidden", False)}})
            elif ev.kind == "stall":
                out.append({
                    "ph": "X", "pid": pid, "tid": tid(track(ev, "wall")),
                    "ts": us(ev), "dur": ev.dur * 1e6 if use_clock else 0.0,
                    "cat": "stall", "name": f"stall:{ev.name}",
                    "args": {"lane": ev.name, "stream": ev.stream,
                             "moment": ev.moment, "seconds": ev.dur}})
            elif ev.kind == "compute":
                out.append({
                    "ph": "X", "pid": pid, "tid": tid(track(ev, "wall")),
                    "ts": us(ev), "dur": ev.dur * 1e6 if use_clock else 0.0,
                    "cat": "compute", "name": ev.name,
                    "args": {"moment": ev.moment, "tenant": ev.tenant,
                             "seconds": ev.dur}})
            elif ev.kind == "span":
                rec = {"ph": ev.attrs["ph"], "pid": pid,
                       "tid": tid(track(ev, ev.name)), "ts": us(ev),
                       "cat": "span", "name": ev.attrs["label"]}
                out.append(rec)
            else:  # evict / prefetch / state / oom / snapshot / mark
                args: dict[str, Any] = dict(ev.attrs)
                for field in ("stream", "tenant", "chunk_id", "moment"):
                    v = getattr(ev, field)
                    if v is not None:
                        args[field] = v
                if ev.nbytes:
                    args["bytes"] = ev.nbytes
                out.append({
                    "ph": "i", "pid": pid, "s": "t",
                    "tid": tid(track(ev, ev.kind)),
                    "ts": us(ev), "cat": ev.kind, "name": ev.name,
                    "args": args})
        # Close any spans still open (e.g. a benchmark that probed an
        # OutOfMemory mid-step) so the exported trace is always balanced;
        # assert_balanced_spans stays strict for callers who want that.
        open_spans = {k: v for k, v in self._spans.items() if v}
        if open_spans:
            maxts: dict[int, float] = {}
            for rec in out:
                if rec.get("ph") != "M":
                    maxts[rec["tid"]] = max(
                        maxts.get(rec["tid"], rec["ts"]), rec["ts"])
            for (rank, tr), stack in open_spans.items():
                name = f"rank{rank}/{tr}" if rank is not None else tr
                t = tid(name)
                for begin in reversed(stack):
                    out.append({"ph": "E", "pid": pid, "tid": t,
                                "ts": max(maxts.get(t, 0.0), us(begin)),
                                "cat": "span", "name": begin.attrs["label"]})
        return {"traceEvents": out,
                "otherData": {"clock": "timeline" if use_clock else "seq",
                              "counters": self.counter_totals()}}

    def dump_chrome_trace(self, path: str) -> dict[str, Any]:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


# Module-level default hub.  ``HeteroMemory`` picks it up at construction
# when no explicit ``telemetry=`` is given, which is how the benchmark
# runner traces every module without per-module wiring; it is None unless
# someone installs one, so tests and library users pay nothing.
_DEFAULT_HUB: Telemetry | None = None


def set_default_hub(hub: Telemetry | None) -> Telemetry | None:
    global _DEFAULT_HUB
    prev = _DEFAULT_HUB
    _DEFAULT_HUB = hub
    return prev


def default_hub() -> Telemetry | None:
    return _DEFAULT_HUB
