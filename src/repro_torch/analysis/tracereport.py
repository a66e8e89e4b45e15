"""Offline report over a Chrome ``trace_event`` JSON exported by the hub.

``repro_torch.core.telemetry.Telemetry.dump_chrome_trace`` writes the object
format: ``{"traceEvents": [...], "otherData": {...}}``.  This module
re-loads such a file, *validates* it (well-formed event array, monotone
timestamps per track, balanced span begin/end, and — crucially — that
the byte totals derivable from the event stream still equal the counter
totals the hub snapshotted into ``otherData`` at export time), then
prints three summaries:

  * top-K chunks by transferred bytes (who dominates DMA traffic),
  * stall attribution (seconds of critical-path wait per lane and per
    stream that caused the wait),
  * eviction churn (victim -> requester counts, plus per-policy and
    per-urgency tallies).

Opening the trace in Perfetto
-----------------------------
The exported JSON is a standard Chrome trace: open https://ui.perfetto.dev
in a browser and load the file.  Tracks: one per DMA lane (``dma:h2d``,
``dma:d2h``, ``dma:h2s``, ``dma:s2h``, ``dma:coll``), a ``wall`` track
interleaving compute slices with ``stall:<lane>`` slices (the simulated
critical path), per-tenant span tracks (``<tenant>/step``,
``<tenant>/moments``, ``<tenant>/round``, ``<tenant>/ops``), and
instant-event tracks for evictions, prefetch lifecycle, state
transitions and OOMs.  Rank-parallel runs prefix tracks with
``rank<N>/``.  Timestamps are the ``TransferTimeline`` simulated clock in
microseconds when a timeline was attached (``otherData.clock ==
"timeline"``; identical on the CPU and on the card, since the clock sees
only bytes, moments and durations); otherwise event sequence numbers
(``"seq"``) — still useful for ordering, meaningless as durations.

Command line::

    PYTHONPATH=src python -m repro_torch.analysis.tracereport trace.json --top 10
"""

from __future__ import annotations

import argparse
import collections
import json
import math
from typing import Any


def load(path: str) -> dict[str, Any]:
    """Load a Chrome trace JSON file (object format)."""
    with open(path) as fh:
        trace = json.load(fh)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError(f"{path}: not a Chrome trace object "
                         "(missing 'traceEvents')")
    return trace


def _tracks(trace: dict[str, Any]) -> dict[tuple[int, int], list[dict]]:
    """Group timestamped events by (pid, tid) track, preserving order."""
    tracks: dict[tuple[int, int], list[dict]] = collections.defaultdict(list)
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "M":
            continue
        tracks[(ev.get("pid", 0), ev.get("tid", 0))].append(ev)
    return tracks


def validate(trace: dict[str, Any]) -> None:
    """Check structure, per-track monotonicity, span balance, conservation.

    Raises ``AssertionError`` with a descriptive message on any failure.
    """
    events = trace["traceEvents"]
    assert isinstance(events, list), "traceEvents must be a list"
    for ev in events:
        assert isinstance(ev, dict) and "ph" in ev and "name" in ev, (
            f"malformed trace event: {ev!r}")
        if ev["ph"] != "M":
            assert isinstance(ev.get("ts"), (int, float)), (
                f"event missing numeric ts: {ev!r}")

    for (pid, tid), evs in _tracks(trace).items():
        prev = -math.inf
        stack: list[str] = []
        for ev in evs:
            assert ev["ts"] >= prev, (
                f"track (pid={pid}, tid={tid}): timestamps regress at "
                f"{ev['name']!r} ({ev['ts']} < {prev})")
            prev = ev["ts"]
            if ev["ph"] == "B":
                stack.append(ev["name"])
            elif ev["ph"] == "E":
                assert stack, (f"track (pid={pid}, tid={tid}): span end "
                               f"{ev['name']!r} without begin")
                top = stack.pop()
                assert top == ev["name"], (
                    f"track (pid={pid}, tid={tid}): span end "
                    f"{ev['name']!r} does not match open {top!r}")
        assert not stack, (f"track (pid={pid}, tid={tid}): unclosed "
                           f"spans {stack}")

    counters = trace.get("otherData", {}).get("counters")
    if counters:
        got_bytes: dict[str, int] = collections.defaultdict(int)
        got_counts: dict[str, int] = collections.defaultdict(int)
        for ev in events:
            if ev.get("cat") == "move":
                lane = ev["args"]["lane"]
                got_bytes[lane] += ev["args"]["bytes"]
                got_counts[lane] += 1
            elif ev.get("cat") == "collective":
                got_bytes["coll"] += ev["args"]["bytes"]
        for lane, want in counters.get("lane_bytes", {}).items():
            assert got_bytes[lane] == want, (
                f"conservation violated in trace: {lane} events="
                f"{got_bytes[lane]} counters={want}")
        for lane, want in counters.get("lane_counts", {}).items():
            assert got_counts[lane] == want, (
                f"conservation violated in trace: {lane} count events="
                f"{got_counts[lane]} counters={want}")


def report(trace: dict[str, Any], top_k: int = 10) -> str:
    """Render the three summaries as a printable string."""
    events = trace["traceEvents"]

    chunk_bytes: collections.Counter = collections.Counter()
    chunk_moves: collections.Counter = collections.Counter()
    stall_by_lane: dict[str, float] = collections.defaultdict(float)
    stall_by_stream: dict[str, float] = collections.defaultdict(float)
    churn: collections.Counter = collections.Counter()
    evict_policy: collections.Counter = collections.Counter()
    evict_urgency: collections.Counter = collections.Counter()
    lane_bytes: collections.Counter = collections.Counter()

    for ev in events:
        cat, args = ev.get("cat"), ev.get("args", {})
        if cat == "move":
            key = (args.get("stream"), args.get("chunk"))
            chunk_bytes[key] += args.get("bytes", 0)
            chunk_moves[key] += 1
            lane_bytes[args.get("lane")] += args.get("bytes", 0)
        elif cat == "stall":
            lane = args.get("lane", ev["name"].split(":", 1)[-1])
            dur_s = args.get("seconds", ev.get("dur", 0) / 1e6)
            stall_by_lane[lane] += dur_s
            stall_by_stream[args.get("stream", "?")] += dur_s
        elif cat == "evict":
            victim = args.get("tenant", ev["name"])
            churn[(victim, args.get("requester"))] += 1
            evict_policy[args.get("policy")] += 1
            evict_urgency[args.get("urgency")] += 1

    lines: list[str] = []
    lines.append(f"== top {top_k} chunks by transferred bytes ==")
    if chunk_bytes:
        for (stream, chunk), nbytes in chunk_bytes.most_common(top_k):
            lines.append(f"  {stream}[chunk {chunk}]: "
                         f"{nbytes / 2**20:.2f} MiB over "
                         f"{chunk_moves[(stream, chunk)]} moves")
    else:
        lines.append("  (no chunk moves recorded)")
    if lane_bytes:
        per_lane = ", ".join(f"{lane}={b / 2**20:.2f} MiB"
                             for lane, b in sorted(lane_bytes.items()))
        lines.append(f"  lane totals: {per_lane}")

    lines.append("== stall attribution ==")
    if stall_by_lane:
        for lane, sec in sorted(stall_by_lane.items(),
                                key=lambda kv: -kv[1]):
            lines.append(f"  lane {lane}: {sec * 1e3:.3f} ms")
        for stream, sec in sorted(stall_by_stream.items(),
                                  key=lambda kv: -kv[1]):
            lines.append(f"  waited-on stream {stream}: {sec * 1e3:.3f} ms")
    else:
        lines.append("  (no stalls recorded)")

    lines.append("== eviction churn ==")
    if churn:
        for (victim, requester), n in churn.most_common(top_k):
            tag = ("self" if victim == requester
                   else f"for {requester}")
            lines.append(f"  {victim} evicted {n}x ({tag})")
        lines.append("  by policy: " + ", ".join(
            f"{p}={n}" for p, n in evict_policy.most_common()))
        lines.append("  by urgency: " + ", ".join(
            f"{u}={n}" for u, n in evict_urgency.most_common()))
    else:
        lines.append("  (no evictions recorded)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="validate + summarise a telemetry Chrome trace")
    ap.add_argument("trace", help="path to a trace JSON written by "
                    "Telemetry.dump_chrome_trace")
    ap.add_argument("--top", type=int, default=10,
                    help="how many chunks / churn pairs to list")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip structural + conservation validation")
    ns = ap.parse_args(argv)

    trace = load(ns.trace)
    if not ns.no_validate:
        validate(trace)
        print(f"{ns.trace}: valid "
              f"({len(trace['traceEvents'])} events, "
              f"clock={trace.get('otherData', {}).get('clock', '?')})")
    print(report(trace, top_k=ns.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
