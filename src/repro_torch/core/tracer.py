"""Runtime memory tracer (PatrickStar Section 8.1).

During a *warm-up* iteration the tracer records, at every operator
begin/end ("**moment**"), the real memory consumption R of the computing
device and the bytes C the chunk manager holds there; non-model footprint
is R - C.  Since PTM iterations repeat the same compute pattern, the
warm-up profile predicts every later iteration, giving:

  * ``chunkable_memory(moment)`` — device bytes available for chunks at a
    moment (total - non-model[moment]);
  * per-chunk *reference moments*, the future-knowledge schedule consumed
    by the OPT eviction policy (Section 8.3) — recorded per stream (param
    chunks are referenced in FWD/BWD/ADAM, optimizer-state chunks only in
    ADAM, activation chunks exactly twice: their FWD write and their
    mirrored BWD read — the FWD->BWD reuse distance is what lets OPT
    spill cold act chunks to host mid-step and the prefetcher stage them
    back ahead of ``backward_layer``), which also yields the total
    reference order the schedule-driven prefetcher stages chunks from;
  * ``peak_nonmodel`` / GPU **margin space** for device-aware operator
    placement (Section 8.2).

During warm-up the chunk budget is capped at ``warmup_chunk_fraction``
(default 20%, the paper's choice) of device memory, and eviction falls
back to chunk-list order because no schedule exists yet.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass(frozen=True)
class Moment:
    index: int
    op_name: str
    phase: str  # "FWD" | "BWD" | "ADAM"
    nonmodel_bytes: int


class RuntimeMemoryTracer:
    def __init__(
        self,
        device_total_bytes: int,
        *,
        warmup_chunk_fraction: float = 0.2,
        overhead_bytes: int = 0,
    ) -> None:
        self.device_total_bytes = device_total_bytes
        self.warmup_chunk_fraction = warmup_chunk_fraction
        # constant runtime overhead (the CUDA context, as in the paper).
        self.overhead_bytes = overhead_bytes
        self.warmup = True
        self.moments: list[Moment] = []
        # stream -> chunk_id -> *device* reference moments (the schedule
        # OPT eviction and the prefetcher consume: both reason about the
        # device tier, so a use that computes host-side is not a reason to
        # keep — or stage — a chunk on the device)
        self.stream_chunk_moments: dict[str, dict[int, list[int]]] = defaultdict(
            lambda: defaultdict(list)
        )
        # stream -> chunk_id -> host-side reference moments (ADAM on host);
        # promoted to device refs for OS groups later placed in GPU margin.
        self.host_chunk_moments: dict[str, dict[int, list[int]]] = defaultdict(
            lambda: defaultdict(list)
        )
        self._moment_idx = -1

    # ------------------------------------------------------------- recording
    def begin_iteration(self) -> None:
        self._moment_idx = -1
        if self.warmup:
            self.moments.clear()
            self.stream_chunk_moments.clear()
            self.host_chunk_moments.clear()

    def record_moment(self, op_name: str, phase: str, nonmodel_bytes: int) -> int:
        """Called at operator start and finish.  Returns the moment index."""
        self._moment_idx += 1
        if self.warmup:
            self.moments.append(
                Moment(self._moment_idx, op_name, phase, int(nonmodel_bytes))
            )
        return self._moment_idx

    def record_chunk_use(
        self, chunk_id: int, stream: str = "param", dev: str = "device"
    ) -> None:
        if not self.warmup:
            return
        m = max(self._moment_idx, 0)
        if dev == "device":
            self.stream_chunk_moments[stream][chunk_id].append(m)
        else:
            self.host_chunk_moments[stream][chunk_id].append(m)

    def end_warmup(self) -> None:
        self.warmup = False

    @property
    def current_moment(self) -> int:
        return max(self._moment_idx, 0)

    # --------------------------------------------------------------- queries
    def nonmodel_at(self, moment: int) -> int:
        if not self.moments:
            return 0
        moment = min(max(moment, 0), len(self.moments) - 1)
        return self.moments[moment].nonmodel_bytes

    def chunkable_memory(self, moment: int | None = None) -> int:
        """Device bytes available for chunks (Section 8.1)."""
        if self.warmup:
            return int(self.device_total_bytes * self.warmup_chunk_fraction)
        m = self.current_moment if moment is None else moment
        avail = self.device_total_bytes - self.overhead_bytes - self.nonmodel_at(m)
        return max(avail, 0)

    @property
    def peak_nonmodel_bytes(self) -> int:
        return max((m.nonmodel_bytes for m in self.moments), default=0)

    def margin_space(self, param_working_set_bytes: int) -> int:
        """GPU margin space for OS chunks (Section 8.2):
        total - peak non-model - the param fp16 working set."""
        return max(
            self.device_total_bytes
            - self.overhead_bytes
            - self.peak_nonmodel_bytes
            - param_working_set_bytes,
            0,
        )

    def schedule(self, stream: str | None = None) -> dict[int, list[int]]:
        """The per-chunk future-reference schedule for OPT eviction.

        Without ``stream`` the merged (all-stream) schedule is returned,
        which is what a standalone single-stream manager consumes."""
        if stream is not None:
            per = self.stream_chunk_moments.get(stream, {})
            return {c: list(ms) for c, ms in per.items()}
        merged: dict[int, list[int]] = defaultdict(list)
        for per in self.stream_chunk_moments.values():
            for c, ms in per.items():
                merged[c].extend(ms)
        return {c: sorted(ms) for c, ms in merged.items()}

    def schedule_by_stream(
        self, promote_chunks: "dict[str, set[int]] | None" = None
    ) -> dict[str, dict[int, list[int]]]:
        """Per-stream device schedules.  ``promote_chunks`` (stream ->
        chunk ids) additionally merges in host-side reference moments for
        chunks the placement plan later keeps on the device (OS groups in
        GPU margin space: their ADAM runs device-side after warm-up)."""
        out = {
            s: {c: list(ms) for c, ms in per.items()}
            for s, per in self.stream_chunk_moments.items()
        }
        for s, chunks in (promote_chunks or {}).items():
            per = out.setdefault(s, {})
            hosted = self.host_chunk_moments.get(s, {})
            for c in chunks:
                if c in hosted:
                    per[c] = sorted(per.get(c, []) + list(hosted[c]))
        return out

    def duration_schedule(self, cost_of) -> dict[int, float]:
        """Per-moment compute durations for the transfer timeline
        (:class:`repro_torch.core.timeline.TransferTimeline`): maps each
        warm-up moment through ``cost_of(op_name, phase) -> seconds``
        (a cost model's per-operator time).
        Zero-duration moments are omitted — the timeline treats missing
        moments as instantaneous."""
        out: dict[int, float] = {}
        for m in self.moments:
            dur = cost_of(m.op_name, m.phase)
            if dur > 0.0:
                out[m.index] = dur
        return out

    def gather_reference_sequence(
        self, cmap, stream: str = "param",
        phases: tuple[str, ...] = ("FWD", "BWD"),
    ) -> list[tuple[int, int]]:
        """Deduplicated (moment, comm_group) pairs of one iteration — the
        schedule the rank-parallel plane's gather prefetcher walks: at
        every lock-step moment, the next upcoming *remote-group
        all-gathers* can be issued ahead of the operator that reads them.

        ADAM moments are excluded by default on purpose: the ADAM stage is
        local to chunk owners (Section 7), so a post-reduce-scatter
        reference must never re-gather a group that was just released."""
        phase_of = {m.index: m.phase for m in self.moments}
        per = self.stream_chunk_moments.get(stream, {})
        refs = {
            (mm, cmap.comm_group(c))
            for c, ms in per.items()
            for mm in ms
            if phase_of.get(mm) in phases
        }
        return sorted(refs)

    def reference_sequence(
        self, schedules: "dict[str, dict[int, list[int]]] | None" = None
    ) -> list[tuple[int, str, int]]:
        """All device-side (moment, stream, chunk_id) references of one
        iteration in moment order — the staging queue the prefetcher
        walks.  Pass the (possibly promotion-amended) ``schedules`` to
        keep prefetch and OPT consuming the same future."""
        if schedules is None:
            schedules = self.schedule_by_stream()
        refs = [
            (m, s, c)
            for s, per in schedules.items()
            for c, ms in per.items()
            for m in ms
        ]
        return sorted(refs)
