"""Runtime chunk manager: a per-stream view of the unified memory space.

This is the paper's runtime module (Sections 6.2, 8.3).  One
:class:`ChunkManager` owns the payloads and tensor states of one *stream*
(param fp16 / param fp32 / momentum / variance share a layout but have
independent payloads).  All capacity budgeting, transfer accounting and
eviction live in the shared :class:`~repro_torch.core.memory.HeteroMemory`
pool the stream registers with — so a device-tier miss in one stream can
evict a chunk of *any* stream, the paper's single heterogeneous
CPU+GPU memory space.  Constructing a manager without an explicit
``pool`` creates a private single-stream pool, which preserves the
historical standalone behaviour (and API) exactly.

In the port a payload is a flat torch tensor that really lives on its
tier (HBM for the device tier of a CUDA pool, pinned CPU memory for the
host tier), every cross-tier move is a real copy, and the accounting
(bytes + count per link) is the reference's exactly — so eviction-policy
quality is measured the way the paper measures it (CPU<->GPU
data-movement volume).  Tensor views are slices of the chunk payload:
the chunk is the storage.

Per-stream usage counters are incremental (kept in lock-step with the
pool's global counters), so ``device_bytes_used()`` is O(1) and the
eviction loop never rescans the chunk list to learn the tier occupancy.
Chunk states are likewise tracked incrementally per chunk, making
``chunk_state`` O(1) instead of a scan over the chunk's tensors.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable

import torch

from repro_torch.core.chunk import ChunkTensorMap
from repro_torch.core.memory import (
    Device,
    EvictionPolicy,
    HeteroMemory,
    OutOfMemory,
    Tenant,
    TransferStats,
)
from repro_torch.core.state import (
    ChunkState,
    TensorState,
    check_transition,
)

__all__ = [
    "ChunkManager",
    "Device",
    "EvictionPolicy",
    "HeteroMemory",
    "OutOfMemory",
    "Tenant",
    "TransferStats",
]


@dataclasses.dataclass
class _ChunkRecord:
    chunk_id: int
    payload: torch.Tensor | None  # None <=> all tensors FREE, space released
    location: Device | None
    pinned: int = 0  # pin refcount
    last_use: int = -1  # for LRU
    arrival: int = -1  # for FIFO
    # pending asynchronous copy into ``payload`` (CUDA pools only)
    ready: "torch.cuda.Event | None" = None


class ChunkManager:
    """Manages one chunk stream inside a shared two-tier memory space."""

    def __init__(
        self,
        cmap: ChunkTensorMap,
        *,
        dtype: torch.dtype = torch.float32,
        device_capacity_bytes: int | None = None,
        host_capacity_bytes: int | None = None,
        policy: EvictionPolicy | None = None,
        name: str = "chunks",
        pool: HeteroMemory | None = None,
        tenant: "Tenant | None" = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.cmap = cmap
        self.dtype = dtype
        self.chunk_bytes = cmap.chunk_size * dtype.itemsize
        if tenant is not None:
            if pool is None:
                pool = tenant.pool
            elif tenant.pool is not pool:
                raise ValueError(
                    f"tenant {tenant.name!r} belongs to a different pool")
            # tenant-qualified pool-wide stream name: two tenants can then
            # both own e.g. a "param" stream without colliding
            name = tenant.qualify(name)
        self.name = name
        if pool is None:
            pool = HeteroMemory(
                device_capacity_bytes=device_capacity_bytes,
                host_capacity_bytes=host_capacity_bytes,
                policy=policy if policy is not None else "opt",
                device=device,
            )
        elif (device_capacity_bytes is not None or host_capacity_bytes is not None
              or policy is not None):
            raise ValueError(
                "capacity and eviction policy are owned by the shared pool; "
                "do not pass device/host_capacity_bytes or policy together "
                "with pool="
            )
        self.pool = pool
        pool.register_stream(self, tenant)
        self.stats = TransferStats()  # this stream's share of pool.stats

        self._records = [
            _ChunkRecord(chunk_id=c, payload=None, location=None)
            for c in range(cmap.num_chunks)
        ]
        self._tensor_state: dict[str, TensorState] = {
            p.name: TensorState.FREE for p in cmap.placements
        }
        # incremental per-chunk state tallies -> O(1) chunk_state
        self._chunk_compute: Counter[int] = Counter()
        self._chunk_hold: Counter[int] = Counter()
        self._chunk_released: Counter[int] = Counter()
        # incremental per-stream tier usage (pool keeps the global sums)
        self._device_used = 0
        self._host_used = 0
        self._slow_used = 0
        self._peak_device_used = 0  # this stream's device high-water mark

    # ------------------------------------------------- pool-compat properties
    @property
    def device_capacity(self) -> int | None:
        return self.pool.device_capacity

    @property
    def host_capacity(self) -> int | None:
        return self.pool.host_capacity

    @property
    def slow_capacity(self) -> int | None:
        return self.pool.slow_capacity

    @property
    def policy(self) -> EvictionPolicy:
        return self.pool.policy

    # ------------------------------------------------------------ accounting
    def device_bytes_used(self) -> int:
        return self._device_used

    def host_bytes_used(self) -> int:
        return self._host_used

    def slow_bytes_used(self) -> int:
        return self._slow_used

    def peak_device_bytes(self) -> int:
        """This stream's lifetime device high-water mark (the pool keeps
        the cross-stream mark) — e.g. the activation plane's real device
        footprint for honest margin accounting."""
        return self._peak_device_used

    def location(self, chunk_id: int) -> Device | None:
        return self._records[chunk_id].location

    def tensor_state(self, name: str) -> TensorState:
        return self._tensor_state[name]

    def chunk_state(self, chunk_id: int) -> ChunkState:
        if self._chunk_compute[chunk_id] > 0:
            return ChunkState.COMPUTE
        if self._chunk_hold[chunk_id] > 0:
            return ChunkState.HOLD
        if self._chunk_released[chunk_id] > 0:
            return ChunkState.RELEASED
        return ChunkState.FREE

    def _set_state(self, name: str, new: TensorState) -> None:
        """Single mutation point keeping the per-chunk tallies in sync."""
        old = self._tensor_state[name]
        if old is new:
            return
        chunk_id = self.cmap.placement(name).chunk_id
        if old is TensorState.COMPUTE:
            self._chunk_compute[chunk_id] -= 1
        elif old is TensorState.RELEASED:
            self._chunk_released[chunk_id] -= 1
        elif old is not TensorState.FREE:
            self._chunk_hold[chunk_id] -= 1
        if new is TensorState.COMPUTE:
            self._chunk_compute[chunk_id] += 1
        elif new is TensorState.RELEASED:
            self._chunk_released[chunk_id] += 1
        elif new is not TensorState.FREE:
            self._chunk_hold[chunk_id] += 1
        self._tensor_state[name] = new
        tel = self.pool.telemetry
        if tel is not None:
            tl = self.pool.timeline
            tel.state(name, old=old.name, new=new.name, stream=self.name,
                      tenant=self.tenant.name, chunk_id=chunk_id,
                      ts=tl.now if tl is not None else None,
                      moment=self.tenant.current_moment,
                      rank=self.pool.telemetry_rank)

    # -------------------------------------------------------------- schedule
    def register_moments(self, moments: dict[int, list[int]]) -> None:
        """Install this stream's warm-up reference schedule (OPT eviction)."""
        self.pool.register_moments(self.name, moments)

    def set_moment(self, moment: int) -> None:
        self.tenant.set_moment(moment)

    def set_chunkable_memory_fn(self, fn: Callable[[], int | None],
                                basis_bytes: int | None = None) -> None:
        """Tracer hook: returns the device bytes currently usable for chunks."""
        self.pool.set_chunkable_memory_fn(fn, tenant=self.tenant,
                                          basis_bytes=basis_bytes)

    # ------------------------------------------------------------- tensor API
    def access_tensor(self, name: str, comp_dev: Device = "device") -> torch.Tensor:
        """Algorithm 1 (single-process part): bring the tensor's chunk to
        ``comp_dev``, mark the tensor COMPUTE, return a view of its payload."""
        p = self.cmap.placement(name)
        old = self._tensor_state[name]
        if old is TensorState.RELEASED:
            # zero-filling a remote parameter would corrupt the model; the
            # engine must run the group's all-gather (Algorithm 1 line 12)
            # before any of its tensors enters COMPUTE.
            raise RuntimeError(
                f"tensor {name}: chunk {p.chunk_id} is RELEASED (owned by "
                f"rank {self.cmap.chunk_owner(p.chunk_id)}); fetch the "
                f"communication group by all-gather before accessing it"
            )
        rec = self.pool.ensure_on(self, p.chunk_id, comp_dev)
        check_transition(old, TensorState.COMPUTE)
        self._set_state(name, TensorState.COMPUTE)
        view = rec.payload[p.offset : p.offset + p.numel]
        if old is TensorState.FREE:
            view.zero_()  # Algorithm 1 line 31
        return view.view(p.shape)

    def release_tensor(self, name: str, target_state: TensorState) -> None:
        """Algorithm 2 (single-process part)."""
        old = self._tensor_state[name]
        check_transition(old, target_state)
        self._set_state(name, target_state)
        if target_state is TensorState.FREE:
            self._maybe_release_chunk(self.cmap.placement(name).chunk_id)

    def force_tensor_state(self, name: str, target_state: TensorState) -> None:
        """Unchecked state overwrite (grad->param payload swap in ADAM)."""
        self._set_state(name, target_state)

    def reset_states(self, target: TensorState = TensorState.HOLD) -> None:
        """Reset all resident tensors (e.g. to HOLD before BWD, Section
        6.2).  FREE and RELEASED tensors hold no local payload and keep
        their state — a remote chunk stays released until its group is
        re-fetched."""
        for name, s in self._tensor_state.items():
            if not s.is_payload_free:
                check_transition(s, target)
                self._set_state(name, target)

    def tensor_view(self, name: str) -> torch.Tensor:
        """Read-only style access without a state change (debug/checkpoint)."""
        p = self.cmap.placement(name)
        rec = self._records[p.chunk_id]
        if rec.payload is None:
            raise KeyError(f"tensor {name}: chunk {p.chunk_id} has no payload")
        return rec.payload[p.offset : p.offset + p.numel].view(p.shape)

    # -------------------------------------------- dynamic streams (serving)
    def add_tensor(self, name: str, shape: tuple[int, ...],
                   chunk_id: int | None = None):
        """Map a new tensor into a dynamically-populated stream (KV): the
        map assigns (or recycles) a chunk, the record table grows to
        cover it, and the tensor starts FREE — its first access
        zero-fills (Algorithm 1 line 31), which is exactly a fresh
        decode cache.  An explicit ``chunk_id`` pins the tensor to that
        id (stable slot->chunk binding for the compiled serving plane)."""
        from repro_torch.core.chunk import TensorSpec

        p = self.cmap.add_tensor(TensorSpec(name, tuple(shape)), chunk_id)
        while len(self._records) < self.cmap.num_chunks:
            self._records.append(_ChunkRecord(
                chunk_id=len(self._records), payload=None, location=None))
        self._tensor_state[name] = TensorState.FREE
        return p

    def remove_tensor(self, name: str) -> None:
        """Unmap a dynamic tensor (request completed): payload released,
        bytes uncharged, chunk id recycled for the next admission."""
        chunk_id = self.cmap.placement(name).chunk_id
        self._set_state(name, TensorState.FREE)
        del self._tensor_state[name]
        self.pool.release_payload(self, chunk_id)
        self.cmap.remove_tensor(name)

    # -------------------------------------------------------------- chunk API
    def pin(self, chunk_id: int) -> None:
        self._records[chunk_id].pinned += 1

    def unpin(self, chunk_id: int) -> None:
        rec = self._records[chunk_id]
        if rec.pinned <= 0:
            raise RuntimeError(f"chunk {chunk_id} is not pinned")
        rec.pinned -= 1

    def prepare_payload(self, chunk_id: int, comp_dev: Device = "device") -> torch.Tensor:
        """Materialize (if FREE) and move a chunk to ``comp_dev``."""
        return self.pool.ensure_on(self, chunk_id, comp_dev).payload

    def ensure_on(self, chunk_id: int, dev: Device) -> torch.Tensor:
        return self.pool.ensure_on(self, chunk_id, dev).payload

    def free_chunk(self, chunk_id: int) -> None:
        """Drop a chunk's payload, forcing all its tensors to FREE."""
        for p in self.cmap.chunk_tensors(chunk_id):
            self._set_state(p.name, TensorState.FREE)
        self.pool.release_payload(self, chunk_id)

    # --------------------------------------------------------------- internals
    def _maybe_release_chunk(self, chunk_id: int) -> None:
        if self.chunk_state(chunk_id) is ChunkState.FREE:
            self.pool.release_payload(self, chunk_id)
