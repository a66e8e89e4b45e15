"""Chunk / tensor->chunk mapping schema (PatrickStar Section 6.1).

Model-data tensors are packed append-style into fixed-size chunks, in the
order the model defines them (the N-ary storage model): the first tensor
starts at offset 0 of chunk 0; each following tensor is placed right after
the previous one; a tensor that does not fit in the remaining space of the
current chunk opens a new chunk (tensors never straddle chunks).

The same layout is shared by the four model-data streams (param fp16,
param fp32, momentum, variance), so the offset of a parameter's OS tensors
equals the offset of its fp16 tensor — "the offsets in the chunk list of
param fp16, param fp32, momentum, and variance tensors of the same
parameter are consistent", which keeps ADAM fully local under ZeRO.

Grad fp16 has *no* chunk list: gradients reuse the param-fp16 chunk space
(Section 6.2).

For the data-parallel runtime, the chunk count is padded up to a multiple
of ``nproc`` so chunks divide evenly into communication groups of
``nproc`` chunks (Section 7).  ``group_boundaries`` optionally force the
packer to close the current group before specific tensors, so that a
scanned layer stack starts on a communication-group boundary (this is the
TPU adaptation that makes per-layer all-gather inside ``lax.scan``
possible).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A logical model-data tensor to be packed into chunks."""

    name: str
    shape: tuple[int, ...]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclasses.dataclass(frozen=True)
class TensorPlacement:
    """Where a tensor lives inside the chunk list."""

    name: str
    shape: tuple[int, ...]
    chunk_id: int
    offset: int  # element offset inside the chunk

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


class ChunkMapError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ChunkTensorMap:
    """The chunk<->tensor mapping schema produced by the preprocessing stage."""

    chunk_size: int  # elements per chunk
    placements: tuple[TensorPlacement, ...]
    num_chunks: int  # padded to a multiple of nproc
    num_payload_chunks: int  # chunks actually containing tensors
    nproc: int

    # ---------------------------------------------------------------- lookup
    def placement(self, name: str) -> TensorPlacement:
        return self._by_name()[name]

    def _by_name(self) -> dict[str, TensorPlacement]:
        if not hasattr(self, "_by_name_cache"):
            object.__setattr__(
                self, "_by_name_cache", {p.name: p for p in self.placements}
            )
        return self._by_name_cache  # type: ignore[attr-defined]

    def chunk_tensors(self, chunk_id: int) -> list[TensorPlacement]:
        return list(self._by_chunk().get(chunk_id, ()))

    def _by_chunk(self) -> dict[int, tuple[TensorPlacement, ...]]:
        """chunk_id -> placements index, built once (chunk_tensors is called
        per eviction candidate; a linear scan there made eviction O(n^2))."""
        if not hasattr(self, "_by_chunk_cache"):
            idx: dict[int, list[TensorPlacement]] = {}
            for p in self.placements:
                idx.setdefault(p.chunk_id, []).append(p)
            object.__setattr__(
                self,
                "_by_chunk_cache",
                {c: tuple(ps) for c, ps in idx.items()},
            )
        return self._by_chunk_cache  # type: ignore[attr-defined]

    # ------------------------------------------------------------ statistics
    @property
    def total_numel(self) -> int:
        return sum(p.numel for p in self.placements)

    @property
    def capacity(self) -> int:
        return self.num_chunks * self.chunk_size

    @property
    def utilization(self) -> float:
        """Fraction of chunk capacity that holds real tensor data."""
        return self.total_numel / self.capacity if self.capacity else 1.0

    @property
    def fragmentation(self) -> float:
        return 1.0 - self.utilization

    @property
    def payload_elems(self) -> int:
        """Elements of real tensor data (M in the paper's volume model);
        same meaning as :attr:`repro_torch.core.zero.ChunkLayout.payload_elems`,
        so the analytic ``comm_volume_bytes`` accepts either layout."""
        return self.total_numel

    @property
    def num_comm_groups(self) -> int:
        return self.num_chunks // self.nproc

    def comm_group(self, chunk_id: int) -> int:
        return chunk_id // self.nproc

    def comm_group_chunk_ids(self, group: int) -> range:
        return range(group * self.nproc, (group + 1) * self.nproc)

    def owner_rank(self, chunk_id: int) -> int:
        """Process that owns this chunk under the ZeRO split (Section 7):
        rank r owns chunk ``g*p + r`` of every communication group g."""
        return chunk_id % self.nproc

    def chunk_owner(self, chunk_id: int) -> int:
        """Alias of :meth:`owner_rank` (the distributed runtime's name)."""
        return self.owner_rank(chunk_id)

    def local_chunk_ids(self, rank: int) -> list[int]:
        return [c for c in range(self.num_chunks) if c % self.nproc == rank]

    def comm_group_tensors(self, group: int) -> list[TensorPlacement]:
        """All tensor placements of a communication group's chunks (padding
        chunks contribute nothing) — the unit Algorithm 2's post-FWD/BWD
        group-complete check and the all-gather fetch operate on."""
        out: list[TensorPlacement] = []
        for c in self.comm_group_chunk_ids(group):
            out.extend(self._by_chunk().get(c, ()))
        return out

    def tensor_comm_group(self, name: str) -> int:
        return self.comm_group(self.placement(name).chunk_id)


def build_chunk_map(
    tensors: Sequence[TensorSpec],
    chunk_size: int,
    *,
    nproc: int = 1,
    group_boundaries: Iterable[str] = (),
) -> ChunkTensorMap:
    """Pack ``tensors`` (in order) into chunks of ``chunk_size`` elements.

    ``group_boundaries``: names of tensors before which the packer pads to
    the next *communication-group* boundary (a multiple of ``nproc``
    chunks).  Tensors larger than ``chunk_size`` are rejected — the paper's
    schema never splits a tensor across chunks (the chunk-size search is
    responsible for picking a feasible size).
    """
    if chunk_size <= 0:
        raise ChunkMapError(f"chunk_size must be positive, got {chunk_size}")
    boundaries = set(group_boundaries)
    placements: list[TensorPlacement] = []
    chunk_id = 0
    offset = 0
    started = False
    for t in tensors:
        if t.numel > chunk_size:
            raise ChunkMapError(
                f"tensor {t.name} ({t.numel} elems) exceeds chunk size {chunk_size}"
            )
        if t.name in boundaries and started and not (offset == 0 and chunk_id % nproc == 0):
            # close the current communication group
            chunk_id = ((chunk_id + (1 if offset > 0 else 0) + nproc - 1) // nproc) * nproc
            offset = 0
        if offset + t.numel > chunk_size:
            chunk_id += 1
            offset = 0
        placements.append(
            TensorPlacement(name=t.name, shape=t.shape, chunk_id=chunk_id, offset=offset)
        )
        offset += t.numel
        started = True
    num_payload = chunk_id + (1 if offset > 0 else 0)
    num_payload = max(num_payload, 1)
    num_chunks = ((num_payload + nproc - 1) // nproc) * nproc
    return ChunkTensorMap(
        chunk_size=chunk_size,
        placements=tuple(placements),
        num_chunks=num_chunks,
        num_payload_chunks=num_payload,
        nproc=nproc,
    )


def build_act_chunk_map(
    names: Sequence[str], numel: int, *, align: int = 256
) -> ChunkTensorMap:
    """Chunk map for the activation stream: one checkpointed layer input
    per chunk.

    Activations differ from model data in two ways that shape the layout:
    they are all the same size (every layer's saved input is the embed
    output's shape), and they are rank-local (never all-gathered or
    reduce-scattered), so the map is built with ``nproc=1`` — act chunks
    have no communication groups.  The chunk size is the activation numel
    rounded up to ``align``, so exactly one activation occupies each
    chunk and FWD-write / BWD-read / free maps 1:1 onto chunk
    materialize / access / release.
    """
    size = int(math.ceil(max(numel, 1) / align) * align)
    specs = [TensorSpec(n, (numel,)) for n in names]
    return build_chunk_map(specs, size, nproc=1)


def pages_for(positions: int, page_tokens: int | None) -> int:
    """KV pages covering ``positions`` decode positions: ``ceil(positions
    / page_tokens)``, at least one.  An unpaged stream (``page_tokens is
    None``) is one page spanning the whole horizon."""
    if page_tokens is None:
        return 1
    return max(1, -(-int(positions) // int(page_tokens)))


class DynamicChunkMap:
    """Mutable chunk<->tensor map for *dynamically populated* streams.

    The four model-data streams and the activation stream have layouts
    fixed for a whole iteration (the act stream is rebuilt wholesale on a
    batch-shape change).  The serving plane's KV stream is different: a
    sequence's KV chunks are allocated when its request is **admitted**
    and freed when it **completes**, while other sequences' chunks live
    on — the map must grow and shrink tensor-by-tensor mid-flight.

    Layout: one tensor per chunk (every KV tensor is chunk-sized by
    construction, exactly like the act stream's one-activation-per-chunk
    rule), chunk ids of removed tensors are recycled through a free list
    so the id space — and with it the manager's record table — stays
    bounded by the peak concurrent tensor count.  ``nproc`` is fixed at 1:
    KV state is rank-local, it is never all-gathered or reduce-scattered,
    so there are no communication groups.

    **Paging** (``page_tokens=``): with a page size the stream's unit
    becomes a per-position-block page — a sequence at position ``p``
    holds :func:`pages_for` ``(p)`` chunks per (group, layer) instead of
    one whole-horizon chunk, and :meth:`pages_for` is the map-level page
    math admission reasons with.  The map itself stays one-tensor-per-
    chunk; pages are simply more (smaller) tensors.

    **Reserved ids** (:meth:`reserve_ids`): the compiled serving plane
    pins padded batch slot ``s`` to a fixed chunk-id *range*.  Reserving
    the range takes those ids out of default allocation and out of
    free-list recycling permanently: a removed tensor on a reserved id
    does NOT return to the free list, so background default allocation
    can never collide with a live slot's pinned page range — reserved
    ids are only ever (re)used by an explicit ``chunk_id=`` bind.

    Invariant: every id below the high-water mark is exactly one of
    occupied / free / reserved; reserved ids may also sit above it.

    The query surface mirrors :class:`ChunkTensorMap` (``placement`` /
    ``chunk_tensors`` / ``num_chunks`` / ``chunk_size`` ...), so
    :class:`~repro_torch.core.manager.ChunkManager` and the pool consume either
    interchangeably.
    """

    nproc = 1

    def __init__(self, chunk_size: int, *,
                 page_tokens: int | None = None) -> None:
        if chunk_size <= 0:
            raise ChunkMapError(f"chunk_size must be positive, got {chunk_size}")
        if page_tokens is not None and page_tokens < 1:
            raise ChunkMapError(
                f"page_tokens must be >= 1, got {page_tokens}")
        self.chunk_size = chunk_size
        self.page_tokens = page_tokens
        self._by_name: dict[str, TensorPlacement] = {}
        self._by_chunk: dict[int, TensorPlacement] = {}
        self._free: list[int] = []
        self._reserved: set[int] = set()
        self._next_chunk = 0

    # ----------------------------------------------------------------- pages
    def pages_for(self, positions: int) -> int:
        """Pages a sequence holding ``positions`` cache positions needs
        per (group, layer) under this map's page size."""
        return pages_for(positions, self.page_tokens)

    # ------------------------------------------------------------- reserve
    def reserve_ids(self, ids: Iterable[int]) -> None:
        """Withdraw ``ids`` from default allocation and from free-list
        recycling (idempotent).  A reserved id is bound only through an
        explicit ``add_tensor(..., chunk_id=)``, and removing such a
        tensor keeps the id reserved — the compiled plane's slot page
        ranges stay collision-free however many sequences churn."""
        for i in ids:
            if i < 0:
                raise ChunkMapError(f"chunk_id must be >= 0, got {i}")
            if i in self._reserved:
                continue
            if i in self._by_chunk:
                raise ChunkMapError(
                    f"chunk {i} holds {self._by_chunk[i].name}; a live "
                    f"chunk cannot be reserved")
            if i < self._next_chunk:
                self._free.remove(i)
            self._reserved.add(i)

    # ---------------------------------------------------------------- mutate
    def add_tensor(self, spec: TensorSpec,
                   chunk_id: int | None = None) -> TensorPlacement:
        """Map a tensor into a chunk of its own.

        With ``chunk_id=None`` the id is recycled LIFO from the free list
        (or the id space grows).  An explicit ``chunk_id`` pins the tensor
        to that id — the compiled serving plane binds padded batch slot
        ``s`` to a fixed id range so a slot's chunks are *stable across
        admissions*: re-binding a slot to a new sequence touches the same
        chunk ids and therefore never changes any compiled-step shape.
        """
        if spec.name in self._by_name:
            raise ChunkMapError(f"tensor {spec.name} already mapped")
        if spec.numel > self.chunk_size:
            raise ChunkMapError(
                f"tensor {spec.name} ({spec.numel} elems) exceeds chunk size "
                f"{self.chunk_size}")
        if chunk_id is not None:
            if chunk_id < 0:
                raise ChunkMapError(f"chunk_id must be >= 0, got {chunk_id}")
            if chunk_id in self._by_chunk:
                raise ChunkMapError(
                    f"chunk {chunk_id} already holds "
                    f"{self._by_chunk[chunk_id].name}")
            if chunk_id >= self._next_chunk:
                # ids between the old high-water mark and the requested id
                # become free (the record table must stay dense) — except
                # reserved ones, which stay bindable-by-pin only
                self._free.extend(i for i in range(self._next_chunk, chunk_id)
                                  if i not in self._reserved)
                self._next_chunk = chunk_id + 1
            elif chunk_id not in self._reserved:
                self._free.remove(chunk_id)
        else:
            if self._free:
                chunk_id = self._free.pop()
            else:
                chunk_id = self._next_chunk
                while chunk_id in self._reserved:
                    chunk_id += 1
                self._next_chunk = chunk_id + 1
        p = TensorPlacement(name=spec.name, shape=spec.shape,
                            chunk_id=chunk_id, offset=0)
        self._by_name[spec.name] = p
        self._by_chunk[chunk_id] = p
        return p

    def remove_tensor(self, name: str) -> int:
        """Unmap a tensor; its chunk id goes back to the free list —
        unless it is reserved, in which case it stays out of default
        allocation and waits for the next explicit pin."""
        p = self._by_name.pop(name)
        del self._by_chunk[p.chunk_id]
        if p.chunk_id not in self._reserved:
            self._free.append(p.chunk_id)
        return p.chunk_id

    # ---------------------------------------------------------------- lookup
    def placement(self, name: str) -> TensorPlacement:
        return self._by_name[name]

    def chunk_tensors(self, chunk_id: int) -> list[TensorPlacement]:
        p = self._by_chunk.get(chunk_id)
        return [p] if p is not None else []

    @property
    def placements(self) -> tuple[TensorPlacement, ...]:
        return tuple(self._by_name.values())

    @property
    def num_chunks(self) -> int:
        """High-water chunk-id bound (recycled ids included): the record
        table a manager must be able to index."""
        return self._next_chunk

    @property
    def num_payload_chunks(self) -> int:
        return len(self._by_chunk)

    @property
    def total_numel(self) -> int:
        return sum(p.numel for p in self._by_name.values())

    @property
    def capacity(self) -> int:
        return self.num_payload_chunks * self.chunk_size

    def chunk_owner(self, chunk_id: int) -> int:
        return 0  # rank-local stream: this process owns everything

    def comm_group(self, chunk_id: int) -> int:
        raise ChunkMapError("dynamic (rank-local) streams have no comm groups")


def build_kv_chunk_map(numel: int, *, align: int = 256,
                       page_tokens: int | None = None) -> DynamicChunkMap:
    """Empty dynamic map for the serving KV stream: one (sequence, layer,
    page) cache per chunk, sized for the largest layer page rounded to
    ``align`` (the same vreg-tiling alignment as the act stream).  With
    ``page_tokens`` the unit is a position-block page instead of a whole
    decode horizon."""
    size = int(math.ceil(max(numel, 1) / align) * align)
    return DynamicChunkMap(size, page_tokens=page_tokens)


# ---------------------------------------------------------------------------
# Chunk-size search (Section 9.1, Table 3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkSizeSearchResult:
    chunk_size: int
    utilization: float
    num_chunks: int
    candidates: tuple[tuple[int, float], ...]  # (size, utilization) per feasible size


def search_chunk_size(
    tensors: Sequence[TensorSpec],
    *,
    nproc: int = 1,
    group_boundaries: Iterable[str] = (),
    search_range: Sequence[int] | None = None,
    memory_budget_elems: int | None = None,
    align: int = 1,
) -> ChunkSizeSearchResult:
    """Offline search for the chunk size with minimal fragmentation.

    Mirrors the paper's lightweight pre-training search: it never allocates
    payloads, only runs the mapping schema for each candidate size and
    scores utilization.  ``memory_budget_elems`` rejects sizes whose padded
    capacity exceeds the heterogeneous memory budget (the "some chunk size
    settings do not work" effect in Fig. 12).  ``align`` forces candidate
    sizes to a hardware alignment (we use 1024 = 8*128 on TPU so chunk
    payloads tile cleanly into (8,128) vregs).

    The paper searches 128..512 in "model units" (i.e. scaled by hidden
    size); callers pass an explicit element range instead.
    """
    largest = max((t.numel for t in tensors), default=1)
    if search_range is None:
        lo = max(largest, 1)
        search_range = [lo + k * max(lo // 8, align) for k in range(0, 13)]
    candidates: list[tuple[int, float]] = []
    best: tuple[float, int, ChunkTensorMap] | None = None
    for raw in search_range:
        size = int(math.ceil(raw / align) * align)
        if size < largest:
            continue
        try:
            cmap = build_chunk_map(
                tensors, size, nproc=nproc, group_boundaries=group_boundaries
            )
        except ChunkMapError:
            continue
        if memory_budget_elems is not None and cmap.capacity > memory_budget_elems:
            continue  # infeasible on this budget
        candidates.append((size, cmap.utilization))
        key = (cmap.utilization, -size)
        if best is None or key > (best[0], -best[1]):
            best = (cmap.utilization, size, cmap)
    if best is None:
        raise ChunkMapError(
            "no feasible chunk size in search range "
            f"(largest tensor {largest} elems, budget {memory_budget_elems})"
        )
    util, size, cmap = best
    return ChunkSizeSearchResult(
        chunk_size=size,
        utilization=util,
        num_chunks=cmap.num_chunks,
        candidates=tuple(candidates),
    )
