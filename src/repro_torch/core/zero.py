"""Chunked ZeRO parameter store of the port (``repro.core.zero`` twin).

A tree of parameters is packed (append-style, :mod:`repro_torch.core.chunk`)
into a chunk store laid out ``[G, p, S]``:

- ``S``  chunk size in elements,
- ``p``  = ``nproc`` = the number of ZeRO (data) ranks,
- ``G``  communication groups; group g = chunks ``[g*p, (g+1)*p)`` and rank
  ``r`` owns chunk ``g*p + r`` (the paper's Fig. 8).

Layer stacks keep a leading layer axis, ``[L, G, p, S]``.  The layouts,
chunk sizes and offsets equal the reference's field for field (the CPU
tests check it), so a store written by either package reads in the other.

The port simulates the ``p`` ranks in one process: a store holds every
rank's ``[G, 1, S]`` shard side by side, so the all-gather of the shards
(:func:`gather_store`) is a view of the store in chunk-id order, and the
gradient of that view, summed over the ranks' losses, is the
reduce-scatter of the reference's autodiff transpose.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.core.chunk import (
    ChunkMapError,
    ChunkTensorMap,
    TensorSpec,
    build_chunk_map,
    search_chunk_size,
)
from repro_torch.models.api import flatten_with_paths, unflatten

# the reference's chunk alignment (chunk payloads tile (8, 128) blocks)
CHUNK_ALIGN = 1024


def keystr(path: tuple) -> str:
    """A key path as ``jax.tree_util.keystr`` spells a dict path:
    ``("attn", "wq")`` -> ``"['attn']['wq']"``."""
    return "".join(f"[{k!r}]" for k in path)


@dataclasses.dataclass(frozen=True)
class ChunkLayout:
    """Static metadata binding a parameter tree to a chunk store."""

    cmap: ChunkTensorMap
    paths: tuple = dataclasses.field(repr=False, hash=False, compare=False)
    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtype: torch.dtype  # store dtype (params: bf16; optimizer state: fp32)

    # ----------------------------------------------------------------- sizes
    @property
    def chunk_size(self) -> int:
        return self.cmap.chunk_size

    @property
    def nproc(self) -> int:
        return self.cmap.nproc

    @property
    def num_groups(self) -> int:
        return self.cmap.num_comm_groups

    @property
    def store_shape(self) -> tuple[int, int, int]:
        """[G, p, S]; axis 1 is the ZeRO (data) rank."""
        return (self.num_groups, self.nproc, self.chunk_size)

    @property
    def capacity(self) -> int:
        return self.cmap.capacity

    @property
    def payload_elems(self) -> int:
        return self.cmap.total_numel

    # ---------------------------------------------------------------- offsets
    def flat_offset(self, name: str) -> int:
        p = self.cmap.placement(name)
        return p.chunk_id * self.chunk_size + p.offset

    @functools.cached_property
    def _segments(self) -> tuple[list[int], list[int]]:
        """The flat store cut into consecutive pieces, tensors and the gaps
        between them: (piece sizes, index of each tensor's piece in names'
        order)."""
        spans = sorted((self.flat_offset(n), _numel(s), i) for i, (n, s)
                       in enumerate(zip(self.names, self.shapes)))
        sizes, where, pos = [], [0] * len(spans), 0
        for off, n, i in spans:
            if off > pos:
                sizes.append(off - pos)
            where[i] = len(sizes)
            sizes.append(n)
            pos = off + n
        if pos < self.capacity:
            sizes.append(self.capacity - pos)
        return sizes, where


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def make_layout(tree: Any, *, nproc: int, dtype: torch.dtype = torch.bfloat16,
                chunk_size: int | None = None,
                memory_budget_elems: int | None = None) -> ChunkLayout:
    """A :class:`ChunkLayout` for a tree of tensors (meta tensors will do:
    only shapes are read).  Without ``chunk_size``, runs the paper's
    offline chunk-size search (utilization-maximising, aligned to
    :data:`CHUNK_ALIGN`)."""
    pairs = flatten_with_paths(tree)
    names = [keystr(path) for path, _ in pairs]
    shapes = [tuple(int(d) for d in leaf.shape) for _, leaf in pairs]
    specs = [TensorSpec(n, s) for n, s in zip(names, shapes)]
    if chunk_size is None:
        chunk_size = search_chunk_size(
            specs, nproc=nproc, align=CHUNK_ALIGN,
            memory_budget_elems=memory_budget_elems).chunk_size
    cmap = build_chunk_map(specs, chunk_size, nproc=nproc)
    return ChunkLayout(cmap=cmap, paths=tuple(p for p, _ in pairs),
                       names=tuple(names), shapes=tuple(shapes), dtype=dtype)


# ---------------------------------------------------------------------------
# flatten / unflatten
# ---------------------------------------------------------------------------


def flatten_to_store(layout: ChunkLayout, tree: Any, *, device=None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Pack a parameter tree into a new ``[G, p, S]`` chunk store (padding
    zero), on ``device`` (default: the leaves' device), or into ``out``
    (a contiguous ``[G, p, S]`` slice of a larger store)."""
    pairs = flatten_with_paths(tree)
    if tuple(keystr(p) for p, _ in pairs) != layout.names:
        raise ChunkMapError("tree does not match layout (leaf names differ)")
    if out is not None:
        device = out.device
        flat = out.view(-1).zero_()
    else:
        if device is None:
            device = pairs[0][1].device if pairs else "cpu"
        flat = torch.zeros(layout.capacity, dtype=layout.dtype,
                           device=device)
    for name, (_, leaf) in zip(layout.names, pairs):
        off = layout.flat_offset(name)
        leaf = leaf.reshape(-1)
        flat[off:off + leaf.numel()] = leaf.to(device=device,
                                               dtype=layout.dtype)
    return flat.reshape(layout.store_shape)


def unflatten_from_flat(layout: ChunkLayout, flat: torch.Tensor, *,
                        dtype: torch.dtype | None = None) -> Any:
    """The parameter tree of a flat chunk vector ``[capacity]``: views of
    ``flat`` (copies where ``dtype`` differs).  Differentiable; the
    gradient of ``flat`` is built in one pass (``torch.split``'s backward
    concatenates the pieces), never one full-size buffer per tensor."""
    sizes, where = layout._segments
    pieces = torch.split(flat.reshape(-1), sizes)
    leaves = []
    for i, shape in enumerate(layout.shapes):
        leaf = pieces[where[i]].view(shape)
        if dtype is not None:
            leaf = leaf.to(dtype)
        leaves.append(leaf)
    return unflatten(list(layout.paths), leaves)


def unflatten_from_store(layout: ChunkLayout, store: torch.Tensor,
                         **kw) -> Any:
    return unflatten_from_flat(layout, store.reshape(-1), **kw)


# ---------------------------------------------------------------------------
# the simulated collectives (paper Section 7)
# ---------------------------------------------------------------------------


def gather_store(store: torch.Tensor) -> torch.Tensor:
    """The all-gather of every rank's ``[..., G, 1, S]`` shard, as the
    flat chunk vector ``[..., G*p*S]`` in chunk-id order (Algorithm 1
    ``FetchRemoteChunks``).  The simulated ranks' shards sit side by side
    in one ``[..., G, p, S]`` store, so the gather is a view of it; the
    gradient of the view is what the reduce-scatter sums onto each
    owner's shard."""
    return store.reshape(*store.shape[:-3], -1)


def gather_params(layout: ChunkLayout, store: torch.Tensor, *,
                  dtype: torch.dtype | None = None) -> Any:
    """Fetch the chunks and rebuild the parameter tree (one layer)."""
    return unflatten_from_flat(layout, gather_store(store), dtype=dtype)


# ---------------------------------------------------------------------------
# host/device split for device-aware OS placement (Section 8.2)
# ---------------------------------------------------------------------------


def split_groups(store: torch.Tensor, device_groups: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a ``[G, p, S]`` (or ``[L, G, p, S]``) store along G into a
    device-resident head and a host-resident tail (views)."""
    axis = store.ndim - 3
    g = store.shape[axis]
    device_groups = max(0, min(device_groups, g))
    return (store.narrow(axis, 0, device_groups),
            store.narrow(axis, device_groups, g - device_groups))


def merge_groups(dev: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_groups`, on ``dev``'s device."""
    return torch.cat([dev, host.to(dev.device)], dim=dev.ndim - 3)


# ---------------------------------------------------------------------------
# communication volume cost model (Section 7)
# ---------------------------------------------------------------------------


def comm_volume_bytes(layout, *, itemsize: int = 2) -> dict[str, float]:
    """The paper's analytic inter-GPU volume per iteration (the
    reference's ``comm_volume_bytes``, same keys and arithmetic).

    chunked (PatrickStar): 2 all-gathers (FWD+BWD) + 1 reduce-scatter
       = 3 * (p-1)/p * 2M = 6(p-1)/p * M bytes (fp16/bf16);
    broadcast (ZeRO-Offload): 10(p-1)/p * M.
    ``chunked_capacity_bytes`` is the same model over the padded store
    capacity: what chunk-granular collectives move."""
    p = layout.nproc
    m_bytes = layout.payload_elems * itemsize
    cap_bytes = layout.capacity * itemsize
    frac = (p - 1) / p if p > 1 else 0.0
    return {
        "chunked_allgather_bytes": 3 * frac * m_bytes,
        "chunked_capacity_bytes": 3 * frac * cap_bytes,
        "broadcast_baseline_bytes": 5 * frac * m_bytes,
        "params_bytes": float(m_bytes),
    }
