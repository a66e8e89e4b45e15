"""Tensor-parallel metadata and the simulated model axis of the port
(``repro.models.tp`` twin).

Each model exposes ``tp_axes()``: a tree mirroring its param tree whose
leaves are the TP-sharded axis index, or ``None`` for params replicated
across the model axis.

**The simulated model axis.**  The reference runs every layer as an SPMD
body under ``shard_map``: each model rank holds its local shards, and the
ranks meet at ``psum``, ``pmax`` and ``all_gather``.  The port runs the
``tp`` model ranks in one process on one device, as it runs the data
ranks.  A param tree at ``tp > 1`` holds, at each sharded leaf, a
:class:`Ranks` tuple of the ranks' local shards, in rank order, and at
each replicated leaf rank 0's copy alone (:func:`merge_ranks`).  A layer
runs each rank's local body in turn (:func:`rank_view` gives rank r's
params) up to the reference's collective, which is then an explicit
reduction over the ranks' values
(:meth:`repro_torch.models.layers.AxisCtx.psum_model` and its siblings).
An activation the reference holds identical on every rank is computed
once; sharded intermediates are per rank.  At ``tp == 1`` no leaf is a
:class:`Ranks`, every rank loop runs once and every reduction returns its
one value: the code and its numbers are those of one device.

**Gradients.**  The reference wraps each replicated leaf in a
``custom_vjp`` identity whose transpose psums the per-rank gradients over
the model axis (each rank's autodiff sees only its own branch).  Here
every rank's branch reads rank 0's copy, so autograd itself sums the
branches into that copy's gradient; :func:`sync_replicated_grads` then
writes it into every other rank's slot of the gradient, so the copies
receive identical updates and stay bitwise equal through ADAM, as the
reference's do.  A sharded leaf's gradient is its rank's alone.

**Resharding.**  :func:`split_for_tp` slices a tp=1 ("global") param tree
into one rank's local shard, for the runtime's ``init_state`` and the
tests, and :func:`join_ranks` puts the ranks' shards of a leaf back
together; :func:`infer_tp_axes` recovers the axes from the two trees'
shapes.  A model's ``tp_axes()`` holds the reference's integers; where a
leaf needs more to split right, the integer is a :class:`TPAxis`, equal
to it, that carries the rule:

  * ``lead``: a unit's sub-layers are stacked (zamba's ``[6, ...]`` mamba
    layers, xlstm's ``[7, ...]`` mLSTMs), and the reference counts their
    axes from the sub-layer, so the split falls ``lead`` axes further in;
  * ``heads``: a head-major axis (mLSTM's value channels) splits within
    each head: it is ``heads`` blocks of ``dh`` columns, and rank r takes
    columns ``h * dh + r * dh / tp + j`` of every head h.  A contiguous
    split would give rank r whole heads, but the layer reads its local
    columns as every head's ``dh / tp`` slice (its carry is ``[B, nh, dk,
    dh / tp]``): the reference's contiguous ``split_for_tp`` of a global
    mLSTM gives each rank other heads' values than its body pairs them
    with, a different model.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.api import flatten_with_paths, unflatten


class Ranks(tuple):
    """The tp model ranks' values of one sharded quantity, in rank order:
    a param leaf's local shards, a cache leaf's per-rank parts, or a
    per-rank intermediate (the vocab-local logits)."""

    @classmethod
    def of(cls, values):
        """``values`` (one a rank) as a :class:`Ranks`, or the value
        itself when there is one rank."""
        values = list(values)
        return values[0] if len(values) == 1 else cls(values)


def shards(x) -> list:
    """The per-rank shards of a vocab-sharded value (a table, the local
    logits): the elements of a :class:`Ranks`, else ``x`` alone (one rank
    holds the whole vocab)."""
    return list(x) if isinstance(x, Ranks) else [x]


def rank_view(tree, rank: int):
    """Rank ``rank``'s local tree: element ``rank`` of every
    :class:`Ranks` leaf, every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: rank_view(v, rank) for k, v in tree.items()}
    return tree[rank] if isinstance(tree, Ranks) else tree


def merge_ranks(trees: list, axes) -> Any:
    """The tp ranks' local trees (identical structure) -> one tree whose
    sharded leaves (axis not None) are :class:`Ranks` of the ranks'
    leaves and whose replicated leaves are rank 0's.  One tree is
    returned as it is."""
    if len(trees) == 1:
        return trees[0]
    pairs = [flatten_with_paths(t) for t in trees]
    ax = [a for _, a in flatten_with_paths(axes)]
    if len(ax) != len(pairs[0]):
        raise ValueError(f"tp_axes has {len(ax)} leaves, the params "
                         f"{len(pairs[0])}")
    leaves = [pairs[0][i][1] if a is None
              else Ranks(p[i][1] for p in pairs)
              for i, a in enumerate(ax)]
    return unflatten([p for p, _ in pairs[0]], leaves)


class TPAxis(int):
    """A sharded axis with its split rule, equal to the axis index as an
    integer (the reference's ``tp_axes`` value).  ``lead``: stacked axes
    ahead of the layer's own (a unit's ``[n, ...]`` sub-layers, whose
    axes the reference counts from the sub-layer), so the split falls on
    axis ``int(self) + lead``.  ``heads``: the axis is laid out head-major,
    ``heads`` blocks of equal width, and splits within each head (module
    docstring): rank r of tp takes every head's r-th ``width / heads /
    tp`` columns; None splits it contiguously."""

    heads: int | None
    lead: int

    def __new__(cls, axis: int, heads: int | None = None, lead: int = 0):
        out = super().__new__(cls, axis)
        out.heads, out.lead = heads, lead
        return out

    def __repr__(self) -> str:
        return f"TPAxis({int(self)}, heads={self.heads}, lead={self.lead})"


def stacked(axes, n: int = 1):
    """``axes`` (a layer's axes tree) for that layer stacked ``n`` deep
    inside a bigger one (a unit's ``[n_sub, ...]`` sub-layers): the same
    integers, each split ``n`` axes further in."""
    if isinstance(axes, dict):
        return {k: stacked(v, n) for k, v in axes.items()}
    if axes is None:
        return None
    return TPAxis(int(axes), getattr(axes, "heads", None),
                  getattr(axes, "lead", 0) + n)


def _at(ax, shift: int) -> int:
    """The index of a sharded axis in a leaf with ``shift`` more leading
    axes (a group's ``[L, ...]``)."""
    return int(ax) + getattr(ax, "lead", 0) + shift


def _headwise(t: torch.Tensor, at: int, heads: int) -> torch.Tensor:
    """``t`` with axis ``at`` viewed as ``[heads, width / heads]``."""
    return t.unflatten(at, (heads, t.shape[at] // heads))


def _shard(t: torch.Tensor, ax, tp: int, rank: int,
           shift: int = 0) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along its sharded axis (``ax``,
    with ``shift`` more leading axes): a head-major axis's r-th part of
    every head; otherwise ``ceil(n / tp)`` entries, the last rank's
    zero-padded where tp does not divide n (the vocab-parallel tables:
    ``init_embedding``'s ``ceil(vocab / tp)`` rows)."""
    at = _at(ax, shift)
    if getattr(ax, "heads", None):
        h = _headwise(t, at, ax.heads)
        m = h.shape[at + 1] // tp
        return h.narrow(at + 1, rank * m, m).flatten(at, at + 1)
    n = t.shape[at]
    m = -(-n // tp)
    part = t.narrow(at, min(rank * m, n), max(0, min(m, n - rank * m)))
    if part.shape[at] == m:
        return part
    shape = list(t.shape)
    shape[at] = m - part.shape[at]
    return torch.cat([part, t.new_zeros(shape)], dim=at)


def join_ranks(parts: list, ax, shift: int = 0) -> torch.Tensor:
    """The inverse of :func:`split_for_tp` for one leaf: the ranks'
    shards (in rank order) -> the global tensor (a padded vocab keeps its
    padding rows)."""
    at = _at(ax, shift)
    if getattr(ax, "heads", None):
        return torch.cat([_headwise(p, at, ax.heads) for p in parts],
                         dim=at + 1).flatten(at, at + 1)
    return torch.cat(list(parts), dim=at)


def split_for_tp(tree: Any, axes: Any, tp: int, rank: int,
                 shift: int = 0) -> Any:
    """Slice a tp=1 param tree into the TP-local shard for ``rank``
    (the reference's ``split_for_tp``; ``shift`` skips leading stacked
    axes, 1 for a group's ``[L, ...]`` leaves).  Replicated leaves
    (axis None) come back as they are."""
    pairs = flatten_with_paths(tree)
    ax = [a for _, a in flatten_with_paths(axes)]
    if len(ax) != len(pairs):
        raise ValueError(f"tp_axes has {len(ax)} leaves, the tree "
                         f"{len(pairs)}")
    return unflatten([p for p, _ in pairs], [
        t if a is None else _shard(t, a, tp, rank, shift)
        for (_, t), a in zip(pairs, ax)])


def infer_tp_axes(global_specs: Any, local_specs: Any, tp: int) -> Any:
    """Derive the axes tree by comparing tp=1 and tp=N leaf shapes (the
    reference's rule, and ``ceil(n / tp)`` for a padded vocab).  Shapes
    give the axis as it lies in the leaf, and cannot tell how it splits:
    a :class:`TPAxis` with no ``lead`` comes back as its integer, which it
    equals."""
    def infer(g, loc):
        if tuple(g.shape) == tuple(loc.shape):
            return None
        for rule in (lambda a, b: a == b * tp,
                     lambda a, b: a != b and -(-a // tp) == b):
            for i, (a, b) in enumerate(zip(g.shape, loc.shape)):
                if rule(a, b):
                    return i
        raise ValueError(f"cannot infer tp axis: {tuple(g.shape)} vs "
                         f"{tuple(loc.shape)}")

    gp = flatten_with_paths(global_specs)
    lp = flatten_with_paths(local_specs)
    return unflatten([p for p, _ in gp],
                     [infer(g, loc) for (_, g), (_, loc) in zip(gp, lp)])


def replicated_ranges(layout, axes) -> list[tuple[int, int]]:
    """(offset, numel) in the flat chunk vector of every replicated leaf
    (axis None) of ``layout``'s tree."""
    ax = [a for _, a in flatten_with_paths(axes)]
    if len(ax) != len(layout.names):
        raise ValueError(f"tp_axes has {len(ax)} leaves, the layout "
                         f"{len(layout.names)}")
    out = []
    for name, shape, a in zip(layout.names, layout.shapes, ax):
        if a is None:
            n = 1
            for d in shape:
                n *= d
            out.append((layout.flat_offset(name), n))
    return out


def sync_replicated_grads(grads: list, ranges) -> None:
    """Write rank 0's gradient of every replicated leaf (autograd's sum of
    every rank's branch) into the other ranks' gradient chunks, in place.
    ``grads``: the ranks' gradient stores of one layer (or the stem),
    ``[G, p, S]`` each, in chunk-id order."""
    if len(grads) == 1:
        return
    src = grads[0].reshape(-1)
    for g in grads[1:]:
        dst = g.view(-1)
        for off, n in ranges:
            dst[off:off + n].copy_(src[off:off + n])


def ranks_tree(trees: list):
    """The tp ranks' trees of one structure (a layer's per-rank caches)
    -> one tree whose every leaf is a :class:`Ranks`; one tree is
    returned as it is."""
    if len(trees) == 1:
        return trees[0]
    pairs = [flatten_with_paths(t) for t in trees]
    return unflatten([p for p, _ in pairs[0]],
                     [Ranks(p[i][1] for p in pairs)
                      for i in range(len(pairs[0]))])


def rank_of(x, rank: int):
    """Rank ``rank``'s value of a per-rank quantity: element ``rank`` of a
    :class:`Ranks`, else ``x`` itself (one rank, or a value every rank
    shares; rank 0's copy of a replicated cache leaf is every rank's)."""
    return x[rank] if isinstance(x, Ranks) else x


def replicate(x, tp: int):
    """``x`` as every one of ``tp`` ranks holds it (a replicated cache
    leaf, which the runtime stores once a rank): a :class:`Ranks` of
    ``x`` repeated, ``x`` itself at tp=1."""
    return Ranks.of([x] * tp)
