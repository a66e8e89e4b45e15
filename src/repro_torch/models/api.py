"""Model API of the port: how architectures plug into the chunked runtime.

As in the reference (``repro.models.api``), a model is a **stem**
(embedding / LM head, final norm) plus an ordered list of **block
groups**, each a stack of ``length`` structurally identical layers whose
params are stored stacked ``[L, ...]`` and chunk-managed per layer.
Params are nested dicts of tensors, flattened in JAX's order (dict keys
sorted, :func:`flatten_with_paths`), so both packages lay out chunks byte
for byte alike.  Random numbers come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

import torch

if TYPE_CHECKING:
    from repro_torch.models.layers import AxisCtx


def flatten_with_paths(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(key path, leaf)`` pairs of a nested-dict tree in JAX's
    flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(flatten_with_paths(tree[key], path + (key,)))
        return out
    return [(path, tree)]


def unflatten(paths: list[tuple], leaves: list) -> Any:
    """Inverse of :func:`flatten_with_paths` for nested dicts."""
    if paths == [()]:
        return leaves[0]
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested-dict tree; a tuple (a
    :class:`~repro_torch.models.tp.Ranks`: the model ranks' values of one
    leaf) maps element by element and keeps its type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def write_cache(cache: dict, new: dict) -> dict:
    """Copy each leaf of ``new`` into ``cache``'s (a flat dict of
    tensors, or of the model ranks' tensors) and return ``cache``: the
    per-row decode's in-place update of a recurrent state, which a CUDA
    graph replays."""
    for key, t in new.items():
        dst = cache[key]
        if isinstance(dst, tuple):
            for r, d in enumerate(dst):
                d.copy_(t[r])
        else:
            dst.copy_(t)
    return cache


@dataclasses.dataclass(frozen=True)
class BlockGroup:
    """A stack of identical layers."""

    name: str
    length: int
    # init_layer(generator) -> params dict for ONE layer
    init_layer: Callable[[torch.Generator], Any]
    # apply(params, x, extras, ctx) -> (x, aux loss)   (full sequence)
    apply: Callable[..., tuple[torch.Tensor, Any]]
    # init_cache(batch, max_len, device=None) -> ONE layer's decode cache
    init_cache: Callable[..., Any] | None = None
    # prefill(params, x, extras, ctx) -> (x, cache)
    prefill: Callable[..., tuple[torch.Tensor, Any]] | None = None
    # decode(params, x, cache, pos, extras, ctx) -> (x, cache); pos is an
    # int, or [B] integers on the device (one position a row: the compiled
    # serving round's slots), and the latter updates ``cache`` in place
    decode: Callable[..., tuple[torch.Tensor, Any]] | None = None


class Model:
    """Base class; concrete architectures override the hooks below."""

    # groups before which ``between_groups`` is not the identity (whisper's
    # decoder): the eager trainer differentiates the hook there
    boundaries: tuple[str, ...] = ()

    def __init__(self, cfg: Any, ctx: AxisCtx):
        self.cfg = cfg
        self.ctx = ctx

    # ----------------------------------------------------------- structure
    def init_stem(self, gen: torch.Generator) -> Any:
        raise NotImplementedError

    def groups(self) -> list[BlockGroup]:
        raise NotImplementedError

    # ------------------------------------------------------------- forward
    def embed(self, stem: Any, batch: dict) -> tuple[torch.Tensor, Any]:
        """-> (x [B,S,d], extras)."""
        raise NotImplementedError

    def between_groups(self, name: str, x, extras, stem, batch):
        """Hook run before group ``name``."""
        return x, extras

    # ------------------------------------------------------------ training
    def head_loss(self, stem: Any, x, batch: dict):
        """Final norm + LM head + loss -> scalar (fp32)."""
        raise NotImplementedError

    # ------------------------------------------------------------- serving
    def embed_decode(self, stem: Any, token, pos, extras: Any):
        """Embed a single decode token -> [B,1,d] (``pos``: an int or [B]
        integers on the device, as ``BlockGroup.decode`` takes it)."""
        raise NotImplementedError

    def head_logits(self, stem: Any, x):
        """-> vocab logits (fp32)."""
        raise NotImplementedError

    def decode_extras(self, stem: Any, x) -> Any:
        """extras for decode-time group applies (default: none)."""
        return None

    # ------------------------------------------------------------ metadata
    @property
    def supports_decode(self) -> bool:
        # encoder-style groups (no cache) are skipped at decode time; the
        # model decodes iff at least one group has a decode step
        return any(g.decode is not None for g in self.groups())

    def init_params(self, gen: torch.Generator) -> dict:
        """Full param tree on the CPU, drawn from ``gen``:
        ``{"stem": ..., "groups": {name: stacked [L, ...] params}}``."""
        params = {"stem": self.init_stem(gen)}
        groups = {}
        for g in self.groups():
            layers = [g.init_layer(gen) for _ in range(g.length)]
            groups[g.name] = _stack(layers)
        params["groups"] = groups
        return params

    def param_specs(self) -> dict:
        """The param tree's shapes and dtypes, allocating nothing: the
        tree of :meth:`init_params` as meta tensors."""
        with torch.device("meta"):
            return self.init_params(torch.Generator())

    def tp_axes(self) -> dict:
        """Which axis of each param the model axis shards (None =
        replicated), as the reference's ``tp_axes``."""
        raise NotImplementedError


def masked_mean_loss(per_tok_loss, mask, global_tokens):
    """Local loss sum scaled by the GLOBAL token count (the reference's
    ``masked_mean_loss``: with data parallelism the sum over ranks is the
    global mean, and grads need no later divide)."""
    if mask is not None:
        per_tok_loss = per_tok_loss * mask
    return torch.sum(per_tok_loss) / global_tokens


def _stack(layers: list) -> Any:
    """Layers' trees (one structure) stacked leaf by leaf on a new leading
    axis; a tuple leaf (the model ranks' values) stacks rank by rank."""
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    if isinstance(layers[0], tuple):
        return type(layers[0])(_stack(list(col)) for col in zip(*layers))
    return torch.stack(layers)
