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
from typing import Any, Callable

import torch

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
    """Apply ``fn`` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    # decode(params, x, cache, pos, extras, ctx) -> (x, cache)
    decode: Callable[..., tuple[torch.Tensor, Any]] | None = None


class Model:
    """Base class; concrete architectures override the hooks below."""

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

    # ------------------------------------------------------------- serving
    def embed_decode(self, stem: Any, token, pos: int, extras: Any):
        """Embed a single decode token -> [B,1,d]."""
        raise NotImplementedError

    def head_logits(self, stem: Any, x):
        """-> vocab logits (fp32)."""
        raise NotImplementedError

    def decode_extras(self, stem: Any, x) -> Any:
        """extras for decode-time group applies (default: none)."""
        return None

    # ------------------------------------------------------------ metadata
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


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return torch.stack(layers)
