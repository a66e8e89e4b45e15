"""Zamba2-style hybrid of the port (``repro.models.zamba`` twin,
arXiv:2411.15242): a Mamba2 backbone with ONE globally shared
attention + MLP block applied every ``shared_interval`` layers.

The shared block's weights live in the STEM, so several operators read
the same tensors (the paper's shared parameters, Section 6.2).  It runs
on ``concat(hidden, original embedding)`` (2 x d_model wide, as in Zamba)
and each unit owns a projection back to d_model.  A unit's mamba layers
are stacked on a leading axis (``[shared_interval, ...]``, the
reference's ``jax.vmap`` init) and applied in a loop (its
``jax.lax.scan``); the layers left over form a ``tail`` group.

Extras are ``{"shared_attn": the stem's block, "x0": the embedding
output}``, so the gradient of the loss reaches the stem through them: the
eager trainer differentiates them (``core/engine.py``), the chunked
runtime's autograd sees them as it sees everything else.

Caches: a unit's is the shared block's k/v ``[B, C, KV, hd]`` beside its
mamba layers' state and conv tails ``[shared_interval, B, ...]`` (the
batch axis second); the tail's ``[B, ...]``.  A decode with one position
a row (a tensor ``pos``: the compiled round's slots) writes every leaf
in place, as ``layers.attention_decode`` does.

At tp > 1 (the reference's layouts): the shared block's attention and
MLP shard as a dense layer's (its kv heads divide tp, so each rank caches
its own: the "tp" plan), the mamba layers as ``ssm`` sets out, and
``w_proj``, the norms and the embedding output ``x0`` are replicated.
Every cache leaf is then a ``Ranks`` of the model ranks' values.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import HybridConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.api import BlockGroup, _stack, tree_map, write_cache
from repro_torch.models.tp import stacked
from repro_torch.models.transformer import (
    TransformerLM,
    _stem_tp_axes,
    decoder_layer_tp_axes,
)


def _shared_cfg(cfg: HybridConfig):
    """The shared attention block operates at 2 x d_model width."""
    return cfg.replace(d_model=2 * cfg.d_model, d_ff=cfg.d_ff,
                       sliding_window=None)


class ZambaLM(TransformerLM):
    cfg: HybridConfig

    # ------------------------------------------------------------------ stem
    def init_stem(self, gen) -> dict:
        stem = super().init_stem(gen)
        scfg = _shared_cfg(self.cfg)
        stem["shared_attn"] = {
            "attn": L.init_attention(gen, scfg, self.ctx.tp, self.dtype),
            "mlp": L.init_mlp(gen, scfg, self.ctx.tp, self.dtype),
            "norm_attn": torch.ones((scfg.d_model,), dtype=self.dtype),
            "norm_mlp": torch.ones((scfg.d_model,), dtype=self.dtype),
        }
        return stem

    # ------------------------------------------------------------------ unit
    def _mamba_layer(self, gen) -> dict:
        return {"norm": torch.ones((self.cfg.d_model,), dtype=self.dtype),
                "cell": S.init_mamba2(gen, self.cfg, self.ctx.tp,
                                      self.dtype)}

    def _init_unit(self, gen) -> dict:
        cfg = self.cfg
        return {
            "mamba": _stack([self._mamba_layer(gen)
                             for _ in range(cfg.shared_interval)]),
            # per-unit projection of the shared block's 2d output back to d
            "w_proj": L.dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                   dtype=self.dtype),
        }

    def _shared_block(self, sp, x2, ctx, *, mode, cache=None, pos=None):
        """x2: [B, S, 2d] -> (out [B, S, 2d], the attention cache)."""
        scfg = _shared_cfg(self.cfg)
        h = L.rms_norm(x2, sp["norm_attn"])
        new_cache = None
        if mode == "train":
            a = L.attention_fwd(sp["attn"], h, scfg, ctx)
        elif mode == "prefill":
            a, new_cache = L.attention_prefill(sp["attn"], h, scfg, ctx)
        else:
            a, new_cache = L.attention_decode(sp["attn"], h, cache, pos,
                                              scfg, ctx)
        x2 = x2 + a
        h = L.rms_norm(x2, sp["norm_mlp"])
        return x2 + L.mlp_fwd(sp["mlp"], h, scfg, ctx), new_cache

    def _apply_unit(self, p, x, extras, ctx, *, mode, cache=None, pos=None):
        cfg = self.cfg
        # the shared block first (Zamba puts attention between the groups)
        x2 = torch.cat([x, extras["x0"]], dim=-1)
        x2, attn_cache = self._shared_block(
            extras["shared_attn"], x2, ctx, mode=mode,
            cache=cache["attn"] if mode == "decode" else None, pos=pos)
        # w_proj is replicated (no psum): the reference's fp32 product is
        # rounded to x's dtype at once
        x = x + L.matmul(x2, p["w_proj"], x.dtype)
        states = []
        for j in range(cfg.shared_interval):
            mp = tree_map(lambda t, _j=j: t[_j], p["mamba"])
            h = L.rms_norm(x, mp["norm"])
            if mode == "decode":
                mc = tree_map(lambda t, _j=j: t[_j], cache["mamba"])
                y, mc2 = S.mamba2_decode(mp["cell"], h, mc, cfg, ctx)
                states.append(write_cache(mc, mc2) if isinstance(
                    pos, torch.Tensor) else mc2)
            else:
                y, (state, convs) = S.mamba2_fwd(mp["cell"], h, cfg, ctx)
                if mode == "prefill":
                    states.append(S.mamba2_cache(state, convs, ctx.tp))
            x = x + y
        if mode == "train":
            return x, 0.0
        if mode == "decode" and isinstance(pos, torch.Tensor):
            return x, cache  # every leaf was written in place
        return x, {"attn": attn_cache, "mamba": _stack(states)}

    # --------------------------------------------------------------- plumbing
    def embed(self, stem, batch):
        x, _ = super().embed(stem, batch)
        return x, {"shared_attn": stem["shared_attn"], "x0": x}

    def decode_extras(self, stem, x):
        return {"shared_attn": stem["shared_attn"], "x0": x}

    def _unit_init_cache(self, batch, max_len, device=None):
        cfg = self.cfg
        mc = S.mamba2_init_cache(cfg, batch, self.ctx.tp, self.compute_dtype,
                                 device=device)
        return {
            "attn": L.attention_init_cache(_shared_cfg(cfg), batch, max_len,
                                           self.ctx.tp, self.compute_dtype,
                                           device=device),
            "mamba": tree_map(lambda t: torch.zeros(
                (cfg.shared_interval,) + tuple(t.shape), dtype=t.dtype,
                device=t.device), mc),
        }

    # ----------------------------------------------------- tail mamba layers
    def _tail_apply(self, p, x, extras, ctx):
        h = L.rms_norm(x, p["norm"])
        y, _ = S.mamba2_fwd(p["cell"], h, self.cfg, ctx)
        return x + y, 0.0

    def _tail_prefill(self, p, x, extras, ctx):
        h = L.rms_norm(x, p["norm"])
        y, (state, convs) = S.mamba2_fwd(p["cell"], h, self.cfg, ctx)
        return x + y, S.mamba2_cache(state, convs, ctx.tp)

    def _tail_decode(self, p, x, cache, pos, extras, ctx):
        h = L.rms_norm(x, p["norm"])
        y, c2 = S.mamba2_decode(p["cell"], h, cache, self.cfg, ctx)
        if isinstance(pos, torch.Tensor):
            c2 = write_cache(cache, c2)
        return x + y, c2

    def groups(self) -> list[BlockGroup]:
        cfg = self.cfg
        out = [BlockGroup(
            name="units",
            length=cfg.num_units,
            init_layer=self._init_unit,
            apply=lambda p, x, e, ctx: self._apply_unit(p, x, e, ctx,
                                                        mode="train"),
            init_cache=self._unit_init_cache,
            prefill=lambda p, x, e, ctx: self._apply_unit(p, x, e, ctx,
                                                          mode="prefill"),
            decode=lambda p, x, c, pos, e, ctx: self._apply_unit(
                p, x, e, ctx, mode="decode", cache=c, pos=pos),
        )]
        if cfg.tail_layers:
            out.append(BlockGroup(
                name="tail",
                length=cfg.tail_layers,
                init_layer=self._mamba_layer,
                apply=self._tail_apply,
                init_cache=lambda b, m, device=None: S.mamba2_init_cache(
                    cfg, b, self.ctx.tp, self.compute_dtype, device=device),
                prefill=self._tail_prefill,
                decode=self._tail_decode,
            ))
        return out

    def tp_axes(self) -> dict:
        cfg, tp = self.cfg, self.ctx.tp
        block = decoder_layer_tp_axes(_shared_cfg(cfg), tp)
        stem = _stem_tp_axes(cfg)
        stem["shared_attn"] = {"attn": block["attn"], "mlp": block["mlp"],
                               "norm_attn": None, "norm_mlp": None}
        cell = {"norm": None, "cell": S.mamba2_tp_axes()}
        # a unit's mamba layers are stacked [shared_interval, ...]
        groups = {"units": {"mamba": stacked(cell), "w_proj": None}}
        if cfg.tail_layers:
            groups["tail"] = cell
        return {"stem": stem, "groups": groups}
