"""MoE language models of the port (``repro.models.moe_lm`` twin):
mixtral-8x7b — RMSNorm, RoPE GQA attention (with the config's sliding
window), a routed expert FFN in every layer, tied embedding — and
deepseek-v2-lite — MLA attention (:mod:`repro_torch.models.mla`) in the
MoE layers, shared experts beside the routed ones, and leading dense
layers, which take GQA attention as the reference's do.  The MoE layers'
decode cache is then MLA's latent cache, the dense layers' the usual k/v:
a model with two cache layouts, one per block group.

``apply`` returns ``(x, aux)``, the router's load-balance loss: the
chunked runtime adds it to the loss, the eager engines drop it, as the
reference's do."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.api import BlockGroup
from repro_torch.models.layers import AxisCtx
from repro_torch.models.transformer import (
    TransformerLM,
    decoder_layer_decode,
    decoder_layer_fwd,
    decoder_layer_prefill,
    decoder_layer_tp_axes,
    init_decoder_layer,
    _stem_tp_axes,
)


def init_moe_layer(gen, cfg, tp: int, dtype) -> dict:
    if cfg.use_mla:
        attn = MLA.init_mla(gen, cfg, tp, dtype)
    else:
        attn = L.init_attention(gen, cfg, tp, dtype)
    return {
        "attn": attn,
        "moe": MOE.init_moe_mlp(gen, cfg, tp, dtype),
        "norm_attn": torch.ones((cfg.d_model,), dtype=dtype),
        "norm_mlp": torch.ones((cfg.d_model,), dtype=dtype),
    }


def moe_layer_fwd(p, x, cfg, ctx: AxisCtx):
    h = L.rms_norm(x, p["norm_attn"])
    if cfg.use_mla:
        x = x + MLA.mla_fwd(p["attn"], h, cfg, ctx)
    else:
        x = x + L.attention_fwd(p["attn"], h, cfg, ctx)
    h = L.rms_norm(x, p["norm_mlp"])
    y, aux = MOE.moe_fwd(p["moe"], h, cfg, ctx)
    return x + y, aux


def moe_layer_prefill(p, x, cfg, ctx: AxisCtx):
    h = L.rms_norm(x, p["norm_attn"])
    if cfg.use_mla:
        a, cache = MLA.mla_prefill(p["attn"], h, cfg, ctx)
    else:
        a, cache = L.attention_prefill(p["attn"], h, cfg, ctx)
    x = x + a
    h = L.rms_norm(x, p["norm_mlp"])
    y, _ = MOE.moe_fwd(p["moe"], h, cfg, ctx)
    return x + y, cache


def moe_layer_decode(p, x, cache, pos, cfg, ctx: AxisCtx):
    """One token through one layer (``pos``: an int, or [B] integers on
    the device; see :func:`~repro_torch.models.layers.attention_decode`
    and :func:`~repro_torch.models.mla.mla_decode`)."""
    h = L.rms_norm(x, p["norm_attn"])
    if cfg.use_mla:
        a, cache = MLA.mla_decode(p["attn"], h, cache, pos, cfg, ctx)
    else:
        a, cache = L.attention_decode(p["attn"], h, cache, pos, cfg, ctx)
    x = x + a
    h = L.rms_norm(x, p["norm_mlp"])
    y, _ = MOE.moe_fwd(p["moe"], h, cfg, ctx)
    return x + y, cache


def moe_layer_tp_axes(cfg, tp: int = 1) -> dict:
    attn = MLA.mla_tp_axes() if cfg.use_mla else L.attention_tp_axes(cfg, tp)
    return {"attn": attn, "moe": MOE.moe_tp_axes(cfg), "norm_attn": None,
            "norm_mlp": None}


class MoELM(TransformerLM):
    """Decoder-only MoE LM: the dense stem, optional leading dense layers,
    then the MoE layers (GQA or MLA attention)."""

    def _moe_init_cache(self, batch, max_len, device=None):
        if self.cfg.use_mla:
            return MLA.mla_init_cache(self.cfg, batch, max_len,
                                      self.compute_dtype, self.ctx.tp,
                                      device=device)
        return self._layer_init_cache(batch, max_len, device=device)

    def groups(self) -> list[BlockGroup]:
        cfg, tp = self.cfg, self.ctx.tp
        out = []
        if cfg.first_dense_layers > 0:
            out.append(BlockGroup(
                name="dense_layers",
                length=cfg.first_dense_layers,
                init_layer=lambda g: init_decoder_layer(g, cfg, tp,
                                                        self.dtype),
                apply=lambda p, x, e, ctx: (decoder_layer_fwd(p, x, cfg,
                                                              ctx), 0.0),
                init_cache=self._layer_init_cache,
                prefill=lambda p, x, e, ctx: decoder_layer_prefill(
                    p, x, cfg, ctx),
                decode=lambda p, x, c, pos, e, ctx: decoder_layer_decode(
                    p, x, c, pos, cfg, ctx),
            ))
        out.append(BlockGroup(
            name="moe_layers",
            length=cfg.num_layers - cfg.first_dense_layers,
            init_layer=lambda g: init_moe_layer(g, cfg, tp, self.dtype),
            apply=lambda p, x, e, ctx: moe_layer_fwd(p, x, cfg, ctx),
            init_cache=self._moe_init_cache,
            prefill=lambda p, x, e, ctx: moe_layer_prefill(p, x, cfg, ctx),
            decode=lambda p, x, c, pos, e, ctx: moe_layer_decode(
                p, x, c, pos, cfg, ctx),
        ))
        return out

    def tp_axes(self) -> dict:
        cfg, tp = self.cfg, self.ctx.tp
        groups = {}
        if cfg.first_dense_layers > 0:
            groups["dense_layers"] = decoder_layer_tp_axes(cfg, tp)
        groups["moe_layers"] = moe_layer_tp_axes(cfg, tp)
        return {"stem": _stem_tp_axes(cfg), "groups": groups}
