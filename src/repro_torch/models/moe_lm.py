"""MoE language model of the port (``repro.models.moe_lm`` twin):
mixtral-8x7b — RMSNorm, RoPE GQA attention (with the config's sliding
window), a routed expert FFN in every layer, tied embedding; optional
leading dense layers (deepseek-v2 style).  MLA attention is not ported:
:func:`repro_torch.configs.model_class` refuses an MLA config.

``apply`` returns ``(x, aux)``, the router's load-balance loss: the
chunked runtime adds it to the loss, the eager engines drop it, as the
reference's do."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
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
    if getattr(cfg, "use_mla", False):
        raise NotImplementedError("MLA attention is not ported yet")
    return {
        "attn": L.init_attention(gen, cfg, tp, dtype),
        "moe": MOE.init_moe_mlp(gen, cfg, tp, dtype),
        "norm_attn": torch.ones((cfg.d_model,), dtype=dtype),
        "norm_mlp": torch.ones((cfg.d_model,), dtype=dtype),
    }


def moe_layer_fwd(p, x, cfg, ctx: AxisCtx):
    h = L.rms_norm(x, p["norm_attn"])
    x = x + L.attention_fwd(p["attn"], h, cfg, ctx)
    h = L.rms_norm(x, p["norm_mlp"])
    y, aux = MOE.moe_fwd(p["moe"], h, cfg, ctx)
    return x + y, aux


def moe_layer_prefill(p, x, cfg, ctx: AxisCtx):
    h = L.rms_norm(x, p["norm_attn"])
    a, cache = L.attention_prefill(p["attn"], h, cfg, ctx)
    x = x + a
    h = L.rms_norm(x, p["norm_mlp"])
    y, _ = MOE.moe_fwd(p["moe"], h, cfg, ctx)
    return x + y, cache


def moe_layer_decode(p, x, cache, pos, cfg, ctx: AxisCtx):
    """One token through one layer (``pos``: an int, or [B] integers on
    the device; see :func:`~repro_torch.models.layers.attention_decode`)."""
    h = L.rms_norm(x, p["norm_attn"])
    a, cache = L.attention_decode(p["attn"], h, cache, pos, cfg, ctx)
    x = x + a
    h = L.rms_norm(x, p["norm_mlp"])
    y, _ = MOE.moe_fwd(p["moe"], h, cfg, ctx)
    return x + y, cache


def moe_layer_tp_axes(cfg, tp: int = 1) -> dict:
    if tp != 1:
        raise NotImplementedError("only tp=1 is ported")
    attn = decoder_layer_tp_axes(cfg, tp)["attn"]
    return {"attn": attn, "moe": MOE.moe_tp_axes(cfg), "norm_attn": None,
            "norm_mlp": None}


class MoELM(TransformerLM):
    """Decoder-only MoE LM: the dense stem, optional leading dense layers,
    then the MoE layers."""

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
            init_cache=self._layer_init_cache,
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
