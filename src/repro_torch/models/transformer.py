"""Dense decoder-only transformer LM of the port (``repro.models.transformer``
twin): LayerNorm or RMSNorm, RoPE GQA attention with optional qk_norm,
gated or plain MLP, tied embedding — gpt2-paper-1b and qwen3-0.6b."""

from __future__ import annotations

import torch

from repro_torch.configs.base import BaseConfig, dtype_of
from repro_torch.models import layers as L
from repro_torch.models.api import BlockGroup, Model
from repro_torch.models.layers import AxisCtx


def init_decoder_layer(gen, cfg, tp: int, dtype) -> dict:
    p = {
        "attn": L.init_attention(gen, cfg, tp, dtype),
        "mlp": L.init_mlp(gen, cfg, tp, dtype),
        "norm_attn": torch.ones((cfg.d_model,), dtype=dtype),
        "norm_mlp": torch.ones((cfg.d_model,), dtype=dtype),
    }
    if cfg.norm != "rms":
        p["norm_attn_b"] = torch.zeros((cfg.d_model,), dtype=dtype)
        p["norm_mlp_b"] = torch.zeros((cfg.d_model,), dtype=dtype)
    return p


def _norm(p, prefix, x, cfg):
    if cfg.norm == "rms":
        return L.rms_norm(x, p[prefix])
    return L.layer_norm(x, p[prefix], p[prefix + "_b"])


def decoder_layer_fwd(p, x, cfg, ctx: AxisCtx, *, positions=None):
    h = _norm(p, "norm_attn", x, cfg)
    x = x + L.attention_fwd(p["attn"], h, cfg, ctx, positions=positions)
    h = _norm(p, "norm_mlp", x, cfg)
    return x + L.mlp_fwd(p["mlp"], h, cfg, ctx)


def decoder_layer_prefill(p, x, cfg, ctx: AxisCtx):
    h = _norm(p, "norm_attn", x, cfg)
    a, cache = L.attention_prefill(p["attn"], h, cfg, ctx)
    x = x + a
    h = _norm(p, "norm_mlp", x, cfg)
    return x + L.mlp_fwd(p["mlp"], h, cfg, ctx), cache


def decoder_layer_decode(p, x, cache, pos, cfg, ctx: AxisCtx):
    h = _norm(p, "norm_attn", x, cfg)
    a, cache = L.attention_decode(p["attn"], h, cache, pos, cfg, ctx)
    x = x + a
    h = _norm(p, "norm_mlp", x, cfg)
    return x + L.mlp_fwd(p["mlp"], h, cfg, ctx), cache


class TransformerLM(Model):
    """Dense decoder-only LM implementing the Model protocol."""

    def __init__(self, cfg: BaseConfig, ctx: AxisCtx):
        super().__init__(cfg, ctx)
        self.dtype = dtype_of(cfg.param_dtype)
        self.compute_dtype = dtype_of(cfg.compute_dtype)

    # ------------------------------------------------------------------ stem
    def init_stem(self, gen) -> dict:
        cfg = self.cfg
        stem = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                          self.ctx.tp, self.dtype),
                "final_norm": torch.ones((cfg.d_model,), dtype=self.dtype)}
        if cfg.norm == "ln":
            stem["final_norm_b"] = torch.zeros((cfg.d_model,),
                                               dtype=self.dtype)
        if not cfg.tie_embeddings:
            stem["unembed"] = L.init_embedding(gen, cfg.vocab_size,
                                               cfg.d_model, self.ctx.tp,
                                               self.dtype)
        return stem

    # ---------------------------------------------------------------- groups
    def _layer_init(self, gen):
        return init_decoder_layer(gen, self.cfg, self.ctx.tp, self.dtype)

    def _layer_apply(self, p, x, extras, ctx):
        # apply returns (x, aux-loss); dense layers have no aux loss
        return decoder_layer_fwd(p, x, self.cfg, ctx), 0.0

    def _layer_prefill(self, p, x, extras, ctx):
        return decoder_layer_prefill(p, x, self.cfg, ctx)

    def _layer_decode(self, p, x, cache, pos, extras, ctx):
        return decoder_layer_decode(p, x, cache, pos, self.cfg, ctx)

    def _layer_init_cache(self, batch, max_len, device=None):
        return L.attention_init_cache(self.cfg, batch, max_len, self.ctx.tp,
                                      self.compute_dtype, device=device)

    def groups(self) -> list[BlockGroup]:
        return [BlockGroup(
            name="layers",
            length=self.cfg.num_layers,
            init_layer=self._layer_init,
            apply=self._layer_apply,
            init_cache=self._layer_init_cache,
            prefill=self._layer_prefill,
            decode=self._layer_decode,
        )]

    # --------------------------------------------------------------- forward
    def embed(self, stem, batch):
        x = L.embed_lookup(stem["embed"], batch["tokens"],
                           self.cfg.vocab_size, self.ctx)
        return x.to(self.compute_dtype), None

    def _final_norm(self, stem, x):
        if self.cfg.norm == "rms":
            return L.rms_norm(x, stem["final_norm"])
        return L.layer_norm(x, stem["final_norm"], stem["final_norm_b"])

    # --------------------------------------------------------------- serving
    def embed_decode(self, stem, token, pos, extras):
        x = L.embed_lookup(stem["embed"], token, self.cfg.vocab_size,
                           self.ctx)
        return x.to(self.compute_dtype)

    def head_logits(self, stem, x):
        x = self._final_norm(stem, x)
        table = stem["embed"] if self.cfg.tie_embeddings else stem["unembed"]
        return L.lm_logits_local(table, x, self.ctx)
