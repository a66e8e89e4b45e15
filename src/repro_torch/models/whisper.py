"""Whisper-large-v3 backbone of the port (``repro.models.whisper`` twin,
arXiv:2212.04356).

Encoder-decoder.  The mel-spectrogram and conv frontend are a stub, as in
the reference: the batch supplies precomputed frame embeddings
``[B, frames, frontend_dim]``; the stem projects them to d_model and adds
learned positions.  Encoder layers are bidirectional self-attention with
RoPE (as the reference applies it); decoder layers are causal
self-attention, then cross-attention over the encoder output, then the
MLP.  LayerNorm and GELU as in Whisper.  Every attention goes through
:func:`repro_torch.models.layers.attention_core`, so a CUDA tensor runs
K2.

Two block groups, ``encoder`` and ``decoder``.  :meth:`between_groups`
before the decoder is not the identity: the encoder's output leaves the
residual stream (normed, it becomes ``extras["enc_out"]``, which every
decoder layer reads through its cross-attention), and the stream
restarts from the token embedding.  :attr:`boundaries` names that group,
so the eager trainer checkpoints the encoder's output and differentiates
the boundary (``core/engine.py``).

Decode: the decoder's cache is its self-attention k/v ``[B, C, KV, hd]``
beside a fixed cross cache ``[B, encoder_frames, KV, hd]`` that prefill
fills once; the encoder has no decode (the serving steps skip it).

Tensor parallelism is the reference's: every attention (the
cross-attention too, whose cache is each rank's own heads of the encoder
k/v) and MLP shards as the dense family's; the frontend projection, the
encoder positions and the norms are replicated.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import EncDecConfig, dtype_of
from repro_torch.models import layers as L
from repro_torch.models.api import BlockGroup, Model, masked_mean_loss
from repro_torch.models.layers import AxisCtx
from repro_torch.models.tp import rank_view, ranks_tree


def _ln(p, name, x):
    return L.layer_norm(x, p[name], p[name + "_b"])


def _ln_params(d, dtype):
    return (torch.ones((d,), dtype=dtype), torch.zeros((d,), dtype=dtype))


def cross_attention_fwd(p, x, enc_kv, cfg, ctx: AxisCtx):
    """x: [B, Sq, d] queries; enc_kv: precomputed {"k", "v"} [B, F, KV,
    hd] (each rank's own kv heads at tp > 1).  Unmasked: every query sees
    every frame.  Each rank attends over its heads, then the out
    projections psum (none where the block is replicated)."""
    b, sq, _ = x.shape
    n = 1 if L._gqa(cfg, ctx.tp)[2] else ctx.tp
    # one rank: the reference's fp32 product is rounded to x's dtype at once
    out_dtype = x.dtype if n == 1 else torch.float32
    ys = []
    for r in range(n):
        pr, kv = rank_view(p, r), rank_view(enc_kv, r)
        q = L.matmul(x, pr["wq"]).reshape(b, sq, -1, cfg.head_dim)
        k, v = L._align_kv(kv["k"], kv["v"], cfg, ctx, r)
        out = L.attention_core(q, k, v, ctx, causal=False)
        ys.append(L.matmul(out.reshape(b, sq, -1), pr["wo"], out_dtype))
    return ctx.psum_model(ys).to(x.dtype)


def cross_kv(p, enc_out, cfg, ctx: AxisCtx):
    """The cross-attention's k/v of the encoder output [B, F, d], each
    rank's from its own wk/wv."""
    b, f, _ = enc_out.shape
    n = 1 if L._gqa(cfg, ctx.tp)[2] else ctx.tp
    kvs = []
    for r in range(n):
        pr = rank_view(p, r)
        kvs.append({
            "k": L.matmul(enc_out, pr["wk"]).reshape(b, f, -1, cfg.head_dim),
            "v": L.matmul(enc_out, pr["wv"]).reshape(b, f, -1, cfg.head_dim)})
    return ranks_tree(kvs * (ctx.tp // n))


class WhisperBackbone(Model):
    cfg: EncDecConfig
    boundaries = ("decoder",)

    def __init__(self, cfg: EncDecConfig, ctx: AxisCtx):
        super().__init__(cfg, ctx)
        self.dtype = dtype_of(cfg.param_dtype)
        self.compute_dtype = dtype_of(cfg.compute_dtype)

    # ------------------------------------------------------------------ stem
    def init_stem(self, gen) -> dict:
        cfg = self.cfg
        w, b = _ln_params(cfg.d_model, self.dtype)
        w2, b2 = _ln_params(cfg.d_model, self.dtype)
        return {
            "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      self.ctx.tp, self.dtype),
            # stub frontend projection: frame embeddings -> d_model
            "frontend_proj": L.dense_init(gen, (cfg.frontend_dim,
                                                cfg.d_model),
                                          dtype=self.dtype),
            "enc_pos": (torch.randn((cfg.encoder_frames, cfg.d_model),
                                    generator=gen) * 0.01).to(self.dtype),
            "enc_norm": w, "enc_norm_b": b,
            "final_norm": w2, "final_norm_b": b2,
        }

    # ---------------------------------------------------------------- layers
    def _init_enc_layer(self, gen) -> dict:
        cfg = self.cfg
        na, nab = _ln_params(cfg.d_model, self.dtype)
        nm, nmb = _ln_params(cfg.d_model, self.dtype)
        return {"attn": L.init_attention(gen, cfg, self.ctx.tp, self.dtype),
                "mlp": L.init_mlp(gen, cfg, self.ctx.tp, self.dtype),
                "norm_attn": na, "norm_attn_b": nab,
                "norm_mlp": nm, "norm_mlp_b": nmb}

    def _enc_apply(self, p, x, extras, ctx):
        cfg = self.cfg
        h = _ln(p, "norm_attn", x)
        x = x + L.attention_fwd(p["attn"], h, cfg, ctx, causal=False)
        h = _ln(p, "norm_mlp", x)
        return x + L.mlp_fwd(p["mlp"], h, cfg, ctx), 0.0

    def _init_dec_layer(self, gen) -> dict:
        p = self._init_enc_layer(gen)
        p["cross"] = L.init_attention(gen, self.cfg, self.ctx.tp, self.dtype)
        p["norm_cross"], p["norm_cross_b"] = _ln_params(self.cfg.d_model,
                                                        self.dtype)
        return p

    def _cross(self, p, x, enc_kv, ctx):
        h = _ln(p, "norm_cross", x)
        x = x + cross_attention_fwd(p["cross"], h, enc_kv, self.cfg, ctx)
        h = _ln(p, "norm_mlp", x)
        return x + L.mlp_fwd(p["mlp"], h, self.cfg, ctx)

    def _dec_apply(self, p, x, extras, ctx):
        h = _ln(p, "norm_attn", x)
        x = x + L.attention_fwd(p["attn"], h, self.cfg, ctx, causal=True)
        enc_kv = cross_kv(p["cross"], extras["enc_out"], self.cfg, ctx)
        return self._cross(p, x, enc_kv, ctx), 0.0

    def _dec_prefill(self, p, x, extras, ctx):
        h = _ln(p, "norm_attn", x)
        a, cache = L.attention_prefill(p["attn"], h, self.cfg, ctx)
        enc_kv = cross_kv(p["cross"], extras["enc_out"], self.cfg, ctx)
        return self._cross(p, x + a, enc_kv, ctx), {"self": cache,
                                                     "cross": enc_kv}

    def _dec_decode(self, p, x, cache, pos, extras, ctx):
        """One token; ``pos`` as :func:`~repro_torch.models.layers.
        attention_decode` takes it.  The cross cache is read, never
        written."""
        h = _ln(p, "norm_attn", x)
        a, self_cache = L.attention_decode(p["attn"], h, cache["self"], pos,
                                           self.cfg, ctx)
        return self._cross(p, x + a, cache["cross"], ctx), {
            "self": self_cache, "cross": cache["cross"]}

    def _dec_init_cache(self, batch, max_len, device=None):
        cfg = self.cfg
        shape = (batch, cfg.encoder_frames, L._gqa(cfg, self.ctx.tp)[1],
                 cfg.head_dim)
        return {
            "self": L.attention_init_cache(cfg, batch, max_len, self.ctx.tp,
                                           self.compute_dtype,
                                           device=device),
            "cross": {key: torch.zeros(shape, dtype=self.compute_dtype,
                                       device=device) for key in ("k", "v")},
        }

    def groups(self) -> list[BlockGroup]:
        cfg = self.cfg
        return [
            BlockGroup(name="encoder", length=cfg.num_encoder_layers,
                       init_layer=self._init_enc_layer, apply=self._enc_apply),
            BlockGroup(name="decoder", length=cfg.num_layers,
                       init_layer=self._init_dec_layer, apply=self._dec_apply,
                       init_cache=self._dec_init_cache,
                       prefill=self._dec_prefill, decode=self._dec_decode),
        ]

    # --------------------------------------------------------------- forward
    def embed(self, stem, batch):
        frames = batch["frames"].to(self.compute_dtype)  # [B, F, frontend]
        x = L.matmul(frames, stem["frontend_proj"])
        x = x + stem["enc_pos"][None, :x.shape[1]].to(self.compute_dtype)
        return x.to(self.compute_dtype), {"tokens": batch["tokens"]}

    def between_groups(self, name, x, extras, stem, batch):
        if name == "decoder":
            # the encoder is done: x is its output; the stream restarts
            # from the tokens
            enc_out = L.layer_norm(x, stem["enc_norm"], stem["enc_norm_b"])
            tok = L.embed_lookup(stem["embed"], batch["tokens"],
                                 self.cfg.vocab_size, self.ctx)
            return tok.to(self.compute_dtype), {"enc_out": enc_out}
        return x, extras

    def head_loss(self, stem, x, batch):
        x = L.layer_norm(x, stem["final_norm"], stem["final_norm_b"])
        logits = L.lm_logits_local(stem["embed"], x, self.ctx)
        per_tok = L.vocab_parallel_xent(logits, batch["labels"],
                                        self.cfg.vocab_size, self.ctx,
                                        mask=batch.get("mask"))
        return masked_mean_loss(per_tok, None, batch["global_tokens"])

    # --------------------------------------------------------------- serving
    def embed_decode(self, stem, token, pos, extras):
        x = L.embed_lookup(stem["embed"], token, self.cfg.vocab_size,
                           self.ctx)
        return x.to(self.compute_dtype)

    def head_logits(self, stem, x):
        x = L.layer_norm(x, stem["final_norm"], stem["final_norm_b"])
        return L.lm_logits_local(stem["embed"], x, self.ctx)

    def tp_axes(self) -> dict:
        cfg, tp = self.cfg, self.ctx.tp
        enc = {"attn": L.attention_tp_axes(cfg, tp),
               "mlp": L.mlp_tp_axes(cfg),
               "norm_attn": None, "norm_attn_b": None,
               "norm_mlp": None, "norm_mlp_b": None}
        dec = dict(enc, cross=L.attention_tp_axes(cfg, tp), norm_cross=None,
                   norm_cross_b=None)
        stem = {"embed": L.embedding_tp_axes(), "frontend_proj": None,
                "enc_pos": None, "enc_norm": None, "enc_norm_b": None,
                "final_norm": None, "final_norm_b": None}
        return {"stem": stem, "groups": {"encoder": enc, "decoder": dec}}
