"""Phi-3-vision backbone of the port (``repro.models.vlm`` twin): the
phi-3-mini language decoder consuming stub patch embeddings.

The ViT/CLIP encoder is a stub, as in the reference: the batch supplies
precomputed patch embeddings ``[B, num_patches, vision_dim]``; the stem
projects them to d_model (a 2-layer projector with a tanh-approximate
GELU between, ``jax.nn.gelu``'s default) and puts them ahead of the token
embeddings.  The decoder layers are the dense family's: attention runs
causally over ``[patches; tokens]`` with RoPE positions ``0 .. P+T-1``,
so on a CUDA tensor every layer's attention runs K2 at head dim 96.  The
loss is taken on the text positions only.

Decode is the dense family's: the cache holds every position, patches
included, so a decode step after a prefill of P patches and T tokens
writes position P + T.  Tensor parallelism is the dense family's; the
projector is replicated.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import VLMConfig
from repro_torch.models import layers as L
from repro_torch.models.api import masked_mean_loss
from repro_torch.models.transformer import (
    TransformerLM,
    _stem_tp_axes,
    decoder_layer_tp_axes,
)


class VLMBackbone(TransformerLM):
    cfg: VLMConfig

    def init_stem(self, gen) -> dict:
        stem = super().init_stem(gen)
        cfg = self.cfg
        stem["projector"] = {
            "w1": L.dense_init(gen, (cfg.vision_dim, cfg.d_model),
                               dtype=self.dtype),
            "w2": L.dense_init(gen, (cfg.d_model, cfg.d_model),
                               dtype=self.dtype),
        }
        return stem

    def embed(self, stem, batch):
        cfg = self.cfg
        cdtype = self.compute_dtype
        patches = batch["patch_embeds"].to(cdtype)  # [B, P, vision_dim]
        vis = L.matmul(patches, stem["projector"]["w1"])
        vis = L.matmul(L.ACTIVATIONS["gelu"](vis), stem["projector"]["w2"])
        tok = L.embed_lookup(stem["embed"], batch["tokens"], cfg.vocab_size,
                             self.ctx).to(cdtype)
        return torch.cat([vis.to(cdtype), tok], dim=1), None

    def head_loss(self, stem, x, batch):
        """Final norm, tied head and the mean loss over the text positions
        (``x[:, num_patches:]``).  Always the full logits: the reference's
        VLM head does not take the dense family's blockwise ``xent_block``
        path (``repro.models.vlm``), so neither does the port's."""
        cfg = self.cfg
        x = x[:, batch["patch_embeds"].shape[1]:]
        x = self._final_norm(stem, x)
        table = stem["embed"] if cfg.tie_embeddings else stem["unembed"]
        logits = L.lm_logits_local(table, x, self.ctx)
        per_tok = L.vocab_parallel_xent(logits, batch["labels"],
                                        cfg.vocab_size, self.ctx,
                                        mask=batch.get("mask"))
        return masked_mean_loss(per_tok, None, batch["global_tokens"])

    def tp_axes(self) -> dict:
        stem = _stem_tp_axes(self.cfg)
        stem["projector"] = {"w1": None, "w2": None}
        return {"stem": stem,
                "groups": {"layers": decoder_layer_tp_axes(self.cfg,
                                                           self.ctx.tp)}}
