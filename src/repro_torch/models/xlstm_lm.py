"""xLSTM language model of the port (``repro.models.xlstm_lm`` twin,
arXiv:2405.04517): mLSTM blocks with interleaved sLSTM blocks at ratio
``mlstm_per_unit : slstm_per_unit`` (xLSTM[7:1] for xlstm-1.3b).

One block group, ``units``: a unit's params hold its mLSTM layers
stacked on a leading axis (``[mlstm_per_unit, ...]``, the reference's
``jax.vmap`` init), applied in a loop (its ``jax.lax.scan``), then one
sLSTM block, so every unit has one chunk layout.  The stem is the dense
model's (tied embedding, final RMSNorm); there is no attention, so no
layer reaches K2.

Caches carry no position axis: a unit's is ``{"mlstm": {"S", "n", "m"}
stacked [mlstm_per_unit, B, ...], "slstm": {"c", "n", "h", "m"} [B, nh,
dh]}``, all fp32 (the reference's tuples, named).  A decode with one
position a row (a tensor ``pos``: the compiled round's slots) writes
every leaf in place, as ``layers.attention_decode`` does.

At tp > 1 the mLSTM layers shard their value channels and the sLSTM is
replicated (``ssm`` sets out how); every cache leaf is a ``Ranks`` of
the model ranks' values, S each rank's own columns, the rest every
rank's copy.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.api import BlockGroup, _stack, tree_map, write_cache
from repro_torch.models.tp import stacked
from repro_torch.models.transformer import TransformerLM, _stem_tp_axes


def _mlstm_block(p, x, cfg, ctx, carry=None):
    h = L.rms_norm(x, p["norm"])
    y, carry = S.mlstm_fwd(p["cell"], h, cfg, ctx, carry=carry)
    return x + y, carry


def _slstm_block(p, x, cfg, ctx, state=None):
    h = L.rms_norm(x, p["norm"])
    y, state = S.slstm_fwd(p["cell"], h, cfg, ctx, state=state)
    # slstm_fwd adds its own residual and FFN; the same expression as the
    # reference's, in its order (bf16 rounds it)
    return x + (y - h), state


class XLSTMLM(TransformerLM):
    cfg: XLSTMConfig

    # ------------------------------------------------------------------ unit
    def _init_unit(self, gen) -> dict:
        cfg = self.cfg

        def norm():
            return torch.ones((cfg.d_model,), dtype=self.dtype)

        unit = {"mlstm": _stack([
            {"norm": norm(),
             "cell": S.init_mlstm(gen, cfg, self.ctx.tp, self.dtype)}
            for _ in range(cfg.mlstm_per_unit)])}
        if cfg.slstm_per_unit:
            unit["slstm"] = {"norm": norm(),
                             "cell": S.init_slstm(gen, cfg, self.ctx.tp,
                                                  self.dtype)}
        return unit

    def _apply_unit(self, p, x, extras, ctx, *, mode, cache=None, pos=None):
        """mode: "train" (no carries kept), "prefill" (carries from
        zero) or "decode" (from ``cache``; in place for a tensor pos)."""
        cfg = self.cfg
        in_place = mode == "decode" and isinstance(pos, torch.Tensor)
        keep = mode != "train" and not in_place  # return a new cache
        carries = []
        for j in range(cfg.mlstm_per_unit):
            mp = tree_map(lambda t, _j=j: t[_j], p["mlstm"])
            c0 = (tree_map(lambda t, _j=j: t[_j], cache["mlstm"])
                  if mode == "decode" else None)
            x, c = _mlstm_block(mp, x, cfg, ctx, carry=c0)
            if in_place:
                write_cache(c0, c)
            elif keep:
                carries.append(c)
        new = {"mlstm": _stack(carries)} if keep else None
        if cfg.slstm_per_unit:
            s0 = cache["slstm"] if mode == "decode" else None
            x, st = _slstm_block(p["slstm"], x, cfg, ctx, state=s0)
            if in_place:
                write_cache(s0, st)
            elif keep:
                new["slstm"] = st
        if mode == "train":
            return x, 0.0
        return x, cache if in_place else new

    def _unit_init_cache(self, batch, max_len, device=None):
        cfg = self.cfg
        m = S.mlstm_init_cache(cfg, batch, self.ctx.tp, device=device)
        cache = {"mlstm": tree_map(
            lambda t: t[None].expand((cfg.mlstm_per_unit,) + tuple(t.shape))
            .clone(), m)}
        if cfg.slstm_per_unit:
            cache["slstm"] = S.slstm_init_state(
                batch, cfg.n_heads, cfg.d_inner // cfg.n_heads, device=device)
        return cache

    def groups(self) -> list[BlockGroup]:
        return [BlockGroup(
            name="units",
            length=self.cfg.num_units,
            init_layer=self._init_unit,
            apply=lambda p, x, e, ctx: self._apply_unit(p, x, e, ctx,
                                                        mode="train"),
            init_cache=self._unit_init_cache,
            prefill=lambda p, x, e, ctx: self._apply_unit(p, x, e, ctx,
                                                          mode="prefill"),
            decode=lambda p, x, c, pos, e, ctx: self._apply_unit(
                p, x, e, ctx, mode="decode", cache=c, pos=pos),
        )]

    def tp_axes(self) -> dict:
        cfg, tp = self.cfg, self.ctx.tp
        # a unit's mLSTM layers are stacked [mlstm_per_unit, ...]
        unit = {"mlstm": stacked({"norm": None,
                                  "cell": S.mlstm_tp_axes(cfg, tp)})}
        if cfg.slstm_per_unit:
            unit["slstm"] = {"norm": None, "cell": S.slstm_tp_axes()}
        return {"stem": _stem_tp_axes(cfg), "groups": {"units": unit}}
