"""State-space blocks of the port (``repro.models.ssm`` twin): Mamba2's
SSD, at tensor parallelism 1.  mLSTM and sLSTM (xLSTM) come with the
xlstm slice.

Training and prefill run the chunkwise-parallel scan: inside a chunk of
``chunk_len`` positions a quadratic form, across chunks a state
recurrence, here a Python loop over the chunks (the reference's
``jax.lax.scan``).  Decode is the same function at one position from the
cached state and conv tails: an O(1) update a token, with no host read,
so a CUDA graph can capture it.  Gates and state updates run in fp32.

Two departures from the reference's arithmetic, neither changing the
forward:

  * the intra-chunk decay is masked to -inf *before* ``exp``: past the
    diagonal it is a positive sum of up to ``chunk_len - 1`` steps of
    ``dt |A|``, which overflows fp32's ``exp`` at full-size random
    weights, and the reference's ``where(mask, exp(decay), 0)`` then
    gives 0 * inf = NaN in the backward;
  * the three-operand intra-chunk contraction forms the weights
    ``[B, nc, q, q, nh]`` first and contracts over the source position
    with one batched product, never a ``[B, nc, q, q, nh, dh]``
    intermediate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import AxisCtx


def _chunk(x, q):
    """[B, S, ...] -> [B, nc, q, ...] (S % q == 0: the caller pads)."""
    b, s = x.shape[:2]
    return x.reshape(b, s // q, q, *x.shape[2:])


def _pad_to(x, q):
    """Zero-pad the position axis (1) of ``x`` to a multiple of ``q``."""
    pad = (-x.shape[1]) % q
    if pad:
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
    return x, pad


# ===========================================================================
# Mamba2 / SSD
# ===========================================================================


def init_mamba2(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """cfg needs: d_model, d_inner, mamba_heads, mamba_headdim, ssm_state,
    conv_kernel.  ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever
    ``dtype`` is, as in the reference."""
    if tp != 1:
        raise NotImplementedError("only tp=1 is ported")
    d, di = cfg.d_model, cfg.d_inner
    nh, ds, k = cfg.mamba_heads, cfg.ssm_state, cfg.conv_kernel

    def conv(c):
        return (torch.randn((k, c), generator=gen) * 0.1).to(dtype)

    return {
        "w_z": L.dense_init(gen, (d, di), dtype=dtype),
        "w_x": L.dense_init(gen, (d, di), dtype=dtype),
        "w_B": L.dense_init(gen, (d, ds), dtype=dtype),
        "w_C": L.dense_init(gen, (d, ds), dtype=dtype),
        "w_dt": L.dense_init(gen, (d, nh), dtype=dtype),
        "conv_x": conv(di),
        "conv_B": conv(ds),
        "conv_C": conv(ds),
        "A_log": torch.zeros((nh,), dtype=torch.float32),
        "D": torch.ones((nh,), dtype=torch.float32),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32),
        "norm": torch.ones((di,), dtype=dtype),
        "w_out": L.dense_init(gen, (di, d), dtype=dtype),
    }


def mamba2_tp_axes() -> dict:
    return {"w_z": 1, "w_x": 1, "w_B": None, "w_C": None, "w_dt": 1,
            "conv_x": 1, "conv_B": None, "conv_C": None,
            "A_log": 0, "D": 0, "dt_bias": 0, "norm": 0, "w_out": 0}


def _causal_conv(x, kernel, carry=None):
    """Depthwise causal conv. x: [B, S, C]; kernel: [K, C]; carry:
    [B, K-1, C], the previous inputs (decode), or None (zeros).
    -> (silu(conv), the new carry: the last K-1 inputs)."""
    k = kernel.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * kernel[i] for i in range(k))
    new_carry = xp[:, -(k - 1):, :] if k > 1 else carry
    return F.silu(out), new_carry


def _ssd_chunk_scan(xh, bt, ct, la, dt, state0):
    """Chunkwise SSD, all fp32.

    xh: [B, nc, q, nh, dh]  inputs per head
    bt/ct: [B, nc, q, ds]   input/output projections (shared by the heads)
    la: [B, nc, q, nh]      per-step log decay
    dt: [B, nc, q, nh]      step sizes
    state0: [B, nh, dh, ds]
    -> (y [B, nc, q, nh, dh], the state after the last chunk)
    """
    b, nc, q, nh, dh = xh.shape
    lac = torch.cumsum(la, dim=2)  # cumulative log decay within a chunk
    # intra-chunk: y_t = sum_{s<=t} (C_t . B_s) exp(lac_t - lac_s) dt_s x_s
    cb = torch.einsum("bnts,bnqs->bntq", ct, bt)  # [B, nc, t, s]
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = lac[:, :, :, None, :] - lac[:, :, None, :, :]  # [B,nc,t,s,nh]
    decay = decay.masked_fill(~mask[:, :, None], float("-inf"))
    w = torch.exp(decay) * dt[:, :, None, :, :] * cb[..., None]
    # [B, nc, nh, t, s] @ [B, nc, nh, s, dh] -> [B, nc, nh, t, dh]
    y_intra = torch.matmul(w.permute(0, 1, 4, 2, 3),
                           xh.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    # each chunk's contribution to the state it hands on:
    # sum_s exp(lac_q - lac_s) dt_s x_s B_s^T
    laq = lac[:, :, -1:, :]  # [B, nc, 1, nh]
    w_state = torch.exp(laq - lac) * dt  # [B, nc, q, nh]
    # [B, nc, nh, dh, s] @ [B, nc, 1, s, ds] -> [B, nc, nh, dh, ds]
    chunk_state = torch.matmul(
        (w_state[..., None] * xh).permute(0, 1, 3, 4, 2), bt[:, :, None])
    chunk_decay = torch.exp(laq[:, :, 0, :])  # [B, nc, nh]
    # inter-chunk: the incoming state's output, then the carry
    state = state0
    ys = []
    for n in range(nc):
        # y_t += exp(lac_t) C_t . state: [B, 1, nh*dh, ds] @ [B, 1, ds, q]
        y_in = torch.matmul(state.reshape(b, 1, nh * dh, -1),
                            ct[:, n, :, None, :].permute(0, 2, 3, 1))
        y_in = y_in.reshape(b, nh, dh, q).permute(0, 3, 1, 2)
        ys.append(y_in * torch.exp(lac[:, n])[..., None])
        state = state * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
    return y_intra + torch.stack(ys, dim=1), state


def mamba2_fwd(p, x, cfg, ctx: AxisCtx, state0=None, conv_carries=None):
    """x: [B, S, d] -> (y [B, S, d], (state, conv carries))."""
    b, s, _ = x.shape
    nh = p["A_log"].shape[0]
    dh, ds = cfg.mamba_headdim, cfg.ssm_state
    q = min(cfg.chunk_len, s)
    z = F.silu(L.matmul(x, p["w_z"]))
    xr = L.matmul(x, p["w_x"])
    br = L.matmul(x, p["w_B"])
    cr = L.matmul(x, p["w_C"])
    cc = conv_carries or {"x": None, "B": None, "C": None}
    xc, cx = _causal_conv(xr, p["conv_x"], cc["x"])
    bc, cb_ = _causal_conv(br, p["conv_B"], cc["B"])
    ccv, ccc = _causal_conv(cr, p["conv_C"], cc["C"])
    dt = F.softplus(L.matmul(x, p["w_dt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())  # [nh]
    la = dt * a  # log decay per step

    xc, _ = _pad_to(xc, q)
    bc, _ = _pad_to(bc, q)
    ccv, _ = _pad_to(ccv, q)
    la_p, _ = _pad_to(la, q)
    dt_p, _ = _pad_to(dt, q)
    sp = xc.shape[1]
    xh = _chunk(xc, q).reshape(b, sp // q, q, nh, dh).float()
    if state0 is None:
        state0 = torch.zeros((b, nh, dh, ds), dtype=torch.float32,
                             device=x.device)
    y, state = _ssd_chunk_scan(xh, _chunk(bc, q).float(),
                               _chunk(ccv, q).float(), _chunk(la_p, q),
                               _chunk(dt_p, q), state0)
    y = y.reshape(b, sp, nh * dh)[:, :s]
    y = y + (xc.float().reshape(b, sp, nh, dh)
             * p["D"].float()[None, None, :, None]).reshape(b, sp, -1)[:, :s]
    y = y.to(x.dtype) * z
    y = L.rms_norm(y, p["norm"])
    # tp=1: the reference's fp32 product is rounded to x's dtype at once
    out = L.matmul(y, p["w_out"], x.dtype)
    return out, (state, {"x": cx, "B": cb_, "C": ccc})


def mamba2_init_cache(cfg, batch: int, tp: int, dtype, device=None) -> dict:
    """One layer's decode state: the fp32 SSM state and the conv tails in
    ``dtype`` (the compute dtype) — a cache without a position axis."""
    if tp != 1:
        raise NotImplementedError("only tp=1 is ported")
    k = cfg.conv_kernel
    return {
        "state": torch.zeros((batch, cfg.mamba_heads, cfg.mamba_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, k - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, k - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, k - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
    }


def mamba2_decode(p, x, cache, cfg, ctx: AxisCtx):
    """Single-token state update. x: [B, 1, d] -> (y, the new cache)."""
    carries = {"x": cache["conv_x"], "B": cache["conv_B"],
               "C": cache["conv_C"]}
    y, (state, cc) = mamba2_fwd(p, x, cfg, ctx, state0=cache["state"],
                                conv_carries=carries)
    return y, {"state": state, "conv_x": cc["x"], "conv_B": cc["B"],
               "conv_C": cc["C"]}
