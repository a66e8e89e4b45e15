"""State-space and recurrent blocks of the port (``repro.models.ssm``
twin) at tensor parallelism 1: Mamba2's SSD, and xLSTM's mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory with a recurrent
coupling, strictly sequential).

Training and prefill run the chunkwise-parallel scans: inside a chunk of
``chunk_len`` positions a quadratic form, across chunks a state
recurrence, here a Python loop over the chunks (the reference's
``jax.lax.scan``); sLSTM loops over the positions.  With
``ctx.inner_remat`` each step of those loops runs under
``torch.utils.checkpoint``, as the reference wraps its scan bodies in
``jax.checkpoint``: the backward recomputes a step's intermediates and
keeps only the carries.  Decode is the same function at one position
from the cached state: an O(1) update a token, with no host read, so a
CUDA graph can capture it.  Gates and state updates run in fp32.

Departures from the reference's arithmetic, none changing the forward:

  * SSD's intra-chunk decay is masked to -inf *before* ``exp``: past the
    diagonal it is a positive sum of up to ``chunk_len - 1`` steps of
    ``dt |A|``, which overflows fp32's ``exp`` at full-size random
    weights, and the reference's ``where(mask, exp(decay), 0)`` then
    gives 0 * inf = NaN in the backward (mLSTM's reference masks first);
  * the three-operand intra-chunk contractions (SSD's and mLSTM's) form
    the ``[.., q, q, nh]`` weights first and contract over the source
    position with one batched product, never a ``[.., q, q, nh, dh]``
    intermediate;
  * the stabilisers' maxima are ``torch.amax`` and ``torch.maximum``,
    which split a tie's gradient evenly, as JAX's ``max`` does;
  * an mLSTM row whose denominator is exactly 0 gives 0 instead of the
    reference's 0 / 0; only a padded row gets there (its q is 0), and its
    NaN turned the reference's gradients NaN at a ragged length with
    large input gates (ROADMAP section 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import AxisCtx

# the SSM layers (Mamba2, mLSTM, sLSTM), and with them zamba and xlstm,
# take tensor parallelism in the slice after the attention/MLP/MoE/MLA one
_TP_LATER = ("tp > 1 for the SSM layers (Mamba2, mLSTM, sLSTM; zamba and "
             "xlstm) is the next slice of the port (ROADMAP §1: the SSM "
             "families' tensor parallelism); only tp=1 runs")


def _chunk(x, q):
    """[B, S, ...] -> [B, nc, q, ...] (S % q == 0: the caller pads)."""
    b, s = x.shape[:2]
    return x.reshape(b, s // q, q, *x.shape[2:])


def _remat(step, on: bool):
    """``step`` under ``torch.utils.checkpoint`` when ``on`` and autograd
    records (the reference's ``jax.checkpoint`` around a scan body)."""
    if not on:
        return step
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return step(*args)
        return checkpoint(step, *args, use_reentrant=False)
    return wrapped


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
        raise NotImplementedError(_TP_LATER)
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


def _ssd_chunk_scan(xh, bt, ct, la, dt, state0, inner_remat=False):
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
    def step(state, cs, cd, ct_c, lac_c):
        # y_t += exp(lac_t) C_t . state: [B, 1, nh*dh, ds] @ [B, 1, ds, q]
        y_in = torch.matmul(state.reshape(b, 1, nh * dh, -1),
                            ct_c[:, :, None, :].permute(0, 2, 3, 1))
        y_in = y_in.reshape(b, nh, dh, q).permute(0, 3, 1, 2)
        return state * cd[:, :, None, None] + cs, \
            y_in * torch.exp(lac_c)[..., None]

    step = _remat(step, inner_remat)
    state = state0
    ys = []
    # unbind: one backward node for every chunk's slice
    for inp in zip(*(t.unbind(1) for t in (chunk_state, chunk_decay, ct,
                                           lac))):
        state, y_in = step(state, *inp)
        ys.append(y_in)
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
                               _chunk(dt_p, q), state0,
                               inner_remat=ctx.inner_remat)
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
        raise NotImplementedError(_TP_LATER)
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


# ===========================================================================
# mLSTM (xLSTM's matrix-memory cell), chunkwise-parallel
# ===========================================================================


def init_mlstm(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """cfg needs: d_model, d_inner, n_heads (mLSTM heads).  The gate
    projections ``w_i``, ``w_f`` and ``f_bias`` are fp32 whatever
    ``dtype`` is, as in the reference."""
    if tp != 1:
        raise NotImplementedError(_TP_LATER)
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = di // nh
    return {
        "w_up": L.dense_init(gen, (d, di), dtype=dtype),
        "w_q": L.dense_init(gen, (di, nh * dh), dtype=dtype),
        "w_k": L.dense_init(gen, (di, nh * dh), dtype=dtype),
        "w_v": L.dense_init(gen, (di, nh * dh), dtype=dtype),
        "w_i": L.dense_init(gen, (di, nh), dtype=torch.float32),
        "w_f": L.dense_init(gen, (di, nh), dtype=torch.float32),
        "f_bias": torch.full((nh,), 3.0, dtype=torch.float32),
        "norm": torch.ones((nh * dh,), dtype=dtype),
        "w_gate": L.dense_init(gen, (d, nh * dh), dtype=dtype),
        "w_down": L.dense_init(gen, (nh * dh, d), dtype=dtype),
    }


def mlstm_tp_axes(cfg, tp: int = 1) -> dict:
    """At tp=1 every mLSTM leaf is replicated (the reference shards the
    value channels only for tp > 1)."""
    if tp != 1:
        raise NotImplementedError(_TP_LATER)
    return {k: None for k in ("w_up", "w_q", "w_k", "w_v", "w_i", "w_f",
                              "f_bias", "norm", "w_gate", "w_down")}


def _mlstm_step(carry, qc, kc, vc, lic, fc):
    """One chunk of the stabilised mLSTM, all fp32, heads leading.

    carry: {"S": [B, nh, dk, dv], "n": [B, nh, dk], "m": [B, nh]}, whose
    true values are S e^m and n e^m; qc/kc: [B, nh, q, dk]; vc: [B, nh,
    q, dv]; lic: [B, nh, q] the log input gates; fc: [B, nh, q] the
    cumulative log forget gates within the chunk.  -> (the carry at the
    chunk's end, y [B, nh, q, dv])."""
    S, n, m = carry["S"], carry["n"], carry["m"]
    q, dk = qc.shape[-2], qc.shape[-1]
    root = dk ** 0.5
    mask = torch.ones((q, q), dtype=torch.bool, device=qc.device).tril()
    # log weights: intra (t, s): F_t - F_s + i_s; the carry's: m + F_t
    logw = fc[..., :, None] - fc[..., None, :] + lic[..., None, :]
    logw = logw.masked_fill(~mask, float("-inf"))  # [B, nh, t, s]
    logw_c = m[..., None] + fc  # [B, nh, q]
    m_t = torch.maximum(torch.amax(logw, dim=-1), logw_c)
    w = torch.exp(logw - m_t[..., None])
    wc = torch.exp(logw_c - m_t)
    scores = torch.matmul(qc, kc.transpose(-1, -2)) / root
    h = torch.matmul(scores * w, vc)
    h = h + wc[..., None] * torch.matmul(qc, S) / root
    # normaliser: n_t = sum_s w[t, s] k_s + wc_t n_carry
    nq = torch.matmul(w, kc) + wc[..., None] * n[:, :, None, :]
    denom = torch.abs((qc * nq).sum(-1)) / root
    denom = torch.maximum(denom, torch.exp(-m_t))[..., None]
    # a zero denominator (a padded row, q = 0, once the stabiliser passes
    # ~104 and exp(-m) underflows) gives 0, not 0 / 0: every other row is
    # h / denom exactly, and the discarded row's NaN stays out of the
    # backward, where the reference's turns the gradients NaN
    ok = denom > 0
    y = torch.where(ok, h / torch.where(ok, denom, 1.0), 0.0)
    # the carry at the chunk's end
    fq = fc[..., -1]  # [B, nh]
    m_new = torch.maximum(m + fq,
                          torch.amax(lic + fq[..., None] - fc, dim=-1))
    ws = torch.exp(lic + fq[..., None] - fc - m_new[..., None])
    decay = torch.exp(m + fq - m_new)
    s_new = S * decay[..., None, None] + torch.matmul(
        (ws[..., None] * kc).transpose(-1, -2), vc)
    n_new = n * decay[..., None] + (ws[..., None] * kc).sum(-2)
    return {"S": s_new, "n": n_new, "m": m_new}, y


def _mlstm_chunk_scan(qh, kh, vh, li, lf, carry, inner_remat=False):
    """Stabilised chunkwise mLSTM.

    qh/kh: [B, nc, q, nh, dk]; vh: [B, nc, q, nh, dv]; li/lf: [B, nc, q,
    nh] (log input gate, log forget gate), all fp32.  -> (y [B, nc, q,
    nh, dv], the carry after the last chunk)."""
    fcum = torch.cumsum(lf, dim=2)  # cumulative log forget in a chunk

    def chunks(t):  # [B, nc, q, nh, ...] -> nc x [B, nh, q, ...]
        return t.movedim(3, 2).contiguous().unbind(1)

    step = _remat(_mlstm_step, inner_remat)
    ys = []
    for inp in zip(*(chunks(t) for t in (qh, kh, vh, li, fcum))):
        carry, y = step(carry, *inp)
        ys.append(y)
    return torch.stack(ys, dim=1).movedim(2, 3), carry


def mlstm_init_cache(cfg, batch: int, tp: int = 1, device=None) -> dict:
    """One mLSTM layer's decode carry, fp32: the matrix memory S, the
    normaliser n and the stabiliser m (-1e30: nothing seen yet)."""
    if tp != 1:
        raise NotImplementedError(_TP_LATER)
    nh = cfg.n_heads
    dh = cfg.d_inner // nh
    kw = dict(dtype=torch.float32, device=device)
    return {"S": torch.zeros((batch, nh, dh, dh), **kw),
            "n": torch.zeros((batch, nh, dh), **kw),
            "m": torch.full((batch, nh), -1e30, **kw)}


def mlstm_fwd(p, x, cfg, ctx: AxisCtx, carry=None):
    """x: [B, S, d] -> (y [B, S, d], the carry after the last position).
    q, k, v and the gates are zero-padded to a multiple of ``chunk_len``
    as in the reference: a padded step has input gate e^0 and forget
    gate 1, which raises the carried ``m`` without changing S e^m."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    dh = cfg.d_inner // nh
    dv = p["w_v"].shape[1] // nh
    q = min(cfg.chunk_len, s)
    u = F.silu(L.matmul(x, p["w_up"]))
    qq = L.matmul(u, p["w_q"]).reshape(b, s, nh, dh)
    kk = L.matmul(u, p["w_k"]).reshape(b, s, nh, dh)
    vv = L.matmul(u, p["w_v"]).reshape(b, s, nh, dv)
    li = L.matmul(u, p["w_i"], torch.float32)  # log input gate (pre-exp)
    lf = F.logsigmoid(L.matmul(u, p["w_f"], torch.float32)
                      + p["f_bias"].float())  # log forget gate
    ch = lambda t: _chunk(_pad_to(t, q)[0].float(), q)
    if carry is None:
        carry = mlstm_init_cache(cfg, b, device=x.device)
    y, carry = _mlstm_chunk_scan(ch(qq), ch(kk), ch(vv), ch(li), ch(lf),
                                 carry, inner_remat=ctx.inner_remat)
    y = y.reshape(b, -1, nh * dv)[:, :s].to(x.dtype)
    y = L.rms_norm(y, p["norm"])
    y = y * F.silu(L.matmul(x, p["w_gate"]))
    # tp=1: the reference's fp32 product is rounded to x's dtype at once
    return L.matmul(y, p["w_down"], x.dtype), carry


def mlstm_decode(p, x, carry, cfg, ctx: AxisCtx):
    """One position from the carried (S, n, m): ``mlstm_fwd`` at S = 1."""
    return mlstm_fwd(p, x, cfg, ctx, carry=carry)


# ===========================================================================
# sLSTM (scalar-memory cell with recurrent coupling) — strictly sequential
# ===========================================================================


def init_slstm(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """The bias ``b`` is fp32 whatever ``dtype`` is, as in the reference.
    (The reference draws ``w_ff_up`` and ``w_ff_down`` from one key; the
    port draws them one after the other from ``gen``.)"""
    if tp != 1:
        raise NotImplementedError(_TP_LATER)
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = di // nh
    ff = int(d * 4 / 3) // 8 * 8
    return {
        # input projections for (z, i, f, o)
        "w_in": L.dense_init(gen, (d, 4 * di), dtype=dtype),
        # block-diagonal recurrent weights per head: [nh, dh, 4 * dh]
        "r": (torch.randn((nh, dh, 4 * dh), generator=gen)
              / dh ** 0.5).to(dtype),
        "b": torch.cat([torch.zeros(2 * di), torch.full((di,), 2.0),
                        torch.zeros(di)]).float(),
        "norm": torch.ones((di,), dtype=dtype),
        "w_down": L.dense_init(gen, (di, d), dtype=dtype),
        # the sLSTM block's post-FFN
        "w_ff_up": L.dense_init(gen, (d, ff), dtype=dtype),
        "w_ff_down": L.dense_init(gen, (ff, d), dtype=dtype),
    }


def slstm_tp_axes() -> dict:
    return {k: None for k in
            ("w_in", "r", "b", "norm", "w_down", "w_ff_up", "w_ff_down")}


def slstm_init_state(batch: int, nh: int, dh: int, device=None) -> dict:
    """sLSTM's decode state, fp32: cell c, normaliser n, hidden h and the
    stabiliser m (-1e30), each [B, nh, dh]."""
    kw = dict(dtype=torch.float32, device=device)
    z = lambda: torch.zeros((batch, nh, dh), **kw)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, nh, dh), -1e30, **kw)}


def _slstm_step(state, pre_t, r):
    """One position, heads leading.  state: {"c", "n", "h", "m"}, each
    [nh, B, dh]; pre_t: [4, nh, B, dh] the input projections of (z, i, f,
    o); r: [nh, dh, 4 dh] fp32.  -> the new state (h is the output)."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    nh, b, dh = h.shape
    # the block-diagonal recurrent product, one batched matmul:
    # [nh, B, dh] @ [nh, dh, 4 dh] -> [nh, B, 4, dh] -> [4, nh, B, dh]
    rec = torch.bmm(h, r).view(nh, b, 4, dh).permute(2, 0, 1, 3)
    zt, it, ft, ot = (pre_t + rec).unbind(0)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    lf = F.logsigmoid(ft)
    lfm = lf + m
    m_new = torch.maximum(lfm, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(lfm - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    # maximum, not clamp: n is 1 exactly after the first step, and the
    # tie's gradient splits as JAX's does
    h = o * c / torch.maximum(n, n.new_ones(()))
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_fwd(p, x, cfg, ctx: AxisCtx, state=None):
    """Sequential over time. x: [B, S, d] -> (x + the cell's output + its
    FFN [B, S, d], the state after the last position).  The loop keeps
    heads ahead of the batch ([nh, B, dh]: the recurrent product is one
    ``bmm`` with no copy) and takes its positions by ``unbind`` (one
    backward node for all of them, not a full-size zero gradient a
    position)."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    di = cfg.d_inner
    dh = di // nh
    pre = L.matmul(x, p["w_in"], torch.float32) + p["b"].float()
    pre = pre.reshape(b, s, 4, nh, dh).permute(1, 2, 3, 0, 4).contiguous()
    if state is None:
        state = slstm_init_state(b, nh, dh, device=x.device)
    state = {k: t.transpose(0, 1).contiguous() for k, t in state.items()}
    r = p["r"].float()
    step = _remat(_slstm_step, ctx.inner_remat)
    hs = []
    for pre_t in pre.unbind(0):
        state = step(state, pre_t, r)
        hs.append(state["h"])
    # [S, nh, B, dh] -> [B, S, nh * dh]
    hs = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, di).to(x.dtype)
    y = L.rms_norm(hs, p["norm"])
    # tp=1: the reference's fp32 products are rounded to x's dtype at once
    x = x + L.matmul(y, p["w_down"], x.dtype)
    h2 = F.gelu(L.matmul(x, p["w_ff_up"]), approximate="tanh")
    out = x + L.matmul(h2, p["w_ff_down"], x.dtype)
    return out, {k: t.transpose(0, 1).contiguous() for k, t in state.items()}


def slstm_decode(p, x, state, cfg, ctx: AxisCtx):
    return slstm_fwd(p, x, cfg, ctx, state=state)
