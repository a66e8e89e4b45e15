"""State-space and recurrent blocks of the port (``repro.models.ssm``
twin): Mamba2's SSD, and xLSTM's mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory with a recurrent coupling,
strictly sequential).

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

Tensor parallelism follows the reference's layouts on the simulated model
axis of :mod:`repro_torch.models.tp` (a sharded leaf is a ``Ranks`` of
the ranks' shards, an activation every rank holds alike is computed
once):

  * Mamba2: z, x, dt, the conv over x and the SSD scan run per rank over
    its ``nh / tp`` heads; the head-shared B and C projections and their
    convs are replicated, computed once; the out projection is
    row-parallel, then the fp32 psum;
  * mLSTM: u, q, k and the i and f gates are replicated, computed once;
    the value channels shard, split head-major (``tp.TPAxis``: rank r
    holds columns ``h * dh + r * dh / tp + j``, the ``dh / tp`` slice of
    every head that its carry ``S [B, nh, dk, dh / tp]`` pairs with), and
    the scan's value-free part (weights, normaliser, stabiliser) runs once
    for every rank's columns; the out projection is row-parallel.  Where
    tp does not divide ``dh`` the whole layer is replicated, as the
    reference's;
  * sLSTM: fully replicated (its recurrent coupling is dense), computed
    once.

**The gated norm is global.**  Mamba2's and mLSTM's RMS norm before the
out projection averages over all ``d_inner`` channels at every tp: each
rank's fp32 sum of squares, psummed, over ``d_inner``.  The reference
takes the mean over each rank's own channels (``L.rms_norm`` on the local
slice), which at tp > 1 is a group norm of tp groups: its model then
depends on the mesh (``tests/test_torch_tp_ssm.py`` shows its Mamba2 and
mLSTM at tp 2 tens of percent of the largest output away from its own tp
= 1 output).  The port computes the function that does not depend on tp,
so one global tree gives one model at every tp; the extra reduction is B
x S fp32 values a layer.

A cache at tp > 1 holds a ``Ranks`` at every leaf (the runtime keeps
``[tp, L, ...]``): the sharded states per rank, the replicated ones (the
B and C conv tails, mLSTM's normaliser and stabiliser, sLSTM's state) as
every rank's copy of one value.

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
from repro_torch.models.tp import Ranks, TPAxis, rank_of, rank_view, \
    replicate


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


def _gated_norm(ys: list, weights: list, ctx: AxisCtx, width: int,
                eps: float = 1e-6) -> list:
    """The RMS norm over all ``width`` channels of the ranks' slices
    ``ys`` (module docstring): each rank's fp32 sum of squares, psummed,
    over ``width``; each slice scaled by its weight.  One rank is
    ``L.rms_norm`` exactly."""
    if len(ys) == 1:
        return [L.rms_norm(ys[0], weights[0], eps)]
    ss = ctx.psum_model([(y.float() * y.float()).sum(-1, keepdim=True)
                         for y in ys], extra=True)
    inv = torch.rsqrt(ss / width + eps)
    return [(y.float() * inv * w.float()).to(y.dtype)
            for y, w in zip(ys, weights)]


def _row_parallel(ys: list, ws: list, ctx: AxisCtx, dtype):
    """The row-parallel out projection: each rank's product in fp32, the
    psum, one cast to ``dtype``; one rank rounds its fp32 product to
    ``dtype`` at once (the reference's product, then cast, with no psum
    between)."""
    if len(ys) == 1:
        return L.matmul(ys[0], ws[0], dtype)
    return ctx.psum_model([L.matmul(y, w, torch.float32)
                           for y, w in zip(ys, ws)]).to(dtype)


# ===========================================================================
# Mamba2 / SSD
# ===========================================================================


def init_mamba2(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """cfg needs: d_model, d_inner, mamba_heads, mamba_headdim, ssm_state,
    conv_kernel.  Every leaf at its tp-local shape (the reference's):
    the inner channels and heads divide over tp, B and C are whole.
    ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever ``dtype`` is, as in
    the reference."""
    d, di = cfg.d_model, cfg.d_inner
    nh, ds, k = cfg.mamba_heads, cfg.ssm_state, cfg.conv_kernel
    if di % tp or nh % tp:
        raise ValueError(f"mamba d_inner={di}/heads={nh} not divisible by "
                         f"tp={tp}")
    di, nh = di // tp, nh // tp

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


def _mamba2_rank(p, x, cfg, ctx: AxisCtx, bt, ct, state0, carry_x):
    """One model rank's heads: z, x and dt projections, the conv over x,
    the SSD scan from ``state0`` and the skip, gated by z.  ``bt``/``ct``:
    the chunked, fp32 B and C every rank shares.  -> (y [B, S, di_l] in
    x's dtype before the norm, the state after the last position, the x
    conv's carry)."""
    b, s, _ = x.shape
    nh = p["A_log"].shape[0]
    dh, ds = cfg.mamba_headdim, cfg.ssm_state
    q = min(cfg.chunk_len, s)
    z = F.silu(L.matmul(x, p["w_z"]))
    xc, cx = _causal_conv(L.matmul(x, p["w_x"]), p["conv_x"], carry_x)
    dt = F.softplus(L.matmul(x, p["w_dt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())  # [nh]
    la = dt * a  # log decay per step
    xc, _ = _pad_to(xc, q)
    la_p, _ = _pad_to(la, q)
    dt_p, _ = _pad_to(dt, q)
    sp = xc.shape[1]
    xh = _chunk(xc, q).reshape(b, sp // q, q, nh, dh).float()
    if state0 is None:
        state0 = torch.zeros((b, nh, dh, ds), dtype=torch.float32,
                             device=x.device)
    y, state = _ssd_chunk_scan(xh, bt, ct, _chunk(la_p, q), _chunk(dt_p, q),
                               state0, inner_remat=ctx.inner_remat)
    y = y.reshape(b, sp, nh * dh)[:, :s]
    y = y + (xc.float().reshape(b, sp, nh, dh)
             * p["D"].float()[None, None, :, None]).reshape(b, sp, -1)[:, :s]
    return y.to(x.dtype) * z, state, cx


def mamba2_fwd(p, x, cfg, ctx: AxisCtx, state0=None, conv_carries=None):
    """x: [B, S, d] -> (y [B, S, d], (state, conv carries)).  At tp > 1
    the state and the x conv's carry are ``Ranks`` (one a rank; so are
    ``state0`` and ``conv_carries["x"]``), the B and C carries shared."""
    s = x.shape[1]
    q = min(cfg.chunk_len, s)
    cc = conv_carries or {"x": None, "B": None, "C": None}
    # B and C: every rank's, computed once
    bc, cb_ = _causal_conv(L.matmul(x, p["w_B"]), p["conv_B"], cc["B"])
    ccv, ccc = _causal_conv(L.matmul(x, p["w_C"]), p["conv_C"], cc["C"])
    bt = _chunk(_pad_to(bc, q)[0], q).float()
    ct = _chunk(_pad_to(ccv, q)[0], q).float()
    ys, states, cxs = [], [], []
    for r in range(ctx.tp):
        y, state, cx = _mamba2_rank(rank_view(p, r), x, cfg, ctx, bt, ct,
                                    rank_of(state0, r), rank_of(cc["x"], r))
        ys.append(y)
        states.append(state)
        cxs.append(cx)
    ys = _gated_norm(ys, [rank_view(p, r)["norm"] for r in range(ctx.tp)],
                     ctx, cfg.d_inner)
    out = _row_parallel(ys, [rank_view(p, r)["w_out"]
                             for r in range(ctx.tp)], ctx, x.dtype)
    return out, (Ranks.of(states), {"x": Ranks.of(cxs), "B": cb_,
                                    "C": ccc})


def mamba2_cache(state, convs, tp: int = 1) -> dict:
    """One layer's decode cache from ``mamba2_fwd``'s (state, conv
    carries): the B and C tails as every rank's copy."""
    return {"state": state, "conv_x": convs["x"],
            "conv_B": replicate(convs["B"], tp),
            "conv_C": replicate(convs["C"], tp)}


def mamba2_init_cache(cfg, batch: int, tp: int, dtype, device=None) -> dict:
    """One rank's decode state: the fp32 SSM state of its heads, its x
    conv tail and the shared B and C tails in ``dtype`` (the compute
    dtype) — a cache without a position axis."""
    k = cfg.conv_kernel
    return {
        "state": torch.zeros((batch, cfg.mamba_heads // tp,
                              cfg.mamba_headdim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, k - 1, cfg.d_inner // tp),
                              dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, k - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, k - 1, cfg.ssm_state), dtype=dtype,
                              device=device),
    }


def mamba2_decode(p, x, cache, cfg, ctx: AxisCtx):
    """Single-token state update. x: [B, 1, d] -> (y, the new cache)."""
    carries = {"x": cache["conv_x"], "B": rank_of(cache["conv_B"], 0),
               "C": rank_of(cache["conv_C"], 0)}
    y, (state, cc) = mamba2_fwd(p, x, cfg, ctx, state0=cache["state"],
                                conv_carries=carries)
    return y, mamba2_cache(state, cc, ctx.tp)


# ===========================================================================
# mLSTM (xLSTM's matrix-memory cell), chunkwise-parallel
# ===========================================================================


def _mlstm_sharded(cfg, tp: int) -> bool:
    """The value channels shard where tp > 1 divides the head width;
    otherwise every mLSTM leaf is replicated (the reference's rule)."""
    return tp > 1 and (cfg.d_inner // cfg.n_heads) % tp == 0


def init_mlstm(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """cfg needs: d_model, d_inner, n_heads (mLSTM heads).  Every leaf at
    its tp-local shape (the reference's): ``dh / tp`` value channels a
    head where tp divides ``dh``, else all of them.  The gate projections
    ``w_i``, ``w_f`` and ``f_bias`` are fp32 whatever ``dtype`` is, as in
    the reference."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = di // nh
    dv = dh // tp if _mlstm_sharded(cfg, tp) else dh
    return {
        "w_up": L.dense_init(gen, (d, di), dtype=dtype),
        "w_q": L.dense_init(gen, (di, nh * dh), dtype=dtype),
        "w_k": L.dense_init(gen, (di, nh * dh), dtype=dtype),
        "w_v": L.dense_init(gen, (di, nh * dv), dtype=dtype),
        "w_i": L.dense_init(gen, (di, nh), dtype=torch.float32),
        "w_f": L.dense_init(gen, (di, nh), dtype=torch.float32),
        "f_bias": torch.full((nh,), 3.0, dtype=torch.float32),
        "norm": torch.ones((nh * dv,), dtype=dtype),
        "w_gate": L.dense_init(gen, (d, nh * dv), dtype=dtype),
        "w_down": L.dense_init(gen, (nh * dv, d), dtype=dtype),
    }


def mlstm_tp_axes(cfg, tp: int = 1) -> dict:
    """The reference's axes (value channels on w_v's and w_gate's axis 1,
    norm's and w_down's axis 0, where :func:`_mlstm_sharded`; every leaf
    replicated otherwise), split head-major (``tp.TPAxis``: each rank
    takes its ``dh / tp`` slice of every head, the columns its body reads
    as ``[.., nh, dh / tp]``)."""
    sharded = _mlstm_sharded(cfg, tp)
    nh = cfg.n_heads
    cols = TPAxis(1, heads=nh) if sharded else None
    rows = TPAxis(0, heads=nh) if sharded else None
    return {"w_up": None, "w_q": None, "w_k": None, "w_v": cols,
            "w_i": None, "w_f": None, "f_bias": None, "norm": rows,
            "w_gate": cols, "w_down": rows}


def _mlstm_step(carry, qc, kc, vcs, lic, fc):
    """One chunk of the stabilised mLSTM, all fp32, heads leading.

    carry: {"S": a list of [B, nh, dk, dv] (one a rank's value columns),
    "n": [B, nh, dk], "m": [B, nh]}, whose true values are S e^m and n
    e^m; qc/kc: [B, nh, q, dk]; vcs: a list of [B, nh, q, dv], one a
    rank; lic: [B, nh, q] the log input gates; fc: [B, nh, q] the
    cumulative log forget gates within the chunk.  The weights, the
    normaliser and the stabiliser do not read v: they are computed once
    for every rank's columns.  -> (the carry at the chunk's end, a list of
    y [B, nh, q, dv], one a rank)."""
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
    sw = torch.matmul(qc, kc.transpose(-1, -2)) / root * w
    hs = [torch.matmul(sw, vc) + wc[..., None] * torch.matmul(qc, S_r)
          / root for vc, S_r in zip(vcs, S)]
    # normaliser: n_t = sum_s w[t, s] k_s + wc_t n_carry
    nq = torch.matmul(w, kc) + wc[..., None] * n[:, :, None, :]
    denom = torch.abs((qc * nq).sum(-1)) / root
    denom = torch.maximum(denom, torch.exp(-m_t))[..., None]
    # a zero denominator (a padded row, q = 0, once the stabiliser passes
    # ~104 and exp(-m) underflows) gives 0, not 0 / 0: every other row is
    # h / denom exactly, and the discarded row's NaN stays out of the
    # backward, where the reference's turns the gradients NaN
    ok = denom > 0
    ys = [torch.where(ok, h / torch.where(ok, denom, 1.0), 0.0) for h in hs]
    # the carry at the chunk's end
    fq = fc[..., -1]  # [B, nh]
    m_new = torch.maximum(m + fq,
                          torch.amax(lic + fq[..., None] - fc, dim=-1))
    ws = torch.exp(lic + fq[..., None] - fc - m_new[..., None])
    decay = torch.exp(m + fq - m_new)
    wk = ws[..., None] * kc
    s_new = [S_r * decay[..., None, None] + torch.matmul(
        wk.transpose(-1, -2), vc) for vc, S_r in zip(vcs, S)]
    n_new = n * decay[..., None] + wk.sum(-2)
    return {"S": s_new, "n": n_new, "m": m_new}, ys


def _mlstm_chunk_scan(qh, kh, vh, li, lf, carry, inner_remat=False):
    """Stabilised chunkwise mLSTM.

    qh/kh: [B, nc, q, nh, dk]; vh: [B, nc, q, nh, dv], or a list of them
    (one a rank's value columns, the carry's S a list alike); li/lf: [B,
    nc, q, nh] (log input gate, log forget gate), all fp32.  -> (y [B,
    nc, q, nh, dv], or a list of them, the carry after the last chunk)."""
    one = isinstance(vh, torch.Tensor)
    if one:
        vh, carry = [vh], dict(carry, S=[carry["S"]])
    fcum = torch.cumsum(lf, dim=2)  # cumulative log forget in a chunk

    def chunks(t):  # [B, nc, q, nh, ...] -> nc x [B, nh, q, ...]
        return t.movedim(3, 2).contiguous().unbind(1)

    step = _remat(_mlstm_step, inner_remat)
    ys = []
    vcs = list(zip(*(chunks(v) for v in vh)))
    for qc, kc, vc, lic, fc in zip(chunks(qh), chunks(kh), vcs, chunks(li),
                                   chunks(fcum)):
        carry, y = step(carry, qc, kc, list(vc), lic, fc)
        ys.append(y)
    ys = [torch.stack(col, dim=1).movedim(2, 3) for col in zip(*ys)]
    if one:
        return ys[0], dict(carry, S=carry["S"][0])
    return ys, carry


def mlstm_init_cache(cfg, batch: int, tp: int = 1, device=None) -> dict:
    """One rank's mLSTM decode carry, fp32: its value columns' matrix
    memory S, the normaliser n and the stabiliser m (-1e30: nothing seen
    yet), which every rank holds alike."""
    nh = cfg.n_heads
    dh = cfg.d_inner // nh
    dv = dh // tp if _mlstm_sharded(cfg, tp) else dh
    kw = dict(dtype=torch.float32, device=device)
    return {"S": torch.zeros((batch, nh, dh, dv), **kw),
            "n": torch.zeros((batch, nh, dh), **kw),
            "m": torch.full((batch, nh), -1e30, **kw)}


def mlstm_fwd(p, x, cfg, ctx: AxisCtx, carry=None):
    """x: [B, S, d] -> (y [B, S, d], the carry after the last position:
    at tp > 1 a ``Ranks`` at every leaf, S per rank, n and m every
    rank's copy).  q, k, v and the gates are zero-padded to a multiple of
    ``chunk_len`` as in the reference: a padded step has input gate e^0
    and forget gate 1, which raises the carried ``m`` without changing S
    e^m."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    dh = cfg.d_inner // nh
    n_v = ctx.tp if _mlstm_sharded(cfg, ctx.tp) else 1
    ranks = [rank_view(p, r) for r in range(n_v)]
    dv = ranks[0]["w_v"].shape[1] // nh
    q = min(cfg.chunk_len, s)
    u = F.silu(L.matmul(x, p["w_up"]))
    qq = L.matmul(u, p["w_q"]).reshape(b, s, nh, dh)
    kk = L.matmul(u, p["w_k"]).reshape(b, s, nh, dh)
    vvs = [L.matmul(u, pr["w_v"]).reshape(b, s, nh, dv) for pr in ranks]
    li = L.matmul(u, p["w_i"], torch.float32)  # log input gate (pre-exp)
    lf = F.logsigmoid(L.matmul(u, p["w_f"], torch.float32)
                      + p["f_bias"].float())  # log forget gate
    ch = lambda t: _chunk(_pad_to(t, q)[0].float(), q)
    if carry is None:
        c0 = mlstm_init_cache(cfg, b, n_v, device=x.device)
        carry = {"S": [c0["S"]] + [torch.zeros_like(c0["S"])
                                   for _ in range(n_v - 1)],
                 "n": c0["n"], "m": c0["m"]}
    else:
        carry = {"S": [rank_of(carry["S"], r) for r in range(n_v)],
                 "n": rank_of(carry["n"], 0), "m": rank_of(carry["m"], 0)}
    ys, carry = _mlstm_chunk_scan(ch(qq), ch(kk), [ch(v) for v in vvs],
                                  ch(li), ch(lf), carry,
                                  inner_remat=ctx.inner_remat)
    ys = [y.reshape(b, -1, nh * dv)[:, :s].to(x.dtype) for y in ys]
    ys = _gated_norm(ys, [pr["norm"] for pr in ranks], ctx, nh * dh)
    ys = [y * F.silu(L.matmul(x, pr["w_gate"])) for y, pr in zip(ys, ranks)]
    out = _row_parallel(ys, [pr["w_down"] for pr in ranks], ctx, x.dtype)
    tp = ctx.tp
    return out, {"S": Ranks.of(carry["S"]) if n_v > 1
                 else replicate(carry["S"][0], tp),
                 "n": replicate(carry["n"], tp),
                 "m": replicate(carry["m"], tp)}


def mlstm_decode(p, x, carry, cfg, ctx: AxisCtx):
    """One position from the carried (S, n, m): ``mlstm_fwd`` at S = 1."""
    return mlstm_fwd(p, x, cfg, ctx, carry=carry)


# ===========================================================================
# sLSTM (scalar-memory cell with recurrent coupling) — strictly sequential
# ===========================================================================


def init_slstm(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """The bias ``b`` is fp32 whatever ``dtype`` is, as in the reference.
    (The reference draws ``w_ff_up`` and ``w_ff_down`` from one key; the
    port draws them one after the other from ``gen``.)  Replicated at
    every tp: each leaf at its global shape."""
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
    position).  Replicated over the model axis: computed once, the state
    handed back as every rank's copy (``state`` may be one: rank 0's is
    read)."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    di = cfg.d_inner
    dh = di // nh
    pre = L.matmul(x, p["w_in"], torch.float32) + p["b"].float()
    pre = pre.reshape(b, s, 4, nh, dh).permute(1, 2, 3, 0, 4).contiguous()
    if state is None:
        state = slstm_init_state(b, nh, dh, device=x.device)
    state = {k: rank_of(t, 0).transpose(0, 1).contiguous()
             for k, t in state.items()}
    r = p["r"].float()
    step = _remat(_slstm_step, ctx.inner_remat)
    hs = []
    for pre_t in pre.unbind(0):
        state = step(state, pre_t, r)
        hs.append(state["h"])
    # [S, nh, B, dh] -> [B, S, nh * dh]
    hs = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, di).to(x.dtype)
    y = L.rms_norm(hs, p["norm"])
    # replicated, no psum: the reference's fp32 products are rounded to
    # x's dtype at once
    x = x + L.matmul(y, p["w_down"], x.dtype)
    h2 = F.gelu(L.matmul(x, p["w_ff_up"]), approximate="tanh")
    out = x + L.matmul(h2, p["w_ff_down"], x.dtype)
    return out, {k: replicate(t.transpose(0, 1).contiguous(), ctx.tp)
                 for k, t in state.items()}


def slstm_decode(p, x, state, cfg, ctx: AxisCtx):
    return slstm_fwd(p, x, cfg, ctx, state=state)
