"""Dense model layers of the port (``repro.models.layers`` twin).

Conventions
-----------
* Layers are plain functions on tensors that take per-layer param dicts.
  On the serving path those dicts hold views into chunk payloads: the
  chunk is the storage, so the port has no ``nn.Parameter``s (they would
  duplicate it).
* Shapes, layouts and dtypes follow the reference at every public
  function ([B, S, H, D] attention, vocab-local logits in fp32), so the
  parity tests compare like with like.
* Products accumulate in fp32, as the reference's
  ``preferred_element_type=float32``.  Where the reference mixes dtypes
  (a bf16 activation times an fp32 chunk payload) JAX promotes to fp32;
  torch would refuse, so :func:`matmul` casts explicitly.  Where the
  reference keeps an fp32 product only to round it to the activation's
  dtype (the out projections at tp=1: no psum between), the port asks for
  that dtype at once: the same single rounding of the fp32 accumulator,
  and bf16 operands then stay on the tensor cores.
* Attention on a CUDA tensor always runs the hand-written kernels
  (:func:`repro_torch.kernels.ops.flash_attention`: K2's forward, and its
  backward kernel when autograd asks for a gradient); on a CPU tensor
  :func:`attention_core` mirrors the reference's ``auto`` choice exactly,
  and autograd differentiates it.
* Tensor parallelism is the reference's Megatron pattern (column-parallel
  q/k/v and up/gate, row-parallel o and down, one psum a block; the
  vocab-parallel embedding, head, loss and greedy token), on the
  simulated model axis of :mod:`repro_torch.models.tp`: at ``tp > 1`` a
  sharded param leaf is a :class:`~repro_torch.models.tp.Ranks` of the
  ranks' local shards, each layer runs every rank's local body in turn,
  and the reference's ``psum``/``pmax``/``all_gather`` are the explicit
  reductions of :class:`AxisCtx`, the fp32 sum rank 0 first.  A rank's
  attention runs K2 on its own local heads (one call a rank).  The decode
  cache follows :func:`decode_cache_plan`: "tp" (kv heads divide tp,
  each rank caches its own) or "dist" (kv-head groups x strided sequence
  chunks, the partial softmaxes combined across ranks).
* Sliding-window attention (``cfg.sliding_window``): full-sequence
  attention passes the window to the attention core (K2 on a card); the
  decode cache is a ring of ``C = min(max_len, window)`` rows, position
  ``pos`` in slot ``pos % C``.  Rows are RoPE'd before they are cached and
  attention ignores the order of its keys, so a decode step needs no mask
  on the ring: it reads the first ``min(pos + 1, C)`` slots.  A prompt
  longer than the window leaves its last ``window`` rows in the ring at
  ``slot = pos % window`` (the reference's "dist" layout; its "tp" branch
  keeps them in prompt order, which decode then overwrites in the wrong
  slot).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.tp import Ranks, rank_view, ranks_tree, shards


def _ring(p: int) -> float:
    return (p - 1) / p if p > 1 else 0.0


# each kind's link bytes a device for a buffer of ``n`` bytes over ``p``
# ranks (the cost model's ring volumes): an all-gather's buffer is the
# gathered one, a reduce-scatter's the unscattered one
_LINK = {"all-gather": lambda n, p: _ring(p) * n,
         "reduce-scatter": lambda n, p: _ring(p) * n,
         "all-reduce": lambda n, p: 2.0 * _ring(p) * n}


class CollectiveCounter:
    """The collectives the simulated ranks perform, counted as they run
    (the port's stand-in for the reference's HLO collectives, which
    ``parse_collectives`` reads): ``by_kind[kind] = [count, buffer bytes,
    link bytes]`` summed over every simulated data rank's share.  A data
    rank adds one to ``ranks`` as its share starts, so a device's part is
    each sum over ``ranks``.  ``extra_link_bytes`` sums the link bytes of
    the reductions the reference does not make (the gated norm's psum of
    :mod:`repro_torch.models.ssm`), which its cost model therefore does
    not price."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.by_kind: dict = {}
        self.by_axis: dict = {}
        self.extra_link_bytes = 0.0
        self.ranks = 0

    def add(self, kind: str, buffer_bytes: float, group: int, *,
            axis: str = "model", extra: bool = False) -> None:
        """One ``kind`` collective over the ``group`` ranks of mesh axis
        ``axis``, of a ``buffer_bytes`` buffer a device; a group of one
        moves nothing and is not counted."""
        if group <= 1:
            return
        link = _LINK[kind](float(buffer_bytes), group)
        row = self.by_kind.setdefault(kind, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += float(buffer_bytes)
        row[2] += link
        self.by_axis[axis] = self.by_axis.get(axis, 0.0) + link
        if extra:
            self.extra_link_bytes += link

    def per_device(self) -> tuple[dict, dict]:
        """One device's share: ``({kind: {"count", "buffer_bytes",
        "link_bytes"}}, {axis: link bytes})``."""
        n = max(self.ranks, 1)
        return ({k: {"count": c / n, "buffer_bytes": b / n,
                     "link_bytes": l / n}
                 for k, (c, b, l) in sorted(self.by_kind.items())},
                {a: v / n for a, v in sorted(self.by_axis.items())})


def _nbytes(t: torch.Tensor, itemsize: int | None = None) -> int:
    return t.numel() * (itemsize or t.element_size())


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """The reference's mesh-axis context on one device.  The data and pod
    axes are simulated (their ranks run one after another), so they emit
    no collective here; the runtime reads ``dp`` and ``pods`` to shard the
    batch.  The model axis is simulated inside each layer: its ranks' local
    bodies run in turn and meet at the reductions below, each over a list
    of the ``tp`` ranks' values in rank order (one value is returned as it
    is: tp=1 emits nothing, as the reference's absent axis)."""

    tp: int = 1
    dp: int = 1
    pods: int = 1
    attn_impl: str = "auto"  # "naive" | "scan" | "auto" (CPU tensors only)
    attn_block: int = 512  # kv block of the scan implementation
    # compute the LM-head cross-entropy in sequence blocks of this many
    # positions (fp32 logits live range / n_blocks); 0 disables
    xent_block: int = 0
    # MoE routing groups: False routes a call's [B, S] tokens together
    # (the reference's moe_fwd, training); True routes each batch row on
    # its own (the compiled serving round's independent slots)
    moe_per_row: bool = False
    # checkpoint each step of the inner sequence scans (Mamba2's SSD
    # chunks, mLSTM's chunks, sLSTM's time steps), so their backward
    # recomputes a step's intermediates instead of keeping them
    inner_remat: bool = False
    # the MoE combines each rank's expert outputs into [T, d] before the
    # model-axis psum instead of summing the [E, C, d] buffers first
    moe_combine_first: bool = False
    # the collectives performed so far, shared by every ctx replaced from
    # this one (the runtime's row ctx too)
    counter: CollectiveCounter = dataclasses.field(
        default_factory=CollectiveCounter, compare=False, repr=False)

    def psum_model(self, xs, *, extra: bool = False):
        """The reference's ``psum`` over the model axis: the fp32 sum of
        the ranks' values, rank 0 first.  Counted as an all-reduce of one
        rank's fp32 buffer; ``extra`` marks a reduction the reference does
        not make (:class:`CollectiveCounter`)."""
        xs = list(xs)
        if len(xs) == 1:
            return xs[0]
        self.counter.add("all-reduce", _nbytes(xs[0], 4), len(xs),
                         extra=extra)
        out = xs[0].float()
        for x in xs[1:]:
            out = out + x.float()
        return out

    def pmax_model(self, xs):
        """The reference's ``pmax`` over the model axis (counted as an
        all-reduce)."""
        xs = list(xs)
        if len(xs) > 1:
            self.counter.add("all-reduce", _nbytes(xs[0]), len(xs))
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out

    def pmin(self, xs):
        """The reference's ``-pmax(-x)`` over the model axis (counted as
        an all-reduce)."""
        xs = list(xs)
        if len(xs) > 1:
            self.counter.add("all-reduce", _nbytes(xs[0]), len(xs))
        out = xs[0]
        for x in xs[1:]:
            out = torch.minimum(out, x)
        return out

    def all_gather(self, xs, dim: int):
        """The reference's tiled ``all_gather``: the ranks' values
        concatenated along ``dim`` in rank order."""
        xs = list(xs)
        if len(xs) == 1:
            return xs[0]
        self.counter.add("all-gather", len(xs) * _nbytes(xs[0]), len(xs))
        return torch.cat(xs, dim=dim)


# ---------------------------------------------------------------------------
# initializers / numerics helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32):
    std = 1.0 / math.sqrt(max(shape[in_axis], 1))
    return (torch.randn(shape, generator=gen) * std).to(dtype)


def matmul(x, w, ctx_dtype=None):
    """``x @ w`` accumulated in fp32, returned in ``ctx_dtype`` (default
    ``x.dtype``).  Same-dtype operands run natively (fp32 accumulate);
    mixed operands promote to fp32 first, as JAX does."""
    out = ctx_dtype or x.dtype
    if x.dtype == w.dtype == out:
        return x @ w
    return (x.float() @ w.float()).to(out)


def rms_norm(x, weight, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def squared_relu(x):
    r = torch.relu(x)
    return r * r


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": squared_relu,
    "relu": torch.relu,
}


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim//2]


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores (pure math on [B, S, H, Dh] tensors)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _visible(sq, sk, device, *, causal, window, q_offset, kv_len):
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    return mask


def naive_attention(q, k, v, *, causal: bool, window: int | None = None,
                    q_offset: int = 0, kv_len: int | None = None,
                    scale: float | None = None):
    """Reference attention. q: [B,Sq,H,D], k/v: [B,Sk,KV,D] (KV divides H).
    Probabilities are rounded to ``q.dtype`` before the PV product, as in
    the reference."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _visible(sq, sk, q.device, causal=causal, window=window,
                    q_offset=q_offset, kv_len=kv_len)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def scan_attention(q, k, v, *, causal: bool, window: int | None = None,
                   q_offset: int = 0, kv_len: int | None = None,
                   scale: float | None = None, block: int = 512):
    """Online-softmax (flash-style) attention as a loop over KV blocks,
    probabilities kept in fp32 — the reference's scan twin."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // kvh
    nblk = -(-sk // block)
    pad = nblk * block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = torch.arange(sq, device=q.device) + q_offset
    q32 = q.float() * scale
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        if rep != 1:
            kblk = kblk.repeat_interleave(rep, dim=2)
            vblk = vblk.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kblk.float())
        kpos = i * block + torch.arange(block, device=q.device)
        mask = kpos[None, :] < (sk if kv_len is None else kv_len)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > (qpos[:, None] - window))
        logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vblk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_core(q, k, v, ctx: AxisCtx, **kw):
    """The kernel for a CUDA tensor (its shapes for a meta one, which is
    what the dry-run traces); on the CPU the reference's choice."""
    if q.device.type in ("cuda", "meta"):
        return ops.flash_attention(q, k, v, **kw)
    impl = ctx.attn_impl
    if impl == "auto":
        impl = "scan" if (k.shape[1] > 2048 or q.shape[1] > 2048) else "naive"
    if impl == "scan":
        return scan_attention(q, k, v, block=ctx.attn_block, **kw)
    return naive_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# GQA attention block (column/row parallel over the model axis)
# ---------------------------------------------------------------------------


def gqa_shapes(d_model: int, n_heads: int, n_kv: int, head_dim: int,
               tp: int):
    """TP-local head counts (the reference's): query heads divide over tp;
    kv heads divide when they can and are replicated otherwise; when even
    the query heads do not divide, the whole attention block is
    replicated (no out-psum, every param's tp axis None).  -> (h_local,
    kv_local, replicated)."""
    if n_heads % tp != 0:
        return n_heads, n_kv, True
    return n_heads // tp, (n_kv // tp if n_kv % tp == 0 else n_kv), False


def _gqa(cfg, tp: int):
    return gqa_shapes(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, tp)


def attention_tp_axes(cfg, tp: int = 1) -> dict:
    """Which axis of each attention param is TP-sharded (None =
    replicated): wq/wo by heads, wk/wv by kv heads unless they do not
    divide tp."""
    replicated = _gqa(cfg, tp)[2]
    kv_repl = replicated or (tp > 1 and cfg.n_kv_heads % tp != 0)
    if replicated:
        axes = {"wq": None, "wk": None, "wv": None, "wo": None}
    else:
        axes = {"wq": 1, "wk": None if kv_repl else 1,
                "wv": None if kv_repl else 1, "wo": 0}
    if getattr(cfg, "qkv_bias", False):
        axes.update({"bq": None if replicated else 0,
                     "bk": None if kv_repl else 0,
                     "bv": None if kv_repl else 0})
    if getattr(cfg, "qk_norm", False):
        axes.update({"q_norm": None, "k_norm": None})
    return axes


def init_attention(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qk_norm,
    qkv_bias.  Every leaf at its tp-local shape."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv, _ = _gqa(cfg, tp)
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=dtype),
        "wk": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wv": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wo": dense_init(gen, (h * hd, d), dtype=dtype),
    }
    if getattr(cfg, "qkv_bias", False):
        p["bq"] = torch.zeros((h * hd,), dtype=dtype)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype)
    if getattr(cfg, "qk_norm", False):
        p["q_norm"] = torch.ones((hd,), dtype=dtype)
        p["k_norm"] = torch.ones((hd,), dtype=dtype)
    return p


def _rope(cfg, t, positions):
    if getattr(cfg, "use_rope", True):
        return apply_rope(t, positions, getattr(cfg, "rope_theta", 10000.0))
    return t


def _project_q(p, x, cfg, ctx: AxisCtx, positions):
    """One rank's queries [B, S, h_local, hd]."""
    b, s, _ = x.shape
    q = matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, -1, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    return _rope(cfg, q, positions)


def _project_kv(p, x, cfg, ctx: AxisCtx, positions):
    """One rank's keys and values [B, S, kv_local, hd]."""
    b, s, _ = x.shape
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"])
    return _rope(cfg, k, positions), v


def _project_qkv(p, x, cfg, ctx: AxisCtx, positions):
    q = _project_q(p, x, cfg, ctx, positions)
    return (q,) + _project_kv(p, x, cfg, ctx, positions)


def _positions(b, s, device):
    return torch.arange(s, device=device).expand(b, s)


def _kv_heads(cfg, tp: int, rank: int):
    """The kv heads rank ``rank``'s local query heads read, where kv heads
    are replicated but query heads sharded (the reference's
    ``_align_kv``: local q head i reads kv head ``(global_q * KV) // H``,
    not i): ``("narrow", first, n)`` when they are whole consecutive GQA
    groups (K2 then keeps its GQA ratio), else ``("take", ids)``; None
    where every local kv head pairs with its own q heads."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    h_l, _, replicated = _gqa(cfg, tp)
    if tp <= 1 or replicated or KV % tp == 0:
        return None
    ids = [((rank * h_l + i) * KV) // H for i in range(h_l)]
    uniq = list(range(ids[0], ids[-1] + 1))
    rep = h_l // len(uniq)
    if rep * len(uniq) == h_l and ids == [u for u in uniq for _ in
                                          range(rep)]:
        return ("narrow", uniq[0], len(uniq))
    return ("take", ids)


def _align_kv(k, v, cfg, ctx: AxisCtx, rank: int):
    sel = _kv_heads(cfg, ctx.tp, rank)
    if sel is None:
        return k, v
    if sel[0] == "narrow":  # K2 reads contiguous k/v
        return (k.narrow(2, sel[1], sel[2]).contiguous(),
                v.narrow(2, sel[1], sel[2]).contiguous())
    ids = torch.tensor(sel[1], device=k.device)
    return k.index_select(2, ids), v.index_select(2, ids)


def _attend_ranks(p, x, cfg, ctx: AxisCtx, positions, causal: bool):
    """Each model rank's local attention over the full sequence, then the
    out-projection psum (one pass when the block is replicated): (y in
    x's dtype, the ranks' [(k, v)] before alignment, for the cache)."""
    b, s, _ = x.shape
    window = getattr(cfg, "sliding_window", None)
    n = 1 if _gqa(cfg, ctx.tp)[2] else ctx.tp
    # one rank rounds the fp32 product to x's dtype at once; several
    # psum it in fp32 first, as the reference does
    out_dtype = x.dtype if n == 1 else torch.float32
    ys, kvs = [], []
    for r in range(n):
        pr = rank_view(p, r)
        q, k, v = _project_qkv(pr, x, cfg, ctx, positions)
        ka, va = _align_kv(k, v, cfg, ctx, r)
        out = attention_core(q, ka, va, ctx, causal=causal, window=window)
        ys.append(matmul(out.reshape(b, s, -1), pr["wo"], out_dtype))
        kvs.append((k, v))
    return ctx.psum_model(ys).to(x.dtype), kvs * (ctx.tp // n)


def attention_fwd(p, x, cfg, ctx: AxisCtx, *, positions=None, causal=True):
    """Full-sequence attention (training / prefill). x: [B, S, d]."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    return _attend_ranks(p, x, cfg, ctx, positions, causal)[0]


def attention_prefill(p, x, cfg, ctx: AxisCtx, *, positions=None):
    """Prefill returning the output and the KV cache (per rank, in the
    layout of :func:`decode_cache_plan`)."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    y, kvs = _attend_ranks(p, x, cfg, ctx, positions, True)
    return y, ranks_tree([_prefill_cache(k, v, s, cfg, ctx, r)
                          for r, (k, v) in enumerate(kvs)])


def _window_ring(k, s: int, window: int):
    """The last ``window`` rows of a prompt of ``s`` as the decode ring
    holds them: position ``pos`` at slot ``pos % window``, so slot i holds
    ``last[(i - s) mod window]``."""
    perm = torch.remainder(torch.arange(window, device=k.device) - s,
                           window)
    return k[:, s - window:].index_select(1, perm)


def _prefill_cache(k, v, s, cfg, ctx: AxisCtx, rank: int = 0):
    """Rank ``rank``'s cache of the freshly computed K/V.  "tp" mode: its
    own kv heads, every position (with a window shorter than the prompt,
    the last ``window`` rows in ring order).  "dist" mode (k holds every
    kv head: wk/wv are replicated): its kv group's heads and its strided
    slots ``seq_idx, seq_idx + shards, ...`` of the prompt (or of the
    window's ring), padded to whole chunks."""
    mode, kv_l, seq_shards = decode_cache_plan(cfg, ctx.tp)
    window = getattr(cfg, "sliding_window", None)
    if mode == "tp":
        if window and s > window:
            k, v = _window_ring(k, s, window), _window_ring(v, s, window)
        return {"k": k, "v": v}
    kv_grp, seq_idx = divmod(rank, seq_shards)
    k_my = k[:, :, kv_grp * kv_l:(kv_grp + 1) * kv_l]
    v_my = v[:, :, kv_grp * kv_l:(kv_grp + 1) * kv_l]
    ring = min(s, window) if window else s
    if window and s > window:
        k_my, v_my = _window_ring(k_my, s, ring), _window_ring(v_my, s, ring)
    c_l = -(-ring // seq_shards)
    pad = c_l * seq_shards - ring
    if pad:
        k_my = F.pad(k_my, (0, 0, 0, 0, 0, pad))
        v_my = F.pad(v_my, (0, 0, 0, 0, 0, pad))
    return {"k": k_my[:, seq_idx::seq_shards].contiguous(),
            "v": v_my[:, seq_idx::seq_shards].contiguous()}


def decode_cache_plan(cfg, tp: int):
    """How the decode KV cache distributes over the model axis (the
    reference's).  -> (mode, kv_local, seq_shards):

      "tp":   kv heads divide tp (or tp=1): each rank caches its kv/tp
              heads over the whole sequence.
      "dist": kv heads do not divide tp.  Replicating the cache would cost
              tp times its size, so it shards over g = gcd(kv, tp) kv-head
              groups x tp/g sequence chunks: rank r holds kv/g heads of
              group r // (tp/g) and the strided slots of chunk r % (tp/g);
              decode combines the ranks' partial softmaxes with an
              exp-weighted sum (:func:`_attention_decode_dist`).
    """
    kv = cfg.n_kv_heads
    if tp <= 1 or kv % tp == 0:
        return "tp", max(kv // max(tp, 1), 1) if tp > 1 else kv, 1
    g = math.gcd(kv, tp)
    return "dist", kv // g, tp // g


def attention_init_cache(cfg, batch: int, max_len: int, tp: int, dtype,
                         device=None) -> dict:
    """One rank's zero cache: [B, C, KV_local, hd], C the window's ring or
    the horizon, divided into the sequence chunks of the "dist" plan."""
    window = getattr(cfg, "sliding_window", None)
    cache_len = min(max_len, window) if window else max_len
    mode, kv_l, seq_shards = decode_cache_plan(cfg, tp)
    if mode == "tp":
        kv_l = _gqa(cfg, tp)[1]
    shape = (batch, -(-cache_len // seq_shards), kv_l, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x, cache, pos, cfg, ctx: AxisCtx):
    """Single-token decode. x: [B, 1, d]; cache k/v: [B, C, KV, hd] (C
    covers the window for sliding-window attention, else the horizon), a
    :class:`~repro_torch.models.tp.Ranks` of the ranks' caches at tp > 1.

    ``pos`` is either the int position every row writes — the eager
    engine's call, which returns a new cache (the inputs are not
    modified) — or a [B] integer tensor on x's device, one position a row
    — the compiled round's slots, each decoding from its own position.
    That path writes row b's k/v at slot ``pos[b] % C`` into ``cache`` in
    place (the persistent slot cache; the reference donates it) and
    returns ``cache`` itself; it reads no device value on the host, so a
    CUDA graph can capture it.  Position ``pos`` goes to slot ``pos % C``
    either way (the ring; without a window ``pos < C``).  In the "tp" plan
    each rank attends over its own heads (K2's split-kv kernel on a card)
    and the out projections psum; the "dist" plan is
    :func:`_attention_decode_dist`."""
    mode, kv_l, seq_shards = decode_cache_plan(cfg, ctx.tp)
    if mode == "dist":
        return _attention_decode_dist(p, x, cache, pos, cfg, ctx, kv_l,
                                      seq_shards)
    out_dtype = x.dtype if ctx.tp == 1 else torch.float32
    ys, caches = [], []
    for r in range(ctx.tp):
        y, c = _decode_rank(rank_view(p, r), x, rank_view(cache, r), pos,
                            cfg, ctx, out_dtype)
        ys.append(y)
        caches.append(c)
    return ctx.psum_model(ys).to(x.dtype), ranks_tree(caches)


def _decode_rank(p, x, cache, pos, cfg, ctx: AxisCtx, out_dtype):
    """One rank's "tp"-plan decode: (its out projection in ``out_dtype``,
    its cache)."""
    b = x.shape[0]
    c = cache["k"].shape[1]
    if isinstance(pos, torch.Tensor):
        q, k, v = _project_qkv(p, x, cfg, ctx, pos[:, None])
        rows = torch.arange(b, device=x.device)
        slot = torch.remainder(pos, c)
        ck, cv = cache["k"], cache["v"]
        ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))
    else:
        positions = torch.full((b, 1), pos, dtype=torch.long,
                               device=x.device)
        q, k, v = _project_qkv(p, x, cfg, ctx, positions)
        slot = pos % c
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, slot:slot + 1] = k.to(ck.dtype)
        cv[:, slot:slot + 1] = v.to(cv.dtype)
    out = _decode_attend(q, ck, cv, pos)
    return matmul(out.reshape(b, 1, -1), p["wo"], out_dtype), {"k": ck,
                                                                 "v": cv}


def _dist_slot_validity(pos: int, cache_len_local: int, seq_idx: int,
                        window, seq_shards: int, device):
    """Which of a rank's strided cache slots hold a visible position:
    global slot ``j * seq_shards + seq_idx`` at local index j (a window's
    ring is the global slot array)."""
    gslot = (torch.arange(cache_len_local, device=device) * seq_shards
             + seq_idx)
    if window:
        ring = seq_shards * cache_len_local
        slot_pos = pos - torch.remainder(pos % ring - gslot, ring)
        return (slot_pos >= 0) & (slot_pos > pos - window)
    return gslot <= pos


def _attention_decode_dist(p, x, cache, pos, cfg, ctx: AxisCtx, kv_l: int,
                           seq_shards: int):
    """The "dist" plan's decode (the reference's ``_attention_decode_dist``):
    every rank scores its kv group's query heads (gathered from every
    rank) against its (kv-head group, sequence chunk) of the cache; the
    partial softmaxes, padded to all H heads at the group's range as the
    reference pads them, combine by an exp-weighted psum; each rank
    projects its own heads' slice.  The partial attention is the
    reference's own plain product (no Pallas kernel there), in fp32; the
    new token's k/v come from the replicated wk/wv once.  Only the
    eager decode's int ``pos``: the compiled serving round runs at tp=1."""
    if isinstance(pos, torch.Tensor):
        raise NotImplementedError(
            "per-row positions need the \"tp\" cache plan: the compiled "
            "serving round runs at tp=1, as the reference's")
    b = x.shape[0]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h_l, _, replicated = _gqa(cfg, ctx.tp)
    g = KV // kv_l
    hg = H // g
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    # 1. every query head on every rank
    q_full = ctx.all_gather(
        [_project_q(rank_view(p, r), x, cfg, ctx, positions)
         for r in range(1 if replicated else ctx.tp)], dim=2)
    k, v = _project_kv(p if replicated else rank_view(p, 0), x, cfg, ctx,
                       positions)
    window = getattr(cfg, "sliding_window", None)
    ms, ls, accs, caches = [], [], [], []
    for r in range(ctx.tp):
        kv_grp, seq_idx = divmod(r, seq_shards)
        cr = rank_view(cache, r)
        c_l = cr["k"].shape[1]
        gslot = pos % (seq_shards * c_l) if window else pos
        ck, cv = cr["k"].clone(), cr["v"].clone()
        # 2. the new token into its owner's chunk (strided ownership)
        if gslot % seq_shards == seq_idx:
            heads = slice(kv_grp * kv_l, (kv_grp + 1) * kv_l)
            ck[:, gslot // seq_shards] = k[:, 0, heads].to(ck.dtype)
            cv[:, gslot // seq_shards] = v[:, 0, heads].to(cv.dtype)
        caches.append({"k": ck, "v": cv})
        # 3. the partial attention of the group's heads over the chunk
        q_grp = q_full[:, :, kv_grp * hg:(kv_grp + 1) * hg]
        kk, vv = ck, cv
        if kv_l != hg:
            kk = kk.repeat_interleave(hg // kv_l, dim=2)
            vv = vv.repeat_interleave(hg // kv_l, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q_grp.float(),
                              kk.float()) / math.sqrt(hd)
        valid = _dist_slot_validity(pos, c_l, seq_idx, window, seq_shards,
                                    x.device)
        logits = torch.where(valid, logits, NEG_INF)
        m_loc = logits.amax(dim=-1)  # [B, hg, 1]
        w = torch.exp(logits - m_loc[..., None])
        l_loc = w.sum(dim=-1)
        acc = torch.einsum("bhqk,bkhd->bhqd", w, vv.float())

        def pad_heads(t, _g=kv_grp):
            z = t.new_zeros(t.shape[:1] + (H,) + t.shape[2:])
            z[:, _g * hg:(_g + 1) * hg] = t
            return z
        ms.append(pad_heads(torch.where(l_loc > 0, m_loc, NEG_INF)))
        ls.append(pad_heads(l_loc))
        accs.append(pad_heads(acc))
    # 4. the exp-weighted combine across the ranks
    m_star = ctx.pmax_model(ms)
    scales = [torch.exp(m - m_star) for m in ms]
    l_comb = ctx.psum_model([l * sc for l, sc in zip(ls, scales)])
    acc_comb = ctx.psum_model([a * sc[..., None]
                               for a, sc in zip(accs, scales)])
    out_full = acc_comb / torch.clamp(l_comb[..., None], min=1e-30)
    # 5. each rank's heads through its wo slice, psummed
    if replicated:
        out = out_full.permute(0, 2, 1, 3).reshape(b, 1, H * hd)
        y = matmul(out.to(x.dtype), p["wo"], torch.float32)
    else:
        y = ctx.psum_model([
            matmul(out_full[:, r * h_l:(r + 1) * h_l].permute(0, 2, 1, 3)
                   .reshape(b, 1, h_l * hd).to(x.dtype),
                   rank_view(p, r)["wo"], torch.float32)
            for r in range(ctx.tp)])
    return y.to(x.dtype), ranks_tree(caches)


def _decode_attend(q, k, v, pos):
    """q: [B,1,H,D]; k/v: [B,C,KV,D]; the first ``min(pos + 1, C)``
    cache slots are valid (``pos``: an int, or [B] integers, one a row):
    the positions up to ``pos``, or, once a window's ring has wrapped,
    every slot, each holding one of the last C positions.  On a CUDA
    tensor the kernel stops at ``kv_len``, or, per row, at ``kv_lens``
    read from the card over the whole ring; on the CPU this is the
    reference's masked softmax, probabilities rounded to ``q.dtype``."""
    per_row = isinstance(pos, torch.Tensor)
    c = k.shape[1]
    if q.device.type in ("cuda", "meta"):
        if per_row:
            return ops.flash_attention(
                q, k, v, causal=False,
                kv_lens=torch.clamp(pos + 1, max=c).to(torch.int32))
        return ops.flash_attention(q, k, v, causal=True, q_offset=pos,
                                   kv_len=min(pos + 1, c))
    h, d = q.shape[2], q.shape[3]
    if k.shape[2] != h:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(d)
    kpos = torch.arange(c, device=q.device)
    valid = kpos < (torch.clamp(pos.reshape(-1, 1, 1, 1) + 1, max=c)
                    if per_row else min(pos + 1, c))
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (gated / plain), column + row parallel
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if f % tp != 0:
        raise ValueError(f"d_ff={f} not divisible by tp={tp}")
    f = f // tp
    p = {"w_up": dense_init(gen, (d, f), dtype=dtype),
         "w_down": dense_init(gen, (f, d), dtype=dtype)}
    if getattr(cfg, "gated_mlp", True):
        p["w_gate"] = dense_init(gen, (d, f), dtype=dtype)
    return p


def mlp_tp_axes(cfg) -> dict:
    axes = {"w_up": 1, "w_down": 0}
    if getattr(cfg, "gated_mlp", True):
        axes["w_gate"] = 1
    return axes


def mlp_fwd(p, x, cfg, ctx: AxisCtx):
    """Each rank's slice of d_ff, then the down projections' fp32 psum and
    one cast (tp=1: the product rounded to x's dtype at once)."""
    act = ACTIVATIONS[getattr(cfg, "activation", "silu")]
    out_dtype = x.dtype if ctx.tp == 1 else torch.float32
    ys = []
    for r in range(ctx.tp):
        pr = rank_view(p, r)
        up = matmul(x, pr["w_up"])
        if "w_gate" in pr:
            h = act(matmul(x, pr["w_gate"])) * up
        else:
            h = act(up)
        ys.append(matmul(h, pr["w_down"], out_dtype))
    return ctx.psum_model(ys).to(x.dtype)


# ---------------------------------------------------------------------------
# vocab-parallel embedding / head / loss / greedy sampling
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, tp: int = 1,
                   dtype=torch.float32) -> dict:
    """The rank's ``ceil(vocab / tp)`` rows of the table (the last rank's
    past ``vocab`` are padding)."""
    return {"table": dense_init(gen, (-(-vocab // tp), d_model), in_axis=1,
                                dtype=dtype)}


def embedding_tp_axes() -> dict:
    return {"table": 0}


def embed_lookup(p, ids, vocab: int, ctx: AxisCtx):
    """Vocab-parallel lookup: each rank's rows of its own ids (zeros for
    the others), the fp32 psum, then one cast to the table's dtype (tp=1:
    the whole vocab is local and the lookup is the result)."""
    tables = shards(p["table"])
    vl = tables[0].shape[0]
    parts = []
    for r, table in enumerate(tables):
        if len(tables) == 1:
            parts.append(table[ids])
            continue
        local = ids - r * vl
        ok = (local >= 0) & (local < vl)
        emb = table[torch.where(ok, local, 0)]
        parts.append(torch.where(ok[..., None], emb.float(), 0.0))
    return ctx.psum_model(parts).to(tables[0].dtype)


# a low-precision head table above this many elements is cast to fp32
# this many elements at a time (vocab rows): nemotron-4-340b's 256000 x
# 18432 bf16 table alone would take 18.9 GB as one fp32 copy beside a
# card's model; every smaller head casts whole, as the reference writes it
HEAD_CAST_BLOCK = 1 << 28


def _head(table, x):
    if table.dtype == torch.float32 or table.numel() <= 4 * HEAD_CAST_BLOCK:
        return x.float() @ table.float().T
    rows = max(1, HEAD_CAST_BLOCK // table.shape[1])
    x32 = x.float()
    return torch.cat([x32 @ table[i:i + rows].float().T
                      for i in range(0, table.shape[0], rows)], dim=-1)


def lm_logits_local(p, x, ctx: AxisCtx):
    """Tied head: x @ table^T -> fp32 logits over each rank's local vocab
    (a :class:`~repro_torch.models.tp.Ranks` at tp > 1).  Each logit is
    the same fp32 dot product either way; a table past
    ``4 * HEAD_CAST_BLOCK`` elements is cast a block of rows at a time."""
    return Ranks.of(_head(t, x) for t in shards(p["table"]))


def vocab_parallel_xent(local_logits, labels, vocab: int, ctx: AxisCtx, *,
                        mask=None):
    """Per-position cross-entropy over vocab-sharded fp32 logits ([...,
    V_local] a rank, as :func:`lm_logits_local` gives them) without
    gathering them.  labels: [...] integer ids (global).  As in the
    reference, the max shift is a stop-gradient (a constant of the
    log-sum-exp) taken over every rank, padded vocab rows past ``vocab``
    never win, and the target logit is the psum of the one rank's pick
    that holds the label (0 where none does).

    Written to hold at most two logits-sized buffers a rank under
    autograd: the shifted scores are exponentiated in place, and the
    target logit is picked by indexing (whose backward keeps no copy of
    the logits)."""
    parts = shards(local_logits)
    vocab_l = parts[0].shape[-1]
    logits, maxes, picks = [], [], []
    for r, ll in enumerate(parts):
        start = r * vocab_l
        if start + vocab_l > vocab:
            gid = torch.arange(start, start + vocab_l, device=ll.device)
            ll = torch.where(gid < vocab, ll, NEG_INF)
        logits.append(ll)
        maxes.append(ll.detach().amax(dim=-1))
        local = labels - start
        in_range = (local >= 0) & (local < vocab_l)
        safe = torch.where(in_range, local, 0).long().reshape(-1)
        flat = ll.reshape(-1, vocab_l)
        rows = torch.arange(flat.shape[0], device=flat.device)
        picked = flat[rows, safe].reshape(labels.shape)
        picks.append(torch.where(in_range, picked, 0.0))
    gmax = ctx.pmax_model(maxes)  # max shift only
    z = ctx.psum_model([(ll - gmax[..., None]).exp_().sum(dim=-1)
                        for ll in logits])
    loss = torch.log(z) + gmax - ctx.psum_model(picks)
    if mask is not None:
        loss = loss * mask
    return loss


def _xent_block_sum(table_p, x, labels, mask, vocab: int, ctx: AxisCtx):
    logits = lm_logits_local(table_p, x, ctx)
    return vocab_parallel_xent(logits, labels, vocab, ctx, mask=mask).sum()


def blockwise_xent_sum(table_p, x, labels, vocab: int, ctx: AxisCtx,
                       block: int, mask=None):
    """Sum of the cross-entropy over [B,S] positions, computed in sequence
    blocks of ``block`` positions so the fp32 [tokens, V] logits never
    materialise whole (the reference's ``blockwise_xent_sum``): each
    block's body is checkpointed, so its logits are recomputed in the
    backward instead of saved."""
    from torch.utils.checkpoint import checkpoint

    b, s, _ = x.shape
    nb = -(-s // block)
    pad = nb * block - s
    pm = (torch.ones((b, s), dtype=torch.float32, device=x.device)
          if mask is None else mask)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        pm = F.pad(pm, (0, pad))
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nb):
        blk = slice(i * block, (i + 1) * block)
        acc = acc + checkpoint(_xent_block_sum, table_p, x[:, blk],
                               labels[:, blk], pm[:, blk], vocab, ctx,
                               use_reentrant=False)
    return acc


def greedy_token(local_logits, vocab: int, ctx: AxisCtx):
    """Argmax over the vocab of [B,1,V_local] logits a rank -> [B] int64
    token ids.

    Ties break toward the lowest token id by an explicit rule (the
    reference's: the max over every rank first, then the lowest global id
    among the ranks that reach it), not by whatever a backend's argmax
    does; ids at or past ``vocab`` (padding rows) never win.  Device ops
    only: no host read, so a CUDA graph can capture it."""
    parts = shards(local_logits)
    vl = parts[0].shape[-1]
    maxes, cands = [], []
    for r, ll in enumerate(parts):
        gid = torch.arange(r * vl, (r + 1) * vl, device=ll.device)
        ll = torch.where(gid < vocab, ll, -torch.inf)
        lmax = ll.amax(dim=-1, keepdim=True)
        maxes.append(lmax[..., 0])
        cands.append(torch.where(ll >= lmax, gid, vocab + 1).amin(dim=-1))
    gmax = ctx.pmax_model(maxes)
    return ctx.pmin([torch.where(m >= gmax, c, vocab + 1)
                     for m, c in zip(maxes, cands)])[..., 0]
