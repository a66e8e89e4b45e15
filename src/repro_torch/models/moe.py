"""Mixture-of-Experts layer of the port (``repro.models.moe`` twin):
mixtral-8x7b's and deepseek-v2-lite's top-k routed expert FFN.

Routing is GShard-style capacity-based token dropping, computed with
index gathers instead of an ``[T, E, C]`` one-hot product: per-expert
slot positions come from a cumulative count (token-major priority),
tokens are gathered into an ``[E, C, d]`` dispatch buffer, the expert
FFNs run as batched matrix products over E, and the outputs are gathered
back per (token, k) and combined with the router probabilities in fp32.
Gradients flow through the gathers (their transpose is a scatter-add).

**Groups.**  Expert capacity, ``max(int(t * k * cf / E), 4)``, depends on
how many tokens ``t`` the call routes, so packing sequences into one call
can push an expert past the capacity a call of one sequence would have
had and drop a token.  :func:`moe_fwd` therefore routes in groups: with
``ctx.moe_per_row`` every batch row (one sequence) is a group with its
own capacity and its own dispatch, and the expert products still run
once over every group's slots (``[E, G * C, d]``).  One group (the
default) is the reference's ``moe_fwd`` over the whole ``[B, S, d]``
batch, as training uses it; G groups equal G separate reference calls,
what the reference's ``vmap`` lanes compute in its compiled serving round.
Every op is a fixed-shape ``cumsum``, scatter or gather: nothing reads a
device value on the host, so a CUDA graph can capture it.

**Parallel layouts** (``cfg.moe_impl``, the reference's), on the
simulated model axis of :mod:`repro_torch.models.tp`:

  "tp"  each rank holds a 1/tp slice of every expert's width (d_ff_expert:
        w_gate/w_up axis 2, w_down axis 1); every rank runs all experts'
        slots on its slice, and the partial outputs psum.
  "ep"  each rank holds E/tp whole experts (axis 0, ``E % tp == 0``) and
        runs only their slots; the other experts' rows of its [E, C, d]
        buffer are zero, and the psum assembles the experts.

The router is replicated, so routing, the aux loss and the dispatch run
once (the reference's ``psum(aux) / tp`` of tp equal values is that
value).  ``ctx.moe_combine_first`` moves the psum: False sums the ranks'
[E, C, d] expert buffers, then combines them into [T, d]; True combines
each rank's buffer into [T, d] first and sums those (the reference's
smaller collective payload), the same sum in another order.  The shared
experts are a sharded MLP beside the routed ones (its own psum).  At tp=1
the two layouts hold the same shapes and there is nothing to sum.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import AxisCtx
from repro_torch.models.tp import rank_view


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_moe_mlp(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    if cfg.moe_impl not in ("tp", "ep"):
        raise ValueError(f"moe_impl={cfg.moe_impl!r}")
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    if cfg.moe_impl == "ep":
        if e % tp != 0:
            raise ValueError(
                f"moe_impl=ep needs n_experts % tp == 0 ({e} % {tp})")
        e = e // tp
    else:
        if f % tp != 0:
            raise ValueError(f"d_ff_expert={f} not divisible by tp={tp}")
        f = f // tp
    p = {
        "router": L.dense_init(gen, (d, cfg.n_experts),
                               dtype=torch.float32),  # fp32
        "w_gate": L.dense_init(gen, (e, d, f), in_axis=1, dtype=dtype),
        "w_up": L.dense_init(gen, (e, d, f), in_axis=1, dtype=dtype),
        "w_down": L.dense_init(gen, (e, f, d), in_axis=1, dtype=dtype),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = L.init_mlp(gen, _shared_cfg(cfg), tp, dtype)
    return p


def _shared_cfg(cfg):
    return cfg.replace(d_ff=cfg.d_ff_expert * cfg.n_shared_experts)


def moe_tp_axes(cfg) -> dict:
    """Which axis of each MoE param the model axis shards: the experts
    ("ep") or their width ("tp"); the router is replicated."""
    if cfg.moe_impl == "ep":
        axes = {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0}
    else:
        axes = {"router": None, "w_gate": 2, "w_up": 2, "w_down": 1}
    if cfg.n_shared_experts > 0:
        axes["shared"] = L.mlp_tp_axes(cfg)
    return axes


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _top_k(x, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    descending order, ties broken toward the lower index (``jax.lax.top_k``'s
    rule; ``torch.topk`` does not promise one)."""
    n = x.shape[-1]
    ids = torch.arange(n, device=x.device)
    vals, idx = [], []
    for _ in range(k):
        top = x.amax(dim=-1, keepdim=True)
        j = torch.where(x >= top, ids, n).amin(dim=-1, keepdim=True)
        vals.append(top)
        idx.append(j)
        x = x.masked_fill(ids == j, -torch.inf)
    return torch.cat(vals, -1), torch.cat(idx, -1)


def route_topk(x, router_w, cfg):
    """-> (probs [..., T, K], expert_idx [..., T, K], aux loss [...]).
    x: [..., T, d]; leading axes are independent groups (the aux loss is
    one per group: its means run over each group's tokens)."""
    logits = x.float() @ router_w.float()
    probs_full = torch.softmax(logits, dim=-1)
    probs, idx = _top_k(probs_full, cfg.top_k)
    if getattr(cfg, "router_norm_topk", True):
        probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch/GShard style)
    e = cfg.n_experts
    me = probs_full.mean(dim=-2)  # mean router prob per expert
    ce = torch.nn.functional.one_hot(idx[..., 0], e).float().mean(dim=-2)
    aux = e * (me * ce).sum(-1) * cfg.router_aux_coef
    return probs, idx, aux


def dispatch_indices(expert_idx, n_experts: int, capacity: int):
    """Per-assignment slot positions and the ``[E*C]`` token map.

    expert_idx: [..., T, K] (leading axes: independent groups).  Returns
    (pos_in_expert [..., T, K], keep [..., T, K] bool, slot_to_token
    [..., E*C] int64 with T as the "no token" sentinel).  Priority is
    token-major: assignment (t, k) takes the next slot of its expert after
    every (t', k') with t' < t, or t' = t and k' < k."""
    *lead, t, k = expert_idx.shape
    flat_e = expert_idx.reshape(*lead, t * k)
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)  # [..., TK, E]
    pos = torch.cumsum(onehot, dim=-2) - onehot  # earlier same-expert count
    pos = (pos * onehot).sum(-1)  # [..., TK]
    keep = pos < capacity
    slot = flat_e * capacity + torch.clamp(pos, max=capacity - 1)
    token_of = torch.arange(t, device=expert_idx.device).repeat_interleave(k)
    token_of = token_of.expand_as(flat_e)
    # a dropped assignment writes to one spare slot past the end, cut off
    n = n_experts * capacity
    slot_or_spare = torch.where(keep, slot, n)
    slot_to_token = torch.full((*lead, n + 1), t, dtype=torch.long,
                               device=expert_idx.device)
    slot_to_token.scatter_(-1, slot_or_spare, token_of)
    return (pos.reshape(*lead, t, k), keep.reshape(*lead, t, k),
            slot_to_token[..., :n])


def _bmm(a, b):
    """A batched product accumulated in fp32: native when the operands
    share a dtype (the result in it), in fp32 when they do not (JAX's
    promotion), as :func:`repro_torch.models.layers.matmul`."""
    if a.dtype == b.dtype:
        return torch.bmm(a, b)
    return torch.bmm(a.float(), b.float())


def _expert_ffn(w_gate, w_up, w_down, xe, activation):
    """xe: [E, C', d] -> [E, C', d] fp32, the batched expert FFN.  The
    activation runs in fp32, ``h`` is rounded to the input's dtype."""
    act = L.ACTIVATIONS[activation]
    g = _bmm(xe, w_gate).float()
    u = _bmm(xe, w_up).float()
    h = (act(g) * u).to(xe.dtype)
    return _bmm(h, w_down).float()


def moe_fwd(p, x, cfg, ctx: AxisCtx):
    """x: [B, S, d] -> (y [B, S, d], aux loss).  One routing group, or,
    with ``ctx.moe_per_row``, one a batch row (module docstring); the aux
    loss is then the mean of the groups' (serving drops it)."""
    b, s, d = x.shape
    groups = b if ctx.moe_per_row else 1
    tg = b * s // groups
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(groups, tg, d)
    probs, idx, aux = route_topk(xt, p["router"], cfg)
    capacity = max(int(tg * k * cfg.capacity_factor / e), 4)
    pos, keep, slot_to_token = dispatch_indices(idx, e, capacity)

    # dispatch: every group's [E*C] token gather (sentinel row -> zeros),
    # then the groups' slots side by side under each expert: [E, G*C, d]
    x_pad = torch.cat([xt, xt.new_zeros(groups, 1, d)], dim=1)
    base = torch.arange(groups, device=x.device)[:, None] * (tg + 1)
    xd = x_pad.reshape(-1, d).index_select(0, (slot_to_token + base)
                                           .reshape(-1))
    xd = xd.reshape(groups, e, capacity, d).transpose(0, 1)
    xd = xd.reshape(e, groups * capacity, d)
    outs = []
    for r in range(ctx.tp):
        pr = rank_view(p, r)
        if cfg.moe_impl == "ep" and ctx.tp > 1:
            # my experts' slots; the others' rows stay zero
            e_l = e // ctx.tp
            out = xd.new_zeros(xd.shape, dtype=torch.float32)
            out[r * e_l:(r + 1) * e_l] = _expert_ffn(
                pr["w_gate"], pr["w_up"], pr["w_down"],
                xd[r * e_l:(r + 1) * e_l], cfg.activation)
        else:
            out = _expert_ffn(pr["w_gate"], pr["w_up"], pr["w_down"], xd,
                              cfg.activation)
        outs.append(out.reshape(e, groups, capacity, d).transpose(0, 1))

    # combine: each (token, k)'s slot output, weighted by its router prob
    flat_slot = idx * capacity + torch.clamp(pos, max=capacity - 1)
    gbase = torch.arange(groups, device=x.device)[:, None, None] * (
        e * capacity)

    def combine(out):
        picked = out.reshape(-1, d).index_select(0, (flat_slot + gbase)
                                                 .reshape(-1))
        picked = picked.reshape(groups, tg, k, d)
        picked = torch.where(keep[..., None], picked, 0.0)
        return torch.einsum("gtkd,gtk->gtd", picked, probs.float())

    if ctx.moe_combine_first and len(outs) > 1:
        y = ctx.psum_model([combine(o) for o in outs])
    else:
        y = combine(ctx.psum_model(outs))

    if "shared" in p:
        y = y + L.mlp_fwd(p["shared"], xt, _shared_cfg(cfg), ctx).float()
    return y.reshape(b, s, d).to(x.dtype), aux.mean()
