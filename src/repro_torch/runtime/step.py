"""The chunked-ZeRO training runtime of the port (``repro.runtime.step``
twin): the compiled counterpart of PatrickStar, run eagerly.

Array conventions (global shapes, as the reference's):

  param store (stem)    [tp, G, p, S]      the param dtype (bf16 by default)
  param store (group)   [tp, L, G, p, S]
  optimizer-state store the same layout in fp32, three of them (p32, m, v),
                        each split along G into a device part and a host
                        part (Section 8.2): separate contiguous tensors,
                        the host part in pinned CPU memory on a CUDA runtime

The reference runs its step under ``shard_map`` and ``jit``.  The port
simulates the ``p`` data ranks in one process on one device, one after
another, each on its shard of the batch: a rank's all-gather of a layer's
chunks is a view of the store (:func:`repro_torch.core.zero.gather_store`),
and the sum of the ranks' gradients, rank 0 first, is the reduce-scatter
(Algorithm 2).  Pods are further data ranks: the gradients sum over
``data`` within each pod, then over the pods (the reference's psum over
``pod``).  The ``tp`` model ranks are simulated inside each data rank's
forward (:mod:`repro_torch.models.tp`): a layer's params are its ranks'
``[G, p, S]`` shards, each its own autograd leaf, unflattened and merged
into one tree (sharded leaves per rank, replicated leaves rank 0's), and
one loss comes out of the ranks together, as the reference's step reports
it.  The gradient of each replicated leaf (rank 0's copy, which every
rank's branch read) is then written into every rank's gradient, and ADAM
updates each model rank's owned slices, so the copies stay bitwise
equal.  HOLD_AFTER_FWD is ``torch.utils.checkpoint`` around each
layer with the gather and unflatten inside it, so gathered params are not
saved and BWD re-gathers (Section 6.2).  ADAM runs on each rank's owned
slice (Section 7): on a CUDA runtime every update is K1, whose fused
output writes the updated params straight into the param store; the host
part of each layer's optimizer state is copied to the card for it and
back.  The step runs eagerly: capturing it in a CUDA graph (``jit``'s
counterpart) is left for later (ROADMAP).

The serving step functions (:meth:`ChunkedRuntime.prefill_step_fn`,
:meth:`~ChunkedRuntime.decode_step_fn`, and the compiled serving round's
:meth:`~ChunkedRuntime.round_prefill_step_fn` and
:meth:`~ChunkedRuntime.round_decode_step_fn`) read the same param stores,
a layer at a time, and run under ``torch.no_grad``.  Their caches keep the
reference's leading axes, ``[tp, L, B, ...]``:

  batched decode cache  [tp, L, B, C, KV, hd]  (a layer's slice is the
                        layers' batched cache)
  slot cache            [tp, L, S_slots, C, KV, hd]: the reference stacks
                        single-sequence caches ``[1, C, KV, hd]`` along a
                        slot axis; the port puts the slots in place of
                        that batch dim of one, wherever a leaf has it
                        (zamba's mamba states: ``[tp, L, shared_interval,
                        S_slots, ...]``), so a layer's slice is a batched
                        cache whose row s is slot s's sequence

The reference ``vmap``s the round steps over independent lanes; the port
batches the slots, and every op is row-independent (embedding, norms,
projections, attention with one length a row, the greedy head, and MoE
because the round steps route each row on its own: ``AxisCtx.moe_per_row``,
one routing group and one expert capacity a sequence), so a slot computes
what a batch-1 decode of its sequence computes, and a padded slot or
cohort row takes no expert capacity from a real sequence.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import dtype_of
from repro_torch.core import zero
from repro_torch.core.zero import ChunkLayout
from repro_torch.kernels import ops
from repro_torch.models.api import Model, flatten_with_paths, tree_map, \
    unflatten
from repro_torch.models import tp as tpmod
from repro_torch.models.layers import AxisCtx, greedy_token
from repro_torch.models.tp import Ranks, shards

STREAMS = ("p32", "m", "v")


@dataclasses.dataclass(frozen=True)
class RuntimeOptions:
    remat: str = "full"  # "full" | "dots" | "none"
    gather_policy: str = "layer"  # "layer" | "step"
    chunk_size: int | None = None  # None -> per-layout search
    # fraction of OS chunk groups host-resident (1.0 = ZeRO-Offload-style
    # all-on-host; 0.0 = all-on-device)
    os_host_fraction: float = 0.0
    # optimizer
    lr: float = 1e-3
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    # the reference's switch between its fused kernel and plain arithmetic
    # (the same function); a CUDA runtime runs K1 either way
    use_adam_kernel: bool = False
    attn_impl: str = "auto"
    attn_block: int = 512
    # ---- beyond-paper switches: checkpoint each step of the inner
    # sequence scans (SSD, mLSTM, sLSTM: ``AxisCtx.inner_remat``); the
    # MoE combines each model rank's expert outputs into [T, d] before the
    # model-axis psum (``AxisCtx.moe_combine_first``: the same sum in
    # another order; at tp=1 there is no psum to move)
    inner_remat: bool = False
    moe_combine_first: bool = False
    # gradient accumulation: split each rank's batch into N microbatches
    accum_steps: int = 1
    xent_block: int = 0  # blockwise LM-head cross-entropy (0 = off)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing that saves the outputs of plain matrix
    products (the reference's ``dots_with_no_batch_dims_saveable``: the
    projections; batched products, such as the plain attention's, are
    recomputed)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _add_(total: list, more) -> None:
    """``total[i] += more[i]`` in place: the running gradient sum holds
    one set of gradient buffers beside the set being added."""
    for a, b in zip(total, more):
        a.add_(b)


def _rows(batch: dict, lo: int, hi: int) -> dict:
    """Rows ``lo:hi`` of every batched tensor (scalars stay)."""
    return {k: v[lo:hi] if isinstance(v, torch.Tensor) and v.ndim else v
            for k, v in batch.items()}


class ChunkedRuntime:
    """Binds (model, mesh, options) into the step of
    :func:`repro_torch.runtime.driver.build_train_step`."""

    def __init__(self, model_cls, cfg, mesh, options: RuntimeOptions | None
                 = None):
        from repro_torch.launch.mesh import mesh_axes

        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.opt = options or RuntimeOptions()
        if self.opt.remat not in ("full", "dots", "none"):
            raise ValueError(f"remat={self.opt.remat!r}")
        if self.opt.gather_policy not in ("layer", "step"):
            raise ValueError(f"gather_policy={self.opt.gather_policy!r}")
        # a card keeps the host part of the optimizer state in pinned host
        # memory and brings it over for each update (Section 8.2); a CPU
        # runtime keeps it where it is, as the reference's CPU backend; a
        # meta runtime (the dry-run's) traces what the card does
        self.offload_host = self.device.type != "cpu"
        ax = mesh_axes(mesh)
        self.ctx = AxisCtx(tp=ax["tp"], dp=ax["dp"], pods=ax["pods"],
                           attn_impl=self.opt.attn_impl,
                           attn_block=self.opt.attn_block,
                           inner_remat=self.opt.inner_remat,
                           moe_combine_first=self.opt.moe_combine_first,
                           xent_block=self.opt.xent_block)
        self.model: Model = model_cls(cfg, self.ctx)
        self.tp_axes = self.model.tp_axes()
        self._build_layouts()
        # the flat ranges of each layout's replicated leaves, whose
        # gradient rank 0 holds for every model rank
        self._replicated = {
            name: tpmod.replicated_ranges(lay, self._axes(name))
            for name, lay in self.layouts.items()} if self.ctx.tp > 1 else {}

    # ------------------------------------------------------------------ layout
    def _build_layouts(self):
        specs = self.model.param_specs()
        pdtype = dtype_of(self.cfg.param_dtype)
        dp = self.ctx.dp
        self.layouts: dict[str, ChunkLayout] = {}
        self.layouts["stem"] = zero.make_layout(
            specs["stem"], nproc=dp, dtype=pdtype,
            chunk_size=self.opt.chunk_size)
        self.group_lengths: dict[str, int] = {}
        for g in self.model.groups():
            one_layer = tree_map(lambda t: t[0], specs["groups"][g.name])
            self.layouts[g.name] = zero.make_layout(
                one_layer, nproc=dp, dtype=pdtype,
                chunk_size=self.opt.chunk_size)
            self.group_lengths[g.name] = g.length

    # ---------------------------------------------------------------- shapes
    def store_shape(self, name: str, groups: int | None = None) -> tuple:
        """Global shape of a store (``groups`` overrides G: an OS part)."""
        g, p, s = self.layouts[name].store_shape
        g = g if groups is None else groups
        if name == "stem":
            return (self.ctx.tp, g, p, s)
        return (self.ctx.tp, self.group_lengths[name], g, p, s)

    def store_specs(self) -> dict:
        """The param stores' shapes and dtypes (meta tensors)."""
        return {name: torch.empty(self.store_shape(name), dtype=lay.dtype,
                                  device="meta")
                for name, lay in self.layouts.items()}

    def os_split(self, name: str) -> tuple[int, int]:
        """(device_groups, host_groups) along G for OS stores (Section
        8.2), rounded as the reference rounds them."""
        g = self.layouts[name].num_groups
        host = int(round(g * self.opt.os_host_fraction))
        host = min(max(host, 0), g)
        return g - host, host

    def os_specs(self) -> dict:
        """OS stores: {"name": {"p32"|"m"|"v": {"dev": spec, "host": spec}}}."""
        out = {}
        for name in self.layouts:
            dev_g, host_g = self.os_split(name)
            out[name] = {k: {part: torch.empty(self.store_shape(name, n),
                                               dtype=torch.float32,
                                               device="meta")
                             for part, n in (("dev", dev_g),
                                             ("host", host_g))}
                         for k in STREAMS}
        return out

    def collective_bytes(self) -> dict:
        """The chunk collective bytes one rank would move in a step: the
        paper's analytic volume (:func:`repro_torch.core.zero.
        comm_volume_bytes`) of the stem's layout once and of each group's
        layout once a layer.  Counts from the layouts: the simulated ranks
        move nothing.  The model axis's bytes depend on the batch, and
        :func:`repro_torch.runtime.driver.build_train_step` adds them."""
        out: dict = {}
        for name, lay in self.layouts.items():
            n = 1 if name == "stem" else self.group_lengths[name]
            itemsize = torch.empty((), dtype=lay.dtype).element_size()
            for k, v in zero.comm_volume_bytes(lay, itemsize=itemsize).items():
                out[k] = out.get(k, 0.0) + n * v
        return out

    # ------------------------------------------------------- gather plumbing
    def _axes(self, name: str):
        return (self.tp_axes["stem"] if name == "stem"
                else self.tp_axes["groups"][name])

    def _count_gather(self, store: torch.Tensor) -> None:
        """One device's all-gather of its model rank's ``[G, p, S]``
        chunks over the data ranks (:attr:`AxisCtx.counter`)."""
        self.ctx.counter.add("all-gather", store.numel()
                             * store.element_size(), self.ctx.dp,
                             axis="data")

    def _gather_tree(self, name: str, stores, *, dtype, count=True):
        """stores: the model ranks' ``[G, p, S]`` of one layer (or the
        stem), in rank order -> the param tree: at tp > 1 sharded leaves
        are :class:`~repro_torch.models.tp.Ranks` of the ranks' shards and
        replicated leaves rank 0's copy (which every rank's branch then
        reads, so its gradient sums them).  ``count``: the gather is
        counted here (not when the stores were gathered already)."""
        lay = self.layouts[name]
        if count:
            self._count_gather(stores[0])
        return tpmod.merge_ranks(
            [zero.unflatten_from_flat(lay, zero.gather_store(s), dtype=dtype)
             for s in stores], self._axes(name))

    def _remat(self, fn):
        if self.opt.remat == "none":
            return fn
        from torch.utils.checkpoint import (
            checkpoint,
            create_selective_checkpoint_contexts,
        )

        kw = {}
        if self.opt.remat == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)

    # ----------------------------------------------------------- local steps
    def _loss_local(self, leaves: dict, batch: dict):
        """One data rank's loss on its batch shard, its model ranks
        together.  ``leaves``: the model ranks' stem ``[G, p, S]`` stores
        and, per group, per layer, the ranks' ``[G, p, S]`` stores (each
        its own autograd leaf)."""
        model, ctx = self.model, self.ctx
        cdtype = dtype_of(self.cfg.compute_dtype)
        stem = self._gather_tree("stem", leaves["stem"], dtype=cdtype)
        x, extras = model.embed(stem, batch)
        aux = 0.0
        for g in model.groups():
            x, extras = model.between_groups(g.name, x, extras, stem, batch)

            # the group's own extras bound now: a checkpointed body runs
            # again in BWD, after later groups rebound ``extras``; with
            # the "layer" policy the gather + unflatten sit inside the
            # checkpoint, so BWD re-gathers
            per_layer = self.opt.gather_policy == "layer"

            def body(layer_stores, cx, _g=g, _e=extras, _n=per_layer):
                params = self._gather_tree(_g.name, layer_stores,
                                           dtype=cdtype, count=_n)
                return _g.apply(params, cx, _e, ctx)
            inputs = leaves[g.name]
            if not per_layer:
                # one gather for the whole group, then the layers
                for ranks in inputs:
                    self._count_gather(ranks[0])
                inputs = [[zero.gather_store(s) for s in ranks]
                          for ranks in inputs]
            body = self._remat(body)
            for inp in inputs:
                x, a = body(inp, x)
                aux = aux + a
        loss = model.head_loss(stem, x, batch)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return loss + aux, (loss, aux)

    def _leaves(self, pstores: dict) -> dict:
        """Autograd leaves over the param stores, one per model rank: the
        ranks' stem stores, and per layer the ranks' layer stores, so no
        layer's gradient is built as a full-size buffer of its stack."""
        tp = self.ctx.tp
        out = {"stem": [pstores["stem"][t].detach().requires_grad_()
                        for t in range(tp)]}
        for g in self.model.groups():
            store = pstores[g.name]
            out[g.name] = [[store[t, i].detach().requires_grad_()
                            for t in range(tp)]
                           for i in range(store.shape[1])]
        return out

    @staticmethod
    def _flat(leaves: dict) -> list:
        return list(leaves["stem"]) + [t for k, v in leaves.items()
                                       if k != "stem" for ranks in v
                                       for t in ranks]

    def _rank_grads(self, leaves: dict, batch: dict):
        """(loss, aux, grads) of one data rank's shard, summed over
        ``accum_steps`` microbatches (the loss carries 1/global_tokens,
        so microbatch grads SUM)."""
        n = self.opt.accum_steps
        b_loc = batch["tokens"].shape[0]
        if b_loc % n != 0 or b_loc < n:
            raise ValueError(
                f"accum_steps={n} must divide the per-device batch {b_loc}")
        flat = self._flat(leaves)
        loss = aux = grads = None
        mb = b_loc // n
        for i in range(n):
            part = _rows(batch, i * mb, (i + 1) * mb) if n > 1 else batch
            tot, (l_i, a_i) = self._loss_local(leaves, part)
            g_i = torch.autograd.grad(tot, flat)
            l_i, a_i = l_i.detach(), a_i.detach()
            if grads is None:
                loss, aux, grads = l_i, a_i, list(g_i)
            else:
                loss, aux = loss + l_i, aux + a_i
                _add_(grads, g_i)
        return loss, aux / n, grads

    def batch_shards(self, b: int) -> list:
        """Each data rank's rows of a global batch of ``b``, pod-major
        (``[pod][data] -> (lo, hi)``): the batch splits over ``(pod,
        data)`` when both divide it, else over ``data`` when the data
        ranks do (every pod then runs the same rows), else every rank
        runs all of it (the reference's ``batch_axes``)."""
        pods, dp = self.ctx.pods, self.ctx.dp
        if pods > 1 and b % (pods * dp) == 0:
            n = b // (pods * dp)
            return [[((p * dp + d) * n, (p * dp + d + 1) * n)
                     for d in range(dp)] for p in range(pods)]
        if dp > 1 and b % dp == 0:
            n = b // dp
            return [[(d * n, (d + 1) * n) for d in range(dp)]] * pods
        return [[(0, b)] * dp] * pods

    def grads(self, pstores: dict, batch: dict):
        """FWD + BWD of every simulated data rank on its batch shard
        (:meth:`batch_shards`): (loss, aux, grads), the losses and aux
        losses summed over the data ranks (the reference's psum over
        ``data`` and ``pod``), the grads summed rank 0 first within each
        pod (its reduce-scatter), then over the pods, as ``{"stem": [G, p,
        S], group: [L x [G, p, S]]}`` in the param dtype.  At tp > 1 each
        of those is a :class:`~repro_torch.models.tp.Ranks` of the model
        ranks' gradients, every rank's replicated leaves holding rank 0's
        (the sum of every rank's branch)."""
        leaves = self._leaves(pstores)
        b = batch["tokens"].shape[0]
        loss = aux = total = None
        counter = self.ctx.counter
        for pod in self.batch_shards(b):
            pod_total = None
            for lo, hi in pod:
                counter.ranks += 1
                part = batch if (lo, hi) == (0, b) else _rows(batch, lo, hi)
                l_r, a_r, g_r = self._rank_grads(leaves, part)
                # this rank's reduce-scatter of every layer's gradient
                # over the data ranks, and their psum over the pods
                for grad in g_r[::self.ctx.tp]:
                    n = grad.numel() * grad.element_size()
                    counter.add("reduce-scatter", n, self.ctx.dp,
                                axis="data")
                    counter.add("all-reduce", n / self.ctx.dp,
                                self.ctx.pods, axis="pod")
                if loss is None:
                    loss, aux = l_r, a_r
                else:
                    loss, aux = loss + l_r, aux + a_r
                if pod_total is None:
                    pod_total = g_r
                else:
                    _add_(pod_total, g_r)
                del g_r
            if total is None:
                total = pod_total
            else:
                _add_(total, pod_total)
            del pod_total
        tp = self.ctx.tp
        grads = {"stem": self._synced("stem", total[:tp])}
        i = tp
        for g in self.model.groups():
            n = self.group_lengths[g.name]
            grads[g.name] = [self._synced(g.name, total[j:j + tp])
                             for j in range(i, i + n * tp, tp)]
            i += n * tp
        return loss, aux, grads

    def _synced(self, name: str, ranks: list):
        """One layer's (or the stem's) model ranks' gradients with rank
        0's replicated leaves written into every rank's."""
        tpmod.sync_replicated_grads(ranks, self._replicated.get(name, ()))
        return Ranks.of(ranks)

    # -------------------------------------------------------------- optimizer
    def bias_corrections(self, step_idx: int) -> tuple[float, float]:
        """ADAM's bias corrections at ``step_idx``, in fp32 as the
        reference computes them."""
        b1, b2 = self.opt.betas
        t = np.float32(step_idx + 1)
        one = np.float32(1.0)
        return (float(one - np.power(np.float32(b1), t)),
                float(one - np.power(np.float32(b2), t)))

    def adam_pieces(self, name: str) -> list:
        """The contiguous pieces one layer's (or the stem's) ADAM of store
        ``name`` updates, as (part, first group, end group, rank): each
        rank's owned slice of each non-empty part, cut per group where
        the slice is strided (p > 1).  K1 runs once per piece on a card."""
        p = self.ctx.dp
        out = []
        for part, n in zip(("dev", "host"), self.os_split(name)):
            if not n:
                continue
            for r in range(p):
                if p == 1 or n == 1:
                    out.append((part, 0, n, r))
                else:
                    out.extend((part, g, g + 1, r) for g in range(n))
        return out

    def adam_update(self, pstores: dict, osstores: dict, grads: dict,
                    step_idx: int) -> dict:
        """Chunked ADAM on each rank's owned slice; grad chunks in the
        param dtype are read as fp32 (Section 6.2); the updated params go
        into the param store.  On a card every piece is one K1 launch,
        and each layer's host-resident optimizer state is copied to the
        card on the current stream before its update and back after
        (Section 8.2), with no host synchronisation between.  Returns the
        step's h2d/d2h bytes of those copies."""
        opt = self.opt
        b1, b2 = opt.betas
        bc1, bc2 = self.bias_corrections(step_idx)
        hp = dict(lr=opt.lr, beta1=b1, beta2=b2, eps=opt.eps,
                  weight_decay=opt.weight_decay, bias_corr1=bc1,
                  bias_corr2=bc2)
        on_card = self.device.type != "cpu"  # K1 (its shapes on meta)
        moved = {"h2d_bytes": 0, "d2h_bytes": 0}
        for name in self.layouts:
            dev_g = self.os_split(name)[0]
            pieces = self.adam_pieces(name)
            layers = ([None] if name == "stem"
                      else range(self.group_lengths[name]))
            for t_rank in range(self.ctx.tp):
                for layer in layers:
                    self._adam_layer(pstores, osstores, grads, name, t_rank,
                                     layer, dev_g, pieces, on_card, hp, moved)
        return moved

    def _adam_layer(self, pstores, osstores, grads, name, t_rank, layer,
                    dev_g, pieces, on_card, hp, moved) -> None:
        """ADAM of one model rank's layer (or stem) of store ``name``."""
        def at(t):  # the layer's [G, p, S] of a store part
            return t[t_rank] if layer is None else t[t_rank, layer]
        os_l = {k: {part: at(t) for part, t in osstores[name][k].items()}
                for k in STREAMS}
        host = {k: os_l[k]["host"] for k in STREAMS}
        fetch = self.offload_host and host["p32"].numel() > 0
        if fetch:  # the layer's host part (pinned) to the card
            for k, t in host.items():
                os_l[k]["host"] = torch.empty_like(
                    t, device=self.device).copy_(t, non_blocking=True)
            moved["h2d_bytes"] += 3 * host["p32"].numel() * 4
        g_all = grads[name] if layer is None else grads[name][layer]
        g_all = shards(g_all)[t_rank]
        p_all = at(pstores[name])
        for part, g0, g1, r in pieces:
            off = 0 if part == "dev" else dev_g
            st = [os_l[k][part][g0:g1, r] for k in STREAMS]
            self._update(*st, g_all[off + g0:off + g1, r],
                         p_all[off + g0:off + g1, r], on_card, hp)
        if fetch:  # and back
            for k, t in host.items():
                t.copy_(os_l[k]["host"], non_blocking=True)
            moved["d2h_bytes"] += 3 * host["p32"].numel() * 4

    def _update(self, p32, m, v, g, out, on_card: bool, hp: dict) -> None:
        """One piece: p32, m and v in place, the updated params into
        ``out`` (a slice of the param store)."""
        if on_card or self.opt.use_adam_kernel:
            # K1 on a CUDA tensor (the plain version on a CPU one)
            ops.chunked_adam(p32, m, v, g, out=out, **hp)
            return
        # the reference's plain branch (step.py, update_part), the same
        # elementwise operations in the same order, in place through two
        # scratch buffers (each temporary of the out-of-place form cost a
        # pass over fresh memory):
        #   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
        #   p -= lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)
        g32 = g.float()
        b1, b2 = hp["beta1"], hp["beta2"]
        t, u = torch.empty_like(m), torch.empty_like(m)
        m.mul_(b1).add_(torch.mul(g32, 1 - b1, out=t))
        v.mul_(b2).add_(torch.mul(g32, g32, out=t).mul_(1 - b2))
        torch.div(v, hp["bias_corr2"], out=t).sqrt_().add_(hp["eps"])
        torch.div(m, hp["bias_corr1"], out=u).div_(t)
        if hp["weight_decay"]:
            u.add_(torch.mul(p32, hp["weight_decay"], out=t))
        p32.sub_(u.mul_(hp["lr"]))
        out.copy_(p32)

    def train_step_fn(self, *, timed: bool = False) -> Callable:
        """f(pstores, osstores, batch, step_idx) -> (pstores, osstores,
        metrics); the stores are updated in place (the reference donates
        them).  ``batch`` holds tensors on the runtime's device.  With
        ``timed``, metrics also hold ``fwd_bwd_s`` and ``adam_s`` (host
        clock, each phase ended by a device synchronise)."""
        on_card = self.device.type == "cuda"

        def sync():
            if timed and on_card:
                torch.cuda.synchronize(self.device)

        def step(pstores, osstores, batch, step_idx):
            t0 = time.perf_counter()
            loss, aux, grads = self.grads(pstores, batch)
            sync()
            t1 = time.perf_counter()
            moved = self.adam_update(pstores, osstores, grads, int(step_idx))
            del grads
            sync()
            t2 = time.perf_counter()
            metrics = {"loss": loss, "aux_loss": aux, **moved}
            if timed:
                metrics.update(fwd_bwd_s=t1 - t0, adam_s=t2 - t1)
            return pstores, osstores, metrics

        return step

    # --------------------------------------------------------------- serving
    def _serving_stem(self, pstores: dict):
        return self._gather_tree("stem", list(pstores["stem"]),
                                 dtype=dtype_of(self.cfg.compute_dtype))

    def _layer_params(self, pstores: dict, name: str, layer: int):
        return self._gather_tree(name, list(pstores[name][:, layer]),
                                 dtype=dtype_of(self.cfg.compute_dtype))

    def _stack_layers(self, caches: list):
        """Per-layer cache trees (a leaf a :class:`~repro_torch.models.tp.
        Ranks` of the model ranks' caches at tp > 1) -> one tree of
        ``[tp, L, ...]`` leaves."""
        tp = self.ctx.tp
        paths = [p for p, _ in flatten_with_paths(caches[0])]
        cols = zip(*[[leaf for _, leaf in flatten_with_paths(c)]
                     for c in caches])
        return unflatten(paths, [
            torch.stack([shards(c)[t] for t in range(tp) for c in col])
            .unflatten(0, (tp, len(col))) for col in map(list, cols)])

    def _layer_cache(self, tree, layer: int):
        """Layer ``layer``'s cache of ``{tree of [tp, L, ...]}``: views, a
        :class:`~repro_torch.models.tp.Ranks` of the ranks' at tp > 1."""
        tp = self.ctx.tp
        return tree_map(lambda t: Ranks.of(t[r, layer] for r in range(tp)),
                        tree)

    @staticmethod
    def _logits(logits):
        """The head's logits as the reference's step returns them: the
        model ranks' vocab shards side by side (``[..., tp * V_local]``)."""
        return torch.cat(list(logits), dim=-1) if isinstance(
            logits, Ranks) else logits

    def _prefill(self, pstores: dict, stem, batch: dict, ctx=None):
        """Embed + every layer's prefill: (last hidden states, caches
        ``{group: tree of [tp, L, B, S, ...]}``)."""
        model, ctx = self.model, ctx or self.ctx
        x, extras = model.embed(stem, batch)
        caches = {}
        for g in model.groups():
            x, extras = model.between_groups(g.name, x, extras, stem, batch)
            ys = []
            for i in range(self.group_lengths[g.name]):
                params = self._layer_params(pstores, g.name, i)
                if g.prefill is None:
                    x, _ = g.apply(params, x, extras, ctx)
                    continue
                x, cache = g.prefill(params, x, extras, ctx)
                ys.append(cache)
            if ys:
                caches[g.name] = self._stack_layers(ys)
        return x, caches

    def prefill_step_fn(self) -> Callable:
        """f(pstores, batch) -> (logits [B, 1, V] fp32 at the last prompt
        position, caches ``{group: tree of [tp, L, B, S, ...]}``).
        ``batch["tokens"]``: [B, S] on the runtime's device."""

        @torch.no_grad()
        def step(pstores, batch):
            stem = self._serving_stem(pstores)
            x, caches = self._prefill(pstores, stem, batch)
            return self._logits(self.model.head_logits(stem, x[:, -1:, :])), \
                caches

        return step

    def decode_step_fn(self) -> Callable:
        """f(pstores, caches, token [B, 1], pos: int) -> (next tokens [B],
        new caches): every row writes position ``pos`` (the reference's
        scalar-position decode; the input caches are not modified)."""
        model, ctx = self.model, self.ctx

        @torch.no_grad()
        def step(pstores, caches, token, pos):
            stem = self._serving_stem(pstores)
            x = model.embed_decode(stem, token, pos, None)
            extras = model.decode_extras(stem, x)
            new = {}
            for g in model.groups():
                if g.decode is None:
                    continue
                ys = []
                for i in range(self.group_lengths[g.name]):
                    layer_cache = self._layer_cache(caches[g.name], i)
                    x, c2 = g.decode(self._layer_params(pstores, g.name, i),
                                     x, layer_cache, int(pos), extras, ctx)
                    ys.append(c2)
                new[g.name] = self._stack_layers(ys)
            logits = model.head_logits(stem, x)
            return greedy_token(logits, self.cfg.vocab_size, ctx), new

        return step

    def _row_ctx(self) -> AxisCtx:
        """The round steps' context: every batch row (a slot or a cohort
        member) routes through the MoE layers on its own."""
        return dataclasses.replace(self.ctx, moe_per_row=True)

    def round_prefill_step_fn(self) -> Callable:
        """Batched prefill over one admission cohort.

        ``tokens``: [K, S_prompt] on the runtime's device.  Returns
        ``(first tokens [K], caches)`` with every cache leaf [tp, L, K,
        S_prompt, ...]: row k is sequence k's prefill cache (the
        reference's lane-stacked layout without the per-lane batch dim of
        one).  Rows are independent (MoE routes each on its own), so a
        row equals a batch-1 prefill."""
        model, ctx = self.model, self._row_ctx()

        @torch.no_grad()
        def step(pstores, tokens):
            stem = self._serving_stem(pstores)
            x, caches = self._prefill(pstores, stem, {"tokens": tokens}, ctx)
            logits = model.head_logits(stem, x[:, -1:, :])
            return greedy_token(logits, self.cfg.vocab_size, ctx), caches

        return step

    def round_decode_step_fn(self) -> Callable:
        """One continuous-batching decode step over padded slots.

        ``tokens``: [S_slots, 1] and ``pos``: [S_slots] integers on the
        runtime's device (every slot advances from its own position in
        one call).  ``caches``: ``{group: tree of [tp, L, S_slots, C,
        ...]}``, updated in place (slot s's row at ``pos[s]``) and
        returned.  Returns ``(next tokens [S_slots], caches)``.  Free and
        stale slots decode garbage that cannot leak into live rows: the
        host ignores their tokens, and a re-bound slot's row is
        overwritten by the next prefill scatter.  Nothing here reads a
        device value on the host or branches on one, so a CUDA graph can
        capture the step (:func:`repro_torch.runtime.driver.
        build_round_decode_step`)."""
        model, ctx = self.model, self._row_ctx()

        @torch.no_grad()
        def step(pstores, caches, tokens, pos):
            stem = self._serving_stem(pstores)
            x = model.embed_decode(stem, tokens, pos, None)
            extras = model.decode_extras(stem, x)
            for g in model.groups():
                if g.decode is None:
                    continue
                for i in range(self.group_lengths[g.name]):
                    layer_cache = self._layer_cache(caches[g.name], i)
                    x, _ = g.decode(self._layer_params(pstores, g.name, i),
                                    x, layer_cache, pos, extras, ctx)
            logits = model.head_logits(stem, x)
            return greedy_token(logits, self.cfg.vocab_size, ctx), caches

        return step
