"""Hardware constants of the port and the dry-run's roofline
(``repro.analysis.roofline`` twin).

The reference's roofline module keeps module-level constants of its
accelerator and reads XLA's compiled HLO.  The port keeps the constants
as a :class:`Hardware` record passed explicitly to the cost model
(:mod:`repro_torch.analysis.costmodel`) and carried by the transfer
timeline (:attr:`repro_torch.core.timeline.TransferTimeline.hardware`),
so an engine prices its operators with the same card its links describe.

The dry-run's analysis (:mod:`repro_torch.launch.dryrun`) is here too:
:func:`count_params` and :func:`model_flops` with the reference's
arithmetic, read from the port's layouts and ``tp_axes``, and the
:class:`Roofline` record of :func:`analyze`.  ``parse_collectives``, which
reads the collectives out of XLA's optimized HLO text, has no
counterpart: the port compiles no HLO.  Its place is taken by the
runtime's explicit accounting, the collectives the simulated ranks
perform counted as they run (:class:`~repro_torch.models.layers.
CollectiveCounter`), by kind and by mesh axis.  XLA's ``memory_analysis``
has none either: the dry-run tracks the live bytes of its meta trace.

``H100_SXM`` is the card the port runs on.  Its compute and memory rates
are NVIDIA's published figures; its link rates are *measurements* on
that card, because a datasheet says nothing about what a pinned copy
through this host achieves.  ``chip_smoke.py`` measures them again at
its start and replaces them (``dataclasses.replace``) for its run.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.api import flatten_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Rates of one card and its links, in FLOP/s and bytes/s.  ``None``
    for a link means an infinite lane (a transfer takes zero seconds)."""

    name: str
    peak_flops: float  # dense, in the compute dtype the cost model prices
    hbm_bw: float
    h2d_bw: float | None  # pinned host -> device copy
    d2h_bw: float | None  # device -> pinned host copy
    slow_bw: float | None  # host <-> slow tier, both directions
    collective_bw: float | None  # the chunk-group all-gather's rate


H100_SXM = Hardware(
    name="NVIDIA H100 80GB HBM3",
    # NVIDIA H100 SXM5 80GB datasheet, bf16 dense (no sparsity); NVIDIA
    # H100 80GB HBM3, 700 W
    peak_flops=989e12,
    # NVIDIA H100 SXM5 80GB datasheet, HBM3; NVIDIA H100 80GB HBM3, 700 W
    hbm_bw=3.35e12,
    # measured, not a datasheet figure: pinned copies of the chunked
    # runtime's host optimizer state on NVIDIA H100 80GB HBM3, 700 W
    # (chip_smoke.py's rt_profile, PERF.md §5: 45.7 GB/s h2d, 43.6 d2h)
    h2d_bw=45.7e9,
    d2h_bw=43.6e9,
    # the port's slow tier is CPU memory (core/memory.py), so there is no
    # NVMe-class link to measure: an infinite lane
    slow_bw=None,
    # measured: the port's ranks share one card, so a gather is the device
    # copy ``dst.copy_(src)`` between two rank pools (HBM, not NVLink);
    # chip_smoke.py's link phase copied one 142.6 MB chunk at 1431.6 GB/s
    # on NVIDIA H100 80GB HBM3, 700 W
    collective_bw=1.4316e12,
)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """Per-GPU link rates of a cluster of ``gpus_per_node``-GPU nodes,
    bytes/s each way: NVLink between the GPUs of a node, the node's
    network between nodes (one NIC a GPU)."""

    name: str
    gpus_per_node: int
    nvlink_bw: float
    nic_bw: float

    def axis_bw(self, group: int, stride: int) -> float:
        """The rate of a ring over ``group`` ranks ``stride`` apart in the
        mesh's rank order: NVLink when every rank of a group sits in one
        node, the network when the ring crosses nodes (its slowest hop)."""
        return (self.nvlink_bw if group * stride <= self.gpus_per_node
                else self.nic_bw)


H100_NODES = Cluster(
    name="8 x NVIDIA H100 80GB HBM3 (700 W) a node",
    gpus_per_node=8,
    # datasheet figures, not measurements: NVIDIA H100 SXM5 datasheet,
    # fourth-generation NVLink 900 GB/s a GPU both ways together (450 GB/s
    # each way); NVIDIA DGX H100 datasheet, eight ConnectX-7 at 400 Gb/s,
    # one a GPU (400 Gb/s over 8 bits a byte, each way); NVIDIA H100 80GB
    # HBM3, 700 W
    nvlink_bw=900e9 / 2,
    nic_bw=400e9 / 8,
)


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE)
# ---------------------------------------------------------------------------


def _tree_count(spec_tree, axes_tree, tp: int, cfg,
                scale_expert: bool = False) -> tuple[float, float]:
    """(total, active) params of one tree of TP-local shapes: a sharded
    leaf counts ``tp`` times, an expert FFN leaf (outside the shared
    experts) ``top_k / n_experts`` of that in the active count."""
    axes = dict(flatten_with_paths(axes_tree))
    total = active = 0.0
    for path, leaf in flatten_with_paths(spec_tree):
        n = float(leaf.numel())
        if axes.get(path) is not None:
            n *= tp
        total += n
        name = "/".join(str(k) for k in path)
        if scale_expert and ("w_gate" in name or "w_up" in name
                             or "w_down" in name) and "shared" not in name:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return total, active


def count_params(rt) -> tuple[float, float]:
    """(N_total, N_active) global params from the runtime's model, as the
    reference counts them: the TP-local shapes of ``param_specs``, a
    sharded leaf (``tp_axes`` not None) times tp, the MoE expert FFN
    params times ``top_k / n_experts`` (shared experts whole) for
    N_active."""
    cfg, tp = rt.cfg, rt.ctx.tp
    specs = rt.model.param_specs()
    axes = rt.tp_axes
    tot, act = _tree_count(specs["stem"], axes["stem"], tp, cfg)
    for g in rt.model.groups():
        one = tree_map(lambda t: t[0], specs["groups"][g.name])
        is_moe = cfg.arch_type == "moe" and g.name == "moe_layers"
        t1, a1 = _tree_count(one, axes["groups"][g.name], tp, cfg,
                             scale_expert=is_moe)
        tot += t1 * g.length
        act += a1 * g.length
    return tot, act


def model_flops(rt, shape, n_total: float, n_active: float) -> float:
    """Global MODEL_FLOPS for one step of this input shape."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# the roofline of a traced step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveStats:
    # per op kind: (count, buffer_bytes, link_bytes), a device's
    by_kind: dict
    link_bytes_total: float

    def summary(self) -> str:
        parts = [f"{k}:n={v[0]:g},buf={v[1]:.3g},link={v[2]:.3g}"
                 for k, v in sorted(self.by_kind.items())]
        return " ".join(parts) if parts else "none"


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_link_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / traced FLOPs (per device)
    collectives: CollectiveStats
    memory_stats: dict

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


def analyze(*, flops: float, hbm_bytes: float, collectives: dict,
            axis_link_bytes: dict, axis_bw: dict,
            model_flops_per_device: float, memory_stats: dict) -> Roofline:
    """The three terms of one device's step, in seconds, as the
    reference's ``analyze`` forms them from a compiled module: compute =
    ``flops`` / peak, memory = ``hbm_bytes`` / HBM rate (both
    :data:`H100_SXM`'s datasheet rates), collective = each mesh axis's
    link bytes over that axis's rate (``axis_bw``, bytes/s by axis name).
    ``collectives``: ``{kind: {"count", "buffer_bytes", "link_bytes"}}``
    of one device."""
    hw = H100_SXM
    by_kind = {k: (v["count"], v["buffer_bytes"], v["link_bytes"])
               for k, v in collectives.items()}
    coll = CollectiveStats(by_kind=by_kind, link_bytes_total=sum(
        v[2] for v in by_kind.values()))
    compute_s = flops / hw.peak_flops
    memory_s = hbm_bytes / hw.hbm_bw
    collective_s = sum(n / axis_bw[a] for a, n in axis_link_bytes.items()
                       if n)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        flops=flops, hbm_bytes=hbm_bytes,
        collective_link_bytes=coll.link_bytes_total,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops_per_device,
        useful_ratio=(model_flops_per_device / flops) if flops else 0.0,
        collectives=coll, memory_stats=memory_stats)
