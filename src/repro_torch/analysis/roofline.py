"""Hardware constants of the port: one frozen record a card.

The reference's roofline module keeps module-level constants of its
accelerator and reads XLA's compiled HLO.  The port keeps only the
constants, as a :class:`Hardware` record passed explicitly to the cost
model (:mod:`repro_torch.analysis.costmodel`) and carried by the
transfer timeline (:attr:`repro_torch.core.timeline.TransferTimeline.
hardware`), so an engine prices its operators with the same card its
links describe.  The HLO readers (``parse_collectives``, ``analyze``,
``count_params``, ``model_flops``) have no counterpart here.

``H100_SXM`` is the card the port runs on.  Its compute and memory rates
are NVIDIA's published figures; its link rates are *measurements* on
that card, because a datasheet says nothing about what a pinned copy
through this host achieves.  ``chip_smoke.py`` measures them again at
its start and replaces them (``dataclasses.replace``) for its run.
"""

from __future__ import annotations

import dataclasses


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
