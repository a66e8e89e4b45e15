"""Device-aware operator/chunk placement (PatrickStar Section 8.2).

Two decisions are made from the warm-up statistics:

1. **OS chunks in GPU margin space.**  After forward/backward, the device
   keeps ``margin = total - peak_nonmodel - param_fp16_working_set`` bytes
   free.  As many optimizer-state chunk *groups* as fit are pinned to the
   device so that their ADAM update runs there without any host traffic;
   the rest stay on the host and ADAM for them runs host-side (the
   ZeRO-Offload default for *all* OS).  A group is a (param fp32,
   momentum, variance) triple sharing one layout slot, so one group costs
   ``3 * chunk_bytes_fp32`` (+ the transient fp32 grad conversion buffer).

2. **Embedding on host.**  Embedding parameters are O(V*H) but their
   activations are O(B*H); when V is large the parameters should never
   move.  ``embedding_on_host`` returns True when the embedding's chunk
   traffic would exceed its activation traffic.

The same policy object drives both runtimes: the eager engine pins chunks
accordingly, and the compiled path splits the OS chunk store into a
device-resident and a host-resident (``pinned_host`` memory kind) part at
lowering time.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    # number of OS chunk groups resident on device (out of num_local_groups)
    os_device_groups: int
    num_local_groups: int
    margin_bytes: int
    embedding_on_host: bool
    # >0: margin chunks; <0: param-fp16 chunks spilled to host (Table 4)
    margin_or_spill_groups: int
    # device bytes reserved for the activation stream's working set (the
    # act chunks that must co-reside with compute during FWD/BWD); margin
    # OS groups only claim what is left after this reservation
    act_reserved_bytes: int = 0
    # host-resident OS groups whose steady-state home is the slow
    # (NVMe-class) tier: they exceed the host budget left after the param
    # fp16 spill, so between their ADAM visits they rest one tier further
    # down instead of making the config inadmissible.  0 on two-tier plans.
    os_slow_groups: int = 0

    @property
    def os_device_fraction(self) -> float:
        if self.num_local_groups == 0:
            return 0.0
        return self.os_device_groups / self.num_local_groups

    def os_device_chunk_ids(self, cmap) -> set[int]:
        """Chunk ids of the OS groups placed in GPU margin space.  Their
        ADAM updates run device-side after warm-up, so the warm-up's
        host-side reference moments for these chunks must be promoted to
        device references in the OPT/prefetch schedules."""
        return {
            c
            for g_idx in range(self.os_device_groups)
            for c in cmap.comm_group_chunk_ids(g_idx)
        }

    def os_slow_chunk_ids(self, cmap) -> set[int]:
        """Chunk ids of the OS groups whose steady-state home is the slow
        tier (the last ``os_slow_groups`` groups: the margin-placed ones
        come first, host-placed next, overflow last)."""
        return {
            c
            for g_idx in range(self.num_local_groups - self.os_slow_groups,
                               self.num_local_groups)
            for c in cmap.comm_group_chunk_ids(g_idx)
        }


def plan_placement(
    *,
    margin_bytes: int,
    num_local_groups: int,
    chunk_size_elems: int,
    param_fp16_local_bytes: int,
    device_total_bytes: int,
    peak_nonmodel_bytes: int,
    vocab_size: int = 0,
    hidden: int = 0,
    batch_tokens: int = 0,
    act_working_bytes: int = 0,
    host_capacity_bytes: int | None = None,
    slow_capacity_bytes: int | None = None,
) -> PlacementPlan:
    """Derive the placement plan from warm-up statistics.

    ``margin_bytes`` should come from ``RuntimeMemoryTracer.margin_space``.
    ``act_working_bytes`` is the activation stream's device working set
    (chunk-managed checkpointed inputs pinned alongside compute); it is
    carved out of the margin BEFORE optimizer-state groups claim it, so a
    margin-placed OS group can never force the act chunks an operator is
    reading/writing off the device.

    With a bounded host (``host_capacity_bytes``) and a slow tier present
    (``slow_capacity_bytes``), host-placed OS groups that do not fit the
    host budget left after the param-fp16 spill overflow to the slow tier
    (``os_slow_groups``) instead of making the configuration
    inadmissible — the ZeRO-Infinity direction.  Without a slow tier the
    plan is unchanged: overflow remains the pool's OutOfMemory to raise.

    On a shared multi-tenant pool the caller passes its *tenant's* tier
    shares (``PoolLease.host_bytes`` / ``slow_bytes`` — soft budgets,
    falling back to the pool caps), not the raw pool capacities: each
    tenant plans inside its own share and the pool's common overflow
    region absorbs transients at eviction-priority cost.
    """
    # one OS group = param fp32 + momentum + variance, all fp32
    group_bytes = 3 * chunk_size_elems * 4
    os_margin_bytes = max(margin_bytes - act_working_bytes, 0)
    os_device_groups = 0
    if group_bytes > 0:
        os_device_groups = max(
            0, min(num_local_groups, os_margin_bytes // group_bytes))

    # Table 4 diagnostic: positive margin groups, or negative spilled
    # param-fp16 groups when even the fp16 working set does not fit.
    fp16_budget = device_total_bytes - peak_nonmodel_bytes
    if param_fp16_local_bytes > fp16_budget > 0:
        spill_bytes = param_fp16_local_bytes - fp16_budget
        spill_groups = -(-spill_bytes // max(2 * chunk_size_elems, 1))  # ceil
        margin_or_spill = -int(spill_groups)
    else:
        margin_or_spill = int(os_device_groups)

    # Embedding placement: moving O(V*H) params vs O(B*H) activations.
    emb_on_host = bool(vocab_size and batch_tokens and vocab_size > batch_tokens)

    # Third-tier overflow: host-placed OS groups beyond what the host
    # budget can hold (after the fp16 spill it must absorb) rest on the
    # slow tier between ADAM visits.
    os_slow_groups = 0
    if slow_capacity_bytes is not None and host_capacity_bytes is not None:
        host_groups = num_local_groups - int(os_device_groups)
        spill_fp16 = max(param_fp16_local_bytes - max(fp16_budget, 0), 0)
        host_os_budget = max(host_capacity_bytes - spill_fp16, 0)
        fit = host_os_budget // group_bytes if group_bytes > 0 else host_groups
        os_slow_groups = int(max(0, host_groups - fit))

    return PlacementPlan(
        os_device_groups=int(os_device_groups),
        num_local_groups=num_local_groups,
        margin_bytes=int(margin_bytes),
        embedding_on_host=emb_on_host,
        margin_or_spill_groups=margin_or_spill,
        act_reserved_bytes=int(act_working_bytes),
        os_slow_groups=os_slow_groups,
    )
