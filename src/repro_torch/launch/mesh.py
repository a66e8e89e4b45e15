"""The port's mesh: a record of the reference's ``(pod, data, model)``
axes on one device (``repro.launch.mesh`` twin).

The reference builds a JAX device mesh and runs the runtime's step under
``shard_map``.  The port simulates every rank in one process on one
device: the ``pods`` x ``dp`` data ranks one after another (as the
rank-parallel eager plane does), each on its shard of the batch, and the
``tp`` model ranks inside each layer (:mod:`repro_torch.models.tp`).  The
mesh only records the axis sizes and the device.  Pods are further data
ranks: their gradients are summed over ``data`` within each pod, then over
the pods, and the stores shard over ``data`` only (replicated across
pods), as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes by name (``{"data": dp, "model": tp}``, with ``"pod"``
    first when there are pods) and the device the simulated ranks run
    on."""

    shape: dict
    axis_names: tuple[str, ...]
    device: torch.device


def make_smoke_mesh(dp: int = 1, tp: int = 1, pods: int = 1, *,
                    device: str | torch.device = "cuda") -> Mesh:
    """A ``(data, model)`` mesh of ``dp`` x ``tp`` simulated ranks on
    ``device``, ``(pod, data, model)`` with ``pods > 1`` (the reference's
    names).  ``device="cuda"`` without a card raises."""
    for name, n in (("dp", dp), ("tp", tp), ("pods", pods)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if pods > 1:
        return Mesh(shape={"pod": pods, "data": dp, "model": tp},
                    axis_names=("pod", "data", "model"),
                    device=resolve_device(device))
    return Mesh(shape={"data": dp, "model": tp},
                axis_names=("data", "model"), device=resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "meta") -> Mesh:
    """The reference's production mesh: one pod of 16 x 16 = 256 ranks
    ``(data, model)``; ``multi_pod`` adds a leading pure-data ``pod`` axis
    of 2.  On the meta device by default: the dry-run
    (:mod:`repro_torch.launch.dryrun`) traces its 256 or 512 simulated
    ranks there, allocating nothing."""
    if multi_pod:
        return make_smoke_mesh(16, 16, 2, device=device)
    return make_smoke_mesh(16, 16, device=device)


def mesh_axes(mesh: Mesh) -> dict:
    names = mesh.axis_names
    return {
        "pod_axis": "pod" if "pod" in names else None,
        "pods": mesh.shape.get("pod", 1),
        "data_axis": "data",
        "dp": mesh.shape["data"],
        "model_axis": "model",
        "tp": mesh.shape["model"],
    }
