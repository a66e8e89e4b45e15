"""The port's mesh: a record of the reference's ``(data, model)`` axes on
one device (``repro.launch.mesh`` twin).

The reference builds a JAX device mesh and runs the runtime's step under
``shard_map``.  The port simulates the ``dp`` data ranks in one process on
one device, one after another (as the rank-parallel eager plane does):
the mesh only records the axis sizes and the device.  Tensor parallelism
(``tp > 1``) and pods need the tensor-parallel layers (ROADMAP's model-zoo
item, ``models/tp.py``), which the port does not have yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes by name (``{"data": dp, "model": tp}``) and the device
    the simulated ranks run on."""

    shape: dict
    axis_names: tuple[str, ...]
    device: torch.device


def make_smoke_mesh(dp: int = 1, tp: int = 1, pods: int = 1, *,
                    device: str | torch.device = "cuda") -> Mesh:
    """A ``(data, model)`` mesh of ``dp`` simulated ranks on ``device``.
    ``device="cuda"`` without a card raises."""
    if tp != 1 or pods != 1:
        raise NotImplementedError(
            f"tp={tp}, pods={pods}: tensor parallelism and pods need the "
            f"tensor-parallel layers (ROADMAP, the rest of the model zoo: "
            f"models/tp.py), which are not ported yet")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    return Mesh(shape={"data": dp, "model": tp},
                axis_names=("data", "model"), device=resolve_device(device))


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
