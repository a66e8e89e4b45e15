"""Chunk-granular checkpoints of the port, in the reference's on-disk
format (``repro.checkpoint.checkpoint`` twin).

The chunk store is the checkpoint: one ``.npy`` per store part, global
shape, plus ``manifest.json`` with the chunk layouts.  numpy has no
bfloat16, so a bf16 store is saved as its ``uint16`` bit pattern with the
dtype tag ``"bfloat16"``, as the reference saves it; a checkpoint written
by either package restores in the other.  Optimizer state (p32, m, v,
each in its device and host part) rides along: a restore resumes the
exact training state.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import numpy as np
import torch

from repro_torch.core import zero
from repro_torch.models.api import _stack, tree_map
from repro_torch.runtime.step import STREAMS


def _manifest(rt) -> dict:
    return {
        "cfg": dataclasses.asdict(rt.cfg),
        "layouts": {
            name: {
                "chunk_size": lay.chunk_size,
                "nproc": lay.nproc,
                "num_groups": lay.num_groups,
                "names": list(lay.names),
                "shapes": [list(s) for s in lay.shapes],
            }
            for name, lay in rt.layouts.items()
        },
        "mesh": {k: int(v) for k, v in rt.mesh.shape.items()},
        "step": None,
    }


def _np_save(path: pathlib.Path, t: torch.Tensor) -> str:
    """Save one store part; returns its dtype tag."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        np.save(path, t.view(torch.int16).numpy().view(np.uint16))
        return "bfloat16"
    raw = t.numpy()
    np.save(path, raw)
    return str(raw.dtype)


def _np_load(path: pathlib.Path, dtype_tag: str) -> torch.Tensor:
    raw = np.load(path)
    if dtype_tag == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


def save(rt, pstores, osstores, path: str, *, step: int = 0) -> None:
    """Write the stores under ``path`` (created if missing).  On a card,
    waits for the step's copies of host-resident state first."""
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    man = _manifest(rt)
    man["step"] = step
    dtypes = {}
    for name, t in pstores.items():
        dtypes[f"param__{name}"] = _np_save(p / f"param__{name}.npy", t)
    for name, streams in osstores.items():
        for sname, parts in streams.items():
            for part, t in parts.items():
                fn = f"os__{name}__{sname}__{part}"
                dtypes[fn] = _np_save(p / f"{fn}.npy", t)
    man["dtypes"] = dtypes
    (p / "manifest.json").write_text(json.dumps(man, indent=1, default=str))


def restore(rt, path: str):
    """Load stores saved by :func:`save` (by either package) and place
    them where ``rt`` keeps them; layouts must match (same-mesh restore).
    Returns (pstores, osstores, step)."""
    from repro_torch.runtime import driver

    p = pathlib.Path(path)
    man = json.loads((p / "manifest.json").read_text())
    for name, lay in rt.layouts.items():
        m = man["layouts"][name]
        if m["chunk_size"] != lay.chunk_size or m["nproc"] != lay.nproc:
            raise ValueError(
                f"layout mismatch for {name}: checkpoint "
                f"(S={m['chunk_size']},p={m['nproc']}) vs runtime "
                f"(S={lay.chunk_size},p={lay.nproc}); use reshard()")
    dt = man.get("dtypes", {})

    def load(fn):
        return _np_load(p / f"{fn}.npy", dt.get(fn, ""))

    pstores = {name: load(f"param__{name}") for name in rt.layouts}
    osstores = {name: {k: {part: load(f"os__{name}__{k}__{part}")
                           for part in ("dev", "host")}
                       for k in STREAMS}
                for name in rt.layouts}
    pstores, osstores = driver.place_state(rt, pstores, osstores)
    return pstores, osstores, man["step"]


def to_param_tree(rt, pstores) -> Any:
    """Unpack chunk stores into a logical (TP-stacked) parameter tree:
    ``{"stem": [tree per tp rank], "groups": {name: [stacked tree per tp
    rank]}}``, CPU tensors in the store dtype — the export path toward
    framework-agnostic weights."""
    out = {"stem": [], "groups": {}}
    stem = pstores["stem"].detach().cpu()
    for r in range(stem.shape[0]):
        out["stem"].append(tree_map(
            torch.clone, zero.unflatten_from_flat(rt.layouts["stem"],
                                                  stem[r].reshape(-1))))
    for g in rt.model.groups():
        arr = pstores[g.name].detach().cpu()
        lay = rt.layouts[g.name]
        per_rank = []
        for r in range(arr.shape[0]):
            layers = [zero.unflatten_from_flat(lay, arr[r, i].reshape(-1))
                      for i in range(arr.shape[1])]
            per_rank.append(_stack(layers))
        out["groups"][g.name] = per_rank
    return out

