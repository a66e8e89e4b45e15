"""Quickstart — the paper's Listing 1 on the port's eager PatrickStar engine.

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

Trains a small GPT under a 4 MB device budget next to a host tier,
exercising the full chunk machinery: warm-up tracing, OPT eviction,
device-aware placement of optimizer state (ADAM through K1 for the
groups placed on the device), grad reuse of the param chunks.  The twin
of ``examples/quickstart.py``: the same config, budget and batches.
"""

from __future__ import annotations

import argparse
import math

from repro_torch.configs import get_config, model_class
from repro_torch.core.engine import initialize_engine
from repro_torch.data.pipeline import make_batch_fn


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = get_config("gpt2-paper-1b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")

    # ----- paper Listing 1 -------------------------------------------------
    model, optimizer = initialize_engine(
        model_func=lambda: (model_class(cfg), cfg),
        config={"device_memory_bytes": 4_000_000, "policy": "opt",
                "lr": 1e-2, "device": args.device})

    next_batch = make_batch_fn(cfg, 4, 64)
    losses = []
    for step in range(args.steps):
        batch = {k: v for k, v in next_batch().items() if k != "mask"}
        optimizer.zero_grad()
        loss = model(batch)
        model.backward(loss)
        optimizer.step()
        m = model._metrics
        losses.append(model.loss)
        print(f"step {step}: loss={model.loss:.4f} "
              f"moved={m.moved_bytes/1e6:.2f}MB "
              f"(fwd {m.fwd_s*1e3:.0f}ms bwd {m.bwd_s*1e3:.0f}ms "
              f"adam {m.adam_s*1e3:.0f}ms)")
    eng = model._eng
    print("\nchunk map:", eng.cmap.num_chunks, "chunks x",
          eng.cmap.chunk_size, "elems, utilization",
          f"{eng.cmap.utilization:.2%}")
    print("placement plan:", eng.placement)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    return losses


if __name__ == "__main__":
    main()
