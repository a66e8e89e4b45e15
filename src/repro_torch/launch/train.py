"""Training launcher of the port (``repro.launch.train`` twin).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-paper-1b \\
      --batch 8 --seq 1024 --steps 3 --os-host-fraction 0.5 --xent-block 256

Runs the chunked-ZeRO runtime end to end on one device (a card by
default; ``--device cpu`` for the CPU), with the synthetic data pipeline,
checkpointing and a per-step line.  ``--dp`` ranks are simulated one
after another on that device.
"""

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--devices", type=int, default=0,
                    help="accepted and ignored: the reference fakes N host "
                         "devices for its mesh; the port simulates --dp "
                         "ranks on one device")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--gather-policy", default="layer", choices=["layer", "step"])
    ap.add_argument("--os-host-fraction", type=float, default=0.0)
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--xent-block", type=int, default=0,
                    help="blockwise LM-head cross-entropy block (0 = off)")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--use-adam-kernel", action="store_true",
                    help="the reference's fused-ADAM switch (a card runs "
                         "K1 either way)")
    args = ap.parse_args(argv)

    import time

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config, model_class
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.api import flatten_with_paths
    from repro_torch.runtime import driver
    from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.param_dtype:
        cfg = cfg.replace(param_dtype=args.param_dtype,
                          compute_dtype=args.param_dtype)
    mesh = make_smoke_mesh(args.dp, args.tp, args.pods, device=args.device)
    options = RuntimeOptions(
        remat=args.remat, gather_policy=args.gather_policy,
        os_host_fraction=args.os_host_fraction, chunk_size=args.chunk_size,
        lr=args.lr, weight_decay=args.weight_decay,
        use_adam_kernel=args.use_adam_kernel, accum_steps=args.accum_steps,
        xent_block=args.xent_block)
    rt = ChunkedRuntime(model_class(cfg), cfg, mesh, options)
    n_params = sum(t.numel() for _, t in
                   flatten_with_paths(rt.model.param_specs()))
    print(f"arch={cfg.name} mesh={dict(mesh.shape)} "
          f"tp-local params={n_params/1e6:.1f}M "
          f"layouts={[(k, v.store_shape, round(v.cmap.utilization, 3)) for k, v in rt.layouts.items()]}",
          flush=True)

    shape = InputShape("cli", args.seq, args.batch, "train")
    step_fn, _, _ = driver.build_train_step(rt, shape)
    pstores, osstores = driver.init_state(rt, args.seed)
    next_batch = make_batch_fn(cfg, args.batch, args.seq, seed=args.seed)
    on_card = rt.device.type == "cuda"

    for step in range(args.steps):
        t0 = time.perf_counter()
        batch = {k: v for k, v in next_batch().items() if k != "mask"}
        pstores, osstores, metrics = step_fn(pstores, osstores, batch, step)
        if step % args.log_every == 0:
            if on_card:
                torch.cuda.synchronize(rt.device)
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"aux {float(metrics['aux_loss']):.4f}  {dt*1e3:.0f} ms",
                  flush=True)
        if (args.checkpoint and args.checkpoint_every
                and (step + 1) % args.checkpoint_every == 0):
            ckpt.save(rt, pstores, osstores, args.checkpoint, step=step + 1)
    if args.checkpoint:
        ckpt.save(rt, pstores, osstores, args.checkpoint, step=args.steps)
        print(f"saved checkpoint to {args.checkpoint}")


if __name__ == "__main__":
    main()
