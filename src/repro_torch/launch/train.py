"""End-to-end training launcher (twin of ``repro/launch/train.py``).

Composes the substrate: config registry -> data pipeline -> train step
(remat, gradient accumulation) -> asynchronous checkpoints -> watchdog and
straggler monitor; it resumes from the newest checkpoint in ``--ckpt-dir``
and raises on a non-finite loss.  ``--device`` (default ``cuda``) picks the
card or, with ``cpu``, the CPU.  One card has no mesh: ``--mesh`` takes only
``1x1``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \\
      --reduced --steps 200 --seq-len 128 --global-batch 8 \\
      --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
from repro_torch.configs import get
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.schedule import wsd_schedule
from repro_torch.runtime.train import make_train_step
from repro_torch.runtime.watchdog import Heartbeat, StragglerMonitor, Watchdog


def check_mesh(spec: str) -> None:
    """Only the one-device mesh ``1x1``: the port runs on one card."""
    if spec != "1x1":
        raise ValueError(
            f"mesh {spec}: the port trains on one device and takes only "
            "--mesh 1x1 (the sharding rules are ported, "
            "distributed/sharding.py; a sharded run has no meaning on one "
            "card)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", type=int, default=1)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    check_mesh(args.mesh)
    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    pipe = SyntheticLM(cfg, DataConfig(args.seq_len, args.global_batch,
                                       seed=args.seed), device=dev)

    params = M.init_params(cfg, args.seed, dtype, device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(
        cfg,
        lr_fn=lambda s: wsd_schedule(s, peak_lr=args.lr, warmup_steps=20,
                                     total_steps=args.steps),
        grad_accum=args.grad_accum, remat=bool(args.remat)).fn

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ck is not None:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            restored = ck.restore(last, {"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            start = last
            print(f"[train] resumed from step {start}")

    hb = Heartbeat(0)
    monitor = StragglerMonitor()
    with Watchdog([hb], deadline_s=300.0,
                  on_dead=lambda d: print(f"[watchdog] DEAD: {d}")):
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, pipe.batch(step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            hb.beat(step)
            if monitor.record(dt):
                print(f"[straggler] step {step}: {dt:.3f}s vs median "
                      f"{monitor.median():.3f}s")
            if step % args.log_every == 0 or step == args.steps - 1:
                tok_s = args.global_batch * args.seq_len / dt
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"{dt * 1e3:7.1f} ms/step {tok_s:9.0f} tok/s",
                      flush=True)
            if not math.isfinite(loss):
                raise RuntimeError(f"loss diverged at step {step}")
            if ck is not None and step and step % args.ckpt_every == 0:
                ck.save_async(step, {"params": params, "opt": opt})
    if ck is not None:
        ck.wait()
        ck.save(args.steps, {"params": params, "opt": opt})
        print(f"[train] final checkpoint at step {args.steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
