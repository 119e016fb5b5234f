"""Training example, PyTorch port: the twin of ``examples/train_small.py``
on ``repro_torch`` (on the card, or with ``--device cpu`` on the CPU).

Trains a ~100M-parameter member of the qwen3 family for a few hundred steps
on the synthetic pipeline, with checkpoints and restart: it wraps the
port's launcher (``repro_torch.launch.train``), so data, remat, the
optimizer, the asynchronous checkpoints and the watchdog are the same code
as there.  A second call on the same ``--ckpt-dir`` resumes from its newest
checkpoint.

  PYTHONPATH=src python examples/train_small_torch.py [--steps 300]
      [--ckpt-dir DIR] [--device cuda]
"""
import argparse
import dataclasses
import os
import sys
import tempfile

from repro_torch.configs import get
from repro_torch.configs.base import register
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_small_torch"))
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    # a ~100M-parameter member of the qwen3 family (registered on the fly:
    # any ArchConfig works as an --arch target)
    base = get("qwen3_4b")
    register(dataclasses.replace(
        base, name="qwen3_100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768))

    return train_main([
        "--arch", "qwen3_100m",
        "--steps", str(args.steps),
        "--seq-len", "256",
        "--global-batch", "8",
        "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
