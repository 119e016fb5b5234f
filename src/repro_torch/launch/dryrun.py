"""One-card dry run (twin of ``repro/launch/dryrun.py``): reckon every
(arch x shape) cell's step on one H100 without touching device memory.

For each cell this builds the parameters, the optimizer state and the
inputs as meta tensors (``runtime/train.param_struct``, ``opt_struct``,
``launch/shapes.input_specs``), runs the port's own step on them under
``launch/op_cost``'s counter (the attention kernels record their cost and
launch nothing), and records:

  * the counted flops and bytes (``hlo_flops`` / ``hlo_bytes``, the
    reference's names) and the peak of the live bytes under the eager
    schedule (``memory``; ``fits``: under the card's 80 GiB),
  * the one-card roofline terms against the data sheet's peaks and the
    dominant one,
  * MODEL_FLOPS (6 N T train, 2 N T otherwise, N the active parameters) and
    the useful-compute ratio.

These are data-sheet arithmetic over the counted work, not measurements.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_4b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch all --shape all --out DIR
Options:
  --path shortcut|paged   decode access path (default shortcut; a model
                          with an SSM decodes on the shortcut route, since
                          the paged cache holds no SSM state)
  --opt  <key=val,...>    config overrides and step options (grad_accum,
                          remat, factored, block_size)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.configs.base import ArchConfig, get
from repro_torch.kvcache import paged_cache as pc
from repro_torch.launch import op_cost
from repro_torch.launch.shapes import SHAPES, SKIP, cell_status, input_specs
from repro_torch.optim.schedule import wsd_schedule
from repro_torch.runtime import serve as serve_mod
from repro_torch.runtime.train import make_train_step, opt_struct, param_struct

SKIP_REASON = ("long_500k needs sub-quadratic decode; full-attention arch "
               "(documented in DESIGN.md §5)")


def _apply_overrides(cfg: ArchConfig, opt: dict) -> ArchConfig:
    """Config overrides (``--opt key=val,...``)."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    repl = {}
    for k, v in opt.items():
        if k in fields:
            cur = getattr(cfg, k)
            repl[k] = type(cur)(v) if cur is not None else v
    return dataclasses.replace(cfg, **repl) if repl else cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def paged_cache_struct(cfg: ArchConfig, batch: int, seq_len: int,
                       block_size: int, dtype) -> pc.PagedKVCache:
    """A meta ``PagedKVCache`` at the reference dry run's sizes: ``batch``
    sequences of ``seq_len // block_size + 1`` blocks each."""
    mb = seq_len // block_size + 1
    pool = (cfg.num_layers, batch * mb, block_size, cfg.num_kv_heads,
            cfg.resolved_head_dim)
    return pc.PagedKVCache(
        k_pool=_meta(pool, dtype), v_pool=_meta(pool, dtype),
        block_tables=_meta((batch, mb), torch.int32),
        seq_lens=_meta((batch,), torch.int32),
        free_ring=_meta((batch * mb,), torch.int32),
        free_head=_meta((), torch.int32), free_count=_meta((), torch.int32))


def lower_cell(arch: str, shape: str, *, path: str = "shortcut",
               opt: dict | None = None, dtype=torch.bfloat16) -> dict:
    """Reckon one cell on one card; returns the result record."""
    opt = opt or {}
    cfg = _apply_overrides(get(arch), opt)
    status = cell_status(cfg, shape)
    rec = {"arch": arch, "shape": shape, "chips": 1, "path": path,
           "opt": opt, "status": status}
    if status == SKIP:
        rec["reason"] = SKIP_REASON
        return rec
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    t0 = time.perf_counter()
    p_struct = param_struct(cfg, dtype)
    if spec.kind == "train":
        factored = bool(int(opt.get("factored", cfg.num_params() > 3e10)))
        step = make_train_step(
            cfg, lr_fn=lambda s: wsd_schedule(
                s, peak_lr=3e-4, warmup_steps=100, total_steps=10000),
            grad_accum=int(opt.get("grad_accum", 1)),
            remat=bool(int(opt.get("remat", 1))), factored=factored).fn
        args = (p_struct, opt_struct(p_struct, factored=factored),
                input_specs(cfg, shape)["batch"])
        tokens = B * S
        model_flops = 6.0 * cfg.num_active_params() * tokens
    elif spec.kind == "prefill":
        step = serve_mod.make_prefill_step(cfg, s_cap=S, dtype=dtype)
        args = (p_struct, input_specs(cfg, shape)["batch"])
        tokens = B * S
        model_flops = 2.0 * cfg.num_active_params() * tokens
    else:
        ins = input_specs(cfg, shape, dtype=dtype)
        rec["route"] = "shortcut" if cfg.has_ssm else path
        if rec["route"] == "paged":
            cache = paged_cache_struct(cfg, B, S,
                                       int(opt.get("block_size", 16)), dtype)
            step = serve_mod.make_paged_serve_step(cfg)
            args = (p_struct, cache, ins["token"], _meta((B,), torch.int32))
        else:
            step = serve_mod.make_serve_step(cfg)
            args = (p_struct, ins["state"], ins["token"])
        tokens = B                  # one token per sequence per step
        model_flops = 2.0 * cfg.num_active_params() * tokens
    totals = op_cost.analyze(step, *args)
    terms = op_cost.roofline_terms(totals.flops, totals.bytes)
    rec.update({
        "device": op_cost.DEVICE,
        "tokens_per_step": tokens,
        "analyze_s": round(time.perf_counter() - t0, 2),
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops,
        "hlo_flops": totals.flops, "hlo_bytes": totals.bytes,
        "useful_flops_ratio": model_flops / max(totals.flops, 1.0),
        "memory": totals.memory,
        "fits": totals.memory["total_bytes"] <= op_cost.HBM_BYTES,
        **terms,
    })
    # roofline fraction: train/prefill, the model's useful compute time
    # over the dominant term (MFU-like); decode, the reference's bytes a
    # step cannot avoid (parameters + the whole cache or state, read once;
    # a windowed layer reads less, so the fraction can pass 1) over the
    # bound
    bound = rec["step_s_lower_bound"]
    if spec.kind == "decode":
        ideal = op_cost.tensor_bytes(args[:2])
        rec["ideal_bytes_per_device"] = ideal
        rec["roofline_fraction"] = (ideal / op_cost.HBM_BW) / bound
    else:
        rec["roofline_fraction"] = model_flops / op_cost.PEAK_FLOPS / bound
    rec["breakdown"] = totals.breakdown(top=8)
    return rec


def main(argv=None) -> int:
    # --multi-pod and --mesh are not ported: the reference's 16x16 and
    # 2x16x16 meshes are a TPU pod (launch/mesh.py), with no meaning on one
    # card; so is its per-mesh optimizer sharding (_opt_specs)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--path", choices=["shortcut", "paged"],
                    default="shortcut")
    ap.add_argument("--opt", default="",
                    help="comma-separated key=val config overrides")
    ap.add_argument("--out", default="",
                    help="directory for one JSON per cell")
    args = ap.parse_args(argv)

    archs = list(cfg_base.ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    opt = dict(kv.split("=", 1) for kv in args.opt.split(",") if kv)

    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}/{shape}/1-card/{args.path}"
            try:
                rec = lower_cell(arch, shape, path=args.path, opt=opt)
            except Exception as e:      # one cell's failure ends no sweep
                failures += 1
                rec = {"arch": arch, "shape": shape, "chips": 1,
                       "path": args.path, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {tag}: {rec['error']}", flush=True)
            else:
                if rec["status"] == SKIP:
                    print(f"[SKIP] {tag}: {rec['reason']}", flush=True)
                else:
                    print(
                        f"[ OK ] {tag}: mem={rec['memory']['total_bytes']}"
                        f" B ({'fits' if rec['fits'] else 'does not fit'})"
                        f" flops={rec['hlo_flops']:.6g}"
                        f" bytes={rec['hlo_bytes']:.6g}"
                        f" compute={rec['compute_s'] * 1e3:.4f}ms"
                        f" memory={rec['memory_s'] * 1e3:.4f}ms"
                        f" dom={rec['dominant']}"
                        f" roofline={rec['roofline_fraction']:.3f}"
                        f" (route {rec.get('route', '-')},"
                        f" {rec['analyze_s']} s)", flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                opt_tag = "_" + "_".join(
                    f"{k}-{v}" for k, v in opt.items()) if opt else ""
                fname = f"{arch}__{shape}__1-card__{args.path}{opt_tag}.json"
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
