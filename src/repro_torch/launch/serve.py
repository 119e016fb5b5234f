"""Serving driver (twin of ``repro/launch/serve.py``): batched prefill and
greedy decode over the shortcut view or the paged cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --reduced --batch 4 --prompt-len 32 --gen 16 --path shortcut \\
      --device cpu

Float32 parameters drawn from ``--seed`` and random prompt tokens from
``--seed + 1``, on ``--device`` (default ``cuda``: the flash kernel in the
prefill and the decode kernels in every step).  A model with no attention
serves on the shortcut route whatever ``--path`` says; a model with an SSM
and attention on ``--path paged`` raises ``NotImplementedError`` (the
paged cache holds no SSM state, ``runtime/serve.make_paged_serve_step``).
Each part is timed on the host clock between synchronizations of the
device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.device import resolve_device
from repro_torch.kvcache import paged_cache as pc
from repro_torch.models import model as M
from repro_torch.runtime.serve import (make_paged_serve_step,
                                       make_prefill_step, make_serve_step)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--path", choices=["shortcut", "paged"],
                    default="shortcut")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    B, S = args.batch, args.prompt_len
    s_cap = S + args.gen + 8
    params = M.init_params(cfg, args.seed, torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": params["embed"][toks.long()]}
    elif cfg.input_mode == "prefix_embeddings":
        batch["prefix_embeddings"] = torch.randn(
            (B, cfg.prefix_len, cfg.d_model), generator=gen, device=dev) \
            * 0.02

    _sync(dev)
    t0 = time.perf_counter()
    if args.path == "shortcut" or not cfg.has_attention:
        serve = make_serve_step(cfg)
        logits, state = make_prefill_step(cfg, s_cap=s_cap,
                                          dtype=torch.float32)(params, batch)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        outs = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            tok, state = serve(params, state, tok)
            outs.append(tok)
    else:
        serve = make_paged_serve_step(cfg)
        bs = 8
        cache = pc.cache_create(
            cfg.num_layers, num_blocks=B * (s_cap // bs + 1), block_size=bs,
            kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            max_seqs=B, max_blocks_per_seq=s_cap // bs + 1,
            dtype=torch.float32, device=dev)
        logits, caches = M.prefill_forward(params, cfg, batch)
        cache = pc.write_prefill(cache, torch.arange(B, device=dev),
                                 caches.k, caches.v)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        seq_ids = torch.arange(B, dtype=torch.int32, device=dev)
        outs = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            tok, cache = serve(params, cache, tok, seq_ids)
            outs.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_toks = torch.stack(outs, dim=1).cpu()
    print(f"[serve/{args.path}] arch={cfg.name} B={B} prompt={S} "
          f"gen={args.gen}")
    print(f"  prefill: {t_prefill * 1e3:8.1f} ms "
          f"({B * S / t_prefill:9.0f} tok/s)")
    print(f"  decode:  {t_decode * 1e3:8.1f} ms "
          f"({B * (args.gen - 1) / max(t_decode, 1e-9):9.0f} tok/s)")
    print(f"  sample tokens[0]: {gen_toks[0][:12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
