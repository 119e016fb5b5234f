"""Serving example, PyTorch port: the twin of ``examples/serve_paged.py`` on
``repro_torch`` (the CUDA flash and decode kernels on a card, their plain
PyTorch versions with ``--device cpu``).

Prefills a batch of prompts into the paged cache, decodes via (a) the
block-table path and (b) the contiguous shortcut view, checks the outputs
agree token-for-token, and prints the timing split — the KV-layer analogue
of the paper's Figure 2.  A prefix model (``--arch paligemma_3b``) gets
seeded patch embeddings in front of each prompt.

  PYTHONPATH=src python examples/serve_paged_torch.py [--arch qwen3_4b]
      [--device cuda]
"""
import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.kvcache import paged_cache as pc
from repro_torch.models import model as M
from repro_torch.runtime.serve import (make_paged_serve_step,
                                       make_prefill_step, make_serve_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get(args.arch).reduced()
    dev = torch.device(args.device)
    B, S, GEN = args.batch, args.prompt_len, args.gen
    ctx = S + (cfg.prefix_len if cfg.input_mode == "prefix_embeddings"
               else 0)
    s_cap = ctx + GEN + 8
    params = M.init_params(cfg, 0, torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=dev)}
    if cfg.input_mode == "prefix_embeddings":
        batch["prefix_embeddings"] = torch.randn(
            (B, cfg.prefix_len, cfg.d_model), generator=gen,
            device=dev) * 0.02

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # --- shortcut path ----------------------------------------------------
    prefill = make_prefill_step(cfg, s_cap, torch.float32)
    serve_s = make_serve_step(cfg)
    logits, state = prefill(params, batch)
    tok = torch.argmax(logits, -1).to(torch.int32)
    short = [tok]
    sync()
    t0 = time.perf_counter()
    for _ in range(GEN - 1):
        tok, state = serve_s(params, state, tok)
        short.append(tok)
    sync()
    t_short = time.perf_counter() - t0

    # --- paged path ---------------------------------------------------------
    bs = 8
    cache = pc.cache_create(
        cfg.num_layers, num_blocks=B * (s_cap // bs + 1), block_size=bs,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        max_seqs=B, max_blocks_per_seq=s_cap // bs + 1,
        dtype=torch.float32, device=dev)
    logits, caches = M.prefill_forward(params, cfg, batch)
    cache = pc.write_prefill(cache, torch.arange(B, device=dev), caches.k,
                             caches.v)
    serve_p = make_paged_serve_step(cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)
    seq_ids = torch.arange(B, dtype=torch.int32, device=dev)
    paged = [tok]
    sync()
    t0 = time.perf_counter()
    for _ in range(GEN - 1):
        tok, cache = serve_p(params, cache, tok, seq_ids)
        paged.append(tok)
    sync()
    t_paged = time.perf_counter() - t0

    short_np = torch.stack(short, 1).cpu().numpy()
    paged_np = torch.stack(paged, 1).cpu().numpy()
    assert (short_np == paged_np).all(), "access paths must agree!"
    print(f"arch={cfg.name} B={B} prompt={S} gen={GEN}")
    print(f"  paged decode:    {t_paged * 1e3:7.1f} ms  "
          f"({B * (GEN - 1) / t_paged:8.0f} tok/s)   [2 indirections]")
    print(f"  shortcut decode: {t_short * 1e3:7.1f} ms  "
          f"({B * (GEN - 1) / t_short:8.0f} tok/s)   [0 indirections]")
    print(f"  outputs identical across paths ✓  "
          f"sample: {short_np[0][:10].tolist()}")


if __name__ == "__main__":
    main()
