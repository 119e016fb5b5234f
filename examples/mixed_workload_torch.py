"""Figure-8 style mixed workload, live, PyTorch port: the twin of
``examples/mixed_workload.py`` on ``repro_torch`` (the CUDA kernels on a
card, their plain PyTorch versions with ``--device cpu``).

Bulk load, then waves of inserts + lookups with the async mapper running —
prints the version numbers and per-wave lookup latency so the
out-of-sync/catch-up cycle is visible.

  PYTHONPATH=src python examples/mixed_workload_torch.py [--device cuda]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.shortcut_eh import ShortcutEH


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(7)
    n_bulk, n_wave = 20_000, 400
    # distinct keys in [1, 2^31), drawn without materializing the range
    keys = (rng.choice(2**31 - 1, size=n_bulk + 4 * n_wave, replace=False)
            + 1).astype(np.uint32)

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    with ShortcutEH(max_global_depth=14, bucket_slots=256, capacity=4096,
                    poll_interval=0.002, async_mapper=True,
                    device=args.device) as sc:
        t0 = time.perf_counter()
        sc.insert(keys[:n_bulk], np.arange(n_bulk, dtype=np.uint32))
        sc.wait_in_sync()
        print(f"bulk-loaded {n_bulk} in {time.perf_counter() - t0:.2f}s; "
              f"depth={int(sc.state.global_depth)} "
              f"fan-in={sc.avg_fan_in():.2f}")

        inserted = n_bulk
        for wave in range(4):
            burst = keys[inserted:inserted + n_wave]
            sc.insert(burst,
                      np.arange(inserted, inserted + n_wave,
                                dtype=np.uint32))
            inserted += n_wave
            tv, sv = sc.versions()
            print(f"wave {wave}: burst of {n_wave} -> versions "
                  f"trad={tv} shortcut={sv} "
                  f"{'(STALE)' if sv < tv else ''}")
            for probe_i in range(3):
                probe = rng.choice(keys[:inserted], 20_000)
                route = "shortcut" if sc.use_shortcut() else "traditional"
                sync()
                t0 = time.perf_counter()
                out = sc.lookup(probe)
                sync()
                dt = (time.perf_counter() - t0) * 1e3
                assert (out.cpu().numpy() != 0xFFFFFFFF).all()
                print(f"  lookup x20k via {route:11s}: {dt:6.1f} ms")
                time.sleep(0.01)
            sc.wait_in_sync()
            tv, sv = sc.versions()
            print(f"  resynced: trad={tv} shortcut={sv}; "
                  f"stats={sc.stats.creates}c/{sc.stats.updates}u")


if __name__ == "__main__":
    main()
