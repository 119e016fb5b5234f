"""Quickstart, PyTorch port: the twin of ``examples/quickstart.py`` on
``repro_torch`` (the CUDA kernels on a card, their plain PyTorch versions
with ``--device cpu``).

Builds a Shortcut-EH index, shows the async maintenance / version gating /
fan-in routing cycle, and compares both access paths.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
"""
import argparse

import numpy as np

from repro_torch.core.shortcut_eh import ShortcutEH


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    # 5000 distinct keys in [1, 2^31) (drawn without materializing the
    # range, unlike the JAX example: the same distribution, other keys)
    keys = (rng.choice(2**31 - 1, size=5000, replace=False) + 1).astype(
        np.uint32)
    vals = np.arange(5000, dtype=np.uint32)

    # the index: traditional directory (authoritative, synchronous) +
    # shortcut directory (async replica, hardware-friendly access path)
    with ShortcutEH(max_global_depth=12, bucket_slots=64, capacity=4096,
                    async_mapper=True, device=args.device) as index:
        index.insert(keys[:4000], vals[:4000])
        print(f"inserted 4000; versions (trad, shortcut) = "
              f"{index.versions()}  in_sync={index.in_sync()}")

        # lookups are correct immediately — routed via the traditional
        # path until the mapper catches up
        out = index.lookup(keys[:1000]).cpu().numpy()
        assert (out == vals[:1000]).all()
        print(f"lookup wave 1 ok; routed shortcut? "
              f"{index.routed_shortcut > 0}")

        index.wait_in_sync()
        print(f"mapper caught up; versions = {index.versions()}  "
              f"avg fan-in = {index.avg_fan_in():.2f}")

        out = index.lookup(keys[:4000]).cpu().numpy()
        assert (out == vals[:4000]).all()
        print(f"lookup wave 2 ok; routed shortcut? "
              f"{index.routed_shortcut > 0}")

        # an insert burst makes the shortcut stale again (Fig 8)
        index.insert(keys[4000:], vals[4000:])
        print(f"after burst: in_sync={index.in_sync()} "
              f"(lookups keep working via the traditional path)")
        out = index.lookup(keys).cpu().numpy()
        assert (out == vals).all()
        index.wait_in_sync()
        print(f"resynced: {index.versions()}; "
              f"maintenance stats: {index.stats}")


if __name__ == "__main__":
    main()
