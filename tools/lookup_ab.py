"""Times two builds of ``baselines_lookup.cu`` against each other on one
card, at Fig. 7's size: the source under ``src/repro_torch/kernels/csrc/``
("new") and another copy of it, such as the parent commit's ("old"), given
by ``--old``.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/lookup_ab.py \\
        --old build/parent/src/repro_torch/kernels/csrc/baselines_lookup.cu

The states are ``chip_smoke.py`` (i)'s end states: HT, HTI and CH after
2**log2_keys keys in 16 batches (the insert kernels), probed with those keys
and 2**20 absent ones.  Both builds go through the wrapper
(``core/baselines.py``'s ``*_lookup_many``), whose library is swapped for
the build's during its turns, and are held bit for bit to the plain version
(``*_lookup_plain``) on every probe.  The turns run old, new, new, old
(A B B A), each the mean of ``--reps`` calls after 2 warm-up calls, by
``chip_smoke.DeviceTimer``.  Beside them: each build's ptxas registers and
spills, the plain version's time, the byte bound
(``chip_smoke.lookup_bytes_baseline`` at 3.35 TB/s), the sector floor
(``chip_smoke.sector_floor_ms``: the random 64-byte fetches of
``chip_smoke.lookup_sectors_baseline`` at ``chip_smoke.RANDOM_READS_PER_S``,
the rate ``tools/random_sector_peak.py`` measures), and the keys each of
HTI's tables finds.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_old(src: Path):
    """``src`` (its ``common.cuh`` beside it) built as the port builds its
    own, with the launchers' argument types set; logs each kernel's
    registers and spills."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import baselines_lookup as look
    out = _build.BUILD_DIR / "lookup_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libold.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent),
           "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}")
    for line in cs.ptxas_summary(proc.stdout):
        cs.log(f"build old: {line}")
    old = ctypes.CDLL(str(lib))
    for fn, argtypes in look._SIGNATURES.items():
        getattr(old, fn).argtypes = argtypes
        getattr(old, fn).restype = ctypes.c_int
    return old


@contextlib.contextmanager
def library(lib):
    """The wrappers' calls go to ``lib`` inside the block."""
    from repro_torch.kernels import _build
    saved = _build._libs.get("baselines_lookup")
    _build._libs["baselines_lookup"] = lib
    try:
        yield
    finally:
        _build._libs["baselines_lookup"] = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the other baselines_lookup.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-keys", type=int, default=24)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lookup_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import baselines as bl
    from repro_torch.kernels import _build
    from repro_torch.kernels import baselines_lookup as look
    smi = cs.phase_device(torch)
    for _, text in _build.build(("baselines_lookup",)).values():
        for line in cs.ptxas_summary(text):
            cs.log(f"build new: {line}")
    libs = {"new": look._lib(), "old": build_old(args.old.resolve())}
    order = ["old", "new"]

    dev = torch.device("cuda")
    n, n_absent = 1 << args.log2_keys, 1 << 20
    keys_np, vals_np, absent_np = cs.make_keys(n, n_absent, args.seed)
    keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
    vals = torch.from_numpy(vals_np.view(np.int32)).to(dev)
    probe = torch.cat([keys, torch.from_numpy(absent_np.view(np.int32)).to(
        dev)])
    max_log2 = int(np.ceil(np.log2(n / 0.30)))
    batch = n // 16
    timer = cs.DeviceTimer(torch)
    tables = [
        ("HT", "ht_lookup",
         lambda: bl.ht_create(max_log2, cs.FIG7_INITIAL_LOG2, device=dev),
         bl.ht_insert_many, bl.ht_lookup_many, bl.ht_lookup_plain),
        ("HTI", "hti_lookup",
         lambda: bl.hti_create(max_log2, cs.FIG7_INITIAL_LOG2, device=dev),
         bl.hti_insert_many, bl.hti_lookup_many, bl.hti_lookup_plain),
        ("CH", "ch_lookup",
         lambda: bl.ch_create(max_log2 - 4, cs.FIG7_CH_CAPACITY,
                              cs.FIG7_CH_SLOTS, device=dev),
         bl.ch_insert_many, bl.ch_lookup_many, bl.ch_lookup_plain),
    ]
    for label, lname, create, insert, lookup, plain in tables:
        st = create()
        for i in range(0, n, batch):
            st = insert(st, keys[i:i + batch], vals[i:i + batch])
        torch.cuda.synchronize()
        plain_ms, want = timer(lambda: plain(st, probe), reps=1, warmup=1)
        for name in order:
            with library(libs[name]):
                got = lookup(st, probe)
            assert cs.equal_bits(got, want), \
                f"{label}: the {name} build differs from the plain version"
            del got
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            with library(libs[name]):
                ms, _ = timer(lambda: lookup(st, probe), reps=args.reps,
                              warmup=2)
            times[name].append(ms)
        look_bytes = cs.lookup_bytes_baseline(torch, lname, st, probe)
        fetches, found = cs.lookup_sectors_baseline(torch, lname, st, probe)
        bound = look_bytes / cs.HBM_BYTES_PER_S * 1e3
        floor = cs.sector_floor_ms(fetches, probe.numel())
        mean = {name: sum(t) / len(t) for name, t in times.items()}
        cs.log(f"{label} ({lname}), {probe.numel()} probes ({n_absent} "
               f"absent), every build == plain: " + "; ".join(
                   f"{name} {' / '.join(f'{t:.4f}' for t in times[name])} ms "
                   f"(mean {mean[name]:.4f}, old / it "
                   f"{mean['old'] / mean[name]:.3f}x, "
                   f"{100 * floor / mean[name]:.1f}% of the floor)"
                   for name in order)
               + f" (turns {' '.join(order + order[::-1])}, each the mean of "
               f"{args.reps} calls); plain {plain_ms:.4f} ms; byte bound "
               f"{bound:.4f} ms ({look_bytes} B); sector floor {floor:.4f} ms ({fetches} random {cs.FETCH_BYTES}-byte "
               f"fetches, {fetches / probe.numel():.4f} a probe, at "
               f"{cs.RANDOM_READS_PER_S / 1e9:.2f} G/s, and the keys and "
               f"results at 3.35 TB/s); hits by table probed {found}; card "
               f"{smi}")
        del st, want
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
