"""Times two builds of ``flash_attention.cu`` against each other in float32 on
one card: the source under ``src/repro_torch/kernels/csrc/`` ("new") and
another copy of it, such as the parent commit's ("old"), given by
``--old``.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/flash_ab.py --old build/parent/src/repro_torch/kernels/csrc/flash_attention.cu

Both go through the wrapper, ``flash_attention.flash_attention``, whose
library is swapped for the old build during the old turns, on the same
seeded operands, laid out as ``ops.mha_forward`` passes them (strided q, k
and v views of the model layout), causal.  Shapes: ``chip_smoke.py``'s
``FLASH_SERVE_CASE`` (the serve CLI's float32 prefill layer, qwen3_4b at 4
x 2048 tokens) and ``FLASH_F32_CASES`` ((j)'s float32 prefill layers, then
q shorter than the keys).  At each shape: old and new in turns old, new,
new, old (each turn the mean of ``--reps`` calls after 3 warm-up calls, by
``chip_smoke.DeviceTimer``: CUDA events behind a sleep that holds the card
until every call is issued, so that the small cases time the kernel and not
the host's issue), both held to the plain version within
``chip_smoke.attn_limit``, the plain version's time,
``scaled_dot_product_attention``'s in float32 (``chip_smoke.time_sdpa_f32``:
with ``enable_gqa``, and on k and v expanded to every query head), and the
bound (``chip_smoke.flash_bound``: 3xTF32 at 494.7 TFLOP/s, with the CUDA
cores' 67 TFLOP/s beside it).  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_old(source: Path) -> ctypes.CDLL:
    """``source`` built as the port builds its own, with the launcher's
    argument types set."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    out = _build.BUILD_DIR / "flash_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libflash_old.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc {source}:\n{done.stdout}{done.stderr}")
    old = ctypes.CDLL(str(lib))
    fn = old.flash_attention_launch
    fn.argtypes = fa._SIGNATURES["flash_attention_launch"]
    fn.restype = ctypes.c_int
    return old


@contextlib.contextmanager
def library(lib):
    """The wrapper's calls go to ``lib`` (``None``: its own build) inside
    the block."""
    from repro_torch.kernels import _build
    saved = _build._libs.pop("flash_attention", None)
    if lib is not None:
        _build._libs["flash_attention"] = lib
    try:
        yield
    finally:
        _build._libs.pop("flash_attention", None)
        if saved is not None:
            _build._libs["flash_attention"] = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the other flash_attention.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, kernel_path
    smi = cs.phase_device(torch)
    builds = {"old": build_old(args.old), "new": None}
    timer = cs.DeviceTimer(torch)
    name, shape, skv, _, _, _ = cs.FLASH_SERVE_CASE
    cases = [(name, shape, skv, None, 0)] + cs.FLASH_F32_CASES
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 300)
    for name, (B, KV, G, Sq, hd), Skv, window, prefix in cases:
        qm = torch.randn((B, Sq, KV * G, hd), generator=gen, device=dev)
        km, vm = (torch.randn((B, Skv, KV, hd), generator=gen, device=dev)
                  for _ in range(2))
        q = qm.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
        k, v = km.transpose(1, 2), vm.transpose(1, 2)
        kw = dict(window=window, prefix_len=prefix)
        plain_ms, want = timer(lambda: ref.flash_attention_ref(q, k, v, **kw),
                               reps=1, warmup=1)
        times = {"old": [], "new": []}
        errs = {}
        for turn in ("old", "new", "new", "old"):
            with library(builds[turn]):
                ms, got = timer(lambda: flash_attention(q, k, v, **kw),
                                reps=args.reps, warmup=3)
            times[turn].append(ms)
            errs[turn] = cs.close(torch, got, want)
            del got
        sdpa_kw = dict(attn_mask=ref.flash_mask(Sq, Skv, device=dev, **kw))
        if window is None and not prefix and Sq == Skv:
            sdpa_kw = dict(is_causal=True)
        lib_ms, lib_text = cs.time_sdpa_f32(torch, timer, qm.transpose(1, 2),
                                            k, v, want, reps=args.reps,
                                            **sdpa_kw)
        del want
        flops, bytes_, bound, by = cs.flash_bound(q, k, prefix, window)
        old, new = (sum(times[t]) / 2 for t in ("old", "new"))
        cs.log(
            f"{name}: q {tuple(qm.shape)}, k/v {tuple(km.shape)}, window "
            f"{window}, prefix {prefix}, float32; old "
            f"{' / '.join(f'{t:.4f}' for t in times['old'])} ms, new "
            f"({kernel_path(q.dtype, hd)}) "
            f"{' / '.join(f'{t:.4f}' for t in times['new'])} ms (turns old, "
            f"new, new, old; each the mean of {args.reps} calls): "
            f"{old / new:.2f}x; |err| / limit old {errs['old'][0]:.3g}, new "
            f"{errs['new'][0]:.3g}; plain {plain_ms:.4f} ms; {lib_text}, "
            f"{lib_ms:.4f} ms; bound {bound:.4f} ms ({by}; {flops} flops, "
            f"{bytes_} B; the CUDA cores' 67 TFLOP/s: "
            f"{flops / cs.PEAK_F32 * 1e3:.4f} ms); new at "
            f"{100 * bound / new:.1f}% of the bound, "
            f"{flops / new / 1e9:.1f} TFLOP/s; card {smi}")
        del qm, km, vm, q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
