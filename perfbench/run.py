"""Entry point of the benchmark: ``python3 perfbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout (see ``harness.py``)."""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root and its ``src`` replace this file's directory, whose
# module names would shadow others
sys.path[:1] = [os.path.join(ROOT, "src"), ROOT]
# build and kernel caches at fixed paths inside the checkout (the program's
# own nvcc builds go to build/repro_torch/, kernels/_build.py)
_CACHE = os.path.join(ROOT, "build", "perfbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda_cache")

if __name__ == "__main__":
    from pathlib import Path

    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], root=Path(ROOT), t_start=T_START))
