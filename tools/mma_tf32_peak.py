"""The rate of ``mma.sync.m16n8k8`` in TF32 (f32 accumulators) on one card:
the ceiling of the float32 flash kernel's instruction
(``flash_tf32x3_kernel`` in ``src/repro_torch/kernels/csrc/
flash_attention.cu``), beside the data sheet's dense TF32 rate (494.7
TFLOP/s on an H100 SXM, which ``wgmma`` reaches).

    python3 tools/mma_tf32_peak.py

Each warp issues ``iters`` rounds of ``chains`` independent products into
its own accumulators (operands in registers, nothing else in the loop), 8
warps a block, 4 blocks an SM.  Timed with CUDA events, the mean of 5
launches after one warm-up; one chain shows the latency of a dependent
product.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>
template <int CHAINS>
__global__ void __launch_bounds__(256) peak(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x * 3u, b1 = threadIdx.x * 5u;
  for (int j = 0; j < 4; ++j) a[j] = (threadIdx.x + j) * 0x3F800000u;
  float d[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, "
          "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) s += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int peak_launch(int chains, float* out, int blocks, int iters,
                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: peak<1><<<blocks, 256, 0, st>>>(out, iters); break;
    case 2: peak<2><<<blocks, 256, 0, st>>>(out, iters); break;
    case 4: peak<4><<<blocks, 256, 0, st>>>(out, iters); break;
    case 8: peak<8><<<blocks, 256, 0, st>>>(out, iters); break;
    default: return 1;
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_peak: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "mma_tf32_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "peak.cu", out_dir / "libpeak.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.peak_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    name = torch.cuda.get_device_name(0)
    for chains in (1, 2, 4, 8):
        def run():
            assert lib.peak_launch(chains, out.data_ptr(), blocks, iters,
                                   stream) == 0
        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        flops = 2 * 16 * 8 * 8 * chains * iters * blocks * 8
        print(f"mma.sync.m16n8k8 tf32, {chains} independent chain(s) a warp, "
              f"{blocks} blocks of 8 warps on {sms} SMs: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s ({100 * flops / ms / 1e9 / 494.7:.1f}% "
              f"of 494.7); {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
