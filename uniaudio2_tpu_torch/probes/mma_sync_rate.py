"""The tensor cores' rate through ``mma.sync`` on the H100: TF32 m16n8k8
(the products of the float32 flash kernel, `csrc/flash_attn_f32.cu`, three
a product) and bf16 m16n8k16 for comparison, against the data sheet's
dense rates through ``wgmma`` (495 and 989 TFLOP/s).

    python -m uniaudio2_tpu_torch.probes.mma_sync_rate

A kernel of its own (compiled here with nvcc into ``build/probes/``; it is
no kernel of the port) runs 8 independent accumulators a warp, each
2,000 steps, no memory traffic, at 4, 8 and 16 warps an SM; one JSON line
per case with the rate from CUDA events.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from uniaudio2_tpu_torch.ops import _cuda

SOURCE = r"""
#include <cuda_runtime.h>
template <bool TF>
__global__ void rate(float* out, int iters) {
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[0] + j), "r"(a[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[0] + j), "r"(a[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int c = 0; c < 4; ++c) s += d[j][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_rate(int tf, float* out, int blocks, int threads, int iters) {
  if (tf) rate<true><<<blocks, threads>>>(out, iters);
  else rate<false><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
ITERS = 2000


def main(device: str = "cuda"):
    from uniaudio2_tpu_torch.probes import card

    build = _cuda.BUILD_DIR.parent / "probes"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "mma_sync_rate.cu", build / "mma_sync_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int]
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 16 * 32, device=dev)
    lines = []
    for tf in (1, 0):
        for warps in (4, 8, 16):
            blocks, threads = sms * warps // 4, 128
            _cuda.check(lib.run_rate(tf, out.data_ptr(), blocks, threads, ITERS),
                        "run_rate")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run_rate(tf, out.data_ptr(), blocks, threads, ITERS)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            k = 8 if tf else 16
            flop = blocks * threads // 32 * ITERS * 8 * 2 * 16 * 8 * k
            line = {"probe": "mma_sync_rate", "card": card(),
                    "mma": "tf32 m16n8k8" if tf else "bf16 m16n8k16",
                    "warps_per_sm": warps, "tflops": flop / ms / 1e9}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
