"""How fast the H100 reads the int8 lm_head's bytes in the access patterns of
row 4's split-K instances, with no arithmetic: the question behind the
wide-N instance of `csrc/gemv_int4_splitk.cuh`.

    python -m uniaudio2_tpu_torch.probes.int8_read_pattern

A (3072, 128256) int8 weight stored 128512 wide (the lm_head's 395 MB
read, 3072 x 128256 bytes) is read by one launch of each pattern and its
bytes XOR-folded into a register (no store unless the fold hits a
constant, so nothing is written):

* ``gemv``: the GEMV mode's: a block of four warps owns 64 columns, a warp
  step reads 16 rows x 64 bytes (a lane 8 bytes of rows t + 4 l), the
  warps take every fourth step, four steps a batch (2,004 blocks);
* ``wide``: the wide-N mode's: warp w owns columns 64 w of a 256-column
  block and walks every step, three or four steps a batch (501 blocks);
* ``rows``: 512 contiguous bytes of one row a warp load (a lane 16);
* ``stream``: as many bytes read front to back, 16 bytes a thread.

One JSON line a pattern: the median time of one launch, L2 flushed before
each (`probes.FlushedTimer`), and its share of 3.35 TB/s. The source is
compiled with nvcc into ``build/probes/`` on first use.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from uniaudio2_tpu_torch.ops import _cuda

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ unsigned sink;

// 16 rows x 64 bytes a warp step (rows t + 4 l, l < 4), RB steps a batch;
// the block's warps take every fourth step of all K (WIDE = false) or warp
// w owns columns 64 w of the block's 256 and takes every step (WIDE = true)
template <int RB, bool WIDE>
__global__ void __launch_bounds__(128) steps(const int8_t* w, int K, int ldw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, gq = lane >> 2;
  const int col0 = WIDE ? blockIdx.x * 256 + 64 * warp : blockIdx.x * 64;
  const int8_t* wp = w + (size_t)t * ldw + col0 + 8 * gq;
  const int n_steps = K / 16;
  const int first = WIDE ? 0 : warp * RB, stride = WIDE ? RB : 4 * RB;
  unsigned acc = 0;
  for (int b = first; b < n_steps; b += stride) {
    uint2 v[RB][4];
#pragma unroll
    for (int u = 0; u < RB; ++u)
#pragma unroll
      for (int l = 0; l < 4; ++l)
        v[u][l] = b + u < n_steps ? __ldg(reinterpret_cast<const uint2*>(
                                        wp + (size_t)(16 * (b + u) + 4 * l) * ldw))
                                  : make_uint2(0u, 0u);
#pragma unroll
    for (int u = 0; u < RB; ++u)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc += v[u][l].x ^ v[u][l].y;
  }
  if (acc == 0x12345678u) sink = acc;
}

// 512 contiguous bytes of a row a warp load; warp w rows w, w + 4, ...
__global__ void __launch_bounds__(128) rows(const int8_t* w, int K, int ldw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * 512 + 16 * lane;
  unsigned acc = 0;
  for (int r = warp * 4; r < K; r += 16) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = r + u < K ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(r + u) * ldw + col0))
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x12345678u) sink = acc;
}

__global__ void stream(const uint4* w, size_t n) {
  unsigned acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 v = __ldg(w + i);
    acc += v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678u) sink = acc;
}

extern "C" int read_pattern(int pattern, const void* w, int K, int N, int ldw,
                            int sms, void* s) {
  const int8_t* p = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(s);
  switch (pattern) {
    case 0: steps<4, false><<<(N + 63) / 64, 128, 0, st>>>(p, K, ldw); break;
    case 1: steps<4, true><<<(N + 255) / 256, 128, 0, st>>>(p, K, ldw); break;
    case 2: steps<3, true><<<(N + 255) / 256, 128, 0, st>>>(p, K, ldw); break;
    case 3: rows<<<(N + 511) / 512, 128, 0, st>>>(p, K, ldw); break;
    default:
      stream<<<8 * sms, 256, 0, st>>>(reinterpret_cast<const uint4*>(w),
                                      (size_t)K * N / 16);
  }
  return (int)cudaGetLastError();
}
"""
PATTERNS = ("gemv", "wide", "wide, 3 steps a batch", "rows", "stream")
K, N, LDW = 3072, 128256, 128512


def library() -> ctypes.CDLL:
    """The probe's kernels, built from `SOURCE` into build/probes/."""
    out = _cuda.BUILD_DIR.parent / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "int8_read_pattern.cu", out / "libint8_read_pattern.so"
    if not src.exists() or src.read_text() != SOURCE or not lib.exists():
        src.write_text(SOURCE)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                        str(lib), str(src)], check=True)
    handle = ctypes.CDLL(str(lib))
    handle.read_pattern.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    handle.read_pattern.restype = ctypes.c_int
    return handle


def main(device: str = "cuda"):
    """Time each pattern; print one JSON line each and return them."""
    from uniaudio2_tpu_torch.probes import PEAK_BYTES, FlushedTimer, card

    dev = torch.device(device)
    lib = library()
    timer = FlushedTimer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = torch.ones((K, LDW), dtype=torch.int8, device=dev)
    print(json.dumps({"probe": "int8_read_pattern", "card": card(),
                      "bytes": K * N}), flush=True)
    lines = []
    for i, name in enumerate(PATTERNS):
        def run():
            err = lib.read_pattern(i, w.data_ptr(), K, N, LDW, sms,
                                   _cuda.stream_of(w))
            if err:
                raise RuntimeError(f"read_pattern {name}: CUDA error {err}")
        ms = timer(run)
        line = {"pattern": name, "ms": ms,
                "share_of_peak": K * N / (ms * 1e-3) / PEAK_BYTES}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
