"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and linked into one shared
library with a plain C interface, which is loaded with ``ctypes``. The
library is named by a hash of the sources, so an edited source is rebuilt,
and it lives in ``build/kernels/`` at the repository root (listed in
``.gitignore``). Nothing is built when a module is imported: the first
launch builds, or a caller (``chip_smoke.py``) calls `build` itself.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("gemv_int4i.cu", "gemv_int8.cu", "gemv_int4.cu", "gemv_int4g.cu",
           "gemv_int4c.cu", "gemv_int4cg.cu", "qkv_rope.cu", "fused_swiglu.cu",
           "flash_attn.cu", "flash_attn_f32.cu", "lean_update.cu",
           "gemv_int8_splitk.cu", "gemv_int4_native.cu", "gemv_int4_sweep.cu",
           "gemv_int4_stacked.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps, out_f32, stream
# (G scale groups, 0 = per-channel)
_GEMV = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
# the same with the host's plan before the stream: for the column-packed
# forms splits (0 = the tiled instance), span (`quant.tc_plan`); rows 1, 4,
# 5 and 6 splits (0 = the tiled instance), mt, span (mt 16: the split-K
# kernel, `quant.gemv_plan`; mt = the tile kernel's BN: `quant.tc_plan`)
# and the tile kernel's scratch for x (or NULL)
_GEMV_TC = _GEMV[:-1] + [_I, _I, _P]
_GEMV_ROWS = _GEMV[:-1] + [_I, _I, _I, _P, _P]
_SIGNATURES = {
    "ua2_gemv_int4i": _GEMV_ROWS,
    "ua2_gemv_int4i_tiled": _GEMV,
    "ua2_gemv_int8": _GEMV_ROWS,
    "ua2_gemv_int8_wide": _GEMV_ROWS,
    "ua2_gemv_int8_tiled": _GEMV,
    "ua2_gemv_int4": _GEMV_ROWS,
    "ua2_gemv_int4_tiled": _GEMV,
    "ua2_gemv_int4g": _GEMV_ROWS,
    "ua2_gemv_int4g_tiled": _GEMV,
    "ua2_gemv_int4c": _GEMV_TC,
    "ua2_gemv_int4c_tiled": _GEMV,
    "ua2_gemv_int4cg": _GEMV_TC,
    "ua2_gemv_int4cg_tiled": _GEMV,
    # splits, int* out: the tile kernel's clusters of `splits` blocks the
    # card holds at once
    "ua2_tc_max_clusters": [_I, _P],
    # x, w, scale, norm_w, cos, sin, q, k, v, B, K, n_head, n_groups,
    # head_size, layout, G, eps, stream: the first design at any B
    "ua2_qkv_rope_tiled": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _F, _P],
    # the same with the split-K plan before the stream: splits, span
    # (`quant.gemv_plan`; above 16 rows the first design, the plan unread)
    "ua2_qkv_rope": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _F, _I, _I, _P],
    # x, w1, s1, w2, s2, w3, s3, norm_w, residual, ab, out, M, K, I, N,
    # ldw3, layout12, G12, layout3, G3, eps, splits1, span1, splits3, span3,
    # stream (`fused_mlp.swiglu_plan`)
    "ua2_fused_swiglu": [_P] * 11 + [_I] * 9 + [_F] + [_I] * 4 + [_P],
    # x, w1, s1, w2, s2, w3, s3, norm_w, residual, xn, h, out, M, K, I, N,
    # ldw3, layout12, G12, layout3, G3, eps, splits1, span1, splits3, span3,
    # stream: the two tile passes above 16 rows (`fused_mlp.swiglu_plan`)
    "ua2_fused_swiglu_tc": [_P] * 12 + [_I] * 9 + [_F] + [_I] * 4 + [_P],
    # x, w1, s1, w2, s2, w3, s3, norm_w, residual, h, out, M, K, I, N,
    # ldw3, layout12, G12, layout3, G3, eps, stream: the two tiled passes
    "ua2_fused_swiglu_tiled": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, o, B, H, G, T, hd, scale, causal, bq (query rows a block,
    # `flash_attention.flash_plan`), stream
    "ua2_flash_attn": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, o, B, H, G, T, hd, scale, stream: float32, non-causal
    # (csrc/flash_attn_f32.cu: 3xTF32 on the tensor cores, and the first
    # design on the CUDA cores)
    "ua2_flash_attn_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "ua2_flash_attn_f32_simt": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # hd, bq, int[3] out: keys a stage, stages, dynamic shared bytes
    "ua2_flash_layout": [_I, _I, _P],
    # g, m_q, m_scale, p, a, b, upd, new_m_q, new_m_scale, rows,
    # rows_per_lead, cols, is_bf16, b1, 1 - b1, wd, eps, inv_mc, -lr, stream
    "ua2_lean_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _P],
    # x, w, scale, out, M, K, N, ldw, splits, span (pairs of rows,
    # `int4_stream.stream_plan`), stream: row 12 on the TMA ring
    "ua2_gemv_int8_splitk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w, scale, partial, out, K, N, ldw, splits, chunk, stream: the first
    # design
    "ua2_gemv_int8_splitk_twopass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P],
    # x, w, scale, out, M, K, N, ldw (the padded width), bn (0 = row-major),
    # splits, span (`int4_stream.stream_plan`), stream: the TMA-ring kernel
    "ua2_gemv_int4_native": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # int[5] out: its form (tn, bk, stages, slice rule, unpack)
    "ua2_gemv_int4_native_form": [_P],
    # x, w, scale, out, M, K, N, ldw (0 for chunk-major), bn, stream: the
    # first design
    "ua2_gemv_int4_native_simt": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # form, x, w, scale, out, M, K, N, ldw, splits, span, stream
    "ua2_gemv_int4_sweep": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # form, int[5] out: tn, bk, stages, slice rule, unpack
    "ua2_gemv_int4_sweep_form": [_I, _P],
    # tn, box byte rows, stages, M, span: the TMA-ring kernel's dynamic
    # shared bytes
    "ua2_gemv_int4_stream_smem": [_I, _I, _I, _I, _I],
    # form, x, w, scale, out, M, K, N, ldw, stream: the first design's forms
    "ua2_gemv_int4_sweep_simt": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # form, int[4] out: cols, unroll, mt, unpack
    "ua2_gemv_int4_sweep_simt_form": [_I, _P],
    # x, w, scale, layer, out, M, K, N, ldw, s_stride, L, splits, span
    # (`int4_stream.stream_plan`), stream: row 14 on the TMA ring
    "ua2_gemv_int4_stacked": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
                              _I, _P],
    # x, w, scale, layer, out, M, K, N, ldw, w_stride, s_stride, L, stream:
    # the first design
    "ua2_gemv_int4_stacked_simt": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                                   _L, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_info = {"seconds": None, "log": ""}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library; a
    library built from the same sources is reused. The compiler's output,
    with ``-Xptxas -v`` (registers, shared memory and spills per kernel),
    is kept in ``build_info["log"]``."""
    lib_path = BUILD_DIR / f"libua2_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, "-Xptxas", "-v"]
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc, *flags, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(obj.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(log))
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    build_info.update(seconds=time.perf_counter() - t0,
                      log="".join(log) + link.stdout)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        handle.ua2_error_string.argtypes = [ctypes.c_int]
        handle.ua2_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().ua2_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def count(fn, form: Optional[str] = None) -> None:
    """One launch of wrapper ``fn``: its ``launches`` count and, for a
    wrapper with several weight forms, its count of ``form``."""
    fn.launches += 1
    if form is not None:
        fn.forms[form] = fn.forms.get(form, 0) + 1


_COUNTED: list = []     # every wrapper whose count was ever reset


def reset_count(fn) -> None:
    """Zero ``fn``'s counts (and register it: a wrapper's module resets its
    count once at import)."""
    fn.launches = 0
    fn.forms = {}
    if fn not in _COUNTED:
        _COUNTED.append(fn)


class Counter:
    """The count of a kernel that several wrappers launch, kept beside the
    wrappers' own counts (by the launching wrapper's form) and registered
    as they are, so that captured graphs and `counts_since` see it."""

    def __init__(self, name: str):
        self.__name__ = name
        reset_count(self)


def counts() -> dict:
    """Every registered wrapper's counts: {fn: (launches, forms)}."""
    return {fn: (fn.launches, dict(fn.forms)) for fn in _COUNTED}


def counts_since(before: dict) -> dict:
    """The launches counted after the snapshot ``before`` (of `counts`)."""
    delta = {}
    for fn, (launches, forms) in counts().items():
        n0, f0 = before.get(fn, (0, {}))
        df = {k: v - f0.get(k, 0) for k, v in forms.items() if v != f0.get(k, 0)}
        if launches != n0 or df:
            delta[fn] = (launches - n0, df)
    return delta


def set_counts(snapshot: dict) -> None:
    """Put every wrapper's counts back to ``snapshot``."""
    for fn, (launches, forms) in snapshot.items():
        fn.launches, fn.forms = launches, dict(forms)


def capture_graph(fn, pool=None, generator=None):
    """Capture ``fn()`` into a CUDA graph (on the current device, in the
    memory pool ``pool``, with ``generator``'s state registered when one is
    given). The wrappers ``fn`` runs count nothing: returns the graph and
    the counts one replay launches, for `add_counts`."""
    import torch

    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "this torch cannot register a torch.Generator with a CUDA "
                "graph (CUDAGraph.register_generator_state is missing), so "
                "a step that samples from it cannot be captured: sample "
                "with per-row seeds (RowKeys, no generator) or decode with "
                "DecodeEngine(graph=False)")
        graph.register_generator_state(generator)
    before = counts()
    with torch.cuda.graph(graph, pool=pool):
        fn()
    per_replay = counts_since(before)
    set_counts(before)
    return graph, per_replay


def add_counts(delta: dict, times: int) -> None:
    """Count ``times`` launches of each kernel in ``delta`` (of
    `counts_since`): what ``times`` replays of a captured CUDA graph launch,
    since a replay runs no Python wrapper."""
    for fn, (launches, forms) in delta.items():
        fn.launches += launches * times
        for k, v in forms.items():
            fn.forms[k] = fn.forms.get(k, 0) + v * times


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
