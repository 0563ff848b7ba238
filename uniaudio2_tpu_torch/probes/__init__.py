"""Ports of the JAX package's TPU measurement probes (`scripts/`), each a
script that runs on the card: `profile_gemv` (the split-K int8 GEMV against
the production int8 kernel, a bf16 product and an int8 x int8 product),
`profile_attention` (the causal GQA flash kernel at the backbone's prefill
shape and the DiT's kernel, against the production einsum path and SDPA),
`int4_native_probe` (row 1's GEMV with a conversion-free unpack) and
`sweep_gemv_blocks` (row 5's K-split GEMV in twelve tile forms, at M = 1,
8 and 16); and, with no TPU counterpart, `gemv_splitk_sweep` (rows 1 and
6's split-K GEMV at every legal number of K-slices, against the host's
plan), `tc_splits_sweep` (the tensor-core tile kernel of rows 1, 6, 7
and 8 likewise), `swiglu_splits_sweep` (row 2's two split-K passes likewise),
`splitk_ab` (rows 1, 5 and 6's split-K GEMVs through this checkout's
kernel library and another checkout's, in one process) and
`int8_read_pattern` (the lm_head's bytes read in row 4's access patterns,
no arithmetic). Each prints the
card's name and power limit beside its numbers."""

import statistics
import subprocess

PEAK_BF16 = 989e12      # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def bound_us(n_bytes: int, flops: int) -> float:
    """Least time of one call (us): the bytes at the HBM rate or the
    operations at the bf16 peak, the larger."""
    return max(n_bytes / PEAK_BYTES, flops / PEAK_BF16) * 1e6


class FlushedTimer:
    """Median CUDA-event time (ms) of single launches, the 50 MB L2 flushed
    (a 256 MiB buffer zeroed) before each, as a decode step finds it.

    After the flush the card spins for `SPIN_CYCLES` (``torch.cuda._sleep``,
    ~0.25 ms at the H100's 1.98 GHz) before the start event, so the host
    has queued the timed launch, wrapper and all, before the card reaches
    the start event: the host's launch cost stays out of the timed window
    as long as it takes less than the flush and the spin."""

    SPIN_CYCLES = 500_000

    def __init__(self, device):
        import torch

        self.torch = torch
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device=device)

    def __call__(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def int4_tinygemm(w):
    """Any int4 container repacked once for ``torch._weight_int4pack_mm``
    (the library's int4 GEMV, timed as a yardstick, never on the port's
    path): levels + 8 as uint4, zero points 0, bf16 scales per group of
    rows (the container's own groups, or the per-channel scale repeated
    over groups of 256 rows). The library packs whole groups of 8 output
    columns: a width that is not a multiple of 8 (the audio head's 12300)
    gets zero columns past it. Returns (packed weight, group size, scales
    and zeros)."""
    import torch

    from uniaudio2_tpu_torch.ops import quant

    q = (quant.levels(w).T + 8).contiguous()                         # (N, K)
    scale = w.scale if w.scale.ndim == 2 else w.scale[None]
    pad = -q.shape[0] % 8
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad), value=8)
        scale = torch.nn.functional.pad(scale, (0, pad))
    packed = ((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8).contiguous()
    n, k = q.shape
    if scale.shape[0] == 1:
        scale = scale.expand(k // 256, n)
    sz = torch.stack([scale, torch.zeros_like(scale)], -1).to(
        torch.bfloat16).contiguous()
    return (torch._convert_weight_to_int4pack(packed, 8), k // scale.shape[0],
            sz)
