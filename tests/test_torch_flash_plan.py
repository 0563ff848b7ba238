"""The flash attention kernel's host plan (`flash_attention.flash_plan`):
the launch of `csrc/flash_attn.cu` for rows 10 (the codec DiT) and 15 (the
backbone's causal GQA prefill probe), on the CPU.

The plan is a function of the shape only. Its grid must cover every (query
tile, batch, head) once, its tile must be one the kernel instantiates (64
rows, one consumer warpgroup, at hd 64; 128 rows, two, at hd 128), and the
shared memory of that tile, by the kernel's own constants, must fit the
227 KB a block may take on the H100.
"""

import re
from pathlib import Path

import pytest

from uniaudio2_tpu_torch.ops import flash_attention as fa

SMEM_LIMIT = 232_448                       # bytes a block may take, H100
SOURCE = (Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attn.cu").read_text()
# (B, H, G, T, hd) of the main path: the codec windows, their tails, and
# the prefill probe
PATH_SHAPES = [(2, 24, 24, 186, 64), (2, 24, 24, 374, 64), (2, 24, 24, 750, 64),
               (2, 24, 24, 130, 64), (1, 24, 24, 130, 64), (1, 24, 8, 2048, 128),
               (1, 24, 8, 1000, 128)]


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_the_kernel_is_the_hopper_design():
    assert _constant("STAGES") >= 2
    assert "__launch_bounds__(NC * 128 + 32, 1)" in SOURCE   # + a producer warp
    assert "wgmma.mma_async" in SOURCE and "cp.async.bulk.tensor" in SOURCE
    assert "static_assert(smem_bytes(HD, BQ) <= 232448" in SOURCE


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 750, 2048])
@pytest.mark.parametrize("b,h,g", [(1, 2, 1), (2, 24, 24), (1, 24, 8), (4, 32, 8)])
def test_the_grid_covers_every_tile_once(b, h, g, t, hd):
    plan = fa.flash_plan(b, h, g, t, hd)
    assert plan.tiles * plan.bq >= t > (plan.tiles - 1) * plan.bq
    assert plan.blocks == b * h * plan.tiles


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_shared_memory_fits(hd):
    """Q's tile, the K and V stages in 64-column panels of 128-byte rows,
    the mbarriers and the 1024 bytes of alignment, by the kernel's
    constants: hd 128, 128 rows: 164,904 bytes (one block an SM); hd 64,
    64 rows: 74,792."""
    bq = fa.flash_plan(1, 1, 1, 1, hd).bq
    bk, stages = _constant("BK"), _constant("STAGES")
    smem = hd // 64 * 128 * (bq + 2 * stages * bk) + 8 * (2 * stages + 1) + 1024
    assert smem == {64: 74_792, 128: 164_904}[hd] <= SMEM_LIMIT


@pytest.mark.parametrize("b,h,g,t,hd", PATH_SHAPES)
def test_the_tile_follows_the_head_dim(b, h, g, t, hd):
    """hd 64 (the codec's windows): 64 rows, one consumer warpgroup. hd 128
    (the prefill probe): 128 rows, two. Neither T nor G moves it."""
    plan = fa.flash_plan(b, h, g, t, hd)
    assert plan.bq == hd
    for other_t in (1, 129, 4096):
        assert fa.flash_plan(b, h, h, other_t, hd).bq == plan.bq
    fa.flash_plan.cache_clear()
    assert fa.flash_plan(b, h, g, t, hd) == plan


@pytest.mark.parametrize("b,h,g,t,hd", [(1, 6, 4, 8, 64), (1, 4, 2, 8, 32),
                                        (1, 4, 0, 8, 64), (1, 4, 4, 0, 128)])
def test_no_plan_for_what_the_kernel_does_not_take(b, h, g, t, hd):
    with pytest.raises(ValueError):
        fa.flash_plan(b, h, g, t, hd)
