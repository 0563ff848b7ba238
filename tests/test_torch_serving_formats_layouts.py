"""The tree and single-request tests of `test_torch_serving_formats.py`
for configurations D and E with a prompt in bucket 256 (255 prefill rows,
past the fused kernels' 128, so every projection and the column-packed
down-projection take the plain GEMV path) and for D served from the stacked
``unroll=False`` layout (per-layer slices of stacked containers).
The code lives in that file; this one gives it its own ``served`` fixture,
so that a parallel run spreads the configurations over workers.
"""

import pytest

import test_torch_serving_formats as base
from test_torch_serving_formats import (  # noqa: F401  (collected here)
    one_thread,
    test_generate_audio_greedy_identical,
    test_trees_container_for_container_equal,
)


@pytest.fixture(scope="module", params=["D-bucket256", "E-bucket256", "D-stacked"])
def served(request):
    return base.build(request.param)
