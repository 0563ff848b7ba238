"""The tests of `test_torch_serving_formats.py` (the port's decode engine
against the JAX `DecodeEngine`, trees byte-identical and greedy tokens
identical) for configurations D and E: int4all and int4allg in the
quantizers' K-split + column-packed layout, the JAX ``UA2_INT4I=0``.
The code lives in that file; this one gives it its own ``served`` fixture,
so that a parallel run spreads the configurations over workers.
"""

import pytest

import test_torch_serving_formats as base
from test_torch_serving_formats import (  # noqa: F401  (collected here)
    one_thread,
    test_generate_audio_cfg_greedy_identical,
    test_generate_audio_greedy_identical,
    test_generate_text_greedy_identical,
    test_trees_container_for_container_equal,
)


@pytest.fixture(scope="module", params=["D-int4all-ksplit", "E-int4allg-ksplit"])
def served(request):
    return base.build(request.param)
