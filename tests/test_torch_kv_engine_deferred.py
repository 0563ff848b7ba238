"""The tests of `test_torch_kv_engine.py` (the port's `DecodeEngine` at its
own defaults against the JAX engine, greedy tokens identical) under
deferred KV writes: int8 cache, block-128 prefix reads, and every layer's
K/V written in one coalesced write per frame into the stacked cache. The
code lives in that file; this one gives it its own ``engines`` fixture, so
that a parallel run spreads the policies over workers.
"""

import pytest

import test_torch_kv_engine as base
from test_torch_kv_engine import (  # noqa: F401  (collected here)
    model,
    one_thread,
    test_generate_audio_identical_to_jax,
    test_generate_text_identical_to_jax,
)


@pytest.fixture(scope="module", params=["deferred"])
def engines(request, model):  # noqa: F811
    return base.build(request.param, model)
