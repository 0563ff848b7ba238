"""The port's batching server and HTTP endpoint (`engine/server.py`,
`engine/http_server.py`) on the CPU, over a tiny port engine that holds the
JAX engine's weights (f32, greedy): the batched results equal JAX's
`BatchingServer` on the same requests and the port engine's direct calls;
requests group by their sampling arguments, full groups launch without
waiting, submitters may be many threads, a failing decode reaches every
waiter, and a seeded request's tokens do not depend on its batch. The HTTP
endpoint binds 127.0.0.1 on a free port.
"""

import http.client
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JCfg
from uniaudio2_tpu.engine.decode import DecodeEngine as JEngine
from uniaudio2_tpu.engine.server import BatchingServer as JServer
from uniaudio2_tpu.models import unified as junified

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import tasks
from uniaudio2_tpu_torch.engine.decode import DecodeEngine
from uniaudio2_tpu_torch.engine.http_server import InferenceHTTPServer
from uniaudio2_tpu_torch.engine.server import BatchingServer

KW = dict(max_frames=6, buckets=(32,))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    jparams = junified.init_params(jax.random.PRNGKey(0), JCfg.tiny())
    jeng = JEngine(jparams, JCfg.tiny(), cache_dtype=jnp.float32, **KW)
    teng = DecodeEngine(convert_params(jax.tree_util.tree_map(np.asarray, jparams),
                                       "cpu"),
                        UnifiedModelConfig.tiny(), cache_dtype=torch.float32, **KW)
    return jeng, teng


def _grids(ts, n):
    out = []
    for i in range(n):
        prompt = (np.arange(1, 4 + i) * 3) % 50
        text = (np.arange(2, 7) + i) % 50
        out.append(tasks.prepare_tts(prompt, text, ts))
    return out


def _serve(server_cls, engine, items, mode="text", **kw):
    with server_cls(engine, max_batch=4, max_wait_ms=50.0) as srv:
        futs = [srv.submit(mode, g, m, topk=1, seed=888) for g, m in items]
        return [f.result(timeout=300) for f in futs], srv.stats


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", ["text", "audio"])
def test_batched_greedy_equals_jax_server(engines, mode):
    """Three requests ride one launch, their results JAX's server's."""
    jeng, teng = engines
    items = _grids(teng.cfg.tokens, 3)
    got, stats = _serve(BatchingServer, teng, items, mode)
    ref, _ = _serve(JServer, jeng, items, mode)
    for g, r in zip(got, ref):
        _equal(g, r)
    assert stats == {"requests": 3, "batches": 1, "batched_requests": 3}


def test_mixed_groups_and_full_batches(engines):
    _, teng = engines
    ts = teng.cfg.tokens
    (g1, m1), (g2, m2) = _grids(ts, 2)
    with BatchingServer(teng, max_batch=4, max_wait_ms=20.0) as srv:
        f_text = srv.submit("text", g1, m1, topk=1)
        f_audio = srv.submit("audio", g2, m2, topk=5, seed=7)
        text = f_text.result(timeout=300)
        reason, semantic = f_audio.result(timeout=300)
    assert text.ndim == 1 and reason.shape[0] == semantic.shape[0] == 8
    assert srv.stats["batches"] == 2           # other keys never co-batch
    with BatchingServer(teng, max_batch=2, max_wait_ms=10_000.0) as srv:
        futs = [srv.submit("text", g, m, topk=1) for g, m in _grids(ts, 4)]
        assert len([f.result(timeout=300) for f in futs]) == 4
    assert srv.stats["batches"] == 2           # two full groups, no timer
    with pytest.raises(ValueError):
        srv.submit("video", g1, m1)
    with pytest.raises(ValueError):
        srv.submit("audio", g1, m1, use_cfg=True)


def test_concurrent_submitters(engines):
    """More submitting threads than cores, the interpreter switching
    threads as often as it can: every result equals the direct call and
    no request is lost from the counts."""
    _, teng = engines
    items = _grids(teng.cfg.tokens, 4)
    n = 12
    results = [None] * n
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with BatchingServer(teng, max_batch=3, max_wait_ms=30.0) as srv:
            def worker(i):
                g, m = items[i % 4]
                results[i] = srv.submit("text", g, m, topk=1).result(timeout=300)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert srv.stats["requests"] == srv.stats["batched_requests"] == n
    expected = [teng.generate_text(g, m, topk=1) for g, m in items]
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, expected[i % 4])


def test_errors_reach_every_waiter(engines):
    _, teng = engines
    (g, m), = _grids(teng.cfg.tokens, 1)
    with BatchingServer(teng, max_batch=2, max_wait_ms=10_000.0) as srv:
        bad = srv.submit("text", np.zeros((5, 3), np.int64),
                         np.ones((5, 3), bool), topk=1)   # 3 streams, not 9
        good = srv.submit("text", g, m, topk=1)
        for f in (bad, good):                 # one launch: both fail
            with pytest.raises(ValueError):
                f.result(timeout=300)


def test_seeded_request_independent_of_batch(engines):
    """Per-request seeds: the same request and seed give the same sampled
    tokens alone and beside three others."""
    _, teng = engines
    items = _grids(teng.cfg.tokens, 4)
    g, m = items[1]
    for mode in ("text", "audio"):
        with BatchingServer(teng, max_batch=1, max_wait_ms=1.0) as srv:
            solo = srv.submit(mode, g, m, temperature=0.9, topk=5,
                              seed=7).result(timeout=300)
        with BatchingServer(teng, max_batch=4, max_wait_ms=10_000.0) as srv:
            futs = [srv.submit(mode, gg, mm, temperature=0.9, topk=5,
                               seed=7 if i == 1 else 100 + i)
                    for i, (gg, mm) in enumerate(items)]
            got = [f.result(timeout=300) for f in futs]
        assert srv.stats["batches"] == 1
        _equal(solo, got[1])
        other = teng.generate_text_batch([(g, m)], temperature=0.9, topk=5,
                                         seeds=[8])[0]
        if mode == "text":
            assert not np.array_equal(solo, other)


@pytest.fixture(scope="module")
def served(engines):
    _, teng = engines
    srv = InferenceHTTPServer(teng, max_batch=4, max_wait_ms=30.0)
    srv.start()
    yield srv, teng
    srv.stop()


def _post(port, path, payload, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    body = payload if isinstance(payload, str) else json.dumps(payload)
    conn.request("POST", path, body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def test_http_healthz_tts_asr(served):
    srv, engine = served
    ts = engine.cfg.tokens
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200 and body["ok"] is True and "requests" in body["stats"]

    prompt, text = [3, 1, 4], [1, 5, 9, 2]
    status, body = _post(srv.port, "/v1/tts", {
        "prompt_tokens": prompt, "text_tokens": text, "topk": 1, "seed": 7})
    assert status == 200, body
    g, m = tasks.prepare_tts(np.asarray(prompt), np.asarray(text), ts)
    reason, semantic = engine.generate_audio(g, m, topk=1, seed=7)
    np.testing.assert_array_equal(np.asarray(body["reason"]).reshape(8, -1), reason)
    np.testing.assert_array_equal(np.asarray(body["semantic"]).reshape(8, -1), semantic)

    rng = np.random.default_rng(0)
    reason, semantic = rng.integers(0, 30, (8, 5)), rng.integers(0, 60, (8, 9))
    status, body = _post(srv.port, "/v1/asr", {
        "prompt_tokens": [2, 7], "reason": reason.tolist(),
        "semantic": semantic.tolist(), "topk": 1})
    assert status == 200, body
    g, m = tasks.prepare_asr(np.asarray([2, 7]), reason.T, semantic.T, ts)
    np.testing.assert_array_equal(np.asarray(body["tokens"]),
                                  engine.generate_text(g, m, topk=1, seed=888))


def test_http_concurrent_requests_batch(engines):
    """Three concurrent HTTP requests ride exactly one launch. The server
    groups three and waits for batch-mates far longer than any scheduling
    delay: with a short wait, a first arrival ahead of the other two by
    more than the wait launches alone, and the two, queued behind its
    decode and expired by then, launch one at a time (the JAX batcher's
    policy too), so the count would depend on the machine's load."""
    _, teng = engines
    results = [None] * 3

    def worker(port, i):
        results[i] = _post(port, "/v1/tts", {
            "text_tokens": [1 + i, 5, 9], "topk": 1, "seed": 7})

    with InferenceHTTPServer(teng, max_batch=3, max_wait_ms=60_000.0) as srv:
        threads = [threading.Thread(target=worker, args=(srv.port, i))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        batches = srv.batcher.stats["batches"]
    assert all(r is not None and r[0] == 200 for r in results), results
    assert batches == 1


def test_http_bad_requests(served):
    srv, _ = served
    assert _post(srv.port, "/v1/tts", {})[0] == 400                # no text
    assert _post(srv.port, "/v1/asr", {"reason": [[1, 2]],
                                       "semantic": [[3]]})[0] == 400
    assert _post(srv.port, "/v1/asr", {"reason": [1, 2],
                                       "semantic": [3]})[0] == 400
    assert _post(srv.port, "/v1/tts", "{not json")[0] == 400
    assert _post(srv.port, "/v1/nope", {})[0] == 404
