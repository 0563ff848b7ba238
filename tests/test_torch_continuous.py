"""The port's continuous-batching scheduler (`engine/continuous.py`) against
the JAX package's `ContinuousEngine` and the port's own unbatched
`DecodeEngine`, on the CPU in float32, where the frame step that a card
replays as a CUDA graph runs eagerly.

The cases are `tests/test_continuous.py`'s: staggered text, audio and CFG
admission, the offline refill-on-completion path (text, audio, CFG), the
cache-budget reset and the submit refusals, attn_block identity, online
timings, ladder parsing and ladder identity, both overlap-window cases,
overlap then drain, and warm-up; then the int8 `QuantKV` cache with inline
and deferred writes, the refill's row-view splice in the stacked and the
list layout, a text EOS inside a segment, and sampled tokens reproducible
from one seed.

Greedy tokens (``topk=1``) must be identical to JAX's, request by request;
sampled tokens cannot match JAX's (the two frameworks draw different
numbers), so they are held to reproducibility. Each JAX reference is
computed once per configuration (one compiled engine each, `jax_ref`).
The JAX package's `_step_overlap` keeps its turn flag across overlap
windows; its runs here reset ``_flip`` when no overlap is open, as
`scripts/bench_serving_latency.py` does, and the port resets it itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import continuous as jcontinuous
from uniaudio2_tpu.engine import tasks
from uniaudio2_tpu.models import unified as junified

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import continuous
from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine
from uniaudio2_tpu_torch.engine.decode import DecodeEngine
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.ops.kv_cache import QuantKV

BASE = dict(bucket=32, seg_frames=4, cache_len=256, max_frames=8, topk=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny()
    jparams = junified.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, UnifiedModelConfig.tiny(), convert_params(jparams,
                                                                     "cpu")


def _requests(ts, n):
    reqs = []
    for i in range(n):
        prompt = (np.arange(1, 4 + (i % 3)) * 5 + i) % 50
        text = (np.arange(2, 8) * 3 + i) % 50
        reqs.append(tasks.prepare_tts(prompt, text, ts))
    return reqs


def _cfg_requests(ts, n):
    reqs = []
    for i in range(n):
        prompt = (np.arange(1, 4 + (i % 3)) * 5 + i) % 50
        text = (np.arange(2, 8) * 3 + i) % 50
        g, m = tasks.prepare_tts(prompt, text, ts)
        ng, nm = tasks.prepare_tts_cfg_negative(prompt, text, ts)
        reqs.append((g, m, ng, nm))
    return reqs


def _submit_all(ce, reqs, caps=None):
    caps = caps or [None] * len(reqs)
    return [ce.submit(*r[:2], max_frames=c,
                      **({} if len(r) == 2 else dict(neg_grid=r[2],
                                                     neg_mask=r[3])))
            for r, c in zip(reqs, caps)]


def _online(ce, rids, jax_side=False, calls=200):
    """step_online until every request completes (a JAX engine gets its
    turn flag reset whenever no overlap window is open)."""
    results = {}
    for _ in range(calls):
        if jax_side and ce._overlap is None:
            ce._flip = False
        results.update(ce.step_online())
        if len(results) == len(rids):
            break
    assert len(results) == len(rids)
    return [results[r] for r in rids]


@pytest.fixture(scope="module")
def jax_ref(setup):
    """``jax_ref(name)``: the JAX engine's results for one configuration,
    computed on first use and kept for the module."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _jax_run(setup, name)
        return runs[name]
    return get


def _jax_run(setup, name):
    jcfg, jp = setup[0], setup[1]
    ts = jcfg.tokens
    f32 = dict(cache_dtype=jnp.float32)

    def engine(cfg=jcfg, **kw):
        # fixed segments: two programs to compile (greedy tokens do not
        # depend on the segment lengths, which the port's ladder cases vary)
        return jcontinuous.ContinuousEngine(
            jp, cfg, **dict(BASE, **f32, seg_ladder="off", **kw))

    if name == "text":
        ce = engine(mode="text", rows=2)
        rids = _submit_all(ce, _requests(ts, 5))
        res = ce.run_until_drained()
        out = [res[r] for r in rids]
    elif name == "audio":
        ce = engine(mode="audio", rows=2)
        rids = _submit_all(ce, _requests(ts, 3))
        res = ce.run_until_drained()
        out = [res[r] for r in rids]
    elif name == "budget":
        ce = engine(mode="text", rows=1, cache_len=64)
        rids = _submit_all(ce, _requests(ts, 3), [16] * 3)
        res = ce.run_until_drained()
        out = [res[r] for r in rids]
    elif name == "offline":
        ce = engine(mode="text", rows=2, cache_len=80)
        out = ce.run_offline([(g, m, 8) for g, m in _requests(ts, 6)])
    elif name == "offline_audio":
        out = engine(mode="audio", rows=2).run_offline(
            [(g, m, 8) for g, m in _requests(ts, 3)])
    elif name == "cfg":
        ce = engine(mode="audio", rows=2, use_cfg=True, cfg_scale=1.5)
        rids = _submit_all(ce, _cfg_requests(ts, 3))
        res = ce.run_until_drained()
        out = [res[r] for r in rids]
    elif name == "cfg_offline":
        out = engine(mode="audio", rows=2, use_cfg=True,
                     cfg_scale=1.5).run_offline(
            [(*r, 8) for r in _cfg_requests(ts, 4)])
    elif name == "overlap":
        ce = engine(mode="text", rows=2, cache_len=64, max_frames=24,
                    windows=2)
        out = _online(ce, _submit_all(ce, _requests(ts, 3), [8, 24, 24]),
                      jax_side=True)
    elif name == "overlap_cfg":
        ce = engine(mode="audio", rows=4, cache_len=64, max_frames=24,
                    use_cfg=True, cfg_scale=1.5, windows=2)
        out = _online(ce, _submit_all(ce, _cfg_requests(ts, 3), [8, 24, 24]),
                      jax_side=True)
    elif name.startswith("int8_"):
        ce = engine(mode="text", rows=2, kv_quant="on",
                    kv_write=name[len("int8_"):])
        rids = _submit_all(ce, _requests(ts, 4))
        res = ce.run_until_drained()
        out = [res[r] for r in rids]
    elif name == "eos":
        cfg = dataclasses.replace(jcfg, tokens=dataclasses.replace(
            ts, text_eos=974))
        out = engine(cfg, mode="text", rows=2).run_offline(
            [(g, m, 8) for g, m in _requests(ts, 5)])
    else:
        raise ValueError(name)
    return out


def _port(setup, **kw):
    kw = dict(BASE, **kw)
    kw.setdefault("cache_dtype", torch.float32)
    return ContinuousEngine(setup[3], setup[2], **kw)


def _unbatched(setup, mode, reqs, frames=8, **kw):
    """The port's own DecodeEngine, one request at a time (greedy)."""
    eng = DecodeEngine(setup[3], setup[2], max_frames=frames,
                       cache_dtype=torch.float32, buckets=(32,))
    if mode == "text":
        return [eng.generate_text(g, m, topk=1) for g, m in reqs]
    return [eng.generate_audio(g, m, topk=1, **kw) for g, m in reqs]


def _same(got, *refs):
    for ref in refs:
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            if isinstance(a, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_text_staggered_matches_unbatched(setup, jax_ref):
    reqs = _requests(setup[2].tokens, 5)
    ce = _port(setup, mode="text", rows=2)
    rids = _submit_all(ce, reqs)
    results = ce.run_until_drained()
    assert set(results) == set(rids)
    _same([results[r] for r in rids], jax_ref("text"),
          _unbatched(setup, "text", reqs))
    # 5 requests through 2 rows: refills into a RUNNING batch
    assert ce.stats["refills"] == 5
    assert ce.stats["segments"] >= 2


def test_audio_staggered_matches_unbatched(setup, jax_ref):
    reqs = _requests(setup[2].tokens, 3)
    ce = _port(setup, mode="audio", rows=2)
    rids = _submit_all(ce, reqs)
    results = ce.run_until_drained()
    _same([results[r] for r in rids], jax_ref("audio"),
          _unbatched(setup, "audio", reqs))


def test_cache_budget_reset(setup, jax_ref):
    reqs = _requests(setup[2].tokens, 3)
    # cache 64, bucket 32: a 31-frame budget; 16-frame requests spend it
    # after one wave, so the scheduler must reset the window
    ce = _port(setup, mode="text", rows=1, cache_len=64, seed=888)
    rids = _submit_all(ce, reqs, [16] * 3)
    results = ce.run_until_drained()
    got = [results[r] for r in rids]
    _same(got, jax_ref("budget"))
    _same([g[:8] for g in got], _unbatched(setup, "text", reqs))
    assert ce.stats["resets"] >= 1


def test_submit_rejects_unservable(setup):
    ce = _port(setup, mode="text", rows=1, cache_len=64)
    g, m = _requests(setup[2].tokens, 1)[0]
    with pytest.raises(ValueError, match="cache budget"):
        ce.submit(g, m, max_frames=64)
    with pytest.raises(ValueError, match="bucket"):
        ce.submit(np.zeros((33, 9), np.int64), np.ones((33, 9), bool))


def test_offline_in_graph_matches_unbatched(setup, jax_ref):
    """Refill on completion over a fixed request list, including position
    resets (80-slot cache, 8-frame budgets)."""
    reqs = _requests(setup[2].tokens, 6)
    ce = _port(setup, mode="text", rows=2, cache_len=80)
    got = ce.run_offline([(g, m, 8) for g, m in reqs])
    assert len(got) == 6
    _same(got, jax_ref("offline"), _unbatched(setup, "text", reqs))


def test_offline_audio_mode(setup, jax_ref):
    reqs = _requests(setup[2].tokens, 3)
    got = _port(setup, mode="audio", rows=2).run_offline(
        [(g, m, 8) for g, m in reqs])
    _same(got, jax_ref("offline_audio"),
          _unbatched(setup, "audio", reqs))


def _cfg_unbatched(setup, reqs):
    eng = DecodeEngine(setup[3], setup[2], max_frames=8,
                       cache_dtype=torch.float32, buckets=(32,))
    return [eng.generate_audio(g, m, topk=1, use_cfg=True, cfg_scale=1.5,
                               neg_grid=ng, neg_mask=nm)
            for g, m, ng, nm in reqs]


def test_cfg_staggered_matches_static(setup, jax_ref):
    """[cond, uncond] pairs admitted atomically into one pair slot (2
    rows, 3 requests): the static CFG path's greedy tokens."""
    reqs = _cfg_requests(setup[2].tokens, 3)
    ce = _port(setup, mode="audio", rows=2, use_cfg=True, cfg_scale=1.5)
    rids = _submit_all(ce, reqs)
    results = ce.run_until_drained()
    assert ce.stats["refills"] == 3
    _same([results[r] for r in rids], jax_ref("cfg"),
          _cfg_unbatched(setup, reqs))


def test_cfg_offline_matches_static(setup, jax_ref):
    reqs = _cfg_requests(setup[2].tokens, 4)
    got = _port(setup, mode="audio", rows=2, use_cfg=True,
                cfg_scale=1.5).run_offline([(*r, 8) for r in reqs])
    _same(got, jax_ref("cfg_offline"), _cfg_unbatched(setup, reqs))


def test_cfg_submit_requires_negative(setup):
    ce = _port(setup, mode="audio", rows=2, cache_len=128, use_cfg=True)
    g, m = _requests(setup[2].tokens, 1)[0]
    with pytest.raises(ValueError, match="negative prompt"):
        ce.submit(g, m)
    with pytest.raises(ValueError, match="pairs"):
        _port(setup, mode="audio", rows=3, use_cfg=True)


def test_attn_block_token_identical_in_continuous(setup, jax_ref):
    """Prefix-bounded reads (attn_block) change no token through segments,
    drain and refills; block 64 runs four levels of the 256-slot cache."""
    reqs = _requests(setup[2].tokens, 4)
    outs = {}
    for blk in (0, 64):
        ce = _port(setup, mode="text", rows=2, attn_block=blk)
        assert ce.levels == ((64, 128, 192, 256) if blk else None)
        rids = _submit_all(ce, reqs)
        res = ce.run_until_drained()
        outs[blk] = [res[r] for r in rids]
    _same(outs[64], outs[0], jax_ref("text")[:4])


def test_resolve_attn_block_policy(setup):
    """Auto enables block 128 only at cache budgets >= 512 (the JAX
    engine's policy); an explicit value wins."""
    from uniaudio2_tpu_torch.engine.decode import resolve_attn_block

    assert resolve_attn_block(-1, 256) == 0
    assert resolve_attn_block(-1, 512) == 128
    assert resolve_attn_block(-1, 768) == 128
    assert resolve_attn_block(None, 256) == 0
    assert resolve_attn_block(0, 2048) == 0
    assert resolve_attn_block(64, 256) == 64
    ce = ContinuousEngine(setup[3], setup[2], cache_len=512)
    assert ce.attn_block == 128 and ce.levels == (128, 256, 384, 512)


def test_step_online_and_timings(setup, jax_ref):
    """step_online admits and decodes one segment a call, returns what
    completed, and records the wall-clock lifecycle."""
    reqs = _requests(setup[2].tokens, 3)
    ce = _port(setup, mode="text", rows=2)
    assert ce.step_online() == {}           # idle: no device work
    assert ce.frames_run == 0
    rids = _submit_all(ce, reqs)
    _same(_online(ce, rids, calls=50), jax_ref("text")[:3])
    for rid in rids:
        t = ce.timings[rid]
        assert t["submitted"] <= t["admitted"] <= t["first"] <= t["done"]
        assert t["frames"] >= 1


def test_resolve_seg_ladder():
    resolve = ContinuousEngine._resolve_ladder
    jresolve = jcontinuous.ContinuousEngine._resolve_ladder
    for spec, k in (("auto", 8), ("auto", 4), ("off", 8), ("0", 8),
                    ("2,8,4,8", 8), ("16", 8)):
        assert resolve(spec, k) == jresolve(spec, k)
    assert resolve("auto", 8) == (2, 8)
    assert resolve("2,8,4,8", 8) == (2, 4, 8)
    assert resolve("16", 8) == (8,)
    with pytest.raises(ValueError):
        resolve("fast,slow", 8)
    reactive = ContinuousEngine._resolve_reactive
    assert reactive("on") and reactive("1")
    assert not reactive("off") and not reactive("auto") and not reactive(None)
    with pytest.raises(ValueError):
        reactive("maybe")


def test_online_ladder_token_identity(setup, jax_ref):
    """The ladder and the reactive segment change no token; 3 requests
    through 2 rows queue one behind a full batch (the reactive path)."""
    reqs = _requests(setup[2].tokens, 3)
    got = {}
    for ladder, reactive in (("off", None), ("auto", None),
                             ("2,4,8", "on"), ("1,2", None)):
        ce = _port(setup, mode="text", rows=2, seg_ladder=ladder,
                   seg_reactive=reactive)
        got[ladder] = _online(ce, _submit_all(ce, reqs), calls=100)
        assert (ce.stats["reactive"] >= 1) == (reactive == "on")
    for out in got.values():
        _same(out, jax_ref("text")[:3])


def _overlap_run(setup, windows, cfg_pairs=False):
    ts = setup[2].tokens
    if cfg_pairs:
        ce = _port(setup, mode="audio", rows=4, cache_len=64, max_frames=24,
                   use_cfg=True, cfg_scale=1.5, windows=windows)
        reqs = _cfg_requests(ts, 3)
    else:
        ce = _port(setup, mode="text", rows=2, cache_len=64, max_frames=24,
                   windows=windows)
        reqs = _requests(ts, 3)
    # cache 64, bucket 32: a 31-frame budget. r1 (cap 8) frees its row at
    # pos 40; r3 (cap 24) then needs 24 > 23 while r2 still decodes: the
    # overlap trigger
    return _online(ce, _submit_all(ce, reqs, [8, 24, 24])), ce


def test_online_overlap_windows_token_identity(setup, jax_ref):
    one, ce_one = _overlap_run(setup, 1)
    two, ce_two = _overlap_run(setup, 2)
    assert ce_one.stats["overlaps"] == 0 and ce_one.stats["drains"] >= 1
    assert ce_two.stats["overlaps"] >= 1 and ce_two.stats["drains"] == 0
    _same(two, one, jax_ref("overlap"))
    _same([t[:8] for t in two], _unbatched(setup, "text",
                                           _requests(setup[2].tokens, 3)))


def test_online_overlap_windows_cfg_pairs(setup, jax_ref):
    one, _ = _overlap_run(setup, 1, cfg_pairs=True)
    two, ce = _overlap_run(setup, 2, cfg_pairs=True)
    assert ce.stats["overlaps"] >= 1
    _same(two, one, jax_ref("overlap_cfg"))


def test_overlap_then_run_until_drained(setup, jax_ref):
    """run_until_drained retires a live overlap window first; a second
    overlap reuses the first's spare window and admits its arrival on its
    first turn (the turn flag starts on the fresh window's side)."""
    reqs = _requests(setup[2].tokens, 3)
    ce = _port(setup, mode="text", rows=2, cache_len=64, max_frames=24,
               windows=2)
    rids = _submit_all(ce, reqs, [8, 24, 24])
    w0 = ce._win
    results = {}
    while ce._overlap is None:
        results.update(ce.step_online())
    results.update(ce.run_until_drained())
    assert set(results) == set(rids) and ce._overlap is None
    _same([results[r] for r in rids], jax_ref("overlap"))
    # again: the spare window comes back fresh; its arrival is admitted at
    # the call that opens the overlap
    ce._flip = True
    rids = _submit_all(ce, reqs, [8, 24, 24])
    while ce._overlap is None:
        results.update(ce.step_online())
    assert ce._overlap is w0
    assert any(s.request_id == rids[2] for s in ce._overlap.slots)
    results.update(ce.run_until_drained())
    _same([results[r] for r in rids], jax_ref("overlap"))


def test_warmup_precompiles(setup, jax_ref):
    """warmup() runs every program once and leaves a fresh window; the
    next request gives its tokens."""
    ce = _port(setup, mode="text", rows=2, seg_ladder="auto",
               seg_reactive="on")
    ce.warmup()
    assert ce.frames_run > 0 and ce._pos_host == 32
    assert not bool(ce._state.active.any()) and int(ce._state.frame) == 0
    g, m = _requests(setup[2].tokens, 1)[0]
    rid = ce.submit(g, m)
    results = {}
    for _ in range(50):
        results.update(ce.step_online())
        if results:
            break
    _same([results[rid]], jax_ref("text")[:1])


@pytest.mark.parametrize("kv_write", ["inline", "deferred"])
def test_int8_cache_matches_jax(setup, kv_write, jax_ref):
    """The int8 `QuantKV` cache (stacked layout for deferred writes, whose
    refills write inline); empty rows stay finite."""
    reqs = _requests(setup[2].tokens, 4)
    ce = _port(setup, mode="text", rows=2, kv_quant="on", kv_write=kv_write)
    assert isinstance(ce._state.caches.backbone.k, QuantKV)
    rids = _submit_all(ce, reqs)
    res = ce.run_until_drained()
    _same([res[r] for r in rids], jax_ref(f"int8_{kv_write}"))
    ce = _port(setup, mode="audio", rows=4, kv_quant="on", kv_write=kv_write,
               topk=5, temperature=1.0)
    rid = ce.submit(*reqs[0])
    reason, semantic = ce.run_until_drained()[rid]
    assert reason.shape[0] == 8 and (reason >= 0).all()
    for t in continuous._cache_tensors(ce._state.caches):
        assert bool(torch.isfinite(t.float()).all())


def _batch_axis(t, cache_dtype):
    """The batch axis of a cache tensor: ``ndim - 3`` of a `QuantKV`'s f32
    scales, ``ndim - 4`` of values."""
    scales = cache_dtype == torch.int8 and t.dtype == torch.float32
    return t.ndim - (3 if scales else 4)


@pytest.mark.parametrize("layout", ["stacked", "list"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_refill_splices_one_row(setup, layout, dtype):
    """A refill writes through row views: row 1's slots [pos - 31, pos)
    equal a one-row cache's after the same decode step, every other row and
    slot keeps its bytes, and the row's state is set."""
    _, _, cfg, params = setup
    caches = unified.init_caches(cfg, 3, dtype=dtype, seq_len=96,
                                 as_lists=layout == "list", device="cpu")
    gen = torch.Generator().manual_seed(0)
    tensors = list(continuous._cache_tensors(caches))
    for t in tensors:
        t.copy_(torch.randint(-50, 50, t.shape, generator=gen).to(t.dtype))
    before = [t.clone() for t in tensors]
    b, par = 3, cfg.tokens.parallel_number
    state = continuous.SlotState(
        pos=torch.zeros(1, dtype=torch.int64),
        active=torch.zeros(b, dtype=torch.bool),
        frame_tokens=torch.zeros((b, 1, par), dtype=torch.int64),
        frame_mask=torch.zeros((b, 1, par), dtype=torch.bool),
        is_reason=torch.zeros(b, dtype=torch.bool),
        forbid_prefix=torch.ones(b, dtype=torch.int64),
        valid_from=torch.full((b,), 96),
        stop_at=torch.zeros(b, dtype=torch.int64),
        keys=torch.zeros(b, dtype=torch.int64),
        frame=torch.zeros(1, dtype=torch.int64), caches=caches)
    g, m = _requests(cfg.tokens, 1)[0]
    grid = torch.zeros((32, par), dtype=torch.int64)
    mask = torch.zeros((32, par), dtype=torch.bool)
    grid[32 - len(g):], mask[32 - len(g):] = torch.from_numpy(g), \
        torch.from_numpy(np.asarray(m))
    pos = 50
    one = unified.init_caches(cfg, 1, dtype=dtype, seq_len=96,
                              as_lists=layout == "list", device="cpu")
    for t, src in zip(continuous._cache_tensors(one), before):
        t.copy_(src.narrow(_batch_axis(t, dtype), 1, 1))
    with torch.no_grad():
        continuous._refill_one(params, cfg, state, 1, grid, mask, len(g), 8,
                               32, pos)
        unified.decode_hidden(
            params, cfg, grid[None, :-1], mask[None, :-1], one, pos - 31,
            key_valid=(torch.arange(96) >= pos - len(g) + 1)[None])
    for t, old, ref in zip(tensors, before, continuous._cache_tensors(one)):
        axis = _batch_axis(t, dtype)
        for r in (0, 2):
            assert torch.equal(t.narrow(axis, r, 1), old.narrow(axis, r, 1))
        assert torch.equal(t.narrow(axis, 1, 1), ref)
        slot = axis + 2
        assert torch.equal(t.narrow(axis, 1, 1).narrow(slot, 0, pos - 31),
                           old.narrow(axis, 1, 1).narrow(slot, 0, pos - 31))
        assert not torch.equal(t.narrow(axis, 1, 1), old.narrow(axis, 1, 1))
    assert state.active.tolist() == [False, True, False]
    assert state.valid_from.tolist() == [96, pos - len(g) + 1, 96]
    assert state.stop_at.tolist() == [0, pos + 8, 0]
    assert state.forbid_prefix.tolist() == [1, 0, 1]
    assert torch.equal(state.frame_tokens[1], grid[-1:])


def test_text_eos_inside_a_segment(setup, jax_ref):
    """A text EOS that the greedy path reaches mid-segment (``text_eos``
    set to a token two requests emit at their second frame): the row
    frees there, online and offline, as in JAX."""
    cfg = dataclasses.replace(setup[2], tokens=dataclasses.replace(
        setup[2].tokens, text_eos=974))
    reqs = _requests(cfg.tokens, 5)
    ce = ContinuousEngine(setup[3], cfg, **dict(
        BASE, mode="text", rows=2, seg_frames=8, cache_dtype=torch.float32))
    rids = _submit_all(ce, reqs)
    res = ce.run_until_drained()
    online = [res[r] for r in rids]
    offline = ContinuousEngine(setup[3], cfg, **dict(
        BASE, mode="text", rows=2, cache_dtype=torch.float32)).run_offline(
        [(g, m, 8) for g, m in reqs])
    _same(online, jax_ref("eos"))
    _same(offline, online)
    assert sorted(len(t) for t in online)[:2] == [1, 1]


def test_sampled_tokens_reproducible_from_one_seed(setup):
    """Sampled tokens (topk 5) depend on the seed and the admission
    schedule only: two engines with one seed agree, the segment lengths
    change nothing while every request is admitted at the first frame,
    and another seed gives other tokens."""
    reqs = _requests(setup[2].tokens, 3)

    def run(seed, ladder="off", online=False):
        ce = _port(setup, mode="audio", rows=4, topk=5, temperature=1.0,
                   seed=seed, seg_ladder=ladder, max_frames=12)
        rids = _submit_all(ce, reqs)
        if online:
            return _online(ce, rids)
        res = ce.run_until_drained()
        return [res[r] for r in rids]

    a = run(7)
    _same(run(7), a)
    _same(run(7, "1,3", online=True), a)
    b = run(8)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, b))
