"""The frame graph's step (`engine/frame_graph.py`) against the eager frame
loop (`DecodeEngine(graph=False)`, `_frames`) and the JAX `DecodeEngine`,
on the CPU, where the step runs eagerly, `STOP_EVERY` frames a run.

The eager loop is held to JAX by `test_torch_engine.py`,
`test_torch_batch_decode.py` and `test_torch_kv_engine*.py`; here the
graph's step must give its greedy tokens, phases and frame counts exactly,
in text (ASR), two-phase audio, the CFG pair, 8 ragged batched rows and the
engine's own policies on `tiny(max_seq_len=1024)` (int8 KV, block-128
levels, inline and deferred writes) across two level boundaries; the same
with EOS arriving inside a run of `STOP_EVERY` in {1, 3, 16} frames; the
same sampled tokens under per-row seeds (`RowKeys` folding the device
frame counter) and under the shared generator. One text and one audio case
go straight against JAX.

EOS inside a run: text decoding takes as ``text_eos`` a token its greedy
path reaches a few frames in. Audio stops only on a frame whose eight
codebooks are all ``reason_eos`` (the phase switch) or all
``semantic_eos`` (+ card), which a random tiny model never emits, so the
audio cases wrap the local decoder (in both loops alike) to emit that
frame whenever the greedy codebook 0 is 1 mod 4: a data-dependent EOS in
every row at its own frame (24 frames leave every row time to switch and
stop).

The step must not read the device (the proxy here: `Tensor.__bool__`,
`item`, `tolist`, `cpu`, `numpy`, `__int__` and `__float__` raise while it
runs), must keep its buffers' addresses, and one engine serving two
requests must give the tokens of two fresh engines.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import decode as jdecode
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.models import unified as junified

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import decode, frame_graph
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.ops import _cuda
from uniaudio2_tpu_torch.ops.sampling import RowKeys

FRAMES = 12
GREEDY = dict(topk=1, temperature=1.0, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.tiny(max_seq_len=1024)
    params = junified.init_params(jax.random.PRNGKey(3), jcfg)
    ts = jcfg.tokens
    tts = jtasks.prepare_tts(np.array([1, 5, 6, 7]), np.array([3, 10, 2]), ts)
    neg = jtasks.prepare_tts_cfg_negative(np.array([1, 5, 6, 7]),
                                          np.array([3, 10, 2]), ts)
    rng = np.random.default_rng(0)
    asr = [jtasks.prepare_asr(np.array([4, 8, 9]),
                              rng.integers(0, 30, (3 + i, 8)),
                              rng.integers(0, 60, (5 + 2 * i, 8)), ts)
           for i in range(8)]
    return jcfg, params, convert_params(params, "cpu"), tts, neg, asr


def _cfg(**tokens):
    cfg = UnifiedModelConfig.tiny(max_seq_len=1024)
    return dataclasses.replace(cfg, tokens=dataclasses.replace(cfg.tokens,
                                                               **tokens))


def _engine(model, graph, cfg=None, **kw):
    kw.setdefault("max_frames", FRAMES)
    kw.setdefault("buckets", (64,))
    kw.setdefault("cache_dtype", torch.float32)
    return decode.DecodeEngine(model[2], cfg or _cfg(), graph=graph, **kw)


def _request(model, case, eng, **sampling):
    """One request's raw outputs: (text_out, audio_out, phase_out, frames)
    and the engine's frame count."""
    _, _, _, (g, m), (ng, nm), asr = model
    kw = dict(GREEDY, **sampling)
    if case == "asr":
        out = eng._run("text", *asr[0], **kw)
    elif case == "tts":
        out = eng._run("audio", g, m, **kw)
    elif case == "tts_cfg":
        out = eng._run("audio", g, m, use_cfg=True, cfg_scale=1.5,
                       neg_grid=ng, neg_mask=nm, **kw)
    elif case == "asr_x8":
        out = eng._run_batched("text", asr, **kw)
    elif case == "tts_x8":
        out = eng._run_batched("audio", asr, **kw)
    else:
        raise ValueError(case)
    return out, eng.last_steps


def _same(a, b):
    (oa, na), (ob, nb) = a, b
    assert na == nb and oa[3] == ob[3]
    for x, y in zip(oa[:3], ob[:3]):
        np.testing.assert_array_equal(x, y)


def _graph_vs_eager(model, case, cfg=None, **kw):
    sampling = kw.pop("sampling", {})
    eager = _request(model, case, _engine(model, False, cfg, **kw), **sampling)
    graph = _request(model, case, _engine(model, True, cfg, **kw), **sampling)
    _same(graph, eager)
    return graph


@pytest.fixture
def forced_audio_eos(monkeypatch):
    """The local decoder emits an EOS frame (all eight codebooks
    ``reason_eos`` in the reasoning phase, ``semantic_eos`` + card after
    the switch) wherever its greedy codebook 0 is 1 mod 4."""
    orig = unified._local_decoder_generate

    def forced(params, cfg, last_h, stream, *, forbid_prefix, **kw):
        out = orig(params, cfg, last_h, stream, forbid_prefix=forbid_prefix,
                   **kw)
        ts = cfg.tokens
        second = forbid_prefix[:, 0] > 0
        eos = torch.where(second, ts.semantic_eos + ts.audio_reason_card,
                          ts.reason_eos)
        hit = (out[:, 0] % 4 == 1)[:, None]
        return torch.where(hit, eos[:, None].expand_as(out), out)

    monkeypatch.setattr(unified, "_local_decoder_generate", forced)


@pytest.mark.parametrize("case", ["asr", "tts", "tts_cfg", "asr_x8", "tts_x8"])
def test_greedy_matches_eager_loop(model, case):
    (out, n) = _graph_vs_eager(model, case)
    assert n == FRAMES


@pytest.mark.parametrize("kv_write", ["inline", "deferred"])
@pytest.mark.parametrize("case", ["tts", "asr"])
def test_engine_defaults_across_levels(model, case, kv_write):
    """The engine's own policies (no policy argument but the write): 300
    frames in a 512-slot cache, int8 KV, block-128 levels, past the
    boundaries at 128 and 256: three graphs."""
    eng = _engine(model, True, max_frames=300, cache_dtype=torch.bfloat16,
                  kv_write=kv_write)
    (out, n) = _request(model, case, eng)
    p = eng.last_policy
    assert p["kv_dtype"] == torch.int8 and p["attn_block"] == 128
    assert p["cache_len"] == 512 and n > 256
    (fg,) = eng.frame_graphs.values()
    first = (model[3] if case == "tts" else model[5][0])[0].shape[0] - 1
    assert len({fg.level(pos) for pos in range(first, first + n)}) == 3
    eager = _engine(model, False, max_frames=300, cache_dtype=torch.bfloat16,
                    kv_write=kv_write)
    _same((out, n), _request(model, case, eager))


def _text_eos_reached(model, case, frame):
    """A token the greedy text path of ``case`` (row 0) first emits at or
    after ``frame``, and that frame."""
    (text, _, _, _), _ = _request(model, case, _engine(model, False))
    row = text if text.ndim == 1 else text[0]
    for f in range(frame, len(row)):
        if row[f] not in row[:f]:
            return int(row[f]), f
    raise AssertionError(f"no new token after frame {frame}: {row}")


@pytest.mark.parametrize("stop_every", [1, 3, 16])
@pytest.mark.parametrize("case", ["asr", "asr_x8"])
def test_text_eos_inside_a_run(model, monkeypatch, case, stop_every):
    monkeypatch.setattr(frame_graph, "STOP_EVERY", stop_every)
    eos, frame = _text_eos_reached(model, case, 4)
    (out, n) = _graph_vs_eager(model, case, _cfg(text_eos=eos))
    if case == "asr":
        assert n == frame + 1 and (stop_every == 1 or n % stop_every)
    assert (out[0] == -1).any()


@pytest.mark.parametrize("stop_every", [1, 3, 16])
@pytest.mark.parametrize("case", ["tts", "tts_cfg", "tts_x8"])
def test_audio_eos_inside_a_run(model, forced_audio_eos, monkeypatch, case,
                                stop_every):
    monkeypatch.setattr(frame_graph, "STOP_EVERY", stop_every)
    (out, n) = _graph_vs_eager(model, case, max_frames=24)
    phases = out[2].reshape(-1, 24)
    assert n < 24
    if case == "tts_x8":        # rows stop at their own frames
        assert len({int(np.nonzero(row)[0].max()) for row in phases}) > 1
    else:
        assert stop_every == 1 or n % stop_every
    assert (phases == decode.PHASE_SEMANTIC).any(axis=1).all()
    assert (phases == decode.PHASE_REASON).any(axis=1).all()


def test_row_keys_fold_the_device_counter():
    keys = RowKeys.from_seeds([3, 1, 4, 1, 5], "cpu")
    for step in (0, 1, 7, 499, 2 ** 40):
        counter = torch.tensor([step], dtype=torch.int64)
        assert torch.equal(keys.fold(counter).keys, keys.fold(step).keys)
        assert torch.equal(keys.fold(counter).fold(1).fold(3).uniform(9),
                           keys.fold(step).fold(1).fold(3).uniform(9))


@pytest.mark.parametrize("case", ["asr_x8", "tts_x8"])
def test_per_row_seeds_sample_as_eager(model, case):
    _graph_vs_eager(model, case, sampling=dict(
        topk=5, temperature=0.9, seeds=list(range(10, 18))))


@pytest.mark.parametrize("case", ["tts", "tts_cfg"])
def test_shared_stream_samples_as_eager(model, case):
    _graph_vs_eager(model, case, sampling=dict(topk=5, temperature=0.9,
                                               seed=7))


@contextlib.contextmanager
def _no_device_reads():
    names = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__",
             "__float__")
    own = {n: torch.Tensor.__dict__[n] for n in names
           if n in torch.Tensor.__dict__}

    def read(*args, **kwargs):
        raise AssertionError("the frame step read a tensor on the host")

    for n in names:
        setattr(torch.Tensor, n, read)
    try:
        yield
    finally:
        for n in names:
            if n in own:
                setattr(torch.Tensor, n, own[n])
            else:
                delattr(torch.Tensor, n)


def _buffers(fg, eng):
    """Every tensor the graph's step reads or writes: its static buffers,
    the local decoder's cache and the engine's kept caches."""
    out = [fg.tokens, fg.tmask, fg.pos, fg.step, fg.finished, fg.is_reason,
           fg.forbid, fg.text_out, fg.audio_out, fg.phase_out, fg.audio_fb,
           fg.text_fb, fg.local.steps]
    out += [t for t in (fg.keys, fg.key_valid) if t is not None]

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in leaves(y)]

    out += leaves(fg.local.cache) + leaves(list(eng._kept.values()))
    return out


@pytest.mark.parametrize("case,sampling", [
    ("asr", {}), ("tts_cfg", dict(topk=5, temperature=0.9)),
    ("tts_x8", dict(topk=5, temperature=0.9, seeds=list(range(8))))])
def test_step_reads_nothing_and_keeps_its_buffers(model, monkeypatch, case,
                                                  sampling):
    orig = frame_graph.FrameGraph._frame
    seen = []

    def guarded(self, host_pos):
        ptrs = [t.data_ptr() for t in _buffers(self, eng)]
        with _no_device_reads():
            orig(self, host_pos)
        assert [t.data_ptr() for t in _buffers(self, eng)] == ptrs
        seen.append(ptrs)

    monkeypatch.setattr(frame_graph.FrameGraph, "_frame", guarded)
    eng = _engine(model, True)
    _request(model, case, eng, **sampling)
    _request(model, case, eng, **sampling)      # a second request
    # the frames of both requests and the one level's warm-up frame
    assert len(seen) == 2 * FRAMES + 1 and all(p == seen[0] for p in seen)


@pytest.mark.parametrize("graph", [True, False])
def test_one_engine_two_requests_as_fresh_engines(model, graph):
    """Kept caches and kept graphs: two different requests (two prompts of
    one bucket, text and audio) through one engine give the tokens of a
    fresh engine each."""
    _, _, _, tts, _, asr = model
    eng = _engine(model, graph)
    for mode, (g, m) in (("text", asr[1]), ("text", asr[2]), ("audio", tts),
                         ("audio", asr[3])):
        got = eng._run(mode, g, m, **GREEDY)
        fresh = _engine(model, graph)._run(mode, g, m, **GREEDY)
        _same((got, 0), (fresh, 0))
    assert len(eng._kept) == (1 if graph else 0)
    assert len(eng.frame_graphs) == (2 if graph else 0)


@pytest.mark.parametrize("sampling", [{}, dict(topk=5, temperature=0.9,
                                                seed=7)])
def test_new_level_after_a_run_to_max_frames(model, sampling):
    """A kept program whose last request ran to ``max_frames`` (its frame
    counter one past the outputs' last slot) warms up the levels a later,
    longer prompt needs from a reset state: both requests give the tokens
    of a fresh eager engine."""
    jcfg, _, _, (g, m), _, _ = model
    lg, lm = jtasks.prepare_tts(np.array([1, 5, 6, 7]),
                                np.arange(115) % 50 + 3, jcfg.tokens)
    # one 256-slot cache for both buckets: levels 128 and 256
    kw = dict(attn_block=128, buckets=(64, 128))
    eng = _engine(model, True, **kw)
    first = _request(model, "tts", eng, **sampling)
    (fg,) = eng.frame_graphs.values()
    assert first[1] == FRAMES and list(fg.graphs) == [128]
    assert int(fg.step[0]) == FRAMES        # the run ended at max_frames
    _same(first, _request(model, "tts", _engine(model, False, **kw),
                          **sampling))
    kw_req = dict(GREEDY, **sampling)
    got = eng._run("audio", lg, lm, **kw_req)
    assert list(fg.graphs) == [128, 256] and eng.frame_graphs == {
        k: fg for k in eng.frame_graphs}
    _same((got, 0), (_engine(model, False, **kw)._run("audio", lg, lm,
                                                      **kw_req), 0))


def test_kept_programs_are_bounded(model, monkeypatch):
    """Past `KEEP_PROGRAMS` the least recently used program goes, with the
    caches no kept program holds; a program made again gives the same
    tokens. The eager loop and the host-driven path keep nothing."""
    monkeypatch.setattr(decode, "KEEP_PROGRAMS", 2)
    eng = _engine(model, True)
    first = _request(model, "asr", eng)
    for case in ("tts", "tts_cfg"):
        _request(model, case, eng)
    assert [k[:2] for k in eng.frame_graphs] == [("audio", 1), ("audio", 2)]
    held = {id(f.caches) for f in eng.frame_graphs.values()}
    assert {id(c) for c in eng._kept.values()} == held and len(held) == 2
    _same(_request(model, "asr", eng), first)
    assert [k[:2] for k in eng.frame_graphs] == [("audio", 2), ("text", 1)]
    eng.generate_text(*model[5][0], topk=1, no_repeat_ngram=2)
    assert len(eng._kept) == 2
    eager = _engine(model, False)
    _request(model, "asr", eager)
    eager.generate_text(*model[5][0], topk=1, no_repeat_ngram=2)
    assert not eager._kept and not eager.frame_graphs


def test_text_and_audio_match_jax(model):
    """The graph's step (the default engine) against the JAX engine, greedy
    text (ASR) and two-phase audio: identical tokens."""
    jcfg, params, _, (g, m), _, asr = model
    jeng = jdecode.DecodeEngine(params, jcfg, max_frames=FRAMES,
                                cache_dtype=jnp.float32, buckets=(64,))
    teng = _engine(model, True)
    np.testing.assert_array_equal(teng.generate_text(*asr[0], topk=1),
                                  jeng.generate_text(*asr[0], topk=1))
    for a, b in zip(teng.generate_audio(g, m, topk=1),
                    jeng.generate_audio(g, m, topk=1)):
        np.testing.assert_array_equal(a, b)
    assert teng.frame_graphs and teng.last_steps == FRAMES


def test_replay_counts():
    """A replay adds the launches its capture counted, times the replays;
    capturing counts nothing."""
    def kernel():
        _cuda.count(kernel, "a")

    def other():
        _cuda.count(other)

    for fn in (kernel, other):
        _cuda.reset_count(fn)
    before = _cuda.counts()
    kernel()
    kernel()
    other()
    delta = _cuda.counts_since(before)
    assert delta[kernel] == (2, {"a": 2}) and delta[other] == (1, {})
    _cuda.set_counts(before)
    assert kernel.launches == 0 and kernel.forms == {}
    _cuda.add_counts(delta, 5)
    assert kernel.launches == 10 and kernel.forms == {"a": 10}
    assert other.launches == 5
