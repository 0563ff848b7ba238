"""The port's speculative engine (`engine/speculative.py`) against the JAX
package on the CPU, in float32.

Greedy output must be IDENTICAL to the target's plain greedy decode for
ANY draft (the cases of `tests/test_speculative.py`): a perfect draft (the
target itself: every frame accepted), an unrelated one (mostly rejected),
a mid-quality mix swept over k = 2, 3, 4 (the KV rewind at every accept
length) and an int4 serving-layout draft. Each stream is held to JAX's
plain `DecodeEngine` and to the port's own. The acceptance statistics
equal JAX's `SpeculativeEngine`'s; `_decode_hidden_all` and
`_local_decoder_score` (both local-decoder layouts) agree with JAX's on
the same inputs; the cost probe runs at its tiny scale. No tie showed in
these streams, so none is certified.

The JAX programs (one plain engine a mode, one speculative engine a mode)
are compiled once a module; the port runs on one CPU thread."""

import contextlib
import io
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JCfg
from uniaudio2_tpu.engine import speculative as jspec
from uniaudio2_tpu.engine.decode import DecodeEngine as JEngine
from uniaudio2_tpu.models import unified as junified

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import speculative, tasks
from uniaudio2_tpu_torch.engine.decode import DecodeEngine
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.ops import quant

KW = dict(max_frames=12, buckets=(32,))
TOL = 1e-5          # x max|jax|, the f32 function-level parity


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_tree(jcfg, seed):
    """A tree of JAX's `unified.init_params` structure (traced with
    `jax.eval_shape`, not run: running it compiles many small random ops)
    drawn by numpy as JAX draws it: RMSNorm gains one, every other leaf
    normal(0, 0.02)."""
    shapes = jax.eval_shape(lambda key: junified.init_params(key, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if "norm" in jax.tree_util.keystr(path) \
                or "ln_f" in jax.tree_util.keystr(path):
            return np.ones(s.shape, s.dtype)
        return (rng.standard_normal(s.shape) * 0.02).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port(tree):
    return convert_params(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def setup():
    """JAX's trees (target seed 0, an unrelated seed 7), the port's copies
    and the port's copy of their mean, JAX's plain greedy engine, the port's, and a cache of both
    engines' greedy outputs by (mode, prompt)."""
    jcfg, cfg = JCfg.tiny(), UnifiedModelConfig.tiny()
    nt, no = _np_tree(jcfg, 0), _np_tree(jcfg, 7)
    jt, jo = jax.tree.map(jnp.asarray, nt), jax.tree.map(jnp.asarray, no)
    mixed = jax.tree.map(lambda a, b: (a + b) / 2, nt, no)
    jref = JEngine(jt, jcfg, cache_dtype=jnp.float32, **KW)
    trees = {"same": _port(nt), "random": _port(no), "mixed": _port(mixed)}
    tref = DecodeEngine(trees["same"], cfg, cache_dtype=torch.float32, **KW)
    refs = {}

    def ref(mode, i):
        """(JAX's, the port's) plain greedy output for prompt ``i``."""
        if (mode, i) not in refs:
            g, m = _req(cfg.tokens, i)
            refs[mode, i] = tuple(
                e.generate_audio(g, m, topk=1) if mode == "audio"
                else e.generate_text(g, m, topk=1) for e in (jref, tref))
        return refs[mode, i]

    return dict(jcfg=jcfg, cfg=cfg, jt=jt, jo=jo, trees=trees, ref=ref)


def _req(ts, i=0):
    prompt = (np.arange(1, 6) * 3 + i) % 50
    text = (np.arange(2, 9) * 5 + i) % 50
    return tasks.prepare_tts(prompt, text, ts)


def _engine(s, draft, k=3):
    return speculative.SpeculativeEngine(
        draft, s["trees"]["same"], s["cfg"], k=k, cache_dtype=torch.float32,
        device="cpu", **KW)


def _check(s, eng, mode, i):
    """The speculative stream of prompt ``i`` equals JAX's plain greedy
    stream and the port's."""
    g, m = _req(s["cfg"].tokens, i)
    got = eng.generate_audio(g, m) if mode == "audio" \
        else eng.generate_text(g, m)
    for exp in s["ref"](mode, i):
        if mode == "audio":
            np.testing.assert_array_equal(got[0], exp[0])
            np.testing.assert_array_equal(got[1], exp[1])
        else:
            np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("mode", ["audio", "text"])
@pytest.mark.parametrize("draft_kind", ["same", "random"])
def test_greedy_equivalence(setup, mode, draft_kind):
    eng = _engine(setup, setup["trees"][draft_kind])
    for i in range(3):
        _check(setup, eng, mode, i)
        stats = eng.last_stats
        assert stats["rounds"] >= 1
        if draft_kind == "same":
            # a perfect draft must accept every drafted frame
            assert stats["accepted"] == stats["drafted"]
            assert stats["acceptance_rate"] == 1.0


def test_rewind_at_every_accept_length(setup):
    """The mean of the target and an unrelated tree drafts: over four
    prompts and k = 2..4 the accept lengths vary, and the output stays the
    plain greedy stream at every one."""
    seen = set()
    for k in (2, 3, 4):
        eng = _engine(setup, setup["trees"]["mixed"], k=k)
        for i in range(4):
            _check(setup, eng, "audio", i)
            st = eng.last_stats
            seen.add((st["drafted"] - st["accepted"]) // st["rounds"])
            assert 0 <= st["accepted"] <= st["drafted"]
    assert len(seen) >= 2


def test_quantized_draft_layouts(setup):
    """An int4 serving-layout draft (decoder, audio heads, projection; the
    folded table, per-layer and per-codebook lists) and the float target
    in its training layout."""
    qdraft = unified.prepare_serving_params(
        quant.quantize_unified_params(
            setup["trees"]["same"],
            int4_modules=("decoder", "audio_head", "projection_w")),
        dtype=torch.float32)
    assert isinstance(qdraft["audio_head"], list)
    _check(setup, _engine(setup, qdraft), "audio", 1)


def _backbone_rows(prog):
    """The backbone K rows both trees' caches hold below the position."""
    n = int(prog.pos)
    return [(torch.stack(k) if isinstance(k, list) else k)[..., :n, :]
            for k in (prog.t_caches.backbone.k, prog.d_caches.backbone.k)]


@pytest.mark.parametrize("draft", ["same", "mixed"])
def test_prefix_levels_under_rounds(setup, draft):
    """Block-64 prefix levels over a 256-slot cache: the rounds cross the
    level boundary at 64 (each level's round warmed once). The stream and
    the acceptance statistics equal those of rounds that read the whole
    cache, and the stream the port's plain greedy decode's at the same
    policy; so do both caches' backbone K rows. With the target as its own
    draft and k = 3 one round ends its reads at slot 64 exactly: a level
    that misses the round's last slot changes the verify's last row there
    (the bonus frame's), whose K rows no later round rewrites."""
    cfg = UnifiedModelConfig.tiny(max_seq_len=256)
    kw = dict(max_frames=100, buckets=(32,), cache_dtype=torch.float32)
    plain = DecodeEngine(setup["trees"]["same"], cfg, attn_block=64, **kw)
    g, m = _req(cfg.tokens, 0)
    exp = plain.generate_text(g, m, topk=1)
    assert len(exp) > 60
    outs, stats, rows = [], [], []
    for block in (64, 0):
        eng = speculative.SpeculativeEngine(
            setup["trees"][draft], setup["trees"]["same"], cfg, k=3,
            attn_block=block, device="cpu", **kw)
        outs.append(eng.generate_text(g, m))
        stats.append(eng.last_stats)
        prog = eng.programs["text", 32]
        assert list(prog.graphs) == ([64, 128] if block else [None])
        rows.append(_backbone_rows(prog))
    np.testing.assert_array_equal(outs[0], exp)
    np.testing.assert_array_equal(outs[1], exp)
    assert stats[0] == stats[1]
    for a, b in zip(*rows):
        _close(a, b.numpy())


@pytest.fixture(scope="module")
def jax_spec(setup):
    """JAX's speculative engine (k = 3, the unrelated draft), compiled once
    a mode, and the statistics of each mode's request."""
    eng = jspec.SpeculativeEngine(setup["jo"], setup["jt"], setup["jcfg"],
                                  k=3, cache_dtype=jnp.float32, **KW)
    return eng


@pytest.mark.parametrize("mode,i", [("audio", 2), ("text", 1)])
def test_last_stats_equal_jax(setup, jax_spec, mode, i):
    g, m = _req(setup["cfg"].tokens, i)
    eng = _engine(setup, setup["trees"]["random"])
    run = (lambda e: e.generate_audio(g, m)) if mode == "audio" \
        else (lambda e: e.generate_text(g, m))
    got, exp = run(eng), run(jax_spec)
    for a, b in zip(got if mode == "audio" else [got],
                    exp if mode == "audio" else [exp]):
        np.testing.assert_array_equal(a, b)
    assert eng.last_stats == jax_spec.last_stats
    assert eng.rounds_run == eng.last_stats["rounds"] + 1   # one warm-up


def _close(got, ref):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_decode_hidden_all_matches_jax(setup):
    """T = 4 query steps after a prefill: every position's hidden state,
    and the three caches' rows at those positions."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    g, m = _req(cfg.tokens, 0)
    pre, pos, t = 10, 10, 4
    rng = np.random.default_rng(3)
    toks = np.zeros((1, t, 9), np.int64)
    toks[0, :, :-1] = rng.integers(0, 40, (t, 8))
    mask = np.zeros((1, t, 9), bool)
    mask[0, :, :-1] = True
    mask[0, 1, :] = [False] * 8 + [True]    # one text step among audio
    toks[0, 1, -1] = 7

    @jax.jit
    def jax_side(params, g, m, toks, mask):
        jc = junified.init_caches(jcfg, 1, dtype=jnp.float32, seq_len=64)
        jc = junified.prefill(params, jcfg, g, m, jc)
        return jspec._decode_hidden_all(params, jcfg, toks, mask, jc,
                                        jnp.int32(pos))

    jh, jc = jax_side(setup["jt"], g[None, :pre], m[None, :pre], toks, mask)
    tc = unified.init_caches(cfg, 1, dtype=torch.float32, seq_len=64,
                             device="cpu")
    with torch.no_grad():
        unified.prefill(setup["trees"]["same"], cfg,
                        torch.from_numpy(g[None, :pre]),
                        torch.from_numpy(m[None, :pre]), tc)
        th, tc = speculative._decode_hidden_all(
            setup["trees"]["same"], cfg, torch.from_numpy(toks),
            torch.from_numpy(mask), tc, torch.tensor([pos]))
    _close(th, jh)
    for jk, tk in zip(jc, tc):
        _close(tk.k[:, :, :, pos:pos + t], np.asarray(jk.k)[:, :, :, pos:pos + t])


@pytest.mark.parametrize("layout", ["projection_w", "folded table"])
def test_local_decoder_score_matches_jax(setup, layout):
    """N = 3 teacher-forced frames with per-row forbid prefixes: the
    argmax ids of every codebook equal JAX's."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp, tp = setup["jt"], setup["trees"]["same"]
    if layout == "folded table":
        jp = junified.prepare_serving_params(jp, dtype=jnp.float32, cfg=jcfg)
        tp = unified.prepare_serving_params(tp, dtype=torch.float32)
    rng = np.random.default_rng(5)
    n, d = 3, cfg.backbone.n_embd
    h = rng.standard_normal((n, d)).astype(np.float32)
    frames = rng.integers(0, cfg.tokens.audio_vocab, (n, 8))
    forbid = np.array([0, cfg.tokens.audio_reason_card, 5])
    jids = jax.jit(lambda p, *a: jspec._local_decoder_score(p, jcfg, *a))(
        jp, h, jnp.asarray(frames, jnp.int32), jnp.asarray(forbid, jnp.int32))
    with torch.no_grad():
        tids = speculative._local_decoder_score(
            tp, cfg, torch.from_numpy(h), torch.from_numpy(frames),
            torch.from_numpy(forbid))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert (tids[1] >= cfg.tokens.audio_reason_card).all()


def test_engine_needs_a_card_by_default(setup):
    """The default device is the card: without one the engine raises, and
    trees on another device than the engine's are refused."""
    same = setup["trees"]["same"]
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        speculative.SpeculativeEngine(same, same, setup["cfg"])
    with pytest.raises(ValueError, match="lies on"):
        speculative.SpeculativeEngine(same, same, setup["cfg"],
                                      device="meta")


def test_bench_probe_tiny():
    """`probes/bench_speculative.py` at its CPU scale prints JAX's
    `scripts/bench_speculative.py` metrics."""
    from uniaudio2_tpu_torch.probes import bench_speculative

    out = io.StringIO()
    with mock.patch.dict(os.environ, {"UA2_BENCH_SCALE": "tiny"}), \
            contextlib.redirect_stdout(out):
        assert bench_speculative.main(["--ks", "2"]) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    assert [x["metric"] for x in lines] == ["plain_greedy_frame_ms",
                                            "speculative_round_cost"]
    cost = lines[1]
    assert cost["k"] == 2
    assert {"round_ms_accept_all", "round_ms_reject_all", "accept_all_rate",
            "reject_all_rate", "plain_frame_ms",
            "projected_speedup_vs_alpha"} <= set(cost)
    assert cost["accept_all_rate"] == 1.0
    assert all(v > 0 for v in cost["projected_speedup_vs_alpha"].values())
