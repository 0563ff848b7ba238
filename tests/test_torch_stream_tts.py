"""Streaming TTS (`engine/stream_tts.py`) and the streaming codec decoder
under it, against the JAX package on the CPU in float32:
`tests/test_stream_tts.py`'s six cases.

The port's streamed waveform must equal its own offline decode bit for bit
(same chunk schedule, same noise) and the JAX package's within
``RTOL x max|jax|`` (`tests/test_torch_codec.py`'s bound: float32 on both
sides, what differs is the order of the sums). JAX draws its solver noise
from threefry keys, which torch cannot reproduce, so every comparison with
JAX hands the port JAX's draws (`_jax_noise`). JAX codec trees are shaped
by `jax.eval_shape` and filled by numpy from a seed (running the JAX
initialisers compiles hundreds of small random ops).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.codec import decoder as jdecoder
from uniaudio2_tpu.codec.streaming_decoder import (
    StreamingCodecDecoder as JStreamingCodecDecoder,
)
from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.engine import continuous as jcontinuous
from uniaudio2_tpu.engine import stream_tts as jstream_tts
from uniaudio2_tpu.engine import tasks
from uniaudio2_tpu.models import unified as junified

from uniaudio2_tpu_torch.codec.decoder import CodecConfig, CodecDecoder
from uniaudio2_tpu_torch.codec.streaming_decoder import StreamingCodecDecoder
from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine
from uniaudio2_tpu_torch.engine.decode import (
    PHASE_DROPPED, PHASE_REASON, PHASE_SEMANTIC, DecodeEngine,
)
from uniaudio2_tpu_torch.engine.stream_tts import stream_tts

RTOL = 1e-5
CODES = CodecConfig.tiny().rec_codebook_size   # codes the tiny codec takes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(port, ref):
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.abs(port - ref).max() <= RTOL * np.abs(ref).max()


def _jax_params(init, seed, **kwargs):
    """A JAX tree shaped as ``init(key, **kwargs)`` returns it, each array
    leaf normal from numpy with std 0.5 / sqrt(fan-in) (0.1 for vectors)."""
    shapes = jax.eval_shape(functools.partial(init, **kwargs),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        std = 0.5 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0.1
        return jnp.asarray(rng.standard_normal(s.shape) * std, s.dtype)
    return jax.tree_util.tree_map(leaf, shapes)


def _jax_noise(seed):
    """noise_fn giving window ``i`` the draw of JAX's decoders: the i-th
    split of PRNGKey(seed), normal f32."""
    def fn(i, shape):
        key = jax.random.PRNGKey(seed)
        for _ in range(i + 1):
            key, sub = jax.random.split(key)
        return np.asarray(jax.random.normal(sub, shape, jnp.float32))
    return fn


@pytest.fixture(scope="module")
def codec():
    jcfg = jdecoder.CodecConfig.tiny()
    jp = _jax_params(jdecoder.init_decode_params, 0, cfg=jcfg)
    return jcfg, jp, CodecConfig.tiny(), convert_params(jp, "cpu")


def _stream_all(params, cfg, codes, feed_sizes, seed=0, noise_fn=None):
    sd = StreamingCodecDecoder(params, cfg, num_steps=4, seed=seed,
                               noise_fn=noise_fn)
    outs, t, sizes = [], 0, list(feed_sizes)
    while t < codes.shape[1]:
        k = min(sizes.pop(0) if sizes else 3, codes.shape[1] - t)
        outs.append(sd.feed(codes[:, t:t + k]))
        t += k
    outs.append(sd.flush())
    return np.concatenate(outs, axis=-1)


def _both_ways(codec, codes, feed_sizes, seed):
    """The port's stream with JAX's noise against JAX's offline decode, and
    with its own noise against its own offline decode (bit for bit)."""
    jcfg, jp, cfg, tp = codec
    ref = jdecoder.CodecDecoder(jp, jcfg).decode(codes, num_steps=4, seed=seed)
    _close(_stream_all(tp, cfg, codes, feed_sizes, seed, _jax_noise(seed)),
           ref)
    np.testing.assert_array_equal(
        _stream_all(tp, cfg, codes, feed_sizes, seed),
        CodecDecoder(tp, cfg).decode(codes, num_steps=4, seed=seed))


def test_streaming_decoder_matches_offline_multichunk(codec):
    cfg = codec[2]
    win = cfg.window_rec_frames
    hop = win // 4 * 3
    # three whole chunks (no flush padding)
    codes = np.random.default_rng(0).integers(0, CODES, (8, win + 2 * hop))
    _both_ways(codec, codes, [1, 5, 2, 7, 3], 0)


def test_streaming_decoder_flush_padding(codec):
    """A ragged tail pads and solves at flush as the offline path does."""
    cfg = codec[2]
    win = cfg.window_rec_frames
    hop = win // 4 * 3
    codes = np.random.default_rng(1).integers(0, CODES,
                                              (8, win + hop + hop // 2))
    _both_ways(codec, codes, [4, 4, 4], 3)


def test_streaming_decoder_incremental_latency(codec):
    """Audio flows after the first window, not at flush, and matches JAX's
    stream chunk for chunk."""
    jcfg, jp, cfg, tp = codec
    win = cfg.window_rec_frames
    hop = win // 4 * 3
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, CODES, (8, win)), rng.integers(0, CODES, (8, hop))
    sd = StreamingCodecDecoder(tp, cfg, num_steps=4, noise_fn=_jax_noise(0))
    js = JStreamingCodecDecoder(jp, jcfg, num_steps=4)
    early = sd.feed(a)
    assert early.shape[-1] > 0           # the first chunk before the flush
    _close(early, js.feed(a))
    more = sd.feed(b)
    assert more.shape[-1] > 0
    _close(more, js.feed(b))
    _close(sd.flush(), js.flush())


@pytest.fixture(scope="module")
def llm():
    jcfg = JaxConfig.tiny()
    jparams = junified.init_params(jax.random.PRNGKey(0), jcfg)
    g, m = tasks.prepare_tts(np.array([1, 5, 6]), np.array([1, 10, 2]),
                             jcfg.tokens)
    return jcfg, jparams, UnifiedModelConfig.tiny(), \
        convert_params(jparams, "cpu"), g, m


def test_stream_tts_end_to_end_matches_offline(codec, llm):
    """Streamed LLM frames equal JAX's stream and the port's offline greedy
    decode; streamed LLM -> streamed codec equals greedy LLM -> offline
    codec decode."""
    jcfg, jparams, cfg, params, g, m = llm
    _, _, ccfg, cparams = codec
    kw = dict(mode="audio", rows=1, bucket=32, seg_frames=6, cache_len=128,
              max_frames=24, topk=1)
    jframes = [(p, np.asarray(f)) for p, f in jcontinuous.ContinuousEngine(
        jparams, jcfg, cache_dtype=jnp.float32, **kw).stream(g, m)]
    ce = ContinuousEngine(params, cfg, cache_dtype=torch.float32, **kw)
    frames = list(ce.stream(g, m))
    assert len(frames) == len(jframes) == 24
    for (p, f), (jp_, jf) in zip(frames, jframes):
        assert p == jp_
        np.testing.assert_array_equal(f, jf)
    card = cfg.tokens.audio_reason_card
    _, semantic = DecodeEngine(params, cfg, max_frames=24,
                               cache_dtype=torch.float32,
                               buckets=(32,)).generate_audio(g, m, topk=1)
    sem = [f - card for p, f in frames if p == PHASE_SEMANTIC]
    np.testing.assert_array_equal(
        np.stack(sem, axis=1) if sem else np.zeros((8, 0), np.int64), semantic)
    chunks = list(stream_tts(
        ContinuousEngine(params, cfg, cache_dtype=torch.float32, **kw),
        cparams, ccfg, g, m, num_steps=4, codec_seed=5))
    if semantic.shape[1] == 0:
        assert chunks == []             # an untrained model never switches
        return
    np.testing.assert_array_equal(
        np.concatenate(chunks, axis=-1),
        CodecDecoder(cparams, ccfg).decode(semantic, num_steps=4, seed=5))


class Scripted:
    """A scripted LLM stream: a reasoning frame, the generated semantic-BOS
    frame (dropped, as the offline split drops it), then ``sem`` with a
    dropped frame after its third."""

    def __init__(self, cfg, sem):
        self.cfg, self.sem = cfg, sem

    def stream(self, grid, mask, max_frames=None):
        card = self.cfg.tokens.audio_reason_card
        yield PHASE_REASON, np.zeros(8, np.int64)
        yield PHASE_SEMANTIC, np.full((8,), self.cfg.tokens.semantic_bos + card,
                                      np.int64)
        for t in range(self.sem.shape[1]):
            yield PHASE_SEMANTIC, self.sem[:, t] + card
            if t == 2:
                yield PHASE_DROPPED, np.zeros(8, np.int64)


def test_stream_tts_glue_with_scripted_llm(codec):
    """Phase filtering, offset removal and flush, driven by a scripted LLM
    (an untrained model never reaches the semantic phase): the port's
    chunks against JAX's `stream_tts` on the same script, and against its
    own streaming and offline decodes bit for bit."""
    jcfg, jp, ccfg, cparams = codec
    cfg = UnifiedModelConfig.tiny()
    win = ccfg.window_rec_frames
    sem = np.random.default_rng(3).integers(0, CODES, (8, win + win // 4 * 3))
    chunks = list(stream_tts(Scripted(cfg, sem), cparams, ccfg, None, None,
                             num_steps=4, codec_seed=9))
    assert len(chunks) >= 2                    # incremental, not one blob
    streamed = np.concatenate(chunks, axis=-1)
    sd = StreamingCodecDecoder(cparams, ccfg, num_steps=4, seed=9)
    np.testing.assert_array_equal(
        streamed, np.concatenate([sd.feed(sem), sd.flush()], axis=-1))
    np.testing.assert_array_equal(
        streamed, CodecDecoder(cparams, ccfg).decode(sem, num_steps=4, seed=9))
    got = list(stream_tts(Scripted(cfg, sem), cparams, ccfg, None, None,
                          num_steps=4, codec_seed=9, noise_fn=_jax_noise(9)))
    ref = list(jstream_tts.stream_tts(Scripted(JaxConfig.tiny(), sem), jp,
                                      jcfg, None, None, num_steps=4,
                                      codec_seed=9))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _close(a, b)


def test_streaming_decoder_short_clip_delegates_to_offline(codec):
    """Clips shorter than one window decode as the offline facade's
    fractional window, at flush."""
    jcfg, jp, cfg, tp = codec
    win = cfg.window_rec_frames
    rng = np.random.default_rng(5)
    for t_rec in (max(2, win // 3), max(3, win - 1)):
        codes = rng.integers(0, CODES, (8, t_rec))
        ref = jdecoder.CodecDecoder(jp, jcfg).decode(codes, num_steps=4, seed=7)
        for noise_fn, want in ((_jax_noise(7), None),
                               (None, CodecDecoder(tp, cfg).decode(
                                   codes, num_steps=4, seed=7))):
            sd = StreamingCodecDecoder(tp, cfg, num_steps=4, seed=7,
                                       noise_fn=noise_fn)
            out = np.concatenate([sd.feed(codes[:, :1]), sd.feed(codes[:, 1:]),
                                  sd.flush()], axis=-1)
            if want is None:
                _close(out, ref)
            else:
                np.testing.assert_array_equal(out, want)
