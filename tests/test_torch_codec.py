"""The port's codec decode path (`uniaudio2_tpu_torch.codec`) against the
JAX package's, on the CPU in float32.

JAX parameter trees have the structure of the JAX package's own `init_*`
(traced with `jax.eval_shape`, not run: running them compiles hundreds of
small random ops) and leaves drawn by numpy from a seed (`_jax_params`);
they cross into the port through `convert.from_jax.convert_params`. Inputs
are made with numpy from a seed too. The JAX DiT takes its einsum
attention on the CPU (its Pallas flash call is TPU-only) and the port's
flash wrapper takes its plain twin on CPU tensors, so the two compute the
same function.

The solver's noise: JAX draws it from threefry keys, which torch cannot
reproduce, so every comparison hands the port the JAX draws (`_jax_noise`,
the keys `CodecDecoder.decode` splits, one per window).

Tolerance: float32 on both sides, JAX matmuls at "highest" precision
(tests/conftest.py). What differs is the order of the sums (XLA vs ATen
kernels) and XLA's exp against ATen's, whose last-bit differences the
flow-time embedding multiplies by up to 1000. Outputs are held to
|port - jax| <= 1e-5 x max|jax|; the worst reading on the CPU is 1.1e-6
(the DiT forward), and the whole windowed decode reads about 2e-7. The
streaming decoder is held to the port's own offline decode bit for bit.
"""

import functools
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.codec import cfm as jcfm
from uniaudio2_tpu.codec import decoder as jdecoder
from uniaudio2_tpu.codec import dit as jdit
from uniaudio2_tpu.codec import rvq as jrvq
from uniaudio2_tpu.codec import scalar_ae as jsae
from uniaudio2_tpu.codec.streaming_decoder import (
    StreamingCodecDecoder as JStreamingCodecDecoder,
)
from uniaudio2_tpu_torch.codec import cfm, decoder, dit, encoder, reasoning, rvq
from uniaudio2_tpu_torch.codec import scalar_ae, ssl_encoder, wavlm_encoder
from uniaudio2_tpu_torch.codec import whisper_encoder
from uniaudio2_tpu_torch.codec.streaming_decoder import StreamingCodecDecoder
from uniaudio2_tpu_torch.convert.from_jax import convert_params, to_tensor
from uniaudio2_tpu_torch.models import gpt, unified
from uniaudio2_tpu_torch.ops import kv_cache, rope

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= RTOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_params(init, seed, **kwargs):
    """A JAX parameter tree shaped as ``init(key, **kwargs)`` returns it
    (``None`` leaves included), each array leaf normal from numpy with std
    0.5 / sqrt(fan-in), the fan-in being the product of all but its last
    axis (0.1 for vectors)."""
    shapes = jax.eval_shape(functools.partial(init, **kwargs),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        std = 0.5 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0.1
        return jnp.asarray(rng.standard_normal(s.shape) * std, s.dtype)
    return jax.tree_util.tree_map(leaf, shapes)


def _jax_noise(seed):
    """noise_fn giving window ``i`` the draw of JAX's ``CodecDecoder.decode``:
    the i-th split of PRNGKey(seed), normal f32."""
    def fn(i, shape):
        key = jax.random.PRNGKey(seed)
        for _ in range(i + 1):
            key, sub = jax.random.split(key)
        return np.asarray(jax.random.normal(sub, shape, jnp.float32))
    return fn


@pytest.fixture(scope="module")
def codec():
    cfg_j = jdecoder.CodecConfig.tiny()
    jp = _jax_params(jdecoder.init_decode_params, 0, cfg=cfg_j)
    return cfg_j, jp, decoder.CodecConfig.tiny(), convert_params(jp, "cpu")


def test_rvq_decode():
    jp = _jax_params(jrvq.init_params, 1, dim=12, codebook_size=7,
                     codebook_dim=4, num_quantizers=3)
    idx = np.random.default_rng(0).integers(0, 7, (2, 5, 3))
    _close(rvq.decode(convert_params(jp, "cpu"), _t(idx)),
           jrvq.decode(jp, jnp.asarray(idx)))


@pytest.mark.parametrize("scale", [2.5, 2.0])
@pytest.mark.parametrize("t", [8, 13, 150])
def test_upsample_nearest(scale, t):
    x = np.random.default_rng(t).standard_normal((1, t, 3)).astype(np.float32)
    out = decoder._upsample_nearest(_t(x), scale)
    assert out.shape[1] == int(math.floor(t * scale))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jdecoder._upsample_nearest(jnp.asarray(x), scale)))


@pytest.mark.parametrize("with_reason", [False, True])
def test_condition_features(codec, with_reason):
    cfg_j, jp, cfg, tp = codec
    rng = np.random.default_rng(1)
    rec = rng.integers(0, cfg.rec_codebook_size, (2, 25, 8))
    reason = (rng.integers(0, cfg.reason_codebook_size, (2, 10, 8))
              if with_reason else None)
    out = decoder.condition_features(
        tp, cfg, _t(rec), None if reason is None else _t(reason))
    ref = jdecoder.condition_features(
        jp, cfg_j, jnp.asarray(rec), None if reason is None else jnp.asarray(reason))
    assert out.shape == (2, 50, cfg.codec_dim)
    _close(out, ref)


@pytest.fixture(scope="module")
def tiny_dit():
    jcfg = jdit.DiTConfig.tiny()
    jp = _jax_params(jdit.init_params, 3, cfg=jcfg)
    return jcfg, jp, dit.DiTConfig.tiny(), convert_params(jp, "cpu")


@pytest.mark.parametrize("times", [(0.0, 0.3), (0.55, 0.9), (1.0, 0.1)])
@pytest.mark.parametrize("prepared", [False, True])
def test_dit_forward(tiny_dit, times, prepared):
    jcfg, jp, cfg, tp = tiny_dit
    if prepared:
        tp = dit.prepare_params(tp)
    x = np.random.default_rng(4).standard_normal(
        (2, 37, cfg.in_channels)).astype(np.float32)
    t = np.asarray(times, np.float32)
    out = dit.forward(tp, cfg, _t(x), _t(t))
    assert out.shape == (2, 37, cfg.out_channels)
    _close(out, jdit.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(t)))


@pytest.mark.parametrize("t", [130, 7])
def test_flash_twin_matches_jax_attention(t):
    """The port's DiT attention (the flash wrapper's twin on the CPU) at
    hd = 64 against JAX's `dit._attention` (its einsum path on the CPU)."""
    rng = np.random.default_rng(t)
    d, h = 128, 2
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.1
         for s in ((d, 3 * d), (3 * d,), (d, d), (d,))]
    _close(dit._attention(_t(x), *map(_t, w), h),
           jdit._attention(jnp.asarray(x), *map(jnp.asarray, w), h))


@pytest.mark.parametrize("guidance", [1.0, 1.5])
def test_solve_euler(tiny_dit, guidance):
    jcfg, jp, cfg, tp = tiny_dit
    lat = cfg.out_channels
    cond = cfg.in_channels - 2 * lat
    rng = np.random.default_rng(5)
    b, t = 2, 24
    mu = rng.standard_normal((b, t, cond)).astype(np.float32)
    ctx = rng.standard_normal((b, t, lat)).astype(np.float32)
    mask = np.arange(t)[None].repeat(b, 0) < 6
    ctx = ctx * mask[..., None]
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (b, t, lat), jnp.float32))
    ref = jcfm.solve_euler(
        lambda x, tt: jdit.forward(jp, jcfg, x, tt), key=key,
        mu=jnp.asarray(mu), incontext_x=jnp.asarray(ctx),
        incontext_mask=jnp.asarray(mask), num_steps=4,
        guidance_scale=guidance, latent_dim=lat)
    out = cfm.solve_euler(
        lambda x, tt: dit.forward(tp, cfg, x, tt), noise=_t(noise), mu=_t(mu),
        incontext_x=_t(ctx), incontext_mask=_t(mask), num_steps=4,
        guidance_scale=guidance)
    _close(out, ref)
    np.testing.assert_array_equal(out.numpy()[mask], ctx[mask])


def test_time_grid_is_jax_linspace():
    for n in (3, 4, 7, 10, 32):
        np.testing.assert_array_equal(cfm._time_grid(n),
                                      np.asarray(jnp.linspace(0.0, 1.0, n + 1)))


_POST_CFG = dict(num_samples=2, downsample_factors=(2, 5),
                 downsample_kernel_sizes=(4, 10), upsample_factors=(5, 2),
                 upsample_kernel_sizes=(10, 4), latent_hidden_dim=8,
                 init_channel=4, default_kernel_size=3, delay_kernel_size=3,
                 res_kernel_size=3)


@pytest.mark.parametrize("name", ["tiny", "post"])
@pytest.mark.parametrize("prepared", [False, True])
def test_scalar_ae_decode(name, prepared):
    if name == "tiny":
        jcfg, cfg = jsae.ScalarAEConfig.tiny(), scalar_ae.ScalarAEConfig.tiny()
    else:
        jcfg = jsae.ScalarAEConfig(**_POST_CFG)
        cfg = scalar_ae.ScalarAEConfig(**_POST_CFG)
    jp = _jax_params(jsae.init_params, 6, cfg=jcfg)
    tp = convert_params(jp, "cpu")
    assert (tp["post"] is None) == (name == "tiny")
    if prepared:
        tp = scalar_ae.prepare_params(tp)
    lat = np.random.default_rng(7).standard_normal(
        (2, 11, cfg.latent_hidden_dim)).astype(np.float32) * 0.5
    out = scalar_ae.decode(tp, cfg, _t(lat))
    ref = jsae.decode(jp, jcfg, jnp.asarray(lat))
    _close(out, ref)


@pytest.mark.parametrize("k,stride,dilation", [(10, 5, 1), (4, 2, 1), (7, 1, 3),
                                               (4, 1, 1)])
def test_conv_lengths(k, stride, dilation):
    """`_conv` (symmetric (k d - d) // 2 padding, even k too) and
    `_conv_transpose` ((k - stride) // 2: k = 10, stride 5 gives 5 T + 1)
    against the JAX helpers, lengths and values."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((1, 9, 3)).astype(np.float32)
    p = {"w": rng.standard_normal((k, 3, 5)).astype(np.float32) * 0.3,
         "b": rng.standard_normal(5).astype(np.float32)}
    tp = {n: _t(v) for n, v in p.items()}
    jp_ = {n: jnp.asarray(v) for n, v in p.items()}
    xt = _t(x).transpose(1, 2)
    out = scalar_ae._conv(xt, tp, dilation=dilation).transpose(1, 2)
    _close(out, jsae._conv(jnp.asarray(x), jp_, dilation=dilation))
    if stride > 1:
        out = scalar_ae._conv_transpose(xt, tp, stride=stride).transpose(1, 2)
        ref = jsae._conv_transpose(jnp.asarray(x), jp_, stride=stride)
        assert out.shape[1] == (9 - 1) * stride - 2 * ((k - stride) // 2) + k
        _close(out, ref)


@pytest.mark.parametrize("with_reason,ctx_len", [(False, 0), (True, 0),
                                                 (False, 14)])
def test_decode_chunk(codec, with_reason, ctx_len):
    cfg_j, jp, cfg, tp = codec
    rng = np.random.default_rng(8)
    win, lat_frames = cfg.window_rec_frames, 2 * cfg.window_rec_frames
    rec = rng.integers(0, cfg.rec_codebook_size, (1, win, 8))
    reason = (rng.integers(0, cfg.reason_codebook_size,
                           (1, cfg.window_reason_frames, 8))
              if with_reason else None)
    ctx = rng.standard_normal((1, lat_frames, cfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (1, lat_frames, cfg.latent_dim),
                                         jnp.float32))
    ref = jdecoder.decode_chunk(
        jp, cfg_j, jnp.asarray(rec), None if reason is None else jnp.asarray(reason),
        jnp.asarray(ctx), jnp.int32(ctx_len), key, num_steps=4,
        guidance_scale=1.5)
    out = decoder.decode_chunk(
        tp, cfg, _t(rec), None if reason is None else _t(reason), _t(ctx),
        ctx_len, _t(noise), num_steps=4, guidance_scale=1.5)
    _close(out, ref)


@pytest.mark.parametrize("frames,with_reason,seed", [
    (60, False, 0),      # three 2 s windows: carry-over and crossfade
    (60, True, 1),       # the same with reasoning codes
    (10, False, 2),      # a short clip: the half-window bucket
])
def test_codec_decoder(codec, frames, with_reason, seed):
    cfg_j, jp, cfg, tp = codec
    rng = np.random.default_rng(frames + seed)
    codes = rng.integers(0, cfg.rec_codebook_size, (8, frames))
    reason = (rng.integers(0, cfg.reason_codebook_size,
                           (8, int(frames / cfg.rec_hz * cfg.reason_hz)))
              if with_reason else None)
    ref = jdecoder.CodecDecoder(jp, cfg_j).decode(codes, reason, num_steps=4,
                                                  seed=seed)
    out = decoder.CodecDecoder(tp, cfg).decode(codes, reason, num_steps=4,
                                               seed=seed,
                                               noise_fn=_jax_noise(seed))
    assert out.shape == (1, int(frames / cfg.rec_hz * cfg.sample_rate))
    assert out.dtype == np.float32
    _close(out, ref)


@pytest.mark.parametrize("frames,pieces", [(60, (7, 20, 1, 32)), (43, (43,)),
                                           (10, (4, 6))])
def test_streaming_decoder_matches_offline(codec, frames, pieces):
    _, _, cfg, tp = codec
    codes = np.random.default_rng(frames).integers(
        0, cfg.rec_codebook_size, (8, frames))
    dec = decoder.CodecDecoder(tp, cfg)
    offline = dec.decode(codes, num_steps=4, seed=3)
    sd = StreamingCodecDecoder(tp, cfg, num_steps=4, seed=3, decoder=dec)
    outs, s = [], 0
    for n in pieces:
        outs.append(sd.feed(codes[:, s: s + n]))
        s += n
    outs.append(sd.flush())
    np.testing.assert_array_equal(np.concatenate(outs, axis=-1), offline)
    assert sd.samples_emitted == offline.shape[-1]


def test_streaming_decoder_matches_jax_streaming(codec):
    """With JAX's noise the port's stream equals the JAX stream."""
    cfg_j, jp, cfg, tp = codec
    codes = np.random.default_rng(12).integers(0, cfg.rec_codebook_size, (8, 50))
    js = JStreamingCodecDecoder(jp, cfg_j, num_steps=4, seed=4)
    ts = StreamingCodecDecoder(tp, cfg, num_steps=4, seed=4,
                               noise_fn=_jax_noise(4))
    for a, b in ((0, 30), (30, 50)):
        _close(ts.feed(codes[:, a:b]), js.feed(codes[:, a:b]))
    _close(ts.flush(), js.flush())


def test_seeded_noise_is_reproducible(codec):
    _, _, cfg, tp = codec
    codes = np.random.default_rng(13).integers(0, cfg.rec_codebook_size, (8, 30))
    dec = decoder.CodecDecoder(tp, cfg)
    a = dec.decode(codes, num_steps=2, seed=5)
    np.testing.assert_array_equal(a, dec.decode(codes, num_steps=2, seed=5))
    assert np.abs(a - dec.decode(codes, num_steps=2, seed=6)).max() > 0


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfm.loss()


_ENTRY_POINTS = [unified.init_params, unified.init_caches, gpt.init_params,
                 kv_cache.init_cache, rope.rope_cache, to_tensor, convert_params,
                 rvq.init_params, dit.init_params, scalar_ae.init_params,
                 decoder.init_decode_params, encoder.init_encode_params,
                 whisper_encoder.init_params, wavlm_encoder.init_params,
                 ssl_encoder.init_params, reasoning.init_params]


@pytest.mark.parametrize("fn", _ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_needs_a_card():
    """With no card the defaults raise (no quiet fall-back to the CPU); with
    one, they allocate there."""
    calls = (lambda: rope.rope_cache(8, 4), lambda: to_tensor(np.ones(3)),
             lambda: kv_cache.init_cache(
                 gpt.GPTConfig.from_name("tiny-expert"), 1, 4, torch.float32))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            leaf = out[0] if isinstance(out, tuple) else out
            assert leaf.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()


def test_convert_params_carries_none_and_lists():
    jp = _jax_params(jsae.init_params, 0, cfg=jsae.ScalarAEConfig.tiny())
    assert jp["pre"] is None and jp["post"] is None
    tp = convert_params(jp, "cpu")
    assert tp["pre"] is None and tp["post"] is None
    assert isinstance(tp["dec_blocks"], list) and isinstance(
        tp["dec_blocks"][0]["units"], list)
    np.testing.assert_array_equal(tp["dec_blocks"][1]["units"][4]["conv1"]["w"],
                                  np.asarray(jp["dec_blocks"][1]["units"][4]["conv1"]["w"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_dit_attention_path_by_dtype_and_head_dim(monkeypatch, dtype, hd):
    """The DiT sends an attention to the flash kernels in bf16 and float32
    at a head dim they are built for (64, 128), as the JAX DiT's `_flash_ok`
    does, and counts every other call on the plain path
    (`_attention.plain_launches`); both paths compute the JAX einsum
    attention here (the kernels' wrapper takes its twin on the CPU), held
    to JAX's `_attention` on the same inputs: float32 within `_close`,
    bf16 (the inputs cast to bf16 for JAX too) within 2e-2 x max|ref|."""
    from uniaudio2_tpu_torch.ops import flash_attention

    kernel_calls = []
    real = flash_attention.flash_attention

    def record(q, k, v, scale):
        kernel_calls.append(q.shape)
        return real(q, k, v, scale)

    monkeypatch.setattr(flash_attention, "flash_attention", record)
    heads, t = 2, 24
    d = heads * hd
    rng = np.random.default_rng(hd)
    x, qkv_w, out_w = (torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.1).to(dtype)
        for s in ((2, t, d), (d, 3 * d), (d, d)))
    qkv_b, out_b = torch.zeros(3 * d, dtype=dtype), torch.zeros(d, dtype=dtype)
    before = dit._attention.plain_launches
    out = dit._attention(x, qkv_w, qkv_b, out_w, out_b, heads)
    kernel = hd in (64, 128)
    assert dit.flash_ok(dtype, hd) == kernel
    assert len(kernel_calls) == int(kernel)
    assert dit._attention.plain_launches == before + int(not kernel)
    assert out.shape == (2, t, d) and out.dtype == dtype

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw, jo = (jnp.asarray(a.float().numpy()).astype(jdt)
                  for a in (x, qkv_w, out_w))
    ref = jdit._attention(jx, jw, jnp.zeros(3 * d, jdt), jo,
                          jnp.zeros(d, jdt), heads)
    if dtype == torch.float32:
        _close(out, ref)
    else:
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= 2e-2 * np.abs(ref).max(), err
