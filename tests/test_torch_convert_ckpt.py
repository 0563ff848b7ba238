"""The port's checkpoint converters (`uniaudio2_tpu_torch/convert/torch_ckpt.py`,
`convert/codec.py`) against the JAX package's (`convert/torch_to_jax.py`,
`convert/codec.py`), on the CPU.

The converters are numpy on both sides and the port's trees keep the JAX
key names, so they must give leaf-for-leaf identical numpy trees: on the
real-depth, tiny-width key inventory of `tests/test_convert_inventory.py`
(contiguous and legacy fused QKV, the ``module.`` envelope), on the codec
inventory of `tests/test_codec_inventory.py`, on the DiT / RVQ / Whisper
round trips of `tests/test_codec_convert.py` and on the ScalarAE of
`tests/test_scalar_ae_torch_parity.py`. ``.npz`` archives cross between
the packages bit for bit in float32; a bf16 tree round-trips through the
port (the JAX package cannot load its own bf16 archive back: ``np.savez``
stores bf16 as ``|V2``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu import config as jconfig
from uniaudio2_tpu.codec import dit as jdit
from uniaudio2_tpu.codec.decoder import CodecConfig as JCodecConfig
from uniaudio2_tpu.codec.encoder import EncoderConfig as JEncoderConfig
from uniaudio2_tpu.codec.scalar_ae import ScalarAEConfig as JScalarAEConfig
from uniaudio2_tpu.convert import codec as jcodec
from uniaudio2_tpu.convert import torch_to_jax as jcvt
from uniaudio2_tpu.models import unified as junified

from uniaudio2_tpu_torch import config as tconfig
from uniaudio2_tpu_torch.codec.decoder import CodecConfig
from uniaudio2_tpu_torch.codec.encoder import EncoderConfig
from uniaudio2_tpu_torch.codec.scalar_ae import ScalarAEConfig
from uniaudio2_tpu_torch.convert import codec as tcodec
from uniaudio2_tpu_torch.convert import merge_safetensors
from uniaudio2_tpu_torch.convert import torch_ckpt as tcvt
from uniaudio2_tpu_torch.models import unified

from tests import test_codec_inventory as inv
from tests.test_codec_convert import _dit_to_sd
from tests.test_convert_inventory import _reference_state_dict


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, path=""):
    """path -> leaf over dicts, lists and None."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def assert_identical(got, ref):
    g, r = _flat(got), _flat(ref)
    assert g.keys() == r.keys()
    for path, a in g.items():
        b = r[path]
        if b is None:
            assert a is None, path
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def inv_cfgs():
    """The inventory's real-depth, tiny-width configs in both packages."""
    common = dict(block_size=512, vocab_size=100, padded_vocab_size=128,
                  n_head=4, n_query_groups=2, rope_base=10000.0,
                  rope_adjustments=None)
    out = []
    for mod in (jconfig, tconfig):
        mod.register_config("inv-backbone", n_layer=28, n_embd=32,
                            intermediate_size=64, **common)
        mod.register_config("inv-decoder", n_layer=4, n_embd=16,
                            intermediate_size=32, **common)
        mod.register_config("inv-und", n_layer=3, n_embd=32,
                            intermediate_size=64, **common)
        mod.register_config("inv-gen", n_layer=2, n_embd=32,
                            intermediate_size=64, **common)
        out.append(mod.UnifiedModelConfig(
            llm_name="inv-backbone", decoder_name="inv-decoder",
            understanding_expert_name="inv-und",
            generation_expert_name="inv-gen", max_seq_len=128))
    return out


def _legacy(sd, cfg):
    """The reference's legacy fused ``attn.attn`` layout of every QKV."""
    out = {}
    for key, v in sd.items():
        if not key.endswith("attn.qkv.weight"):
            out[key] = v
            continue
        g = {"backbone": cfg.backbone, "decoder": cfg.decoder,
             "audio_understanding_expert": cfg.understanding_expert,
             "audio_generation_expert": cfg.generation_expert}[key.split(".")[0]]
        hs, ng, qpk = g.head_size, g.n_query_groups, g.q_per_kv
        q, k, w = np.split(v, [ng * qpk * hs, ng * (qpk + 1) * hs], axis=0)
        out[key.replace("attn.qkv.", "attn.attn.")] = np.concatenate(
            [q.reshape(ng, qpk * hs, -1), k.reshape(ng, hs, -1),
             w.reshape(ng, hs, -1)], axis=1).reshape(-1, v.shape[-1])
    return out


@pytest.mark.parametrize("layout", ["contiguous", "legacy_fused_qkv"])
def test_convert_unified_identical_to_jax(inv_cfgs, layout):
    jcfg, tcfg = inv_cfgs
    sd = _reference_state_dict(jcfg)
    if layout == "legacy_fused_qkv":
        sd = _legacy(sd, jcfg)
    jparams, jmissing = jcvt.convert_unified(dict(sd), jcfg)
    tparams, tmissing = tcvt.convert_unified(dict(sd), tcfg)
    assert tmissing == jmissing == []
    assert_identical(tparams, jparams)
    assert tparams["backbone"]["layers"]["qkv_w"].shape[0] == 28


def test_state_dict_envelope_and_missing_keys(inv_cfgs, tmp_path):
    """``{"model": {"module." + k: tensor}}`` loads as JAX loads it; keys
    left out are reported as JAX reports them."""
    jcfg, tcfg = inv_cfgs
    sd = _reference_state_dict(jcfg)
    path = str(tmp_path / "ep1.checkpoint")
    torch.save({"model": {"module." + k: torch.from_numpy(v)
                          for k, v in sd.items()}}, path)
    loaded = tcvt.load_torch_state_dict(path)
    ref = jcvt.load_torch_state_dict(path)
    assert loaded.keys() == ref.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(loaded[k], ref[k])
    cut = {k: v for k, v in sd.items()
           if k not in ("backbone.transformer.ln_f.weight", "projection.weight")}
    tparams, tmissing = tcvt.convert_unified(cut, tcfg)
    jparams, jmissing = jcvt.convert_unified(dict(cut), jcfg)
    assert tmissing == jmissing == ["backbone.transformer.ln_f.weight",
                                    "projection.weight"]
    assert_identical(tparams, jparams)


@pytest.fixture(scope="module")
def codec_sd():
    """The full codec inventory (`tests/test_codec_inventory.py`)."""
    enc_cfg, codec_cfg = JEncoderConfig.tiny_test(), JCodecConfig.tiny()
    rng = np.random.default_rng(7)
    sd = {}
    sd.update(inv._hf_whisper_encoder_sd(enc_cfg))
    sd.update(inv._hf_wavlm_sd(enc_cfg))
    sd.update(inv._fairseq_mert_sd(enc_cfg))
    sd.update(inv._audio_thinking_sd(enc_cfg, rng))
    sd.update(inv._glue_sd(enc_cfg, rng))
    for name in ("vq_pronunciation_semantic", "vq_structure_semantic",
                 "vq_acoustic"):
        nq = 6 if name == "vq_acoustic" else 1
        sd.update(inv._rvq_sd(f"{name}.", enc_cfg.codec_dim,
                              codec_cfg.rec_codebook_dim,
                              codec_cfg.rec_codebook_size, nq, rng))
    sd.update(_dit_to_sd(jdit.init_params(jax.random.PRNGKey(0), codec_cfg.dit),
                         codec_cfg.dit.num_layers))
    return sd


def test_convert_codec_checkpoint_identical_to_jax(codec_sd):
    sd = codec_sd
    rec = inv._RecordingDict(sd)
    tenc, tdec, tmissing = tcodec.convert_codec_checkpoint(
        rec, EncoderConfig.tiny_test(), CodecConfig.tiny())
    jenc, jdec, jmissing = jcodec.convert_codec_checkpoint(
        dict(sd), JEncoderConfig.tiny_test(), JCodecConfig.tiny())
    assert tmissing == jmissing == []
    unread = sorted(k for k in rec if k not in rec.accessed
                    and not inv._known_unused(k))
    assert unread == []
    assert_identical(tenc, jenc)
    assert_identical(tdec, jdec)
    # a partial dict: the same keys reported missing
    cut = {k: v for k, v in sd.items() if not k.startswith("wavlm_encoder.")}
    _, _, tmissing = tcodec.convert_codec_checkpoint(
        cut, EncoderConfig.tiny_test(), CodecConfig.tiny())
    _, _, jmissing = jcodec.convert_codec_checkpoint(
        cut, JEncoderConfig.tiny_test(), JCodecConfig.tiny())
    assert tmissing == jmissing and tmissing


def test_codec_round_trips_identical_to_jax():
    """The DiT, RVQ and Whisper round trips of `tests/test_codec_convert.py`
    and both weight-norm namings of `fold_weight_norm`."""
    from transformers import WhisperConfig, WhisperModel

    cfg = jdit.DiTConfig.tiny()
    sd = _dit_to_sd(jdit.init_params(jax.random.PRNGKey(0), cfg), cfg.num_layers)
    tm, jm = [], []
    assert_identical(
        tcodec.convert_dit(sd, "cfm_wrapper.estimator.", cfg.num_layers, tm),
        jcodec.convert_dit(sd, "cfm_wrapper.estimator.", cfg.num_layers, jm))
    assert tm == jm == []
    rng = np.random.default_rng(0)
    sd = {
        "vq.project_in.weight": rng.standard_normal((8, 16)).astype(np.float32),
        "vq.project_in.bias": rng.standard_normal(8).astype(np.float32),
        "vq.project_out.weight": rng.standard_normal((16, 8)).astype(np.float32),
        "vq.project_out.bias": rng.standard_normal(16).astype(np.float32),
        "vq.layers.0._codebook.embed": rng.standard_normal((1, 11, 8)).astype(np.float32),
        "vq.layers.1._codebook.embed": rng.standard_normal((11, 8)).astype(np.float32),
    }
    assert_identical(tcodec.convert_rvq(sd, "vq.", []), jcodec.convert_rvq(sd, "vq.", []))
    wcfg = WhisperConfig(
        vocab_size=100, num_mel_bins=8, d_model=32, encoder_layers=2,
        encoder_attention_heads=2, encoder_ffn_dim=64, decoder_layers=1,
        decoder_attention_heads=2, decoder_ffn_dim=64,
        max_source_positions=32, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=1, max_target_positions=32)
    torch.manual_seed(0)
    sd = {"whisper_encoder." + k: v.detach().numpy()
          for k, v in WhisperModel(wcfg).encoder.state_dict().items()}
    assert_identical(tcodec.convert_whisper_encoder(sd, "whisper_encoder.", 2, []),
                     jcodec.convert_whisper_encoder(sd, "whisper_encoder.", 2, []))
    v = rng.standard_normal((6, 4, 3)).astype(np.float32)
    g = rng.standard_normal((6, 1, 1)).astype(np.float32)
    for names in ((".weight_g", ".weight_v"), (".parametrizations.weight.original0",
                                               ".parametrizations.weight.original1")):
        wn = {"c" + names[0]: g, "c" + names[1]: v}
        np.testing.assert_array_equal(tcodec.fold_weight_norm(wn, "c"),
                                      jcodec.fold_weight_norm(wn, "c"))


def _scalar_sd():
    from tests.test_scalar_ae_torch_parity import TorchScalar

    torch.manual_seed(0)
    return {k: v.detach().numpy() for k, v in
            TorchScalar(JScalarAEConfig.tiny()).eval().state_dict().items()}


def test_convert_scalar_ae_identical_to_jax():
    sd = _scalar_sd()
    tp, tm = tcodec.convert_scalar_ae(sd, ScalarAEConfig.tiny())
    jp, jm = jcodec.convert_scalar_ae(sd, JScalarAEConfig.tiny())
    assert tm == jm == []
    assert_identical(tp, jp)


def test_load_tokenizer_builds_the_port_codec(tmp_path, monkeypatch, codec_sd):
    """`load_tokenizer` from a codec config naming the ScalarAE checkpoint:
    the converted trees on the CPU, as tensors equal to JAX's numpy trees.
    The tiny configs stand in for the full ones the function reads."""
    from uniaudio2_tpu_torch.codec import decoder, encoder

    sd = codec_sd
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(tmp_path / "codec.pt"))
    torch.save({"codec_model": {k: torch.from_numpy(v)
                                for k, v in _scalar_sd().items()}},
               str(tmp_path / "sq.pt"))
    (tmp_path / "codec.yaml").write_text(f"sq_resume: {tmp_path / 'sq.pt'}\n")
    monkeypatch.setattr(encoder, "EncoderConfig", EncoderConfig.tiny_test)
    monkeypatch.setattr(decoder, "CodecConfig", lambda: dataclasses.replace(
        CodecConfig.tiny(), scalar=ScalarAEConfig.tiny()))
    tok = tcodec.load_tokenizer(str(tmp_path / "codec.yaml"),
                                str(tmp_path / "codec.pt"), need_decode=True,
                                device="cpu")
    jenc, _, _ = jcodec.convert_codec_checkpoint(
        sd, JEncoderConfig.tiny_test(), JCodecConfig.tiny())
    got = _flat(tok.enc_params)
    for path, ref in _flat(jenc).items():
        if ref is None:
            assert got[path] is None
        else:
            assert torch.equal(got[path], torch.from_numpy(np.asarray(ref))), path
    assert tok.decoder is not None and tok.device.type == "cpu"
    with pytest.raises(ValueError, match="sq_resume"):
        tcodec.load_tokenizer(None, str(tmp_path / "codec.pt"),
                              need_decode=True, device="cpu")


def test_npz_crosses_between_the_packages(inv_cfgs, tmp_path):
    """float32 archives: JAX -> port and port -> JAX, bit for bit."""
    from uniaudio2_tpu.config import UnifiedModelConfig as JCfg

    jcfg, tcfg = JCfg.tiny(), tconfig.UnifiedModelConfig.tiny()
    jparams = junified.init_params(jax.random.PRNGKey(0), jcfg)
    jcvt.save_npz(str(tmp_path / "jax.npz"), jparams)
    like = unified.init_params(tcfg, torch.Generator(), device="meta")
    tparams = tcvt.to_port(tcvt.load_npz(str(tmp_path / "jax.npz"), like),
                           torch.float32, "cpu")
    assert_identical({k: v.numpy() for k, v in _flat(tparams).items()},
                     {k: np.asarray(v) for k, v in _flat(jparams).items()})
    tcvt.save_npz(str(tmp_path / "port.npz"), tparams)
    back = jcvt.to_jax(jcvt.load_npz(str(tmp_path / "port.npz"), jparams))
    assert_identical(jax.tree_util.tree_map(np.asarray, back),
                     jax.tree_util.tree_map(np.asarray, jparams))
    with pytest.raises(ValueError, match="shape"):
        tcvt.load_npz(str(tmp_path / "jax.npz"), unified.init_params(
            dataclasses.replace(tcfg, decoder_name="tiny-expert"),
            torch.Generator(), device="meta"))


def test_npz_bf16_round_trip(tmp_path):
    """bf16 leaves are written as JAX writes them (``|V2``) and read back as
    bf16 where the model's leaf is bf16; the JAX package's own bf16 archive
    loads into the port too, which JAX itself cannot do."""
    from uniaudio2_tpu.config import UnifiedModelConfig as JCfg

    tcfg = tconfig.UnifiedModelConfig.tiny()
    params = unified.init_params(tcfg, torch.Generator().manual_seed(1),
                                 dtype=torch.bfloat16, device="cpu")
    tcvt.save_npz(str(tmp_path / "bf16.npz"), params)
    with np.load(str(tmp_path / "bf16.npz")) as data:
        assert data["backbone/layers/qkv_w"].dtype == np.dtype("V2")
    like = unified.init_params(tcfg, torch.Generator(), dtype=torch.bfloat16,
                               device="meta")
    back = _flat(tcvt.load_npz(str(tmp_path / "bf16.npz"), like))
    for path, t in _flat(params).items():
        assert back[path].dtype == torch.bfloat16
        assert torch.equal(back[path], t), path
    jparams = junified.init_params(jax.random.PRNGKey(0), JCfg.tiny(),
                                   dtype=jnp.bfloat16)
    jcvt.save_npz(str(tmp_path / "jax_bf16.npz"), jparams)
    got = _flat(tcvt.load_npz(str(tmp_path / "jax_bf16.npz"), like))
    ref = jax.tree_util.tree_map(np.asarray, jparams)
    for path, r in _flat(ref).items():
        t = got[path]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      r.view(np.int16), err_msg=path)
    with pytest.raises(ValueError, match="V2"):
        tcvt.load_npz(str(tmp_path / "bf16.npz"), unified.init_params(
            tcfg, torch.Generator(), device="meta"))


def test_merge_safetensors_raises_naming_its_item():
    for call in (lambda: merge_safetensors.merge_safetensors("."),
                 lambda: merge_safetensors.main([])):
        with pytest.raises(NotImplementedError, match="queue 1 item 18"):
            call()
