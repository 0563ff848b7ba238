"""The port's multi-task CLI (`uniaudio2_tpu_torch/cli.py`) against the JAX
package's `cli.main`, on the CPU, through the same argv.

Both read one float32 ``.npz`` written by the JAX package, a tiny WordLevel
``tokenizer.json`` and a tiny train yaml (`tests/test_cli.py`'s recipe).
The yaml's backbone, registered at run time in both packages, is
`tiny-backbone` with the full 128256-entry text vocabulary: the yaml's token
space keeps the full vocabulary's special text ids (``<transcription>`` is
128011), which JAX's lookup past a 1024-row table fills with NaN and the
port's refuses. Decoding is greedy (``--topk 1``; the two packages'
sampling streams cannot match), so every token file and results file must
be identical. Each case is one JAX run and one port run.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from uniaudio2_tpu import cli as jcli
from uniaudio2_tpu import config as jconfig

from uniaudio2_tpu_torch import cli as tcli
from uniaudio2_tpu_torch import config as tconfig
from uniaudio2_tpu_torch.engine import batch_eval, http_server

WORDS = ["hello", "world", "this", "is", "a", "test", "transcribe", "speak"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def write_tokenizer(d, size=0):
    """A WordLevel ``tokenizer.json`` (bos 1, eos 2) in ``d``: `WORDS`, then
    ``t{id}`` up to ``size`` entries, so that every id a model emits decodes
    to a word."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<bos>": 1, "<eos>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(WORDS)})
    vocab.update({f"t{i}": i for i in range(len(vocab), size)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        json.dumps({"bos_token": "<bos>", "eos_token": "<eos>"}))
    return str(d)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    for mod in (jconfig, tconfig):
        mod.register_config(
            "cli-backbone", block_size=512, vocab_size=128256,
            padded_vocab_size=128256, n_layer=2, n_embd=64, n_head=4,
            n_query_groups=2, intermediate_size=128, rope_base=10000.0,
            rope_adjustments=None)
    raw = ("llm_name: cli-backbone\nlocal_model: tiny-decoder\n"
           "understanding_expert: tiny-expert\ngeneration_expert: tiny-expert\n"
           "max_seq_len: 512\n"
           "audio_reason_card: 40\naudio_semantic_card: 70\n"
           "reason_bos: 32\nreason_eos: 33\nreason_pad_token: 34\n"
           "semantic_bos: 64\nsemantic_eos: 65\nsemantic_pad_token: 66\n"
           "audio_prompt_bos: 67\naudio_prompt_eos: 68\ntext_pad_token: 900\n")
    (d / "train.yaml").write_text(raw)
    import yaml
    from uniaudio2_tpu.convert.torch_to_jax import save_npz
    from uniaudio2_tpu.models import unified as junified

    cfg = jconfig.UnifiedModelConfig.from_train_yaml(yaml.safe_load(raw))
    save_npz(str(d / "model.npz"), junified.init_params(jax.random.PRNGKey(0), cfg))
    tokens = d / "tokens"
    tokens.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        torch.save(torch.from_numpy(rng.integers(0, 30, (8, 4 + i))),
                   str(tokens / f"x{i}_reason.pt"))
        torch.save(torch.from_numpy(rng.integers(0, 60, (8, 7 + 2 * i))),
                   str(tokens / f"x{i}_semantic.pt"))
    return {"dir": d, "tok": write_tokenizer(d / "tok", 128256), "tokens": str(tokens),
            "common": ["--llm_train_config", str(d / "train.yaml"),
                       "--text_tokenizer_path", str(d / "tok"),
                       "--resume", str(d / "model.npz"),
                       "--model_dtype", "float32", "--max_frames", "6",
                       "--topk", "1"]}


def run_both(env, name, argv):
    """The same argv through JAX's `cli.main` and the port's (``--device
    cpu``), each into its own output dir."""
    out = {}
    for pkg, mod, extra in (("jax", jcli, []),
                            ("port", tcli, ["--device", "cpu"])):
        out[pkg] = str(env["dir"] / f"{name}_{pkg}")
        mod.main(argv + env["common"] + ["--output_dir", out[pkg]] + extra)
    return out["jax"], out["port"]


def assert_same_tokens(jdir, tdir, names):
    for name in names:
        for kind in ("reason", "semantic"):
            a = torch.load(os.path.join(jdir, f"{name}_{kind}.pt"))
            b = torch.load(os.path.join(tdir, f"{name}_{kind}.pt"))
            assert a.dtype == b.dtype == torch.int64
            assert a.shape[0] == 8 and torch.equal(a, b), (name, kind)


def results(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("quantize", ["none", "int4all"])
def test_tts_stage1_token_files_identical(env, quantize):
    jdir, tdir = run_both(env, f"tts_{quantize}", [
        "--task", "TTS", "--stage", "1", "--text", "hello world",
        "--prompt_text", "speak this", "--quantize", quantize])
    assert_same_tokens(jdir, tdir, ["utt_0"])


def test_asr_batchable_token_dir_identical(env):
    """Three utterances from ``--token_dir``: the batched greedy path."""
    jdir, tdir = run_both(env, "asr_batch", [
        "--task", "ASR", "--token_dir", env["tokens"],
        "--prompt_text", "transcribe this"])
    got = results(os.path.join(tdir, "asr_results.txt"))
    assert got == results(os.path.join(jdir, "asr_results.txt"))
    lines = [line.split("\t") for line in got.splitlines()]
    assert [name for name, _ in lines] == ["x0", "x1", "x2"]
    assert all(len(text.split()) == 6 for _, text in lines)   # 6 frames


@pytest.mark.parametrize("decode_type", ["greedy", "beamsearch", "ngram"])
def test_asr_from_token_files_identical(env, decode_type):
    """One utterance from ``--reason_pt`` / ``--semantic_pt``: greedy, beam
    search and n-gram blocking (the host-driven paths)."""
    base = os.path.join(env["tokens"], "x1")
    jdir, tdir = run_both(env, f"asr_{decode_type}", [
        "--task", "ASR", "--reason_pt", base + "_reason.pt",
        "--semantic_pt", base + "_semantic.pt", "--prompt_text", "transcribe",
        "--decode_type", decode_type, "--beam_size", "2"])
    got = results(os.path.join(tdir, "asr_results.txt"))
    assert got == results(os.path.join(jdir, "asr_results.txt"))
    assert got.startswith("x1\t") and len(got.split()) > 2


class ModCodec:
    """Folds the LM's ids into the tiny codec's codebook and pads an empty
    semantic stream (an untrained model emits no semantic frames; the
    wiring is under test, `tests/test_cli.py`'s stand-in)."""

    def __init__(self, tok):
        self.tok, self.cfg = tok, tok.cfg

    def detokenize_no_reason(self, semantic, **kw):
        sem = np.asarray(semantic)
        if sem.shape[-1] == 0:
            sem = np.zeros((8, 4), np.int64)
        return self.tok.detokenize_no_reason(sem % self.cfg.rec_codebook_size, **kw)


def test_tts_stage_all_writes_the_wav(env, monkeypatch):
    """text -> tokens -> wav with a tiny injected codec on each side (the
    same weights; the solver noise differs, so only the length and
    finiteness are compared)."""
    from uniaudio2_tpu.codec import tokenizer as jtok
    from uniaudio2_tpu.codec.decoder import CodecConfig as JCodec
    from uniaudio2_tpu.codec.decoder import init_decode_params as jinit
    from uniaudio2_tpu.codec.encoder import EncoderConfig as JEnc

    from uniaudio2_tpu_torch.codec import tokenizer as ttok
    from uniaudio2_tpu_torch.codec.decoder import CodecConfig
    from uniaudio2_tpu_torch.codec.encoder import EncoderConfig
    from uniaudio2_tpu_torch.convert.from_jax import convert_params

    jparams = jinit(jax.random.PRNGKey(0), JCodec.tiny())
    jcodec = jtok.ReasoningCodecTokenizer(None, jparams, JEnc.tiny_test(),
                                          JCodec.tiny())
    tcodec = ttok.ReasoningCodecTokenizer(
        None, convert_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        EncoderConfig.tiny_test(), CodecConfig.tiny())
    monkeypatch.setattr(jcli, "load_codec_tokenizer",
                        lambda args, need_decode: ModCodec(jcodec))
    monkeypatch.setattr(tcli, "load_codec_tokenizer",
                        lambda args, need_decode: ModCodec(tcodec))
    jdir, tdir = run_both(env, "tts_all", [
        "--task", "TTS", "--stage", "all", "--text", "hello world",
        "--prompt_text", "speak this", "--codec_steps", "2"])
    assert_same_tokens(jdir, tdir, ["utt_0"])
    sr = CodecConfig.tiny().sample_rate
    jwav = jtok.load_wav(os.path.join(jdir, "wavs", "utt_0.wav"), sr)
    twav = ttok.load_wav(os.path.join(tdir, "wavs", "utt_0.wav"), sr)
    assert twav.size == jwav.size > 0 and np.isfinite(twav).all()


def test_unported_paths_raise_naming_their_item(env, tmp_path):
    argv = ["--task", "ASR", "--test_data_json", str(tmp_path / "none.json"),
            "--results", str(tmp_path / "r.tsv"), "--text_tokenizer_path",
            env["tok"], "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="queue 1 item 20"):
        batch_eval.main(argv + ["--score"])
    with pytest.raises(NotImplementedError, match="queue 1 item 20"):
        batch_eval.main(argv + ["--score", "--decode_type", "continuous"])


def test_stream_tts_cli_matches_jax(env, monkeypatch):
    """``--stream true --topk 1``: the frames each CLI's single-row engine
    streams are identical, and so is the waveform each writes (an untrained
    model never reaches the semantic phase, so both hold no sample);
    ``--use_cfg`` is refused as JAX refuses it."""
    import types

    from scipy.io import wavfile

    from uniaudio2_tpu.codec import decoder as jdec
    from uniaudio2_tpu.engine import continuous as jcont

    from uniaudio2_tpu_torch.codec.decoder import CodecConfig
    from uniaudio2_tpu_torch.convert.from_jax import convert_params
    from uniaudio2_tpu_torch.engine import continuous as tcont

    shapes = jax.eval_shape(lambda k: jdec.init_decode_params(
        k, jdec.CodecConfig.tiny()), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.standard_normal(x.shape) * 0.05, x.dtype),
        shapes)
    codecs = {
        "jax": types.SimpleNamespace(cfg=jdec.CodecConfig.tiny(),
                                     decoder=types.SimpleNamespace(params=jparams)),
        "port": types.SimpleNamespace(cfg=CodecConfig.tiny(),
                                      decoder=types.SimpleNamespace(
                                          params=convert_params(jparams, "cpu")))}
    frames = {"jax": [], "port": []}
    for name, cli, cont in (("jax", jcli, jcont), ("port", tcli, tcont)):
        monkeypatch.setattr(cli, "load_codec_tokenizer",
                            lambda args, need_decode, c=codecs[name]: c)
        orig = cont.ContinuousEngine.stream

        def recorded(self, *a, _orig=orig, _log=frames[name], **kw):
            for phase, frame in _orig(self, *a, **kw):
                _log.append((int(phase), np.asarray(frame).tolist()))
                yield phase, frame
        monkeypatch.setattr(cont.ContinuousEngine, "stream", recorded)
    argv = ["--task", "TTS", "--stream", "true", "--text", "hello world",
            "--prompt_text", "speak this", "--codec_steps", "2"]
    jdir, tdir = run_both(env, "tts_stream", argv)
    assert len(frames["port"]) == 6 and frames["port"] == frames["jax"]
    _, jwav = wavfile.read(os.path.join(jdir, "wavs", "utt_0.wav"))
    _, twav = wavfile.read(os.path.join(tdir, "wavs", "utt_0.wav"))
    assert twav.shape == jwav.shape
    with pytest.raises(ValueError, match="does not support CFG"):
        tcli.main(argv + env["common"] + ["--use_cfg", "true", "--device",
                                          "cpu"])


def test_batch_eval_continuous_tsv_identical_to_jax(env, tmp_path):
    """``--decode_type continuous``: offline continuous batching over five
    utterances through two rows, the TSV line for line JAX's."""
    from uniaudio2_tpu.engine import batch_eval as jbatch

    rng = np.random.default_rng(1)
    torch.save({f"u{i}": torch.from_numpy(rng.integers(0, 30, (8, 3 + i)))
                for i in range(5)}, str(tmp_path / "reason.pt"))
    torch.save({f"u{i}": torch.from_numpy(rng.integers(0, 60, (8, 6 + i)))
                for i in range(5)}, str(tmp_path / "semantic.pt"))
    (tmp_path / "refs.scp").write_text(
        "u0 hello world\nu1 a test\nu2 hello\nu3\nu4 this is\n")
    (tmp_path / "test.json").write_text(json.dumps({"task": "ASR", "keys": {
        "reason_seq": str(tmp_path / "reason.pt"),
        "semantic_seq": str(tmp_path / "semantic.pt"),
        "transcription_seq": str(tmp_path / "refs.scp")}}))
    out = {}
    for name, mod, extra in (("jax", jbatch, []),
                             ("port", batch_eval, ["--device", "cpu"])):
        out[name] = str(tmp_path / f"{name}.tsv")
        mod.main(["--task", "ASR", "--test_data_json",
                  str(tmp_path / "test.json"), "--results", out[name],
                  "--llm_train_config", str(env["dir"] / "train.yaml"),
                  "--resume", str(env["dir"] / "model.npz"),
                  "--text_tokenizer_path", env["tok"],
                  "--prompt_text", "transcribe this", "--model_dtype",
                  "float32", "--max_frames", "6", "--batch_size", "2",
                  "--decode_type", "continuous"] + extra)
    got, ref = results(out["port"]), results(out["jax"])
    assert got == ref
    rows = [line.split("\t") for line in got.splitlines()]
    assert [r[0] for r in rows] == ["u0", "u1", "u2", "u3", "u4"]
    assert all(len(r[1].split()) > 0 for r in rows) and rows[0][2] == "hello world"


def test_entry_points_need_a_card_unless_told_cpu(env, monkeypatch, tmp_path):
    """Without a card the CLI, the HTTP server and batch eval raise at once;
    none carries on on the CPU unless ``--device cpu`` asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.get_parser().get_default("device") == "cuda"
    calls = (
        lambda: tcli.main(["--task", "TTS", "--stage", "1", "--text", "hello",
                           "--output_dir", str(tmp_path / "o")] + env["common"]),
        lambda: http_server.main(["--npz", str(env["dir"] / "model.npz"),
                                  "--train_config", str(env["dir"] / "train.yaml")]),
        lambda: batch_eval.main(["--task", "ASR", "--test_data_json", "t.json",
                                 "--results", str(tmp_path / "r.tsv"),
                                 "--text_tokenizer_path", env["tok"]]),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
    assert not (tmp_path / "o").exists()
