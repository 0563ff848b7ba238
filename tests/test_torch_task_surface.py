"""The port's task surface against the JAX package's, on the CPU: the text
tokenizer, the ASR post-processing, the task runner's grids for every task,
text eval, batch eval and the training CLI's ``--text_tokenizer_path``.

`TextTokenizer` is held to JAX's on its HF ``tokenizer.json`` branch; its
sentencepiece branch cannot run here (this machine has no
``sentencepiece``), so only its import is exercised. The task runners of
both packages drive a recording engine, so the grids, masks and CFG
negatives each task hands the engine are compared without decoding.
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JCfg
from uniaudio2_tpu.engine import generators as jgen
from uniaudio2_tpu.engine import postprocess as jpost
from uniaudio2_tpu.engine import text_eval as jtext_eval
from uniaudio2_tpu.engine import tasks as jtasks
from uniaudio2_tpu.engine.decode import DecodeEngine as JEngine
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.text import tokenizer as jtok

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.engine import generators as tgen
from uniaudio2_tpu_torch.engine import postprocess as tpost
from uniaudio2_tpu_torch.engine import text_eval as ttext_eval
from uniaudio2_tpu_torch.engine.decode import DecodeEngine
from uniaudio2_tpu_torch.text import tokenizer as ttok

from tests.test_torch_cli import write_tokenizer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    plain = write_tokenizer(d / "plain", 1024)
    # no tokenizer_config.json: BOS / EOS from a malformed
    # generation_config.json (trailing commas, an EOS list)
    gen = d / "gen"
    write_tokenizer(gen, 64)
    os.remove(gen / "tokenizer_config.json")
    (gen / "generation_config.json").write_text(
        '{"bos_token_id": 1, "eos_token_id": [2, 9],}')
    (d / "sp").mkdir()
    (d / "sp" / "tokenizer.model").write_bytes(b"")
    (d / "empty").mkdir()
    return {"plain": plain, "gen": str(gen), "sp": str(d / "sp"),
            "empty": str(d / "empty")}


TEXTS = ["hello world", "this is a test", "transcribe speak t40 t41 t999",
         "unknown words here", ""]


@pytest.mark.parametrize("which,max_length", [("plain", -1), ("plain", 3),
                                              ("gen", -1)])
def test_text_tokenizer_identical_to_jax(tok_dirs, which, max_length):
    t = ttok.TextTokenizer(tok_dirs[which], max_length=max_length)
    j = jtok.TextTokenizer(tok_dirs[which], max_length=max_length)
    assert (t.bos_id, t.eos_id, t.pad_id, t.epad_id) == (
        j.bos_id, j.eos_id, j.pad_id, j.epad_id)
    assert (ttok.PAD_ID, ttok.EPAD_ID) == (jtok.PAD_ID, jtok.EPAD_ID)
    for text in TEXTS:
        ids = t.tokenize(text)
        assert ids == j.tokenize(text)
        assert t.decode(np.asarray(ids)) == j.decode(np.asarray(ids))
    assert t.token_to_id("world") == j.token_to_id("world")
    with pytest.raises(ValueError):
        t.token_to_id("nowhere")


def test_text_tokenizer_alignment_and_padding(tok_dirs):
    t = ttok.TextTokenizer(tok_dirs["plain"])
    j = jtok.TextTokenizer(tok_dirs["plain"])
    pieces = ["▁hel", "lo", "Ġwor", "ld", "▁a", "▁te", "s", "t"]
    ids = list(range(10, 18))
    assert t.word_alignment(pieces, ids) == j.word_alignment(pieces, ids)
    segments = [{"text": "hello world", "words": [
        {"word": "hello", "start": 0.0, "end": 0.4},
        {"word": "world", "start": 0.5, "end": 0.9}]},
        {"text": "a test", "words": [{"word": "a", "start": 1.2}]}]
    words = t.tokenize_segments(segments)
    assert words == j.tokenize_segments(segments)
    words += [{"word": "late", "start": 1.9, "tokens": [7, 8, 9]},
              {"word": "untimed", "tokens": [5]}]
    for duration, rate in ((2.0, 12.5), (2.0, 5.0)):
        np.testing.assert_array_equal(t.pad_tokens(words, duration, rate),
                                      j.pad_tokens(words, duration, rate))
    for mod in (t, j):          # a word that starts past the buffer
        with pytest.raises(IndexError):
            mod.pad_tokens(words, 0.9)


def test_text_tokenizer_other_branches(tok_dirs, tmp_path):
    """A directory without ``tokenizer.json`` takes the sentencepiece
    branch, which needs ``sentencepiece`` (absent here, as on the card's
    machine): both packages fail on its import. No tokenizer at all, or no
    directory, raises as in JAX."""
    for mod in (ttok, jtok):
        with pytest.raises(ImportError):
            mod.TextTokenizer(tok_dirs["sp"])
        with pytest.raises(FileNotFoundError):
            mod.TextTokenizer(tok_dirs["empty"])
        with pytest.raises(NotADirectoryError):
            mod.TextTokenizer(tmp_path / "missing")


POST_CASES = [
    "the quick fox runs runs runs runs runs",
    "hello ,   world .",
    "a perfectly normal sentence with no repeats",
    "word word word word word word",
    "all tokens here are unique ones",
    "go to the store go to the store go to the store",
    "你好世界好好好好好好",
    "你好 你好 你好 你好 你好",
    "", "one", "Yes. yes, YES! yes? no no no no",
]


@pytest.mark.parametrize("text", POST_CASES)
def test_postprocess_identical_to_jax(text):
    for name in ("post_process_text", "remove_tail_repetition",
                 "has_excessive_repetition", "cut_at_repeated_phrase",
                 "clean_text"):
        assert getattr(tpost, name)(text) == getattr(jpost, name)(text), name
    assert tpost.remove_tail_repetition(text, 2) == jpost.remove_tail_repetition(text, 2)


class CharTok:
    def tokenize(self, text):
        return [1 + ord(c) % 40 for c in text]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


class RecordingEngine:
    """Records what a runner hands the engine; answers with fixed tokens."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def generate_text(self, grid, mask, **kw):
        self.calls.append((grid, mask, kw))
        return np.array([5, 6, 7])

    def generate_audio(self, grid, mask, **kw):
        self.calls.append((grid, mask, kw))
        return np.zeros((8, 2), np.int64), np.ones((8, 3), np.int64)


def _task_data(fmt_key, rng):
    keys, types = jtasks.condition_prefix(fmt_key)
    return {k: (rng.integers(1, 30, rng.integers(2, 6)) if tp == "text"
                else rng.integers(0, 30, (int(rng.integers(3, 7)), 8)))
            for k, tp in zip(keys, types)}


def _same_calls(tcalls, jcalls):
    assert len(tcalls) == len(jcalls)
    for (tg, tm, tkw), (jg, jm, jkw) in zip(tcalls, jcalls):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tm, jm)
        assert tkw.keys() == jkw.keys()
        for k in tkw:
            if isinstance(jkw[k], np.ndarray):
                np.testing.assert_array_equal(tkw[k], jkw[k], err_msg=k)
            else:
                assert tkw[k] == jkw[k], k


def test_task_runner_grids_identical_for_every_task():
    """Every text-out and audio-out task (with and without CFG negatives)
    and every convenience method hands the engine the grid, mask and
    arguments JAX's runner hands it, and returns the same."""
    assert tgen.UNDERSTANDING_TASKS == jgen.UNDERSTANDING_TASKS
    assert tgen.GENERATION_TASKS == jgen.GENERATION_TASKS
    assert tgen._TEXT_OUT_TASKS == jgen._TEXT_OUT_TASKS
    assert tgen._AUDIO_OUT_TASKS == jgen._AUDIO_OUT_TASKS
    assert tgen.TASK_PROMPT_SUFFIX == jgen.TASK_PROMPT_SUFFIX
    teng, jeng = RecordingEngine(UnifiedModelConfig.tiny()), RecordingEngine(JCfg.tiny())
    trun, jrun = tgen.TaskRunner(teng, CharTok()), jgen.TaskRunner(jeng, CharTok())
    rng = np.random.default_rng(0)
    for task, key in tgen._TEXT_OUT_TASKS.items():
        d = _task_data(key, rng)
        for kw in ({}, {"decode_type": "ngram", "max_repeat_ngram": 3,
                        "topk": 5, "seed": 4}):
            assert trun.run_text_task(task, " prompt ", d, **kw) == \
                jrun.run_text_task(task, " prompt ", d, **kw)
    for task, key in tgen._AUDIO_OUT_TASKS.items():
        d = _task_data(key, rng)
        for kw in ({}, {"use_cfg": True, "cfg_scale": 1.5, "topk": 7}):
            for a, b in zip(trun.run_audio_task(task, "prompt", d, **kw),
                            jrun.run_audio_task(task, "prompt", d, **kw)):
                np.testing.assert_array_equal(a, b)
    codes = [rng.integers(0, 30, (n, 8)) for n in (4, 6, 3)]
    ids = [rng.integers(1, 30, n) for n in (3, 4)]
    for name, args in (
            ("asr", (codes[0], codes[1])), ("caption", (codes[0], codes[1])),
            ("audio_question", (ids[0], codes[0], codes[1])),
            ("speech_s2t", (codes[1], codes[2])), ("tts", (ids[0],)),
            ("tta", (ids[1],)), ("ttm", (ids[0],)), ("lts", (ids[1],)),
            ("instruct_tts", (ids[0], ids[1])),
            ("speech_s2s", (codes[2], codes[0])),
            ("speech_edit", (ids[1], codes[1], codes[2]))):
        tout = getattr(trun, name)("p", *args)
        jout = getattr(jrun, name)("p", *args)
        if isinstance(jout, str):
            assert tout == jout
    trun.caption("p", codes[0], codes[1], music=True)
    jrun.caption("p", codes[0], codes[1], music=True)
    _same_calls(teng.calls, jeng.calls)
    assert any("neg_grid" in kw and kw["neg_grid"] is not None
               for _, _, kw in teng.calls)


def test_prompt_selection_identical(tmp_path):
    p = tmp_path / "prompts.json"
    p.write_text(json.dumps({"ASR": ["transcribe this", "write it down", "asr"],
                             "Yue_TTS": ["sing"], "speech_s2t": ["answer"],
                             "TTS": ["speak this", "say it"]}))
    for task in ("asr", "ASR", "yue_tts", "InstructTTS", "speech_s2t", "TTS",
                 "tta", "music_caption", "nothing"):
        assert tgen.prompt_key_for_task(task) == jgen.prompt_key_for_task(task)
        assert tgen.select_prompt(task, prompt_json=str(p), rng=random.Random(3)) \
            == jgen.select_prompt(task, prompt_json=str(p), rng=random.Random(3))
    assert tgen.select_prompt("x", prompt_text=" inline ") == "inline"
    with pytest.raises(ValueError):
        tgen.select_prompt("asr")


@pytest.fixture(scope="module")
def tiny_models():
    jcfg = JCfg.tiny()
    jparams = junified.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, UnifiedModelConfig.tiny(), tparams


def test_text_eval_identical_to_jax(tiny_models):
    jcfg, jparams, tcfg, tparams = tiny_models
    seqs = [[1, 5, 9, 13, 2], [1, 7, 7, 2], [3], [1, 900, 4, 4, 4, 2, 2]]
    got = ttext_eval.text_perplexity(tparams, tcfg, seqs)
    ref = jtext_eval.text_perplexity(jparams, jcfg, seqs)
    assert got["tokens"] == ref["tokens"] == 4 + 3 + 6
    np.testing.assert_allclose(got["nll"], ref["nll"], rtol=1e-5)
    np.testing.assert_allclose(got["ppl"], ref["ppl"], rtol=1e-5)
    kw = dict(max_frames=6, buckets=(64,))
    teng = DecodeEngine(tparams, tcfg, cache_dtype=torch.float32, **kw)
    jeng = JEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    for prompt in ([1, 5, 9], [1, 2, 3, 4, 5, 6, 7]):
        np.testing.assert_array_equal(
            ttext_eval.generate_text_answer(teng, prompt, topk=1),
            np.asarray(jtext_eval.generate_text_answer(jeng, prompt, topk=1)))


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    """`tests/test_batch_eval.py`'s pre-tokenized ASR set, five utterances,
    with a vocabulary that decodes every id of the tiny model."""
    d = tmp_path_factory.mktemp("batch_eval")
    tok = write_tokenizer(d / "tok", 1024)
    (d / "train.yaml").write_text(
        "llm_name: tiny-backbone\nlocal_model: tiny-decoder\n"
        "understanding_expert: tiny-expert\ngeneration_expert: tiny-expert\n"
        "max_seq_len: 128\naudio_reason_card: 40\naudio_semantic_card: 70\n"
        "reason_bos: 32\nreason_eos: 33\nreason_pad_token: 34\n"
        "semantic_bos: 64\nsemantic_eos: 65\nsemantic_pad_token: 66\n"
        "text_pad_token: 900\n")
    from uniaudio2_tpu.convert.torch_to_jax import save_npz

    save_npz(str(d / "m.npz"), junified.init_params(jax.random.PRNGKey(0), JCfg.tiny()))
    rng = np.random.default_rng(0)
    torch.save({f"u{i}": torch.from_numpy(rng.integers(0, 30, (8, 3 + i)))
                for i in range(5)}, str(d / "reason.pt"))
    torch.save({f"u{i}": torch.from_numpy(rng.integers(0, 60, (8, 6 + i)))
                for i in range(5)}, str(d / "semantic.pt"))
    (d / "refs.scp").write_text("u0 hello world\nu1 go go\nu2 hello\nu3\nu4 a test\n")
    (d / "test.json").write_text(json.dumps({"task": "ASR", "keys": {
        "reason_seq": str(d / "reason.pt"), "semantic_seq": str(d / "semantic.pt"),
        "transcription_seq": str(d / "refs.scp")}}))
    return d, tok


@pytest.mark.parametrize("decode_type", ["greedy", "beamsearch"])
def test_batch_eval_tsv_identical_to_jax(eval_set, decode_type):
    from uniaudio2_tpu.engine import batch_eval as jbatch

    from uniaudio2_tpu_torch.engine import batch_eval as tbatch

    d, tok = eval_set
    out = {}
    for name, mod, extra in (("jax", jbatch, []), ("port", tbatch, ["--device", "cpu"])):
        out[name] = str(d / f"{decode_type}_{name}.tsv")
        mod.main(["--task", "ASR", "--test_data_json", str(d / "test.json"),
                  "--results", out[name], "--llm_train_config", str(d / "train.yaml"),
                  "--resume", str(d / "m.npz"), "--text_tokenizer_path", tok,
                  "--prompt_text", "hello world", "--model_dtype", "float32",
                  "--max_frames", "5", "--batch_size", "2",
                  "--decode_type", decode_type, "--beam_size", "2"] + extra)
    with open(out["port"]) as f, open(out["jax"]) as g:
        got, ref = f.read(), g.read()
    assert got == ref
    rows = [line.split("\t") for line in got.splitlines()]
    assert [r[0] for r in rows] == ["u0", "u1", "u2", "u3", "u4"]
    assert all(len(r[1].split()) > 0 for r in rows) and rows[0][2] == "hello world"


def test_train_cli_reads_text_through_the_tokenizer(tmp_path, monkeypatch, tok_dirs):
    """``--text_tokenizer_path``: the port's trainer tokenizes raw text with
    `TextTokenizer`, as the JAX trainer does: the batches equal JAX's
    `LengthBatcher` over JAX's tokenizer, and two steps train. (The tiny
    yaml leaves special text ids past the tiny vocabulary, so the run takes
    `tiny()`, as `tests/test_torch_train_data.py` does.)"""
    from uniaudio2_tpu.data import batching as jbatching
    from uniaudio2_tpu.data import loading as jloading

    from uniaudio2_tpu_torch.data import batching, loading
    from uniaudio2_tpu_torch.train import optim
    from uniaudio2_tpu_torch.train import train as train_cli

    (tmp_path / "text.txt").write_text(
        "".join(f"s{i} hello world this is a test {'speak ' * i}\n" for i in range(6)))
    (tmp_path / "text_task.json").write_text(json.dumps(
        {"task": "text_only", "keys": {"text_seq": str(tmp_path / "text.txt")}}))
    files = [str(tmp_path / "text_task.json")]
    _, tdata, _ = loading.load_all_tasks(files)
    _, jdata, _ = jloading.load_all_tasks(files)
    kw = dict(batch_scale=64, max_length=128, seed=5)
    tb = batching.LengthBatcher(tdata, UnifiedModelConfig.tiny().tokens,
                                text_tokenizer=ttok.TextTokenizer(tok_dirs["plain"]), **kw)
    jb = jbatching.LengthBatcher(jdata, JCfg.tiny().tokens,
                                 text_tokenizer=jtok.TextTokenizer(tok_dirs["plain"]), **kw)
    tlist, jlist = list(tb.batches(0)), list(jb.batches(0))
    assert len(tlist) == len(jlist) > 0
    for t, j in zip(tlist, jlist):
        for k in ("grid", "grid_mask", "text_loss_mask"):
            np.testing.assert_array_equal(t[k], j[k])

    monkeypatch.setattr(UnifiedModelConfig, "from_train_yaml",
                        classmethod(lambda cls, raw: cls.tiny()))
    (tmp_path / "train.yaml").write_text("llm_name: tiny-backbone\n")
    state = train_cli.main([
        "--train_data_jsons", files[0], "--exp_dir", str(tmp_path / "exp"),
        "--llm_train_config", str(tmp_path / "train.yaml"),
        "--text_tokenizer_path", tok_dirs["plain"], "--batch_scale", "16",
        "--debug_steps", "2", "--n_epoch", "1", "--mixed-precision", "fp32",
        "--optimizer", "adamw_lean", "--device", "cpu"])
    assert state.step == 2
    assert all(bool(torch.isfinite(p).all()) for p in optim.tree_leaves(state.params))
    assert os.path.isfile(tmp_path / "exp" / "ep0.checkpoint" / "meta.json")
