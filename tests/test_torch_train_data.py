"""The port's training pieces around the model against the JAX package, on
the CPU: masks, schedules, the chunked CE and its gradients, the losses,
the data pipeline (same batches from the same seed), the train entry point
with checkpoint save / resume, and the entry points' default device.

Tolerances: masks and batches identical; schedules 1e-6 relative (float32
powers and cosines may differ in the last bit); chunked CE sums and
accuracy, and dh / dW against `jax.grad`, within 1e-5 x max; losses and
their metrics within 1e-5 relative.
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.data import batching as jbatching
from uniaudio2_tpu.data import loading as jloading
from uniaudio2_tpu.train import chunked_ce as jce
from uniaudio2_tpu.train import losses as jlosses
from uniaudio2_tpu.train import masks as jmasks
from uniaudio2_tpu.train import schedule as jsched

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.data import batching, loading
from uniaudio2_tpu_torch.train import chunked_ce, lean_opt, losses, masks
from uniaudio2_tpu_torch.train import schedule, trainer
from uniaudio2_tpu_torch.train import train as train_cli

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("prefix_lm", [True, False])
def test_prefix_lm_mask(prefix_lm):
    loss = np.zeros((3, 10), bool)
    loss[0, 4:8] = True
    loss[1, 1:10] = True
    loss[2, 6:7] = True
    np.testing.assert_array_equal(
        _np(masks.prefix_lm_mask(torch.from_numpy(loss), prefix_lm)),
        _np(jmasks.prefix_lm_mask(jnp.asarray(loss), prefix_lm)))
    masks.validate_loss_mask(loss)
    for bad in ([[False, False]], [[True, False, True]]):
        with pytest.raises(ValueError):
            masks.validate_loss_mask(np.array(bad))


def test_schedules():
    pairs = [(schedule.warmup_lr(3e-4, 100), jsched.warmup_lr(3e-4, 100)),
             (schedule.noam_lr(1.0, 3072, 50), jsched.noam_lr(1.0, 3072, 50)),
             (schedule.get_schedule("cosine", base_lr=1e-3, warmup_steps=10,
                                    total_steps=60),
              jsched.get_schedule("cosine", base_lr=1e-3, warmup_steps=10,
                                  total_steps=60))]
    for tfn, jfn in pairs:
        for step in (0, 1, 5, 9, 10, 11, 37, 59, 60, 99, 100, 1000):
            np.testing.assert_allclose(tfn(step), float(jfn(jnp.int32(step))),
                                       rtol=1e-6, err_msg=str(step))
    with pytest.raises(ValueError):
        schedule.get_schedule("linear")


@pytest.mark.parametrize("all_masked", [False, True])
def test_chunked_ce_sums_and_gradients(all_masked):
    """V = 1000 with chunks of 256 (a ragged last chunk)."""
    n, d, v, chunk = 24, 16, 1000, 256
    rng = np.random.default_rng(0)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    y[:3] = np.argmax(h[:3] @ w, axis=-1)          # some hits for accuracy
    mask = np.zeros(n, bool) if all_masked else np.arange(n) % 3 != 0
    cot = 0.7

    def jfn(h_, w_):
        nll, acc = jce.masked_ce_sums(h_, w_, jnp.asarray(y), jnp.asarray(mask),
                                      chunk)
        return cot * nll, acc

    (jl, jacc), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    nll, acc = chunked_ce.masked_ce_sums(th, tw, torch.from_numpy(y),
                                         torch.from_numpy(mask), chunk)
    (cot * nll).backward()
    for t, j in ((cot * nll, jl), (acc, jacc), (th.grad, jg[0]), (tw.grad, jg[1])):
        j = np.asarray(j)
        np.testing.assert_allclose(_np(t), j, rtol=0,
                                   atol=RTOL * max(np.abs(j).max(), 1e-30))
    if all_masked:
        assert float(nll) == 0.0 and float(acc) == 0.0
        assert not th.grad.any() and not tw.grad.any()
    else:
        assert float(acc) >= 1.0


def test_unified_losses():
    b, s, d, dd, vt, va, ncb = 2, 6, 16, 12, 140, 90, 8
    rng = np.random.default_rng(1)
    f = lambda *shape, sc=1.0: (rng.standard_normal(shape) * sc).astype(np.float32)
    text_logits, audio_logits = f(b, s, vt), f(b, s, ncb, va)
    h_final, lm_w, dec_h, heads = f(b, s, d), f(d, vt, sc=0.2), f(b * s, ncb, dd), \
        f(ncb, dd, va, sc=0.2)
    tl = rng.integers(0, vt, (b, s)).astype(np.int32)
    al = rng.integers(0, va, (b, s, ncb)).astype(np.int32)
    tmask, amask = rng.random((b, s)) > 0.4, rng.random((b, s)) > 0.4
    weights = tuple(float(x) for x in np.linspace(0.5, 1.5, ncb - 1))
    tt = lambda *xs: [torch.from_numpy(x) for x in xs]
    jj = lambda *xs: [jnp.asarray(x) for x in xs]
    dense = (text_logits, audio_logits, tl, al, tmask, amask)
    fused = (h_final, lm_w, dec_h, heads, tl, al, tmask, amask)
    for tfn, jfn, args in ((losses.unified_loss, jlosses.unified_loss, dense),
                           (losses.unified_loss_fused, jlosses.unified_loss_fused,
                            fused)):
        tloss, tm = tfn(*tt(*args), weights)
        jloss, jm = jfn(*jj(*args), weights)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                       atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """The synthetic ASR dataset of tests/test_training.py plus TTS
    examples, in the reference's task-json schema."""
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    reason = {f"utt{i}": torch.from_numpy(rng.integers(0, 30, (8, 3 + i % 3)))
              for i in range(6)}
    semantic = {f"utt{i}": torch.from_numpy(rng.integers(0, 60, (8, 5 + i % 4)))
                for i in range(6)}
    torch.save(reason, str(d / "reason.pt"))
    torch.save(semantic, str(d / "semantic.pt"))
    with open(d / "trans.txt", "w") as f:
        for i in range(6):
            f.write(f"utt{i} 7 8 {9 + i}\n")
    keys = {"reason_seq": str(d / "reason.pt"),
            "semantic_seq": str(d / "semantic.pt"),
            "transcription_seq": str(d / "trans.txt")}
    for task in ("ASR", "TTS"):
        (d / f"{task.lower()}_task.json").write_text(
            json.dumps({"task": task, "keys": keys, "repeat_num": 2}))
    return d


class SplitTok:
    def tokenize(self, text):
        return [int(t) for t in text.split()]


def test_batches_identical_to_jax(tiny_dataset):
    d = tiny_dataset
    files = loading.find_data_jsons([str(d / "*_task.json")], rank=0, world_size=1)
    assert files == jloading.find_data_jsons([str(d / "*_task.json")], rank=0,
                                             world_size=1)
    tdata, _, _ = loading.load_all_tasks(files)
    jdata, _, _ = jloading.load_all_tasks(files)
    assert sorted(tdata) == sorted(jdata) and len(tdata) == 24
    kw = dict(batch_scale=64, text_tokenizer=SplitTok(), max_length=128,
              pad_multiple=16, seed=5)
    tb = batching.LengthBatcher(tdata, UnifiedModelConfig.tiny().tokens, **kw)
    jb = jbatching.LengthBatcher(jdata, JaxConfig.tiny().tokens, **kw)
    for epoch in (0, 1):
        tlist, jlist = list(tb.batches(epoch)), list(jb.batches(epoch))
        assert len(tlist) == len(jlist) > 1
        for t, j in zip(tlist, jlist):
            assert t["ids"] == j["ids"]
            for k in ("grid", "grid_mask", "text_loss_mask", "audio_loss_mask"):
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError):
        loading.find_data_jsons([str(d / "*_task.json")], rank=0, world_size=3)


def test_train_cli_writes_and_resumes(tmp_path, tiny_dataset, monkeypatch):
    """The tiny yaml of tests/test_training.py names tiny models but leaves
    the special text tokens at the full vocabulary's ids (128011, ...),
    past the tiny 1024-row embedding: JAX's `jnp.take` fills those rows
    with NaN and its run trains on a NaN loss, where the port's lookup
    raises. So the port's run reads the yaml and then takes `tiny()`,
    whose special tokens lie inside its vocabulary."""
    d = tiny_dataset
    monkeypatch.setattr(UnifiedModelConfig, "from_train_yaml",
                        classmethod(lambda cls, raw: cls.tiny()))
    yaml_path = tmp_path / "train.yaml"
    yaml_path.write_text(
        "llm_name: tiny-backbone\nlocal_model: tiny-decoder\n"
        "understanding_expert: tiny-expert\ngeneration_expert: tiny-expert\n"
        "max_seq_len: 128\n"
        "audio_reason_card: 40\naudio_semantic_card: 70\n"
        "reason_bos: 32\nreason_eos: 33\nreason_pad_token: 34\n"
        "semantic_bos: 64\nsemantic_eos: 65\nsemantic_pad_token: 66\n"
        "text_pad_token: 900\n")
    exp = str(tmp_path / "exp")
    argv = ["--train_data_jsons", str(d / "asr_task.json"), "--exp_dir", exp,
            "--llm_train_config", str(yaml_path), "--batch_scale", "64",
            "--debug_steps", "2", "--learning_rate", "1e-3",
            "--warmup_steps", "10", "--mixed-precision", "fp32",
            "--print_freq", "1", "--optimizer", "adamw_lean",
            "--device", "cpu"]
    state = train_cli.main(argv + ["--n_epoch", "1"])
    assert state.step == 2
    from uniaudio2_tpu_torch.train import optim
    assert all(bool(torch.isfinite(p).all())
               for p in optim.tree_leaves(state.params))
    assert os.path.isfile(os.path.join(exp, "ep0.checkpoint", "meta.json"))
    # a second call resumes from ep0 and trains epoch 1 only
    state2 = train_cli.main(argv + ["--n_epoch", "2"])
    assert state2.step == 4
    assert state2.opt_state[1].count == 4
    assert os.path.isdir(os.path.join(exp, "ep1.checkpoint"))
    # inference restore: the newest checkpoint's params
    from uniaudio2_tpu_torch.train import checkpoint as ckpt
    like = {k: torch.zeros_like(v) for k, v in state2.params.items()
            if isinstance(v, torch.Tensor)}
    got = ckpt.load_params_for_inference(exp, like)
    assert torch.equal(got["projection_w"], state2.params["projection_w"])
    # once refused here: --distributed in a process group of one rank (the
    # mesh path) trains the first run's parameters bit for bit; and
    # --tensor-parallel 2 on two ranks trains them to summation order (the
    # lean optimizer's int8 moment may round an element to the other
    # neighbour: tests/test_torch_train.py's rule, within 1e-3 x max|p|,
    # at most 0.1 % of the elements beyond 1e-5 x max|p|)
    import datetime

    import torch.distributed as dist
    from uniaudio2_tpu_torch.parallel import dryrun

    first = argv[:argv.index("--exp_dir") + 1] + [str(tmp_path / "one")] \
        + argv[argv.index("--exp_dir") + 2:] + ["--n_epoch", "1"]
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh_state = train_cli.main(first + ["--distributed"])
    finally:
        dist.destroy_process_group()
    for a, b in zip(optim.tree_leaves(mesh_state.params),
                    optim.tree_leaves(state.params)):
        assert torch.equal(a.to_local(), b)
    out = str(tmp_path / "tp.pt")
    tp_argv = first[:first.index("--exp_dir") + 1] + [str(tmp_path / "tp")] \
        + first[first.index("--exp_dir") + 2:]
    dryrun.spawn(dryrun.cli_main, 2, tp_argv + ["--tensor-parallel", "2"],
                 None, out, True, timeout_s=240)
    got = torch.load(out, weights_only=False)
    assert got["step"] == 2
    flips, total = 0, 0
    for (k, a), b in zip(sorted(_flat(got["params"]).items()),
                         optim.tree_leaves(state.params)):
        scale = float(b.abs().max())
        err = (a - b).abs()
        assert float(err.max()) <= 1e-3 * scale, k
        flips += int((err > 1e-5 * scale).sum())
        total += b.numel()
    assert flips <= 1e-3 * total, (flips, total)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_checkpoint_restores_into_a_fresh_state(tmp_path):
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.train import checkpoint as ckpt

    cfg = UnifiedModelConfig.tiny()
    tx = trainer.make_optimizer(schedule.warmup_lr(1e-3, 10),
                                optimizer="adamw_lean", accum_steps=2)
    params = unified.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    state = trainer.init_train_state(params, tx, device="cpu")
    state.opt_state.inner_opt_state[1].leaves["audio_head"].m_q.fill_(3)
    state = state._replace(step=7)
    ckpt.save_checkpoint(str(tmp_path), 3, state, {"epochs": {}, "epoch": 3})
    fresh = trainer.init_train_state(
        unified.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"),
        tx, device="cpu")
    got, epoch, rep = ckpt.maybe_resume(str(tmp_path), fresh)
    assert epoch == 4 and rep == {"epochs": {}, "epoch": 3} and got.step == 7
    assert torch.equal(got.params["backbone"]["wte"], params["backbone"]["wte"])
    assert int(got.opt_state.inner_opt_state[1].leaves["audio_head"].m_q[0, 0, 0]) == 3


def test_checkpoint_skips_unfinished_saves_and_refuses_casts(tmp_path):
    """A directory left by an interrupted save (no meta.json) is not
    resumed from, a save leaves no temporary behind, and a checkpoint
    tensor of another dtype than the state's is refused, not cast."""
    from uniaudio2_tpu_torch.train import checkpoint as ckpt

    tx = trainer.make_optimizer(1e-3, optimizer="adamw_lean")

    def state(dtype, value):
        return trainer.init_train_state(
            {"w": torch.full((4, 256), value, dtype=dtype)}, tx, device="cpu")

    ckpt.save_checkpoint(str(tmp_path), 0, state(torch.float32, 2.0))
    ckpt.save_checkpoint(str(tmp_path), 0, state(torch.float32, 3.0))
    (tmp_path / "ep5.checkpoint").mkdir()
    assert sorted(os.listdir(tmp_path)) == ["ep0.checkpoint", "ep5.checkpoint"]
    got, epoch, _ = ckpt.maybe_resume(str(tmp_path), state(torch.float32, 0.0))
    assert epoch == 1 and float(got.params["w"][0, 0]) == 3.0
    with pytest.raises(ValueError, match="dtype|bfloat16"):
        ckpt.maybe_resume(str(tmp_path), state(torch.bfloat16, 0.0))


@pytest.mark.parametrize("fn", [trainer.init_train_state,
                                lean_opt.adamw_lean(1e-3).init])
def test_new_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_train_entry_points_need_a_card_by_default():
    """Without a card the defaults raise (no quiet fall-back to the CPU);
    with one, they allocate there."""
    params = {"w": torch.zeros(4, 256)}
    tx = trainer.make_optimizer(1e-3, optimizer="adamw_lean")
    assert train_cli.get_parser().get_default("device") == "cuda"
    for call in (lambda: trainer.init_train_state(params, tx).params["w"],
                 lambda: tx.init(params)[1].leaves["w"].m_q):
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
