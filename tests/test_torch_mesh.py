"""The port's device mesh (`uniaudio2_tpu_torch/parallel/mesh.py`), its
sharded train step, its train CLI on a process group and its dry run,
against the JAX package's mesh (tests/conftest.py's 8 virtual CPU devices).

The ranks are CPU processes in a gloo group (`parallel.dryrun.spawn`, a
FileStore rendezvous under a temporary directory, joined under a deadline);
each file spawns its groups once, in a module fixture, and the tests read
what the ranks wrote.

Tolerances (`tests/test_torch_train.py`'s): loss and gradient norm within
LOSS_RTOL of JAX's 8-device step; parameters within TOL. The loss is held
to JAX's step on the same 2 x 2 x 2 mesh, the gradient norm and the
parameters to JAX's step on its (fsdp=4, tp=2) mesh: on the CPU's 8
virtual devices JAX's 2 x 2 x 2 step with tensor parallelism computes the
right loss but gradients up to 97 % off its own unsharded ones in some
leaves (the backbone's, audio_embeddings), where its (fsdp=4, tp=2),
(fsdp=8), (replica=8) and 2 x 2 x 2-without-tp steps all agree with the
unsharded one within 1e-6 (the (fsdp=4, tp=2) step is held to it here). The mesh step
against the port's own plain step on the same batch: loss and norm within
LOSS_RTOL, parameters within MESH_ATOL (the data-parallel and row-parallel
sums run in another order; the first AdamW step moves a parameter by about
the learning rate, 1e-6, and the two runs read 4e-9 apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from uniaudio2_tpu.config import GPTConfig as JGPTConfig
from uniaudio2_tpu.config import UnifiedModelConfig as JaxConfig
from uniaudio2_tpu.models import gpt as jgpt
from uniaudio2_tpu.models import unified as junified
from uniaudio2_tpu.parallel import mesh as jmesh
from uniaudio2_tpu.train import schedule as jsched
from uniaudio2_tpu.train import trainer as jtrainer

from uniaudio2_tpu_torch.config import GPTConfig, UnifiedModelConfig
from uniaudio2_tpu_torch.convert.from_jax import convert_params
from uniaudio2_tpu_torch.parallel import dryrun, mesh as meshlib
from uniaudio2_tpu_torch.train import optim
from uniaudio2_tpu_torch.train import schedule as tsched
from uniaudio2_tpu_torch.train import trainer

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
MESH_ATOL = 1e-7

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


def _norm(spec):
    """A JAX PartitionSpec as the port's tuple (trailing Nones dropped)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, path + (f,))
    else:
        yield path, tree


def _jax_get(tree, path):
    for p in path:
        tree = tree[int(p)] if isinstance(tree, list) else (
            getattr(tree, p) if hasattr(tree, "_fields") else tree[p])
    return tree


# ---------------------------------------------------------------------------
# The spec rules, entry for entry (no ranks needed)
# ---------------------------------------------------------------------------


def _moe_cfgs():
    kw = dict(name="tiny-moe", block_size=64, vocab_size=96,
              padding_multiple=8, n_layer=2, n_embd=32, n_head=4,
              n_query_groups=2, intermediate_size=64, rope_adjustments=None,
              n_expert=4, n_expert_per_token=2, moe_intermediate_size=64)
    return JGPTConfig(**kw), GPTConfig(**kw)


def _specs_cases():
    jcfg = JaxConfig.tiny()
    jp = junified.init_params(jax.random.PRNGKey(0), jcfg)
    yield "unified", jp, convert_params(jp, "cpu")
    jm, _ = _moe_cfgs()
    # MoE leaves big enough for the fsdp rule (>= 2^16 elements)
    big = jm.replace(n_embd=128, moe_intermediate_size=256, n_head=4,
                     intermediate_size=256)
    jg = jgpt.init_params(jax.random.PRNGKey(1), big)
    yield "moe", {"backbone": jg}, convert_params({"backbone": jg}, "cpu")


@pytest.mark.parametrize("use_tp", [False, True])
@pytest.mark.parametrize("case", ["unified", "moe"])
def test_param_specs_equal_jax(case, use_tp):
    """`unified_param_specs` gives JAX's spec for every leaf, and
    `fit_specs_to_mesh` JAX's fitted spec on the 2 x 2 x 2 and 8-way fsdp
    meshes."""
    _, jp, tp_ = next(c for c in _specs_cases() if c[0] == case)
    jspecs = jmesh.unified_param_specs(jp, use_tp=use_tp)
    tspecs = meshlib.unified_param_specs(tp_, use_tp=use_tp)
    n = 0
    for path, spec in _leaves_with_path(tspecs):
        assert spec == _norm(_jax_get(jspecs, path)), path
        n += 1
    assert n == len(jax.tree.leaves(jp))
    for shape in ({"replica": 2, "fsdp": 2, "tp": 2},
                  {"replica": 1, "fsdp": 8, "tp": 1}):
        jm = jmesh.build_mesh(**shape)
        jfit = jmesh.fit_specs_to_mesh(jspecs, jp, jm)
        tfit = meshlib.fit_specs_to_mesh(tspecs, tp_, shape)
        for path, spec in _leaves_with_path(tfit):
            assert spec == _norm(_jax_get(jfit, path)), (shape, path)


def test_placements_and_strategies():
    """A spec's placements per mesh dimension, and the strategy factoring."""
    from torch.distributed.tensor import Replicate, Shard

    assert meshlib.placements((None, "fsdp", "tp")) == [
        Replicate(), Shard(1), Shard(2)]
    assert meshlib.placements((("replica", "fsdp"),)) == [
        Shard(0), Shard(0), Replicate()]
    assert meshlib.placements(()) == [Replicate()] * 3
    assert meshlib._largest_divisor_leq(12, 3) == 3
    assert meshlib._largest_divisor_leq(7, 2) == 1
    assert dryrun.factor(8) == (2, 2, 2)
    assert dryrun.factor(2) == (1, 1, 2)
    assert dryrun.factor(6) == (1, 3, 2)
    with pytest.raises(ValueError):
        meshlib.build_mesh(fsdp=2)      # no process group: one device


# ---------------------------------------------------------------------------
# Adafactor against optax
# ---------------------------------------------------------------------------


def test_adafactor_matches_optax():
    """Three steps of `make_optimizer(optimizer="adafactor")` against JAX's
    (optax.adafactor with decay_rate=b2, weight_decay_rate, no block
    clipping) on factored (both dims >= 128, one 3-D) and unfactored
    leaves."""
    rng = np.random.default_rng(0)
    shapes = {"w": (256, 160), "stack": (2, 128, 192), "small": (64, 300),
              "b": (40,)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jtx = jtrainer.make_optimizer(jsched.warmup_lr(1e-2, 2), grad_clip=1.0,
                                  optimizer="adafactor")
    ttx = trainer.make_optimizer(tsched.warmup_lr(1e-2, 2), grad_clip=1.0,
                                 optimizer="adafactor")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp_ = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp_, device="cpu")
    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp_)
        optim.apply_updates(tp_, tu)
        for k in shapes:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    for k in shapes:
        np.testing.assert_allclose(tp_[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    inner, jinner = ts[1], js[1][0]
    assert inner.count == int(jinner.count) == 3
    for k in shapes:
        for name in ("v_row", "v_col", "v"):
            t, j = getattr(inner, name)[k], getattr(jinner, name)[k]
            assert tuple(t.shape) == j.shape, (k, name)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       err_msg=f"{k} {name}")
    assert tuple(inner.v["small"].shape) == (64, 300)   # unfactored
    assert tuple(inner.v_row["stack"].shape) == (2, 128)    # factored


# ---------------------------------------------------------------------------
# Ranks: the 2 x 2 x 2 train step and dry run, the CLI on two ranks
# ---------------------------------------------------------------------------


def _jax_mesh_step(jp, jcfg, replica, fsdp, tp):
    """JAX's `dryrun_multichip` train step on a mesh of its 8 devices."""
    m = jmesh.build_mesh(replica=replica, fsdp=fsdp, tp=tp)
    params = jmesh.shard_params(jp, m, use_tp=True)
    tx = jtrainer.make_optimizer(jsched.warmup_lr(1e-4, warmup_steps=100),
                                 grad_clip=2.0)
    state = jtrainer.init_train_state(params, tx)
    step = jax.jit(jtrainer.build_train_step(jcfg, tx, prefix_lm=True,
                                             remat=True))
    sharding = NamedSharding(m, P(("replica", "fsdp")))
    batch = jtrainer.Batch(*(jax.device_put(a, sharding)
                             for a in dryrun.dryrun_batch(8)))
    state, metrics = step(state, batch)
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            jax.tree.map(np.asarray, state.params))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    jcfg = JaxConfig.tiny()
    jp = junified.init_params(jax.random.PRNGKey(0), jcfg)
    params_path = str(d / "params.pt")
    torch.save(convert_params(jp, "cpu"), params_path)
    out = {}
    if len(jax.devices()) >= 8:
        out["jax"] = _jax_mesh_step(jp, jcfg, 2, 2, 2)
        out["jax_fsdp_tp"] = _jax_mesh_step(jp, jcfg, 1, 4, 2)
        tx = jtrainer.make_optimizer(jsched.warmup_lr(1e-4, warmup_steps=100),
                                     grad_clip=2.0)
        step = jax.jit(jtrainer.build_train_step(jcfg, tx, prefix_lm=True,
                                                 remat=True))
        _, jm = step(jtrainer.init_train_state(jp, tx), jtrainer.Batch(
            *(jnp.asarray(a) for a in dryrun.dryrun_batch(8))))
        out["jax_unsharded"] = float(jm["loss"]), float(jm["grad_norm"])
    dryrun.spawn(dryrun.rank_main, 8, "cpu", params_path, str(d / "dry.pt"),
                 timeout_s=240)
    out["dry"] = torch.load(d / "dry.pt", weights_only=False)
    out["params"] = convert_params(jp, "cpu")
    return out


@needs8
def test_mesh_train_step_matches_jax(ranks):
    """One (replica=2, fsdp=2, tp=2) step from JAX's params: the loss
    against JAX's step on the same mesh, the gradient norm and parameters
    against JAX's step on its (fsdp=4, tp=2) mesh (see the module's note)."""
    got = ranks["dry"]["train"]
    np.testing.assert_allclose(got["loss"], ranks["jax"][0], rtol=LOSS_RTOL)
    jloss, jnorm, jparams = ranks["jax_fsdp_tp"]
    np.testing.assert_allclose((jloss, jnorm), ranks["jax_unsharded"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], jnorm, rtol=LOSS_RTOL)
    for path, t in _leaves_with_path(got["params"]):
        np.testing.assert_allclose(t.numpy(), _jax_get(jparams, path),
                                   err_msg=str(path), **TOL)


def test_mesh_train_step_equals_the_plain_step(ranks):
    """The same step on one process without a mesh (the port's plain path):
    the data-parallel, FSDP and tensor-parallel sums only reorder it."""
    cfg = UnifiedModelConfig.tiny()
    plain = dryrun.train_step(cfg, ranks["params"], None, use_tp=False,
                              device="cpu", rows=8)
    got = ranks["dry"]["train"]
    np.testing.assert_allclose(got["loss"], plain["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], plain["grad_norm"],
                               rtol=LOSS_RTOL)
    moved = 0.0
    for (path, t), (_, p) in zip(_leaves_with_path(got["params"]),
                                 _leaves_with_path(plain["params"])):
        np.testing.assert_allclose(t.numpy(), p.numpy(), rtol=0,
                                   atol=MESH_ATOL, err_msg=str(path))
        moved = max(moved, float((p - _jax_get(ranks["params"], path))
                                 .abs().max()))
    assert moved > 10 * MESH_ATOL       # the step moved the parameters


def test_mesh_step_with_leaves_sharded_on_the_layer_axis(tmp_path,
                                                          monkeypatch):
    """With every leaf large enough for the fsdp rule (as the full-width
    model's stacked norms are), the rules shard a stacked (L, D) norm on
    its layer axis, which `gpt.forward` cannot split into layers before the
    gather: the step on a one-rank group gathers it whole and equals the
    plain step bit for bit."""
    import datetime

    import torch.distributed as dist

    monkeypatch.setattr(meshlib, "_FSDP_MIN_SIZE", 0)
    cfg = UnifiedModelConfig.tiny()
    params = ranks_free_params(cfg)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = meshlib.build_mesh(device_type="cpu")
        placed = meshlib.shard_params(params, mesh)
        norm = placed["backbone"]["layers"]["norm1_w"]
        assert meshlib.shards_dim(norm, 0) and norm.ndim == 2
        got = dryrun.train_step(cfg, params, mesh, use_tp=False,
                                device="cpu", rows=4)
        plain = dryrun.train_step(cfg, params, None, use_tp=False,
                                  device="cpu", rows=4)
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()
    assert got["loss"] == plain["loss"]
    assert got["grad_norm"] == plain["grad_norm"]
    for (path, t), (_, p) in zip(_leaves_with_path(got["params"]),
                                 _leaves_with_path(plain["params"])):
        assert torch.equal(t, p), path


def ranks_free_params(cfg):
    """The tiny model's parameters from seed 0, on the CPU."""
    from uniaudio2_tpu_torch.models import unified

    with torch.no_grad():
        return unified.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")


def test_batch_rows_replica_major(ranks):
    """Which rows of an 8-row batch each rank holds under `batch_spec`:
    replica major, fsdp minor, the tp ranks of a pair the same rows, by
    `local_rows` and by a DTensor placed with the spec alike."""
    for coord, rows, placed in ranks["dry"]["rows"]:
        r, f, _ = coord
        want = [4 * r + 2 * f, 4 * r + 2 * f + 1]
        assert rows == want and placed == want, coord


def test_dryrun_decode_identical(ranks):
    """The 8-rank dry run's engine on the mesh gives the plain engine's
    greedy text and audio (its ranks assert it; rank 0 kept both)."""
    dry = ranks["dry"]
    np.testing.assert_array_equal(dry["sharded"]["text"], dry["plain"]["text"])
    for a, b in zip(dry["sharded"]["audio"], dry["plain"]["audio"]):
        np.testing.assert_array_equal(a, b)
    assert len(dry["plain"]["text"]) > 0


@needs8
def test_dryrun_prints_jax_line(ranks, capfd, tmp_path):
    """`python -m uniaudio2_tpu_torch.parallel.dryrun` at 8 CPU ranks prints
    JAX's line, with a loss within LOSS_RTOL of JAX's `dryrun_multichip` on
    the same params."""
    import re

    path = str(tmp_path / "params.pt")
    torch.save(ranks["params"], path)
    dryrun.main(["--n", "8", "--device", "cpu", "--params", path])
    line = [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith("dryrun_multichip ok")]
    assert len(line) == 1, line
    m = re.fullmatch(r"dryrun_multichip ok: mesh=\(replica=2,fsdp=2,tp=2\) "
                     r"loss=([0-9.]+) decode_identical=true", line[0])
    assert m, line[0]
    np.testing.assert_allclose(float(m.group(1)), ranks["jax"][0],
                               rtol=LOSS_RTOL, atol=5e-5)   # 4 decimals


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train CLI on two gloo ranks: ``--data-parallel fsdp`` for one
    epoch, then resumed for a second; ``--tensor-parallel 2`` for one
    epoch; and the same first epoch in this process without a group."""
    import json

    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    reason = {f"utt{i}": torch.from_numpy(rng.integers(0, 30, (8, 3 + i % 3)))
              for i in range(6)}
    semantic = {f"utt{i}": torch.from_numpy(rng.integers(0, 60, (8, 5 + i % 4)))
                for i in range(6)}
    torch.save(reason, str(d / "reason.pt"))
    torch.save(semantic, str(d / "semantic.pt"))
    (d / "trans.txt").write_text(
        "".join(f"utt{i} 7 8 {9 + i}\n" for i in range(6)))
    keys = {"reason_seq": str(d / "reason.pt"),
            "semantic_seq": str(d / "semantic.pt"),
            "transcription_seq": str(d / "trans.txt")}
    for task in ("ASR", "TTS"):
        (d / f"{task.lower()}_task.json").write_text(
            json.dumps({"task": task, "keys": keys, "repeat_num": 2}))
    pattern = str(d / "*_task.json")

    def argv(exp, epochs, *extra):
        return ["--train_data_jsons", pattern, "--exp_dir", str(d / exp),
                "--batch_scale", "48", "--debug_steps", "2",
                "--learning_rate", "1e-3", "--warmup_steps", "10",
                "--mixed-precision", "fp32", "--optimizer", "adamw",
                "--print_freq", "0", "--device", "cpu",
                "--n_epoch", str(epochs), *extra]

    out = {}
    for name, args in (("fsdp1", argv("fsdp", 1, "--data-parallel", "fsdp")),
                       ("fsdp2", argv("fsdp", 2, "--data-parallel", "fsdp")),
                       ("tp", argv("tp", 1, "--tensor-parallel", "2"))):
        path = str(d / f"{name}.pt")
        dryrun.spawn(dryrun.cli_main, 2, args, [pattern], path, True,
                     timeout_s=240)
        out[name] = torch.load(path, weights_only=False)
    out["plain"] = _two_rank_reference(argv("plain", 1), pattern)
    out["exp"] = d
    return out


def _two_rank_reference(argv, pattern):
    """The one-process counterpart of the CLI's first epoch on two fsdp
    ranks: each rank's batches come from its half of the files, so each
    step's batch here is both ranks' batches padded to one length and
    stacked, over as many steps as the rank with fewer batches has."""
    import itertools

    from uniaudio2_tpu_torch.data import loading
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.train import train

    args = train.get_parser().parse_args(argv)
    cfg = UnifiedModelConfig.tiny()
    batchers = [train.make_batcher(
        args, cfg, loading.find_data_jsons([pattern], rank=r, world_size=2),
        train.IntTok()) for r in range(2)]
    steps = min(len(batchers[0]), len(batchers[1]), args.debug_steps)
    assert steps == 2
    with torch.no_grad():
        params = unified.init_params(
            cfg, torch.Generator().manual_seed(args.seed), device="cpu")
    tx = trainer.make_optimizer(
        tsched.warmup_lr(args.learning_rate, args.warmup_steps),
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        optimizer=args.optimizer)
    state = trainer.init_train_state(params, tx, device="cpu")
    step = trainer.build_train_step(cfg, tx, prefix_lm=args.prefix_lm,
                                    remat=args.remat,
                                    chunked_ce=args.chunked_ce)
    for raws in itertools.islice(zip(*(b.batches(epoch=0)
                                       for b in batchers)), steps):
        s = max(r["grid"].shape[1] for r in raws)

        def padded(r, k):
            pad = [(0, 0), (0, s - r["grid"].shape[1])]
            return np.pad(r[k], pad + [(0, 0)] * (r[k].ndim - 2))

        both = {k: np.concatenate([padded(r, k) for r in raws])
                for k in ("grid", "grid_mask", "text_loss_mask",
                          "audio_loss_mask")}
        state, _ = step(state, trainer.to_batch(both, "cpu"))
    return state


def test_train_cli_on_two_ranks(cli_runs):
    """Two ranks, fsdp: each rank trains on its half of the files, to the
    parameters of one process stepping on both ranks' batches stacked; a
    checkpoint written by rank 0 and resumed by both ranks into the same
    mesh (the step count goes on), and `load_params_for_inference` reads
    the mesh run's params into an unsharded tree. Two ranks, tp 2: trains,
    both ranks on every file (one data-parallel rank)."""
    import os

    from uniaudio2_tpu_torch.train import checkpoint as ckpt

    plain, one, two = cli_runs["plain"], cli_runs["fsdp1"], cli_runs["fsdp2"]
    assert one["step"] == 2 and two["step"] == 4
    for (path, t), (_, p) in zip(_leaves_with_path(one["params"]),
                                 _leaves_with_path(plain.params)):
        np.testing.assert_allclose(t.numpy(), p.numpy(), rtol=0, atol=1e-6,
                                   err_msg=str(path))
    exp = cli_runs["exp"] / "fsdp"
    assert os.path.isfile(exp / "ep1.checkpoint" / "meta.json")
    like = optim.tree_map(torch.zeros_like, plain.params)
    got = ckpt.load_params_for_inference(str(exp), like)
    for (path, t), (_, p) in zip(_leaves_with_path(got),
                                 _leaves_with_path(two["params"])):
        assert torch.equal(t, p), path
    assert cli_runs["tp"]["step"] == 2
    assert all(bool(torch.isfinite(t).all())
               for _, t in _leaves_with_path(cli_runs["tp"]["params"]))
    files = one["files"]
    every = sorted(str(p) for p in cli_runs["exp"].glob("*_task.json"))
    assert [len(f) for f in files] == [1, 1]
    assert sorted(files[0] + files[1]) == every
    assert [sorted(f) for f in cli_runs["tp"]["files"]] == [every, every]
