"""Multi-rank dry run of the mesh path (port of `__graft_entry__.py`'s
``dryrun_multichip``): one sharded train step and sharded serving on the
tiny config, over ``n`` ranks of one process each.

    python -m uniaudio2_tpu_torch.parallel.dryrun --n 8 --device cpu

``n`` factors as in JAX (tp 2 when n is even, then fsdp 2 when the rest
is even, the rest replicas: 8 -> 2 x 2 x 2). The ranks rendezvous on a
`FileStore` in a temporary directory: gloo over CPU ranks, NCCL over
``cuda:rank`` (``--device cuda``, one card a rank). The train step has
JAX's settings (``prefix_lm``, remat, AdamW, clip 2.0, the same grid,
masks and batch size); the sharded engine's greedy text and audio must
equal the plain engine's. Rank 0 prints JAX's line:
``dryrun_multichip ok: mesh=(replica=R,fsdp=F,tp=T) loss=... decode_identical=true``.

`spawn` starts the ranks and joins them under a deadline (a rank that dies
leaves the others in a collective: they are killed, and it raises). The
other rank functions here are the checks the port's CPU tests run on a
mesh: each takes its inputs from, and writes its outputs to, files.
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from uniaudio2_tpu_torch.parallel import mesh as meshlib


def _entry(fn, rank: int, n: int, store_path: str, device: str,
           timeout_s: float, args) -> None:
    torch.set_num_threads(1)
    meshlib.quiet()
    if device == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, n)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, n, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device: str = "cpu",
          timeout_s: float = 240.0) -> None:
    """Run ``fn(rank, n, *args)`` on ``n`` fresh processes in one process
    group. Joins them under ``timeout_s`` (also the group's collective
    timeout); on a failure or an overrun every rank still alive is killed
    and RuntimeError raised. ``fn`` must be importable by name (a module
    function of this package)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry, args=(fn, r, n, store, device,
                                                  timeout_s, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout_s:.0f} s"
                    break
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
                    break
                time.sleep(0.05)
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
    if failed:
        raise RuntimeError(f"spawn({fn.__name__}, {n}): {failed}")


def factor(n: int):
    """(replica, fsdp, tp) of ``n`` devices, as JAX's dry run factors it."""
    tp = 2 if n % 2 == 0 else 1
    rest = n // tp
    fsdp = 2 if rest % 2 == 0 else rest
    return rest // fsdp, fsdp, tp


def dryrun_batch(b: int, s: int = 16, ncb: int = 8, par: int = 9):
    """JAX's dry-run batch: (grid, grid_mask, text_loss_mask,
    audio_loss_mask) as numpy arrays."""
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 30, size=(b, s + 1, par)).astype(np.int32)
    gmask = np.zeros((b, s + 1, par), bool)
    gmask[:, : s // 2, :ncb] = True      # conditioning: audio steps
    gmask[:, s // 2:, -1] = True         # target: text steps
    tmask = np.zeros((b, s), bool)
    tmask[:, s // 2: s - 1] = True       # one contiguous target segment
    amask = np.zeros((b, s), bool)
    amask[:, 1: s // 2] = True
    return grid, gmask, tmask, amask


def _params(cfg, params_path: Optional[str], device):
    from uniaudio2_tpu_torch.models import unified

    if params_path:
        tree = torch.load(params_path, weights_only=False)
        return meshlib.tree_map_with_path(lambda _, t: t.to(device), tree)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        return unified.init_params(cfg, gen, device=device)


def train_step(cfg, params, mesh, *, use_tp: bool, device, rows: int,
               optimizer: str = "adamw") -> Dict[str, Any]:
    """One train step of JAX's dry run with ``rows`` batch rows on
    ``mesh`` (None: the plain step; on a mesh each rank takes its rows):
    the loss, the gradient norm and the updated parameters, whole."""
    from uniaudio2_tpu_torch.train import schedule, trainer

    par, ncb = cfg.tokens.parallel_number, cfg.tokens.num_codebooks
    batch = [torch.from_numpy(a).to(device)
             for a in dryrun_batch(rows, ncb=ncb, par=par)]
    if mesh is not None:
        batch = [meshlib.local_rows(t, mesh) for t in batch]
    batch = trainer.Batch(*batch)
    tx = trainer.make_optimizer(schedule.warmup_lr(1e-4, warmup_steps=100),
                                grad_clip=2.0, optimizer=optimizer)
    state = trainer.init_train_state(
        meshlib.tree_map_with_path(lambda _, t: t.clone(), params), tx,
        device=device, mesh=mesh, use_tp=use_tp)
    step = trainer.build_train_step(cfg, tx, prefix_lm=True, remat=True,
                                    mesh=mesh)
    state, metrics = step(state, batch)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": meshlib.tree_map_with_path(
                lambda _, t: meshlib.whole(t).detach().cpu(), state.params)}


def serve(cfg, params, mesh, *, use_tp: bool, kv_quant=None,
          batch_rows: int = 0) -> Dict[str, Any]:
    """Greedy text and audio of JAX's dry-run prompt (and ``batch_rows``
    copies through `generate_text_batch`) from an engine on ``mesh``
    (None: the plain engine)."""
    from uniaudio2_tpu_torch.engine import tasks
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    g, m = tasks.prepare_tts(np.array([1, 5, 6]), np.array([1, 10, 2]),
                             cfg.tokens)
    eng = DecodeEngine(params, cfg, max_frames=6, cache_dtype=torch.float32,
                       buckets=(32,), kv_quant=kv_quant, mesh=mesh,
                       use_tp=use_tp)
    out = {"text": np.asarray(eng.generate_text(g, m, topk=1))}
    if kv_quant is None:
        audio = eng.generate_audio(g, m, topk=1)
        out["audio"] = [np.asarray(a) for a in audio[:2]]
    if batch_rows:
        out["batch"] = [np.asarray(r) for r in
                        eng.generate_text_batch([(g, m)] * batch_rows, topk=1)]
    return out


def rank_main(rank: int, n: int, device: str, params_path: Optional[str],
              out_path: Optional[str]) -> None:
    """The dry run on one rank (`spawn`'s function)."""
    from uniaudio2_tpu_torch.config import UnifiedModelConfig

    replica, fsdp, tp = factor(n)
    dev = torch.device(f"cuda:{rank}" if device == "cuda" else "cpu")
    mesh = meshlib.build_mesh(replica=replica, fsdp=fsdp, tp=tp,
                              device_type=dev.type)
    cfg = UnifiedModelConfig.tiny()
    params = _params(cfg, params_path, dev)
    result = train_step(cfg, params, mesh, use_tp=tp > 1, device=dev,
                        rows=max(2 * replica * fsdp, 4))
    loss = result["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    plain = serve(cfg, params, None, use_tp=False)
    sharded = serve(cfg, params, mesh, use_tp=tp > 1)
    np.testing.assert_array_equal(sharded["text"], plain["text"])
    for a, b in zip(sharded["audio"], plain["audio"]):
        np.testing.assert_array_equal(a, b)
    rows = torch.arange(8)
    held = [None] * n
    dist.all_gather_object(held, (
        mesh.get_coordinate(), meshlib.local_rows(rows, mesh).tolist(),
        meshlib.distribute(rows, mesh, meshlib.batch_spec()).to_local()
        .tolist()))
    if rank == 0:
        if out_path:
            torch.save({"train": result, "plain": plain, "sharded": sharded,
                        "rows": held}, out_path)
        print(f"dryrun_multichip ok: mesh=(replica={replica},fsdp={fsdp},"
              f"tp={tp}) loss={loss:.4f} decode_identical=true", flush=True)


def inference_main(rank: int, n: int, params_path: str, moe_path: str,
                   out_path: str) -> None:
    """The sharded-inference checks on a (fsdp=4, tp=2) mesh (`spawn`'s
    function, n = 8): a decode frame and `forward_text` with the
    parameters placed by the spec rules, the serving engine in float and
    int8 KV, and an MoE GPT's forward and gradients with its experts over
    tp (every rank on the same rows). Rank 0 writes every output to
    ``out_path``."""
    from uniaudio2_tpu_torch.config import GPTConfig, UnifiedModelConfig
    from uniaudio2_tpu_torch.models import gpt, unified

    mesh = meshlib.build_mesh(fsdp=n // 2, tp=2, device_type="cpu")
    tp = meshlib.tensor_parallel(mesh)
    cfg = UnifiedModelConfig.tiny()
    params = _params(cfg, params_path, "cpu")
    whole = meshlib.whole_tree(meshlib.shard_params(params, mesh, True))
    out: Dict[str, Any] = {}
    with torch.no_grad():
        caches = unified.init_caches(cfg, 1, dtype=torch.float32,
                                     device="cpu", tp=tp)
        tokens = torch.zeros((1, 1, 9), dtype=torch.int64)
        mask = torch.ones((1, 1, 9), dtype=torch.bool)
        gen = torch.Generator().manual_seed(1)
        frame, _ = unified.decode_frame(whole, cfg, tokens, mask, caches, 0,
                                        gen, temperature=0.9, topk=1,
                                        forbid_prefix=0, tp=tp)
        out["frame"] = frame
        out["k0"] = tp.gather(caches.backbone.k[:, :, :, :1], dim=2)
        toks = torch.from_numpy(
            np.random.default_rng(3).integers(0, 30, (2, 6, 9)))
        out["forward_text"] = unified.forward_text(
            whole, cfg, toks, torch.ones((2, 6, 9), dtype=torch.bool), tp=tp)
    for kv in (None, "on"):
        key = "engine" if kv is None else "engine_int8"
        out[key] = serve(cfg, params, mesh, use_tp=True, kv_quant=kv,
                         batch_rows=3)

    moe = torch.load(moe_path, weights_only=False)
    mcfg = GPTConfig(**moe["cfg"])
    specs = meshlib.tree_map_with_path(
        lambda path, leaf: meshlib._gpt_param_spec(path, leaf, True),
        moe["params"])
    sharded = meshlib._tree_map2(
        lambda p, s: meshlib.distribute(p, mesh, s).requires_grad_(True),
        moe["params"], specs)
    split = lambda path: path[-1] in gpt.TP_SPLIT  # noqa: E731
    x = moe["x"]
    with torch.enable_grad():
        p = meshlib.tree_map_with_path(
            lambda path, t: meshlib.gather(t, tp_partial=split(path),
                                           dp_partial=False), sharded)
        h = gpt.forward(p, mcfg, gpt.embed(p, x), tp=tp)
        loss = gpt.lm_head(p, h, mcfg).square().mean()
        leaves = [sharded["layers"]["fc1_w"], sharded["layers"]["moe_gate_w"],
                  sharded["wte"]]
        grads = torch.autograd.grad(loss, leaves)
    out["moe_loss"] = loss.detach()
    out["moe_grads"] = [meshlib.whole(g) for g in grads]
    out["moe_placements"] = [(str(g.placements), str(t.placements))
                             for g, t in zip(grads, leaves)]
    if rank == 0:
        torch.save(out, out_path)


def train_cli(argv, tiny: bool = False):
    """`train.main(argv)`; with ``tiny`` the model is
    `UnifiedModelConfig.tiny()`, with or without ``--llm_train_config``
    (no yaml can name tiny()'s text tokens, which lie inside its small
    vocabulary)."""
    from unittest import mock

    from uniaudio2_tpu_torch import config
    from uniaudio2_tpu_torch.train import train

    if not tiny:
        return train.main(list(argv))
    # the modules that import the class by name, bound before the patch
    from uniaudio2_tpu_torch.data import batching, loading  # noqa: F401
    from uniaudio2_tpu_torch.train import (  # noqa: F401
        checkpoint, reporter, schedule, trainer,
    )
    tiny_cfg = config.UnifiedModelConfig.tiny

    class Tiny:
        def __new__(cls):
            return tiny_cfg()

        @staticmethod
        def from_train_yaml(raw):
            return tiny_cfg()

    with mock.patch.object(config, "UnifiedModelConfig", Tiny):
        return train.main(list(argv))


def cli_main(rank: int, n: int, argv, patterns, out_path: str,
             tiny: bool = False) -> None:
    """The train CLI on one rank of a gloo group (`spawn`'s function):
    rank 0 writes the final step, the parameters and (given ``patterns``)
    the dataset files `train.data_files` gives each rank on the CLI's
    mesh."""
    from uniaudio2_tpu_torch.train import train

    state = train_cli(argv, tiny)
    mine = [None] * n
    if patterns:
        args = train.get_parser().parse_args(list(argv))
        mesh = meshlib.mesh_for_strategy(args.data_parallel, n,
                                         tp=args.tensor_parallel,
                                         device_type="cpu")
        dist.all_gather_object(mine, train.data_files(patterns, mesh))
    flat = meshlib.tree_map_with_path(lambda _, t: meshlib.whole(t),
                                      state.params)
    if rank == 0:
        torch.save({"step": state.step, "params": flat, "files": mine},
                   out_path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=8, help="ranks (devices)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: one card a rank over NCCL; cpu: gloo")
    p.add_argument("--params", default=None,
                   help="a torch.save'd parameter tree (default: seed 0)")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.n:
        raise SystemExit(f"--device cuda needs {args.n} cards, "
                         f"{torch.cuda.device_count()} present")
    spawn(rank_main, args.n, args.device, args.params, None,
          device=args.device, timeout_s=args.timeout)


if __name__ == "__main__":
    main()
