"""Training entry point (port of `uniaudio2_tpu/train/train.py`), on one
card or on a device mesh.

Same flags as the JAX entry point (the reference's knobs,
`llm_utils/arguments.py:12-77`), plus ``--device`` (``cuda`` by default).

One process trains on one device. Several train as one mesh, one process
a card, started by ``torchrun`` with ``--distributed``, which joins the
process group its environment names (NCCL on cards, ``cuda:LOCAL_RANK``
each; gloo with ``--device cpu``). In a process group (also one set up by
the caller) the JAX entry point's mesh block builds the (replica, fsdp,
tp) mesh from ``--data-parallel`` and ``--tensor-parallel`` over every
rank, and the parameters and optimizer state are sharded on it
(`trainer`). Each data-parallel rank reads its share of the dataset files
(`data_files`; the JAX entry point shards them per process), the tp ranks
of a group the same share, and trains on the batches it builds from them;
every rank takes as many steps an epoch as the rank with the fewest
batches. Checkpoints keep the ``ep{N}.checkpoint/`` layout
(`checkpoint`: rank 0 writes the gathered tree).

Run: ``python -m uniaudio2_tpu_torch.train.train --train_data_jsons
'data/*.json' --exp_dir exp/run1 --optimizer adamw_lean``, or on N cards
``torchrun --nproc-per-node N -m uniaudio2_tpu_torch.train.train
--distributed --data-parallel fsdp --tensor-parallel 2 ...``
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os
from typing import Optional


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the unified audio LM")
    p.add_argument("--train_data_jsons", type=str, nargs="+", required=True)
    p.add_argument("--valid_data_jsons", type=str, nargs="*", default=[])
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--llm_train_config", type=str, default=None,
                   help="yaml with llm_name/local_model/token cards")
    p.add_argument("--text_tokenizer_path", type=str, default=None)
    p.add_argument("--n_epoch", type=int, default=5)
    p.add_argument("--batch_scale", type=int, default=2048)
    p.add_argument("--max_length", type=int, default=2048)
    p.add_argument("--min_length", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=10000)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--data-parallel", dest="data_parallel", type=str,
                   default="fsdp", choices=["sdp", "fsdp", "hsdp"])
    p.add_argument("--tensor-parallel", dest="tensor_parallel", type=int,
                   default=1)
    p.add_argument("--activation-checkpointing", dest="remat",
                   action="store_true", default=True)
    p.add_argument("--no-activation-checkpointing", dest="remat",
                   action="store_false")
    p.add_argument("--prefix_lm", action="store_true", default=False)
    p.add_argument("--audio-capacity", dest="audio_capacity", type=int,
                   default=None,
                   help="static per-row audio-step capacity: run the local "
                        "decoder + audio CE on gathered audio rows only")
    p.add_argument("--no-chunked-ce", dest="chunked_ce",
                   action="store_false", default=True,
                   help="dense-logits CE (the chunked logit-free CE is the "
                        "default)")
    p.add_argument("--optimizer", type=str, default="adamw",
                   choices=["adamw", "adamw_lean", "adafactor"],
                   help="adamw_lean: int8 first moment + factored second "
                        "moment, ~1 byte/param of state, the single-card "
                        "memory configuration")
    p.add_argument("--mixed-precision", dest="precision", type=str,
                   default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=0,
                   help="accepted and unused, as in the JAX entry point")
    p.add_argument("--seed", type=int, default=999)
    p.add_argument("--tensorboard", action="store_true", default=False)
    p.add_argument("--wandb", action="store_true", default=False)
    p.add_argument("--debug_steps", type=int, default=0,
                   help="stop each epoch after N steps (CI smoke)")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="join the process group the torchrun environment "
                        "names (one process a card) and train on the mesh "
                        "of every rank")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to train on (cuda, cuda:N or cpu); "
                        "with --distributed cuda is cuda:LOCAL_RANK")
    return p


def data_files(patterns, mesh):
    """This rank's dataset files: ``files[rank::n]`` of each pattern over
    the mesh's data-parallel ranks (every file without a mesh), so the tp
    ranks of a group read the same files."""
    from uniaudio2_tpu_torch.data import loading
    from uniaudio2_tpu_torch.parallel import mesh as meshlib

    if mesh is None:
        return loading.find_data_jsons(patterns, rank=0, world_size=1)
    return loading.find_data_jsons(patterns, rank=meshlib.dp_rank(mesh),
                                   world_size=meshlib.dp_size(mesh))


def make_batcher(args, cfg, files, tok):
    """The length batcher over the examples of ``files``."""
    from uniaudio2_tpu_torch.data import batching, loading

    data, text_data, _ = loading.load_all_tasks(files)
    data.update(text_data)
    return batching.LengthBatcher(
        data, cfg.tokens, batch_scale=args.batch_scale, text_tokenizer=tok,
        max_length=args.max_length, min_length=args.min_length, seed=args.seed)


def steps_on_every_rank(n: int, device) -> int:
    """The fewest batches an epoch any rank of the process group has."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([n], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


class IntTok:
    """Pre-tokenized text files: whitespace-separated integer ids."""

    def tokenize(self, text):
        return [int(t) for t in text.split()]


def main(argv: Optional[list] = None):
    """Train; returns the final `trainer.TrainState`."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.train import checkpoint as ckpt
    from uniaudio2_tpu_torch.train import schedule, trainer
    from uniaudio2_tpu_torch.parallel import mesh as meshlib
    from uniaudio2_tpu_torch.train.reporter import Reporter

    import torch.distributed as dist

    device = torch.device(args.device)
    if args.distributed:
        meshlib.init_distributed("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    # --- mesh (in a process group) ---
    m = None
    tp = max(args.tensor_parallel, 1)
    if dist.is_initialized():
        n_dev = dist.get_world_size()
        if n_dev % tp:
            raise ValueError(f"--tensor-parallel {tp} does not divide "
                             f"{n_dev} ranks")
        m = meshlib.mesh_for_strategy(args.data_parallel, n_dev, tp=tp,
                                      device_type=device.type)
        logging.info("mesh: %s", m)
    elif tp > 1:
        raise ValueError(f"--tensor-parallel {tp} needs as many ranks: start "
                         f"them with torchrun and --distributed")
    if device.type == "cuda":
        # float32 products in full float32, bf16 products accumulated in
        # float32 (the JAX package's preferred_element_type=float32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # --- config / model ---
    if args.llm_train_config:
        import yaml

        with open(args.llm_train_config, encoding="utf-8") as f:
            cfg = UnifiedModelConfig.from_train_yaml(yaml.safe_load(f))
    else:
        cfg = UnifiedModelConfig()
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        params = unified.init_params(cfg, gen, dtype=dtype, device=device)

    tx = trainer.make_optimizer(
        schedule.warmup_lr(args.learning_rate, args.warmup_steps),
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        accum_steps=args.grad_accum, optimizer=args.optimizer)
    state = trainer.init_train_state(params, tx, device=device, mesh=m,
                                     use_tp=tp > 1)
    del params
    reporter = Reporter(use_tensorboard=args.tensorboard,
                        tb_dir=os.path.join(args.exp_dir, "tb"),
                        use_wandb=args.wandb)
    state, start_epoch, rep_state = ckpt.maybe_resume(args.exp_dir, state)
    if rep_state:
        reporter.load_state_dict(rep_state)
    step_fn = trainer.build_train_step(
        cfg, tx, prefix_lm=args.prefix_lm, remat=args.remat,
        chunked_ce=args.chunked_ce, audio_capacity=args.audio_capacity,
        mesh=m)

    # --- data ---
    if args.text_tokenizer_path:
        from uniaudio2_tpu_torch.text.tokenizer import TextTokenizer

        tok = TextTokenizer(args.text_tokenizer_path)
    else:
        logging.warning("no --text_tokenizer_path; treating text files as "
                        "pre-tokenized integer ids")
        tok = IntTok()
    batcher = make_batcher(args, cfg, data_files(args.train_data_jsons, m),
                           tok)
    steps = None if m is None else steps_on_every_rank(len(batcher), device)

    # --- loop ---
    for epoch in range(start_epoch, args.n_epoch):
        sub = reporter.start_epoch("train", epoch)
        for i, raw in enumerate(itertools.islice(batcher.batches(epoch=epoch),
                                                 steps)):
            state, metrics = step_fn(state, trainer.to_batch(raw, device))
            sub.register({k: float(v) for k, v in metrics.items()})
            if args.print_freq and (i + 1) % args.print_freq == 0:
                logging.info(sub.window_message())
            if args.debug_steps and i + 1 >= args.debug_steps:
                break
        stats = reporter.finish_epoch(sub)
        logging.info("epoch %d: %s", epoch,
                     {k: round(v, 4) for k, v in stats.items()})
        path = ckpt.save_checkpoint(args.exp_dir, epoch, state,
                                    reporter.state_dict())
        logging.info("saved %s", path)
    return state


if __name__ == "__main__":
    main()
