"""Training entry point (port of `uniaudio2_tpu/train/train.py`), on one
card.

Same flags as the JAX entry point (the reference's knobs,
`llm_utils/arguments.py:12-77`), plus ``--device`` (``cuda`` by default).
The port trains on that one device: ``--data-parallel`` is accepted for a
single replica, and what needs more than one device (data parallelism
over several cards, ``--tensor-parallel`` > 1, ``--distributed``) raises
`NotImplementedError` naming ROADMAP queue 1 item 16, as does
``--optimizer adafactor``. Checkpoints keep the ``ep{N}.checkpoint/``
layout with a ``meta.json``, their tensors saved by ``torch.save``.

Run: ``python -m uniaudio2_tpu_torch.train.train --train_data_jsons
'data/*.json' --exp_dir exp/run1 --optimizer adamw_lean``
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

_MULTI = "needs more than one device, which the port does not train on yet " \
         "(ROADMAP queue 1 item 16)"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the unified audio LM (one card)")
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
                   help="multi-host training (not ported yet)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the one device to train on (cuda, cuda:N or cpu)")
    return p


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
    from uniaudio2_tpu_torch.data import batching, loading
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.train import checkpoint as ckpt
    from uniaudio2_tpu_torch.train import schedule, trainer
    from uniaudio2_tpu_torch.train.reporter import Reporter

    if args.distributed:
        raise NotImplementedError(f"--distributed {_MULTI}")
    if args.tensor_parallel > 1:
        raise NotImplementedError(f"--tensor-parallel {args.tensor_parallel} {_MULTI}")
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--data-parallel {args.data_parallel} over "
            f"{torch.cuda.device_count()} cards {_MULTI}; name one card "
            f"with --device cuda:N")
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
    state = trainer.init_train_state(params, tx, device=device)
    del params
    reporter = Reporter(use_tensorboard=args.tensorboard,
                        tb_dir=os.path.join(args.exp_dir, "tb"),
                        use_wandb=args.wandb)
    state, start_epoch, rep_state = ckpt.maybe_resume(args.exp_dir, state)
    if rep_state:
        reporter.load_state_dict(rep_state)
    step_fn = trainer.build_train_step(
        cfg, tx, prefix_lm=args.prefix_lm, remat=args.remat,
        chunked_ce=args.chunked_ce, audio_capacity=args.audio_capacity)

    # --- data ---
    if args.text_tokenizer_path:
        from uniaudio2_tpu_torch.text.tokenizer import TextTokenizer

        tok = TextTokenizer(args.text_tokenizer_path)
    else:
        logging.warning("no --text_tokenizer_path; treating text files as "
                        "pre-tokenized integer ids")
        tok = IntTok()
    train_jsons = loading.find_data_jsons(args.train_data_jsons)
    data, text_data, _ = loading.load_all_tasks(train_jsons)
    data.update(text_data)
    batcher = batching.LengthBatcher(
        data, cfg.tokens, batch_scale=args.batch_scale, text_tokenizer=tok,
        max_length=args.max_length, min_length=args.min_length, seed=args.seed)

    # --- loop ---
    for epoch in range(start_epoch, args.n_epoch):
        sub = reporter.start_epoch("train", epoch)
        for i, raw in enumerate(batcher.batches(epoch=epoch)):
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
