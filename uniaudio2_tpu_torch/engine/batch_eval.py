"""Batch evaluation harness over pre-tokenized test sets (port of
`uniaudio2_tpu/engine/batch_eval.py`).

The reference gives every task file a ``__main__`` batch runner that loads
a test-data json of pre-tokenized dicts and writes a (key, hyp, ref) TSV
for offline scoring (`evaluation/asr_task.py:720-799`). This is the
one-CLI equivalent for all tasks, with the batched decode doing N
utterances per frame loop (greedy), beam search, n-gram-blocked
sampling, or offline continuous batching (``--decode_type continuous``:
`ContinuousEngine.run_offline` over the whole test set, ``--batch_size``
rows, greedy). Not ported yet: ``--score`` (the WER scorer and text
normalisers, ROADMAP queue 1 item 20); it raises.

Usage:
    python -m uniaudio2_tpu_torch.engine.batch_eval \
        --task ASR --test_data_json test.json \
        --llm_train_config cfg.yaml --resume model.npz \
        --text_tokenizer_path tok/ --prompt_text "transcribe" \
        --results asr.tsv [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="batch eval over test jsons")
    p.add_argument("--task", type=str, required=True)
    p.add_argument("--test_data_json", type=str, required=True)
    p.add_argument("--results", type=str, required=True)
    p.add_argument("--llm_train_config", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--exp_dir", type=str, default=None)
    p.add_argument("--text_tokenizer_path", type=str, required=True)
    p.add_argument("--prompt_text", type=str, default=None)
    p.add_argument("--prompt_json", type=str, default=None)
    p.add_argument("--decode_type", type=str, default="greedy",
                   choices=["greedy", "ngram", "beamsearch", "continuous"])
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--topk", type=int, default=200)
    p.add_argument("--beam_size", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=888)
    p.add_argument("--max_frames", type=int, default=500)
    p.add_argument("--model_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "int4", "int4allg", "int4all"],
                   help="serving quantization; int4allg (group-128 scales) "
                        "is the JAX package's recommended int4 point (see "
                        "scripts/quant_quality_report.py)")
    p.add_argument("--score", action="store_true",
                   help="corpus WER after decoding: not ported yet "
                        "(ROADMAP queue 1 item 20), raises")
    p.add_argument("--lang", type=str, default="en", choices=["en", "cn"])
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to decode on (cuda, cuda:N or cpu)")
    return p


def _load_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    d = torch.load(path, map_location="cpu", weights_only=False)
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in d.items()}


def read_scp(path: str) -> Dict[str, str]:
    """kaldi-style ``key text...`` file -> dict (the JAX package's
    `metrics/wer.read_scp`)."""
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
            elif len(parts) == 1:
                out[parts[0]] = ""
    return out


def main(argv: Optional[List[str]] = None):
    args = get_parser().parse_args(argv)
    if args.score:
        raise NotImplementedError(
            "--score: the WER scorer and its text normalisers (metrics/) "
            "are not ported yet (ROADMAP queue 1 item 20); score the TSV "
            "offline")
    from uniaudio2_tpu_torch import cli as climod
    from uniaudio2_tpu_torch.engine import tasks as tm
    from uniaudio2_tpu_torch.engine.generators import select_prompt

    runner = climod.build_runner(args)
    prompt = select_prompt(
        args.task, prompt_text=args.prompt_text, prompt_json=args.prompt_json
    )
    with open(args.test_data_json, encoding="utf-8") as f:
        content = json.load(f)
    task_key = content.get("task", args.task)
    fmt = tm.TASK_FORMATS[task_key]
    keys, types = tm.condition_prefix(task_key)
    ref_key = fmt["loss_key"][-1]

    data = {k: _load_dict(v) if v.endswith(".pt") else v
            for k, v in content["keys"].items()}
    # text references may be raw scp files
    for k, v in list(data.items()):
        if isinstance(v, str):
            data[k] = read_scp(v)

    utt_ids = [u for u in data[keys[0]] if all(u in data[k] for k in fmt["keys"])]
    os.makedirs(os.path.dirname(args.results) or ".", exist_ok=True)

    def prep_item(u):
        """(grid, mask, decoded reference) for one utterance."""
        d = {}
        for k, tp in zip(keys, types):
            v = data[k][u]
            arr = np.asarray(v)
            d[k] = arr.T if tp != "text" and arr.ndim == 2 and arr.shape[0] == 8 else v
        grid, mask = tm.build_condition_grid(
            runner._prompt_ids(prompt), d, keys, types, runner.ts
        )
        ref = data[ref_key].get(u, "")
        if not isinstance(ref, str):
            ref = runner.tok.decode(np.asarray(ref).reshape(-1))
        return grid, mask, ref

    if args.decode_type == "continuous":
        # offline continuous batching: refill on completion over the whole
        # test set (engine/continuous.py)
        from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine
        from uniaudio2_tpu_torch.engine.decode import pick_bucket

        items, gts = [], []
        for u in utt_ids:
            grid, mask, ref = prep_item(u)
            items.append((grid, mask))
            gts.append(ref)
        bucket = pick_bucket(max(g.shape[0] for g, _ in items),
                             runner.engine.buckets)
        ce = ContinuousEngine(
            runner.engine.params, runner.engine.cfg, mode="text",
            rows=args.batch_size, bucket=bucket,
            cache_len=-(-(bucket + args.max_frames + 1) // 256) * 256,
            max_frames=args.max_frames, temperature=args.temperature,
            topk=1, seed=args.seed, cache_dtype=runner.engine.cache_dtype,
        )
        outs = ce.run_offline(items)
        with open(args.results, "w", encoding="utf-8") as f_out:
            for u, toks, gt in zip(utt_ids, outs, gts):
                f_out.write(f"{u}\t{runner.tok.decode(toks)}\t{gt}\n")
        print(f"wrote {args.results} ({len(utt_ids)} utts)")
        return

    n = 0
    with open(args.results, "w", encoding="utf-8") as f_out:
        for i in range(0, len(utt_ids), args.batch_size):
            chunk = utt_ids[i : i + args.batch_size]
            items, gts = [], []
            for u in chunk:
                grid, mask, ref = prep_item(u)
                items.append((grid, mask))
                gts.append(ref)
            if args.decode_type == "greedy":
                outs = runner.engine.generate_text_batch(
                    items, temperature=args.temperature, topk=1, seed=args.seed
                )
            elif args.decode_type == "beamsearch":
                outs = [runner.engine.generate_text_beam(
                    g, m, beam_size=args.beam_size) for g, m in items]
            else:
                outs = [runner.engine.generate_text(
                    g, m, temperature=args.temperature, topk=args.topk,
                    seed=args.seed, no_repeat_ngram=4) for g, m in items]
            for u, toks, gt in zip(chunk, outs, gts):
                hyp = runner.tok.decode(toks)
                f_out.write(f"{u}\t{hyp}\t{gt}\n")
                n += 1
                print(f"[{task_key}] {u} -> {hyp[:70]}")
    print(f"wrote {args.results} ({n} utts)")


if __name__ == "__main__":
    main()
