"""The speculative engine's cost model on the H100 (port of
`scripts/bench_speculative.py`).

    python -m uniaudio2_tpu_torch.probes.bench_speculative [--ks 2 4 8]
    UA2_BENCH_SCALE=tiny python -m uniaudio2_tpu_torch.probes.bench_speculative --ks 2

Acceptance RATES mean nothing on random weights, so this measures the
per-round machinery cost at full scale and projects the speedup as a
function of the acceptance probability alpha.

Per k, `SpeculativeEngine` runs one TTS request (128 frames after a
bucket-64 prompt) with two drafts: ``accept_all`` (at full scale the
int4all tree of the target's own bf16 base, checked by its int8 tree; at
the tiny scale the target itself) and ``reject_all`` (the int4all tree of
an unrelated seed). Both replay the same round (k draft frames, the draft
ingest, one T = k + 1 target verify, the teacher-forced score, one fresh
frame), so round time = generation time / rounds, cross-checked between
the two. The measured acceptance rates are printed beside the labels:
"accept_all" at full scale is one base in two formats, not one tree. The
baseline is the target's plain greedy `DecodeEngine` (its default graph
path), per frame it ran.

With iid acceptance alpha, E[frames / round] = 1 + sum_{i=1..k} alpha^i,
so speedup(alpha, k) = (1 + sum alpha^i) * t_frame_plain / t_round(k).

Each timed call follows a warm-up call (the captures) on a fresh prompt of
the same bucket. Prints one JSON line per metric, under JAX's names.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.engine import tasks
from uniaudio2_tpu_torch.engine.decode import DecodeEngine
from uniaudio2_tpu_torch.engine.speculative import SpeculativeEngine
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.ops import quant

INT4ALL = ("backbone", "decoder", "understanding_expert", "generation_expert",
           "audio_head", "projection_w")
ALPHAS = (0.5, 0.7, 0.8, 0.9, 0.95)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def full_trees(dev):
    """The int4all draft and int8 target of one seeded bf16 base, and the
    int4all tree of an unrelated seed (JAX's seeds 0 and 7)."""
    cfg = UnifiedModelConfig()
    with torch.no_grad():
        base = unified.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0),
            dtype=torch.bfloat16, device=dev)
        draft = unified.prepare_serving_params(
            quant.quantize_unified_params(base, int4_modules=INT4ALL))
        target = unified.prepare_serving_params(
            quant.quantize_unified_params(base))
        del base
        other = unified.init_params(
            cfg, torch.Generator(device=dev).manual_seed(7),
            dtype=torch.bfloat16, device=dev)
        other = unified.prepare_serving_params(
            quant.quantize_unified_params(other, int4_modules=INT4ALL))
    return cfg, draft, target, other


def bench(cfg, draft, target, other, *, ks, frames, cache_dtype, buckets,
          alphas=ALPHAS, prompt_len=23, text_len=12, hi=100, on_engine=None):
    """Print and return the metric lines. ``on_engine(k, name, eng)`` is
    called after each timed speculative call (the smoke reads the engine's
    graphs there)."""
    dev = target["audio_embeddings"].device
    rng = np.random.default_rng(0)

    def fresh_task():
        return tasks.prepare_tts(rng.integers(1, hi, prompt_len),
                                 rng.integers(1, hi, text_len), cfg.tokens)

    def timed(fn):
        g, m = fresh_task()
        fn(g, m)                              # capture + warm-up
        g, m = fresh_task()
        _sync(dev)
        t0 = time.perf_counter()
        fn(g, m)
        _sync(dev)
        return time.perf_counter() - t0

    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    ref = DecodeEngine(target, cfg, max_frames=frames, cache_dtype=cache_dtype,
                       buckets=buckets)
    dt = timed(lambda g, m: ref.generate_audio(g, m, topk=1, seed=1))
    t_frame = dt / max(ref.last_steps, 1)
    emit({"metric": "plain_greedy_frame_ms", "value": round(1e3 * t_frame, 3)})
    del ref
    for k in ks:
        rounds_ms, stats = {}, {}
        for name, d in (("accept_all", draft), ("reject_all", other)):
            eng = SpeculativeEngine(d, target, cfg, k=k, max_frames=frames,
                                    cache_dtype=cache_dtype, buckets=buckets,
                                    device=dev)
            dt = timed(lambda g, m: eng.generate_audio(g, m))
            stats[name] = eng.last_stats
            rounds_ms[name] = 1e3 * dt / max(stats[name]["rounds"], 1)
            if on_engine is not None:
                on_engine(k, name, eng)
            del eng
        t_round = rounds_ms["accept_all"]     # the same program either way
        proj = {str(a): round((1 + sum(a ** i for i in range(1, k + 1)))
                              * 1e3 * t_frame / t_round, 3) for a in alphas}
        emit({"metric": "speculative_round_cost", "k": k,
              "round_ms_accept_all": round(rounds_ms["accept_all"], 2),
              "round_ms_reject_all": round(rounds_ms["reject_all"], 2),
              "accept_all_rate": stats["accept_all"]["acceptance_rate"],
              "reject_all_rate": stats["reject_all"]["acceptance_rate"],
              "plain_frame_ms": round(1e3 * t_frame, 3),
              "projected_speedup_vs_alpha": proj})
    return lines


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ks", type=int, nargs="+", default=[2, 4, 8])
    p.add_argument("--frames", type=int, default=128)
    p.add_argument("--alphas", type=float, nargs="+", default=list(ALPHAS))
    args = p.parse_args(argv)
    if os.environ.get("UA2_BENCH_SCALE") == "tiny":
        cfg = UnifiedModelConfig.tiny()
        target = unified.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        other = unified.init_params(cfg, torch.Generator().manual_seed(7),
                                    device="cpu")
        bench(cfg, target, target, other, ks=args.ks, frames=12,
              cache_dtype=torch.float32, buckets=(32,), alphas=args.alphas,
              prompt_len=5, text_len=7, hi=30)
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device here; UA2_BENCH_SCALE=tiny runs "
                           "the probe on the CPU")
    cfg, draft, target, other = full_trees(torch.device("cuda"))
    bench(cfg, draft, target, other, ks=args.ks, frames=args.frames,
          cache_dtype=torch.bfloat16, buckets=(64,), alphas=args.alphas)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
