"""Multi-task inference CLI (port of `uniaudio2_tpu/cli.py`).

Flag for flag the JAX package's CLI, the reference
`multi_task_inference.py:551-654`: 7 understanding tasks (audio -> text)
and 7 generation tasks (text -> audio), with the same three phases (codec
encode, LM decode, codec decode) and the same artifact layout
(``{name}_reason.pt`` / ``{name}_semantic.pt`` token files,
``wavs/{name}.wav``, ``{task}_results.txt``).

Port-specific: ``--device`` (``cuda`` by default) names the one device the
LM and the codec run on; without a card only ``--device cpu`` runs, nothing
falls back to the CPU. The text and codec tokenizers are built by
`load_text_tokenizer` and `load_codec_tokenizer`, the seams a caller can
replace. ``--stream`` runs `run_generation_streaming` (one single-row
`ContinuousEngine` per prompt bucket feeding `stream_tts`). The JAX
package's ``configure_serving_prng`` has no counterpart.

Checkpoints: ``--resume`` accepts a reference torch ``.pt`` /
``.checkpoint`` (converted on the fly, `convert/torch_ckpt.py`) or an
``.npz`` written by either package; without one the weights are random
from seed 0.

Run as ``python -m uniaudio2_tpu_torch.cli --task ASR --audio x.wav ...``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from uniaudio2_tpu_torch.engine.generators import (
    GENERATION_TASKS, UNDERSTANDING_TASKS, TaskRunner, select_prompt,
)

UNDERSTANDING_LOWER = [t.lower() for t in UNDERSTANDING_TASKS]
GENERATION_LOWER = [t.lower() for t in GENERATION_TASKS]


def str2bool(x: str) -> bool:
    if x in ("true", "True"):
        return True
    if x in ("false", "False"):
        return False
    raise argparse.ArgumentTypeError(x)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Multi-task inference: understanding (audio->text) or "
                    "generation (text->wav), on one CUDA card",
    )
    p.add_argument("--task", type=str, required=True)
    p.add_argument("--stage", type=str, default="all", choices=["1", "2", "all"])
    # understanding inputs
    p.add_argument("--audio", type=str, default=None)
    p.add_argument("--audio_dir", type=str, default=None)
    p.add_argument("--reason_pt", type=str, default=None)
    p.add_argument("--semantic_pt", type=str, default=None)
    p.add_argument("--question", type=str, default=None)
    p.add_argument("--question_file", type=str, default=None)
    # generation inputs
    p.add_argument("--text", type=str, default="")
    p.add_argument("--text_file", type=str, default=None)
    # output
    p.add_argument("--output_dir", type=str, default="./multi_task_out")
    p.add_argument("--results", type=str, default=None)
    p.add_argument("--token_dir", type=str, default=None)
    p.add_argument("--wav_dir", type=str, default=None)
    # prompt
    p.add_argument("--prompt_text", type=str, default=None)
    p.add_argument("--prompt_json", type=str, default=None)
    # LLM
    p.add_argument("--llm_train_config", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--exp_dir", type=str, default=None)
    p.add_argument("--text_tokenizer_path", type=str, default=None)
    p.add_argument("--audio_tokenizer_config", type=str, default=None)
    p.add_argument("--audio_model_path", type=str, default=None)
    p.add_argument("--use_cfg", type=str2bool, default=False)
    p.add_argument("--stream", type=str2bool, default=False,
                   help="streaming TTS (the TTS family, --stage all): LLM "
                        "frames stream out of a continuous-batching engine "
                        "and codec windows are solved as their tokens "
                        "arrive")
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=1.0)
    p.add_argument("--decode_type", type=str, default="greedy",
                   choices=["greedy", "ngram", "beamsearch"])
    p.add_argument("--beam_size", type=int, default=4)
    # codec
    p.add_argument("--codec_config", type=str, default=None)
    p.add_argument("--codec_ckpt", type=str, default=None)
    p.add_argument("--music_ssl_folder", type=str, default=None)
    p.add_argument("--codec_steps", type=int, default=50)
    p.add_argument("--codec_duration", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=888)
    p.add_argument("--rank", type=int, default=0)
    # the JAX package's extras
    p.add_argument("--model_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--max_frames", type=int, default=500,
                   help="decode-frame cap (reference max_audio_frames, "
                        "tts_task.py:222)")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "int4", "int4allg", "int4all"],
                   help="weight-only serving quantization (the int8 / "
                        "int4 GEMV kernels). int8: all matrices; int4: "
                        "packed int4 for the 8x-per-frame local decoder + "
                        "audio head, int8 elsewhere; int4allg: every matrix "
                        "int4 with group-128 scales (the JAX package's "
                        "recommended int4 point, "
                        "scripts/quant_quality_report.py); int4all: "
                        "per-channel int4 everywhere (most quantization "
                        "error, opt-in)")
    p.add_argument("--postprocess", type=str2bool, default=False,
                   help="apply repetition-cleanup to understanding outputs "
                        "(reference post_process_text, asr_task.py:58-172; "
                        "off by default, matching the reference)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to serve on (cuda, cuda:N or cpu)")
    return p


# ---------------------------------------------------------------------------
# Loading helpers
# ---------------------------------------------------------------------------


def resolve_device(name: str):
    """``--device`` -> a torch device. A CUDA device without a card raises:
    the port never falls back to the CPU."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device here; pass "
                               f"--device cpu to run on the CPU")
        if dev.index is not None:
            torch.cuda.set_device(dev)
    return dev


def load_llm(args):
    """Train-config yaml + checkpoint -> (UnifiedModelConfig, params) on
    ``--device``."""
    import torch

    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.convert import torch_ckpt as cvt
    from uniaudio2_tpu_torch.models import unified

    if args.llm_train_config:
        import yaml

        with open(args.llm_train_config, encoding="utf-8") as f:
            train_yaml = yaml.safe_load(f)
        cfg = UnifiedModelConfig.from_train_yaml(train_yaml)
    else:
        cfg = UnifiedModelConfig()

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.model_dtype == "bfloat16" else torch.float32
    resume = args.resume
    if resume is None and args.exp_dir:
        # newest ep*.checkpoint glob (reference resume_for_inference,
        # train_utils.py:159-171)
        cands = sorted(
            glob.glob(os.path.join(args.exp_dir, "ep*.checkpoint")),
            key=os.path.getmtime,
        )
        resume = cands[-1] if cands else None
    if resume and resume.endswith(".npz"):
        # the tree's structure, shapes and dtypes only
        like = unified.init_params(cfg, torch.Generator(), dtype=dtype,
                                   device="meta")
        params = cvt.to_port(cvt.load_npz(resume, like), dtype, device)
    elif resume:
        sd = cvt.load_torch_state_dict(resume)
        params, missing = cvt.convert_unified(sd, cfg)
        if missing:
            print(f"[load_llm] {len(missing)} keys missing from checkpoint "
                  f"(first: {missing[:3]})", file=sys.stderr)
        params = cvt.to_port(params, dtype, device)
    else:
        print("[load_llm] no --resume/--exp_dir: using random init",
              file=sys.stderr)
        gen = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            params = unified.init_params(cfg, gen, dtype=dtype, device=device)
    return cfg, params


def load_text_tokenizer(args):
    """``--text_tokenizer_path`` -> the text tokenizer (`tokenize` /
    `decode`)."""
    from uniaudio2_tpu_torch.text.tokenizer import TextTokenizer

    return TextTokenizer(args.text_tokenizer_path)


def build_runner(args) -> TaskRunner:
    import torch

    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    cfg, params = load_llm(args)
    if args.quantize != "none":
        from uniaudio2_tpu_torch.models.unified import prepare_serving_params
        from uniaudio2_tpu_torch.ops.quant import quantize_unified_params

        all_mods = ("backbone", "decoder", "understanding_expert",
                    "generation_expert", "audio_head", "projection_w")
        int4 = {"int4": ("decoder", "audio_head", "projection_w"),
                "int4allg": all_mods,
                "int4all": all_mods}.get(args.quantize, ())
        with torch.no_grad():
            params = prepare_serving_params(quantize_unified_params(
                params, int4_modules=int4, grouped=args.quantize == "int4allg"))
    tok = load_text_tokenizer(args)
    engine = DecodeEngine(
        params, cfg, max_frames=args.max_frames,
        cache_dtype=(torch.bfloat16 if args.model_dtype == "bfloat16"
                     else torch.float32),
    )
    return TaskRunner(engine, tok)


def load_codec_tokenizer(args, need_decode: bool):
    """Codec config + checkpoint -> ReasoningCodecTokenizer (encode and/or
    decode params) on ``--device``."""
    from uniaudio2_tpu_torch.convert import codec as codec_cvt

    return codec_cvt.load_tokenizer(
        config_path=args.codec_config, ckpt_path=args.codec_ckpt,
        need_decode=need_decode, music_ssl_folder=args.music_ssl_folder,
        device=resolve_device(args.device),
    )


def save_tokens(path: str, arr: np.ndarray) -> None:
    """Save codes in the reference's .pt format for drop-in compatibility."""
    import torch

    torch.save(torch.from_numpy(np.ascontiguousarray(arr)), path)


def load_tokens(path: str) -> np.ndarray:
    import torch

    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def encode_audio_inputs(args) -> Tuple[str, List[str]]:
    """Codec-encode --audio / --audio_dir into {name}_{reason,semantic}.pt
    (reference `_encode_audio_to_tokens`, `multi_task_inference.py:124-151`)."""
    tok = load_codec_tokenizer(args, need_decode=False)
    out_dir = args.output_dir
    os.makedirs(out_dir, exist_ok=True)
    wavs = []
    if args.audio and os.path.isfile(args.audio):
        wavs = [args.audio]
    elif args.audio_dir and os.path.isdir(args.audio_dir):
        wavs = sorted(
            glob.glob(os.path.join(args.audio_dir, "*.wav"))
            + glob.glob(os.path.join(args.audio_dir, "*.flac"))
        )
    names = []
    for wav in wavs:
        name = os.path.splitext(os.path.basename(wav))[0]
        reason, semantic = tok.tokenize(wav)
        save_tokens(os.path.join(out_dir, f"{name}_reason.pt"), reason)
        save_tokens(os.path.join(out_dir, f"{name}_semantic.pt"), semantic)
        names.append(name)
        print(f"[Encode] {name}: reason {reason.shape}, semantic {semantic.shape}")
    return out_dir, names


def _collect_token_inputs(args) -> Tuple[str, List[str]]:
    if (args.audio and os.path.isfile(args.audio)) or (
        args.audio_dir and os.path.isdir(args.audio_dir)
    ):
        return encode_audio_inputs(args)
    if args.reason_pt and args.semantic_pt:
        name = os.path.basename(args.reason_pt).replace("_reason.pt", "")
        return os.path.dirname(args.reason_pt) or ".", [name]
    if args.token_dir and os.path.isdir(args.token_dir):
        files = sorted(glob.glob(os.path.join(args.token_dir, "*_reason.pt")))
        return args.token_dir, [
            os.path.basename(f).replace("_reason.pt", "") for f in files
        ]
    raise ValueError(
        "provide --audio / --audio_dir, --reason_pt + --semantic_pt, or "
        "--token_dir"
    )


def run_understanding(args) -> str:
    task = args.task.strip().lower()
    token_dir, names = _collect_token_inputs(args)
    runner = build_runner(args)
    prompt = select_prompt(
        args.task, prompt_text=args.prompt_text, prompt_json=args.prompt_json
    )
    questions: Dict[str, str] = {}
    if args.question:
        questions = {n: args.question for n in names}
    elif args.question_file and os.path.isfile(args.question_file):
        lines = [l.strip() for l in open(args.question_file) if l.strip()]
        if len(lines) == 1:
            questions = {n: lines[0] for n in names}
        else:
            questions = dict(zip(names, lines))

    results_path = args.results or os.path.join(
        args.output_dir, f"{task}_results.txt"
    )
    os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
    kw = dict(
        temperature=args.temperature, topk=args.topk, seed=args.seed,
        decode_type="ngram" if args.decode_type == "ngram" else "greedy",
        max_repeat_ngram=4 if args.decode_type == "ngram" else 0,
    )
    # fast path: batch simple text tasks over many utterances in one
    # compiled multi-row program (8 at a time)
    batchable = (
        len(names) > 1
        and args.decode_type == "greedy"
        and task in ("asr", "yue_asr", "audio_caption", "music_caption",
                     "lyric_recognition", "speech_s2t")
    )
    if batchable:
        from uniaudio2_tpu_torch.engine import tasks as tm

        fmt_key = {"asr": "ASR", "yue_asr": "Yue_ASR"}.get(task, None)
        with open(results_path, "w", encoding="utf-8") as f_out:
            for i in range(0, len(names), 8):
                chunk = names[i : i + 8]
                items = []
                for name in chunk:
                    reason = load_tokens(
                        os.path.join(token_dir, f"{name}_reason.pt")).T
                    semantic = load_tokens(
                        os.path.join(token_dir, f"{name}_semantic.pt")).T
                    key = fmt_key or {
                        "audio_caption": "audio_caption",
                        "music_caption": "music_caption",
                        "lyric_recognition": "lyric_recognition",
                        "speech_s2t": "speech_s2t",
                    }[task]
                    grid, mask = tm.build_condition_grid(
                        runner._prompt_ids(prompt),
                        {"reason_seq": reason, "semantic_seq": semantic},
                        *tm.condition_prefix(key), runner.ts,
                    )
                    items.append((grid, mask))
                outs = runner.engine.generate_text_batch(
                    items, temperature=args.temperature, topk=1,
                    seed=args.seed,
                )
                for name, toks in zip(chunk, outs):
                    text = runner.tok.decode(toks)
                    f_out.write(f"{name}\t{text}\n")
                    print(f"[{task}] {name} -> {text[:80]}")
        print(f"Results written to {results_path}")
        return results_path

    with open(results_path, "w", encoding="utf-8") as f_out:
        for name in names:
            reason = load_tokens(os.path.join(token_dir, f"{name}_reason.pt")).T
            semantic = load_tokens(
                os.path.join(token_dir, f"{name}_semantic.pt")
            ).T
            if task in ("asr", "yue_asr"):
                if args.decode_type == "beamsearch":
                    from uniaudio2_tpu_torch.engine import tasks as tm
                    grid, mask = tm.prepare_asr(
                        runner._prompt_ids(prompt), reason, semantic,
                        runner.ts,
                    )
                    toks = runner.engine.generate_text_beam(
                        grid, mask, beam_size=args.beam_size
                    )
                    text = runner.tok.decode(toks)
                else:
                    text = runner.asr(prompt, reason, semantic, **kw)
            elif task in ("audio_caption", "music_caption"):
                text = runner.caption(
                    prompt, reason, semantic, music=task == "music_caption", **kw
                )
            elif task == "lyric_recognition":
                text = runner.run_text_task(
                    "lyric_recognition", prompt,
                    {"reason_seq": reason, "semantic_seq": semantic}, **kw,
                )
            elif task == "speech_s2t":
                text = runner.speech_s2t(prompt, reason, semantic, **kw)
            elif task == "audio_understanding":
                q = questions.get(name, "")
                q_ids = np.asarray(runner.tok.tokenize(q), np.int64)
                text = runner.audio_question(prompt, q_ids, reason, semantic, **kw)
            else:
                raise ValueError(task)
            if args.postprocess:
                from uniaudio2_tpu_torch.engine.postprocess import post_process_text
                text = post_process_text(text)
            f_out.write(f"{name}\t{text}\n")
            print(f"[{task}] {name} -> {text[:80]}")
    print(f"Results written to {results_path}")
    return results_path


def run_generation_stage1(args) -> str:
    task = args.task.strip().lower()
    out_dir = args.output_dir
    os.makedirs(out_dir, exist_ok=True)
    runner = build_runner(args)
    prompt = select_prompt(
        args.task, prompt_text=args.prompt_text, prompt_json=args.prompt_json
    )
    kw = dict(
        temperature=args.temperature, topk=args.topk, seed=args.seed,
        use_cfg=args.use_cfg, cfg_scale=args.cfg_scale,
    )

    if task == "speech_s2s":
        token_dir, names = _collect_token_inputs(args)
        for name in names:
            reason = load_tokens(os.path.join(token_dir, f"{name}_reason.pt")).T
            semantic = load_tokens(
                os.path.join(token_dir, f"{name}_semantic.pt")
            ).T
            r, s = runner.speech_s2s(prompt, reason, semantic, **kw)
            save_tokens(os.path.join(out_dir, f"{name}_reason.pt"), r)
            save_tokens(os.path.join(out_dir, f"{name}_semantic.pt"), s)
            print(f"[Stage1] speech_s2s {name}")
        return out_dir

    items = text_items(args)

    for name, text in items:
        ids = np.asarray(runner.tok.tokenize(text), np.int64)
        if task in ("tts", "yue_tts"):
            r, s = runner.tts(prompt, ids, **kw)
        elif task == "tta":
            r, s = runner.tta(prompt, ids, **kw)
        elif task == "ttm":
            r, s = runner.ttm(prompt, ids, **kw)
        elif task == "lts":
            r, s = runner.lts(prompt, ids, **kw)
        elif task in ("instruct_tts", "instructtts"):
            r, s = runner.instruct_tts(prompt, ids, ids, **kw)
        else:
            raise ValueError(task)
        save_tokens(os.path.join(out_dir, f"{name}_reason.pt"), r)
        save_tokens(os.path.join(out_dir, f"{name}_semantic.pt"), s)
        print(f"[Stage1] {name}: reason {r.shape}, semantic {s.shape}")
    return out_dir


def text_items(args) -> List[Tuple[str, str]]:
    """[(name, text)] of the generation tasks: ``--text``, or each non-empty
    line of ``--text_file``."""
    if args.text and args.text.strip():
        return [("utt_0", args.text.strip())]
    if args.text_file and os.path.isfile(args.text_file):
        with open(args.text_file, encoding="utf-8") as f:
            return [(f"utt_{i}", line.strip()) for i, line in enumerate(f)
                    if line.strip()]
    raise ValueError("generation requires --text or --text_file")


def run_generation_stage2(args) -> str:
    token_dir = args.token_dir or args.output_dir
    wav_dir = args.wav_dir or os.path.join(args.output_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    tok = load_codec_tokenizer(args, need_decode=True)
    from uniaudio2_tpu_torch.codec.tokenizer import save_wav

    files = sorted(glob.glob(os.path.join(token_dir, "*_semantic.pt")))
    for f in files:
        name = os.path.basename(f).replace("_semantic.pt", "")
        semantic = load_tokens(f)
        wav = tok.detokenize_no_reason(
            semantic, steps=args.codec_steps, seed=args.seed
        )
        out = os.path.join(wav_dir, f"{name}.wav")
        save_wav(out, wav, tok.cfg.sample_rate)
        print(f"[Stage2] {name} -> {out}")
    return wav_dir


def run_generation_streaming(args) -> str:
    """Streaming TTS: one pipeline per utterance. LLM frames stream out of
    a single-row `ContinuousEngine` (one per prompt bucket), codec windows
    are solved as their tokens arrive, and the finalized waveform is
    written per utterance (`engine/stream_tts.py`)."""
    import time

    from uniaudio2_tpu_torch.codec.tokenizer import save_wav
    from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine
    from uniaudio2_tpu_torch.engine.decode import pick_bucket
    from uniaudio2_tpu_torch.engine.generators import _AUDIO_OUT_TASKS
    from uniaudio2_tpu_torch.engine.stream_tts import stream_tts

    task = args.task.strip().lower()
    if task not in ("tts", "yue_tts"):
        raise ValueError("--stream supports the TTS family")
    if args.use_cfg:
        raise ValueError(
            "--stream does not support CFG (ContinuousEngine decodes "
            "single rows); drop --use_cfg or use the offline --stage all")
    wav_dir = args.wav_dir or os.path.join(args.output_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    runner = build_runner(args)
    codec_tok = load_codec_tokenizer(args, need_decode=True)
    prompt = select_prompt(
        args.task, prompt_text=args.prompt_text, prompt_json=args.prompt_json
    )
    items = text_items(args)

    engines = {}
    for name, text in items:
        ids = np.asarray(runner.tok.tokenize(text), np.int64)
        grid, mask, _ = runner._condition(
            _AUDIO_OUT_TASKS[task], prompt, {"transcription_seq": ids}
        )
        bucket = pick_bucket(grid.shape[0], runner.engine.buckets)
        if bucket not in engines:
            engines[bucket] = ContinuousEngine(
                runner.engine.params, runner.engine.cfg, mode="audio",
                rows=1, bucket=bucket,
                cache_len=-(-(bucket + args.max_frames + 1) // 256) * 256,
                max_frames=args.max_frames, temperature=args.temperature,
                topk=args.topk, seed=args.seed,
                cache_dtype=runner.engine.cache_dtype,
            )
        chunks = []
        t0 = time.perf_counter()
        ttfa = None
        for wav in stream_tts(
            engines[bucket], codec_tok.decoder.params, codec_tok.cfg, grid,
            mask, num_steps=args.codec_steps, codec_seed=args.seed,
        ):
            if ttfa is None:
                ttfa = time.perf_counter() - t0
            chunks.append(wav)
            done_s = sum(c.shape[-1] for c in chunks) / codec_tok.cfg.sample_rate
            print(f"[Stream] {name}: +{wav.shape[-1]} samples "
                  f"({done_s:.2f} s audio)")
        full = (np.concatenate(chunks, axis=-1) if chunks
                else np.zeros((1, 0), np.float32))
        out = os.path.join(wav_dir, f"{name}.wav")
        save_wav(out, full, codec_tok.cfg.sample_rate)
        total = time.perf_counter() - t0
        print(f"[Stream] {name} -> {out} "
              f"(first audio {ttfa:.2f}s, total {total:.2f}s)"
              if ttfa is not None else
              f"[Stream] {name} -> {out} (no audio frames)")
    return wav_dir


def main(argv: Optional[List[str]] = None) -> None:
    args = get_parser().parse_args(argv)
    resolve_device(args.device)
    task = args.task.strip().lower()
    if task in UNDERSTANDING_LOWER:
        run_understanding(args)
        return
    if task in GENERATION_LOWER:
        if args.stream:
            if args.stage != "all":
                raise ValueError("--stream implies --stage all")
            run_generation_streaming(args)
            print("[Done] Streaming generation finished.")
            return
        if args.stage in ("1", "all"):
            run_generation_stage1(args)
            if args.stage == "1":
                print("[Done] Stage 1 only.")
                return
            if not args.token_dir:
                args.token_dir = args.output_dir
        if args.stage in ("2", "all"):
            run_generation_stage2(args)
        print("[Done] Generation pipeline finished.")
        return
    raise ValueError(
        f"unsupported task {args.task}; understanding: {UNDERSTANDING_TASKS}, "
        f"generation: {GENERATION_TASKS}"
    )


if __name__ == "__main__":
    main()
