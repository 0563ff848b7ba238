#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`uniaudio2_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero, nothing is
caught):

1. the card: CUDA with capability >= (9, 0); its name and power limit
   from ``nvidia-smi``;
2. build every CUDA kernel from ``uniaudio2_tpu_torch/csrc`` with nvcc
   (sm_90a) and print the build seconds, each kernel's registers and
   spills, and a line for each of the four bf16 and four float32 flash
   kernels (3xTF32 and the first design, hd 64 and 128), of the seven
   tensor-core tile kernels (rows 7 and 8,
   column-packed; row 1, interleaved, per channel and grouped; rows 5 and
   6, K-split per channel and grouped; row 4, int8), of the tile kernel's
   five pass-1 instances of the fused SwiGLU (`swiglu_tc_kernel`: I4 and
   K4 per channel and grouped, INT8) and the split-K
   kernel's instances (rows 1, 4, 5 and 6, row 4's wide-N GEMV, the fused
   SwiGLU's passes and the QKV step);
3. each kernel, in every weight form it has, against its plain PyTorch
   twin at the serving path's shapes (bf16 activations, M = 1, 2 — the CFG
   pair —, 63 — the prefill bucket 64 — and, for the GEMVs, 255 — bucket
   256; rows 1, 5 and 6 also at M = 8 and 16, the batched rows, where they run
   the split-K kernel of the host's plan: at each of their decode shapes
   the plan, the time of the tiled instance and of
   ``torch._weight_int4pack_mm`` in the same run and the share of the byte
   bound are printed; rows 1, 5 and 6 also at M = 510 and, above 16 rows,
   at the served QKV call with its norm and the unfused MLP's shapes,
   where they run the tensor-core tile kernel: the plan, the tile kernel,
   its tiled instance and the library in the same run, the share of the
   bound, and at how many cases the tile kernel beats the tiled instance
   and the library; the column-packed GEMVs (rows 7 and 8) also at
   M = 510, the CFG pair's bucket-256 prefill, and at every M > 16, where
   they run the tensor-core tile kernel, the plan (`quant.tc_plan`), the
   tile kernel, its tiled instance and ``torch._weight_int4pack_mm`` in
   the same run, the share of the bound, and at how many cases the tile
   kernel beats the tiled instance; row 4 (the int8 GEMV) at the
   projections configurations A and B serve (attn_proj with its residual
   at both widths, the projection, the audio head, the prefill's QKV
   projection with its norm) at M = 1, 2, 8, 16 (the split-K kernel) and
   63, 126, 255, 510 (the tile kernel), and the text lm_head at M = 1-16
   (the split-K kernel's wide-N instance where the plan says) and 63: the
   plan, the kernel, its tiled instance and ``torch._weight_int8pack_mm``
   in the same run, the share of the bound, and at how many cases the
   kernel beats the tiled instance; the fused SwiGLU in its five served
   forms at both widths, with the norm and the residual, at M = 1, 2, 8
   and 16 (two split-K passes) and 63 and 126 (the bucket-64 prefill: two
   tile passes), each beside the first design's two tiled passes,
   `fused_swiglu_tiled`, with the plan and the share of the bound; and the
   two byte-order pairs of the same levels (`int4+int4c` and
   `int4i+int4i`, `int4g+int4cg` and `int4ig+int4ig`) at M = 17, 63, 126
   and 128, both widths, plain and with the norm and the residual: pass
   1's h and the output bit for bit;
   the fused QKV step in its five modes at both widths at M = 1, 2, 8 and
   16 (the split-K kernel's QKV mode, each case beside the first design,
   `qkv_rope_step_tiled`, with the plan and the share of the bound) and
   63 (the first design serves);
   the flash attention kernel at (B, H, hd) =
   (2, 24, 64) and the
   codec windows' T = 186, 374 and 750, plus T = 130 and B = 1 for the
   tails, in bf16 and (the float32 kernel: 3xTF32 on the tensor cores,
   beside the first design on the CUDA cores, `flash_attention_f32_simt`,
   and float32 SDPA) in float32; its causal GQA form at the backbone prefill's (1, 24, 8, T, 128)
   with T = 2048 and 1000, each with the host's plan (tile, stages,
   blocks) and the shares of the operations bound that the kernel and
   SDPA reach; the split-K int8 GEMV at the GEMV probe's six
   shapes), with the median CUDA-event time of each (L2 flushed before
   every launch, as the decode loop finds it), the bound on the card and,
   where one PyTorch call computes the same function, that call's time;
4. the full `UnifiedModelConfig()` (28x3072 backbone, 3 + 2 expert layers,
   4x2048 local decoder) with random bf16 weights from a seeded generator,
   int4 everywhere (int8 lm_head), as `bench.py` serves it:
   `generate_audio` on bench.py's TTS prompt (128 frames), one CFG-pair
   `generate_audio`, and `generate_text` on bench.py's ASR prompt, through
   the frame graphs (the engine's default; so in phases 8-10); frames/s
   and the launch count of every kernel, checked against the count the
   path implies over the frames the card ran (warm-up frames and replays),
   and of the tile kernel (`quant.gemv_tc`, by form) against the prefills'
   GEMVs (phases 8 and 9 check it too);
5. the prefill and first frame once through the kernels (on the card) and
   once through the twins (on the CPU): text and codebook-0 logits and the
   frame's backbone K rows compared; then three planted faults (nibble
   order swapped in every or in one attn_proj, RoPE sign flipped in the
   QKV kernel) that the same comparison must reject;
8. (run after phase 5) every other serving configuration of the JAX CLI,
   each built from the same seeded bf16 tree at full depth and width and
   freed before the next: A ``int8``, B ``int4`` (decoder, heads and
   projection int4, the rest int8), C ``int4allg`` (grouped scales), D
   ``int4all`` not interleaved (K-split + column-packed) and E ``int4allg``
   not interleaved. Each serves the TTS prompt, one CFG pair and the ASR
   prompt for 16 frames, D and E also a prompt in bucket 256 (255 and 510
   prefill rows, past the fused kernels' 128, so the MLP's down-projection
   runs rows 7 and 8 alone; a 512-slot cache, where "auto" picks the int8
   KV cache and block-128 reads); frames/s, memory, the launch count of
   every kernel form and of the tile kernel against the count the tree
   implies, the bucket-64 prefill's host-clock seconds (63 and 126 rows:
   the fused MLP's tile passes) of every configuration and the bucket-256
   prefill's (255 and 510 rows) of phase 4's interleaved int4all tree, C,
   D and E (synchronised, the median of three after a warm-up, then one
   profiled run: busy share and device ms by kernel kind), with summary
   lines.
   Then the prefill and first frame: A and C against the CPU twins (phase
   5's bounds), and a planted fault A must fail (backbone layer 14's int8
   attn_proj levels negated); D against the interleaved int4all run and E
   against C, on the
   card, on the TTS prompt at buckets 64 and 256 and on the ASR prompt
   (the same levels in another byte order: the logits within phase 5's
   bounds, the frame's K rows within tighter ones, far tighter on the
   first four backbone layers); and two planted faults that the K rows
   must reject on both prompts (the K-split halves swapped in one
   attn_proj, one layer's group scales shifted by one group), each
   planted once in backbone layer 14, where the bound on all layers' K
   rows must catch it, and once in layer 1, where the early layers' must;
   then the same layout comparisons and faults on the trees of a second
   seed;
9. (run after phase 8) ``DecodeEngine(params, cfg)`` with no policy
   argument on phase 4's tree: TTS and ASR on bench's prompts for the
   default 500 frames (a 768-slot cache, int8 KV, block-128 reads), the
   CFG pair, and TTS, the CFG pair and ASR on bucket-1024 prompts (1536
   slots, twelve levels), inline and with deferred writes, each request
   at the fewest frames that keep those policies; frames/s, cache bytes,
   the policy "auto" chose, the levels read, launches against the tree's
   count. Then, at the frame that crosses the level boundary at 128 (a
   teacher-forced run from a bucket-128 prompt), int8 against bf16 KV,
   block 128 against 0 and deferred against inline on the logits and K
   rows, on the trees of two seeds, and two planted faults (the per-slot
   scale written one slot late; the level one block short at the
   boundary) that the comparisons must reject;
10. (run after phase 9) batched serving, beam search and n-gram blocking
   on phase 4's tree with the engine's own policies: `generate_text_batch`
   of 8 ragged ASR prompts in bucket 64 (bench's and cuts of it), greedy
   and with per-row seeds at topk 5, `generate_audio_batch` of 8 TTS
   prompts and of 4 CFG utterances (8 rows), 64 frames each (a 256-slot
   cache, int8 KV under "auto" at 8 rows); `generate_text_beam` (beam 4,
   32 steps) and `generate_text(no_repeat_ngram=3)` (64 tokens) on bench's
   ASR prompt (host-driven steps, a 2048-slot cache: int8 KV, block 128);
   beam 1 against greedy decoding (both int8 KV, block 128); frames/s,
   row-frames/s, cache bytes, the policy "auto" chose, the levels read,
   launches against the tree's count. Then (a) the batch in reverse order
   must give every item the same greedy tokens, and (b) each row's first
   frame (text and codebook-0 logits, backbone K rows) must match its item
   run alone in the same bucket within bounds set from readings, on the
   trees of two seeds, where two planted faults (a row's key_valid
   dropped; a row's left pad one slot short) must fail;
11. (run after phase 10) the frame loop through captured CUDA graphs,
   the engine's default on the card, against the eager loop
   (``graph=False``) on phase 4's tree: TTS (128 frames, bucket 64,
   256 slots), the CFG pair and ASR; TTS and ASR at the engine's defaults
   (500 frames, 768 slots, int8 KV, block-128 levels: five of the six
   levels read, so five graphs a program), inline, and TTS deferred at
   200 frames (512 slots, the same policies); 8 ASR
   rows (greedy and with per-row seeds at topk 5) and 8 TTS rows (64
   frames); each request once each way: the same tokens,
   and every kernel form's launches equal to the tree's count over the
   frames run (warm-up frames and replays included); frames/s and
   row-frames/s both ways, capture seconds, the graph pool's bytes, and
   one profiled window of 16 TTS frames each way with its device busy
   share and its device ms and calls a frame by kernel family. Two planted faults (the feedback copy into the static input
   left out; the frame counter not advanced, so every frame writes slot
   0) must change the tokens;
6. the codec at full `CodecConfig()` width (DiT 32 x 24 x 64, ScalarAE
   `default_24k`) with random bf16 weights from a seeded generator:
   (a) one DiT estimator evaluation at B = 2, T = 374 through the flash
   kernel and through its twin, both on the card, and two planted faults
   (hd^-0.5 applied twice; the key mask dropped, so the zero-padded keys
   of the last tile enter the softmax) that the comparison must reject;
   (b) `CodecDecoder.decode` (10 steps, guidance 1.5) of 125 and 500 rec
   frames (one 15 s window, two 30 s windows): seconds, RTF, length,
   finite samples, flash launches = windows x steps x layers and none on
   the DiT's plain attention path;
   (c) `StreamingCodecDecoder` fed the 500 frames in pieces, against (b);
   (e) the codec's default float32 tree (`init_decode_params` with no
   dtype) at full width: one DiT evaluation through the float32 flash
   kernel against its twin and the planted faults of (a); one 125-frame
   window decoded on the card through the float32 kernel, and the same
   weights cast to bf16 through the bf16 kernel: the DiT's kernel and
   plain counts of each, finite samples, and the two waveforms within
   CODEC_F32_BOUNDS;
   (d) TTS end to end as scripts/bench_tts_e2e.py times it on the TPU:
   int4all `generate_audio` for 175 frames, then the codec decode of 125
   semantic frames; RTF = (stage 1 + stage 2) / 10 s;
7. training at full `UnifiedModelConfig()` width (the serving model and
   the codec freed first), seeded random bf16 weights, `adamw_lean`:
   (a) `build_train_step` (grad clip 1.0, per-layer remat, chunked CE) on
   one fixed batch from `LengthBatcher` over a synthetic TTS + ASR set
   (max_length 2048, batch_scale 4096), lr 3e-4 after a 1-step warm-up:
   one warm-up step, 5 timed steps; loss, grad_norm and seconds per step,
   tokens/s, peak memory, model-FLOP share of 989 TFLOP/s, lean launches
   against the leaf predicate's count; then one optimizer update from the
   same gradients and state through the kernel and through its twin, both
   on the card, bit-identical on every fused leaf;
   (b) `python -m uniaudio2_tpu_torch.train.train` (its `main`) at full
   width on the same set written as .pt / text / task-json files under
   build/: 2 steps, one epoch, `ep0.checkpoint` written, then read back
   through `maybe_resume` into a fresh state and compared, then deleted.

Phase 3 also holds the fused lean-update kernel to its twin at full-width
leaf shapes (bit-identical, bf16 g and p), and the stacked-layer int4
GEMV (the layer index read on the card) to its twin and to the bits of
the production K-split kernel's tiled instance on every layer of a
(28, 3072, 8192) stack.

At the end the five probe scripts run (`uniaudio2_tpu_torch/probes/`: the
split-K int8 GEMV against the production int8 kernel, a bf16 product and
``torch._int_mm`` at six shapes; the causal GQA flash kernel and the DiT's
against the einsum path and SDPA; the int4 GEMV with the conversion-free
unpack against the production interleaved kernel, and the K-split int4
GEMV's twelve tile forms against the production K-split kernel, at M = 1,
8 and 16, beside ``torch._weight_int4pack_mm`` and the byte bound; a
28-layer chain over a stacked int4 container as views, as separate
arrays, through the stacked-layer kernel and as one replayed one-layer
graph), their kernels' launches counted. Phase 3 also holds the int4
probes' kernels to their twins (one bf16 ulp) and to the production
kernels' bits.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

    python3 chip_smoke.py --profile-codec

runs phases 1-2, then one 30 s window's codec solve and ScalarAE decode
under torch.profiler, and prints the device time by kernel class (flash
attention, GEMMs, convolutions, the rest) and the top kernels.

    python3 chip_smoke.py --profile-train

runs phases 1-2, then phase 7a's train step (after a warm-up step) under
torch.profiler, and prints the device time by kernel class and the top
kernels.

"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# Kernel vs twin, one call: |diff| <= RTOL * max|twin|. The kernels follow
# the Pallas rounding (f32 sum of unscaled int weights, scale after), the
# twins the JAX fallback's (scale folded into bf16 weights, bf16 products);
# a few 2^-9 roundings stacked stay under 2 % of the output range. The flash
# attention kernel rounds the unnormalised probabilities to bf16, its twin
# the normalised ones: one 2^-9 rounding each, within the same bound.
RTOL = 2e-2
# Full model, kernels on the card vs twins on the CPU, prefill + first
# frame: (max|diff| / max|ref|, min cosine) per compared output. The
# per-call differences above enter the residual stream of 33 layers twice
# and add up. On the H100 the sound run reads at worst 8.1e-2 and cosine
# 0.99794 (codebook 0); the subtlest planted fault of phase 5 (one
# backbone layer's attn_proj with its nibbles swapped) at best 0.254 and
# 0.989 (K rows). The bounds lie between, and each control must fail them.
# Readings in PERF_HISTORY.md.
BOUNDS = {"text": (1e-1, 0.995), "codebook0": (1e-1, 0.995),
          "k_rows": (1e-1, 0.995)}
# The codec DiT at B = 2, T = 374, flash kernel vs twin, both on the card:
# (error, min cosine) of (1) the velocity of one estimator evaluation,
# error = max|diff| / max|ref|, kernel run vs twin run; (2) the 32 layers'
# attention outputs of the kernel run against the twin on the very q, k, v
# each layer gave the kernel, error = ||diff|| / ||ref||. On the H100 the
# sound run reads (1) 9.0e-3, cosine 0.999976 and (2) 1.0e-3, 0.999999;
# hd^-0.5 applied twice (1) 1.8e-2, 0.99983 and (2) 0.107, 0.9943; the key
# mask dropped (1) 1.1e-2, 0.99994 and (2) 2.5e-2, 0.99997. At random init
# the attention barely moves the velocity (its gates are ~0.06), so (2) is
# what holds a fault inside the kernel; each bound lies between the sound
# reading and the faults it must reject. Readings in PERF_HISTORY.md.
DIT_BOUNDS = {"velocity": (1.3e-2, 0.9999), "attention": (1e-2, 0.9999)}
# The float32 flash kernel against its twin, row by row: both keep every
# product and probability in f32 and sum in another order.
RTOL_F32 = 1e-5
# A grouped-scale GEMV scales and rounds each weight to bf16 before the
# product, as its twin does: without a residual the two differ in the order
# of one f32 sum and land within one bf16 ulp, 2^-7 x max|twin|.
RTOL_GROUPED = 2.0 ** -7
# The same quantized levels in another byte order (K-split + column-packed
# against row-interleaved), both on the card: (max|diff| / max|ref|, min
# cosine) per compared output of the prefill + first frame, on two prompts
# (TTS and ASR). The sums run in another order, so single bf16 roundings
# flip and spread through 33 layers. At the end of the network that leaves
# no room for a tighter bound: on the H100 the sound runs read up to 7.4e-2
# and cosine 0.99697 on the text logits (ASR prompt), where a fault deep in
# the network reads 0.124 (TTS prompt), so the logits keep BOUNDS and only
# have to pass. What rejects a fault is the frame's K rows, which see the
# residual stream layer by layer:
#  * `k_rows`, all 28 backbone layers: sound <= 4.42e-2 / >= 0.99937; the
#    faults planted in backbone layer 14 >= 0.150 / <= 0.99677;
#  * `k_early`, the first EARLY_LAYERS backbone layers, where the flips have
#    passed through at most seven layers: sound <= 1.61e-2 / >= 0.99991; the
#    same faults planted in backbone layer 1 >= 0.201 / <= 0.9797. This is
#    the tight one, ten times tighter than BOUNDS in 1 - cosine.
# Those are the worst readings over the trees of two seeds (0 and
# SECOND_SEED), which phase 8 both runs.
# Each bound lies between its two readings; the layer-14 faults must fail
# `k_rows` and the layer-1 faults `k_early`, on both prompts. The codebook-0
# logits are compared on the TTS prompt only: the ASR path never forms them,
# and at its last (text) position the sound runs read 0.125 / 0.9932.
# Readings in PERF.md.
EARLY_LAYERS = 4
FORMAT_BOUNDS = {**BOUNDS, "k_rows": (8e-2, 0.998), "k_early": (4e-2, 0.9995)}
FRAMES = 128
FORMAT_FRAMES = 16      # frames of each request of phase 8
# Peaks of one H100 SXM (NVIDIA data sheet; dense bf16 tensor-core rate and
# HBM3 bandwidth), for the bound columns.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12        # float32 outside the tensor cores
PEAK_TF32 = 495e12      # TF32 on the tensor cores
PEAK_BYTES = 3.35e12
INT4ALL = ("backbone", "decoder", "understanding_expert", "generation_expert",
           "audio_head", "projection_w")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def phase_device():
    if not (ROOT / "uniaudio2_tpu_torch" / "__init__.py").exists():
        fail("the uniaudio2_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no card to run on")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        fail(f"capability {cap} < (9, 0): the kernels are built for sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[1] device: {torch.cuda.get_device_name(0)} capability {cap} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return torch.device("cuda:0"), card


def phase_build():
    from uniaudio2_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib = _cuda.build()
    _cuda.lib()
    nvcc_s = _cuda.build_info["seconds"]
    how = (f"nvcc {nvcc_s:.2f} s" if nvcc_s is not None
           else "already built from these sources")
    print(f"[2] {Path(lib).name} ready in {time.perf_counter() - t0:.2f} s "
          f"({how})", flush=True)
    kernel, flash, flash32, tile, up, splitk, ring = "", {}, {}, {}, {}, {}, {}
    for line in _cuda.build_info["log"].splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line and " 0 bytes spill" not in line:
            print(f"[2] {kernel[:72]}: {line.strip()}", flush=True)
        for forms, pattern in (
                (flash, r"flash_attn_kernelILi(\d+)ELb(\d)ELi(\d)E"),
                (flash32, r"flash_f32_(tc|simt)_kernelILi(\d+)EE"),
                (tile, r"gemv_tc_kernelILi(\d)ELb(\d)E"),
                (up, r"swiglu_tc_kernelILi(\d)ELb(\d)E"),
                (splitk, r"gemv_splitk_kernelILi(\d)ELb(\d)ELi(\d)E"),
                (ring, r"gemv_stream_kernelILi(\d)ELi(\d+)ELi(\d+)ELi(\d)ELi(\d)E")):
            form = re.search(pattern, kernel)
            got = form and re.search(
                r"Used (\d+) registers|(\d+) bytes spill stores", line)
            if got:
                key = "registers" if got.group(1) else "spill stores"
                forms.setdefault(form.groups(), {})[key] = int(
                    got.group(1) or got.group(2))
    for (hd, causal, nc), got in sorted(flash.items()):
        print(f"[2] flash_attn_kernel<HD {hd}, causal {causal}, {nc} consumer "
              f"warpgroups>: {got.get('registers')} registers, "
              f"{got.get('spill stores')} bytes of spill stores", flush=True)
    for (kind, hd), got in sorted(flash32.items()):
        print(f"[2] flash_f32_{kind}_kernel<HD {hd}>: "
              f"{got.get('registers')} registers, {got.get('spill stores')} "
              f"bytes of spill stores", flush=True)
    names = {"0": "INT8", "1": "I4", "2": "K4", "3": "C4"}
    for (layout, grouped), got in sorted(tile.items()):
        print(f"[2] gemv_tc_kernel<layout {names[layout]}, grouped {grouped}>: "
              f"{got.get('registers')} registers, {got.get('spill stores')} "
              f"bytes of spill stores", flush=True)
    for (layout, grouped), got in sorted(up.items()):
        print(f"[2] swiglu_tc_kernel<layout {names[layout]}, grouped {grouped}> "
              f"(the fused SwiGLU's tile pass 1): {got.get('registers')} "
              f"registers, {got.get('spill stores')} bytes of spill stores",
              flush=True)
    modes = {"0": "GEMV", "1": "SwiGLU pass 1", "2": "SwiGLU pass 2",
             "3": "QKV", "4": "GEMV wide"}
    for (layout, grouped, mode), got in sorted(splitk.items()):
        print(f"[2] gemv_splitk_kernel<layout {names[layout]}, grouped "
              f"{grouped}, {modes[mode]}>: {got.get('registers')} registers, "
              f"{got.get('spill stores', 0)} bytes of spill stores", flush=True)
    unpacks = {"0": "shift", "1": "magic"}
    for (layout, tn, bk, stages, unpack), got in sorted(ring.items()):
        print(f"[2] gemv_stream_kernel<layout {names[layout]}, TN {tn}, BK {bk}, "
              f"{stages} stages, {unpacks[unpack]}> (rows 11 and 13's TMA "
              f"ring): {got.get('registers')} registers, "
              f"{got.get('spill stores', 0)} bytes of spill stores", flush=True)
    if _cuda.build_info["log"] and len(ring) != 11:
        fail(f"ptxas reported {len(ring)} of the 11 TMA-ring kernels (row "
             f"11's I4 form, row 13's ten K4 instances)")
    if _cuda.build_info["log"] and (len(flash), len(flash32), len(tile),
                                    len(up), len(splitk)) != (4, 4, 7, 5, 21):
        fail(f"ptxas reported {len(flash)} of the 4 bf16 flash kernels, "
             f"{len(flash32)} of the 4 float32 ones (3xTF32 and SIMT, hd 64 "
             f"and 128), {len(tile)} of the 7 "
             f"tile kernels (C4, I4 and K4 per channel and grouped, INT8), "
             f"{len(up)} of the 5 pass-1 tile kernels of the fused SwiGLU "
             f"(I4 and K4 per channel and grouped, INT8) and "
             f"{len(splitk)} of the 21 split-K kernels (the GEMV: I4 and K4 "
             f"per channel and grouped, INT8; the int8 wide-N GEMV; the fused "
             f"SwiGLU's pass 1: I4 and K4 per channel and grouped, INT8; its "
             f"pass 2: I4 and C4 per channel and grouped, INT8; the QKV step: "
             f"I4 and K4 per channel and grouped, INT8)")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, peak=PEAK_BF16):
    """Least time on the card (ms) and what sets it: the bytes the call must
    move at PEAK_BYTES or its operations at ``peak``, the larger."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# Rows of the kernels line: one per kernel and weight form. A name without
# a colon is the kernel's first ported form (row-interleaved per-channel
# int4 for the fused kernels).
GEMV_ROWS = {"int8": "int8_matmul", "int4i": "int4i_matmul",
             "int4ig": "int4i_matmul:int4ig", "int4": "int4_matmul",
             "int4g": "int4g_matmul", "int4c": "int4c_matmul",
             "int4cg": "int4cg_matmul"}


def qkv_row(form):
    return "qkv_rope_step" if form == "int4i" else f"qkv_rope_step:{form}"


def swiglu_row(form):
    return "fused_swiglu" if form == "int4i+int4i" else f"fused_swiglu:{form}"


# The row of the fused SwiGLU's tile passes above 16 rows (every form),
# counted by their pass-1 kernel (`fused_mlp.swiglu_tc`)
SWIGLU_TILE = "fused_swiglu:tile"


def make_weight(torch, gen, dev, form, k, n):
    """A random (k, n) weight in the container of ``form`` (the JAX
    package's mode names), groups of `quant.INT4_GROUP` rows."""
    from uniaudio2_tpu_torch.ops import quant

    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    if form == "int8":
        return quant.quantize(w)
    q = {"int4": quant.quantize4, "int4i": quant.quantize4,
         "int4c": quant.quantize4_cols, "int4g": quant.quantize4_grouped,
         "int4ig": quant.quantize4_grouped,
         "int4cg": quant.quantize4_cols_grouped}[form](w)
    return quant.to_interleaved(q) if form in ("int4i", "int4ig") else q


def weight_bytes(w):
    """Bytes a kernel must read of ``w``: its true columns and its scale."""
    n = w.scale.shape[-1]
    cols = n - n // 2 if type(w).__name__.startswith("QuantizedLinearC4") else n
    return w.values.shape[0] * cols + nbytes(w.scale)


def sdpa_backend(torch, q, k, v):
    """The CUDA kernels one SDPA call launches (names the backend)."""
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as p:
        torch.nn.functional.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    names = {e.name for e in p.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return ", ".join(sorted(n[:60] for n in names)) or "no kernel traced"


def phase_kernels(torch, dev):
    """Each kernel against its twin at the serving path's shapes. Returns
    {kernel: row} where the row holds the worst max_abs_err over every case
    and, at the kernel's reference case, the kernel's and the twin's time,
    the bound on the card and the library call's time (or None)."""
    from uniaudio2_tpu_torch.ops import (
        _cuda, flash_attention, fused_mlp, int4_native, int4_stacked,
        int4_stream, int4_sweep, qkv_step, quant, splitk_gemv,
    )
    from uniaudio2_tpu_torch.probes import (
        FlushedTimer, int4_native_probe, int4_tinygemm, profile_gemv,
        profile_scan_slice, sweep_gemv_blocks,
    )

    gen = torch.Generator(device=dev).manual_seed(1234)
    timer = FlushedTimer(dev)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    results = {}

    def check(kernel, label, run, plain, case=None, library=None, row=False,
              rtol=RTOL, per_row=False, also=None):
        """``case`` = (bytes, flops) of the call, for its bound; ``library``
        is one PyTorch call of the same function; ``row`` marks the case
        the kernel's row of the kernels line reports. ``per_row`` holds
        each output row (last axis) to ``rtol`` x its own max|twin|.
        ``also`` = (row name, whether this is its case): a second row of
        the kernels line that this case reports to."""
        out, ref = run(), plain()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = 0.0
        for o, r in zip(outs, refs):
            if o.shape != r.shape or o.dtype != r.dtype:
                fail(f"{kernel} {label}: {o.shape}/{o.dtype} vs {r.shape}/{r.dtype}")
            if not bool(torch.isfinite(o.float()).all()):
                fail(f"{kernel} {label}: non-finite output")
            d, mag = (o.float() - r.float()).abs(), r.float().abs()
            e = d.max().item()
            if per_row:
                worst = (d.amax(-1) / mag.amax(-1)).max().item()
                if not worst <= rtol:
                    fail(f"{kernel} {label}: a row's max_abs_err is "
                         f"{worst:.4g} x its max|twin| > {rtol:.4g}")
                row_err = f" worst row {worst:.3e} x max|twin row|"
            else:
                tol = rtol * mag.max().item()
                if e > tol:
                    fail(f"{kernel} {label}: max_abs_err {e:.4g} > {tol:.4g}")
                row_err = ""
            err = max(err, e)
        ms, plain_ms = timer(run), timer(plain)
        lib_ms = None if library is None else timer(library)
        extra = "" if lib_ms is None else f" library {lib_ms:.4f} ms"
        if case is not None:
            bound_ms, bound_by = bound(*case)
            extra += f" bound {bound_ms:.4f} ms ({bound_by})"
        for name, is_row in [(kernel, row)] + ([also] if also else []):
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if is_row:
                entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms)
                extra += " [row]" if name == kernel else f" [row {name}]"
        print(f"[3] {kernel:27s} {label:34s} max_abs_err {err:.3e}{row_err} "
              f"(tol {rtol:.3g} x max|twin{' row' if per_row else ''}|) "
              f"kernel {ms:.4f} ms twin "
              f"{plain_ms:.4f} ms{extra}", flush=True)
        return ms, lib_ms

    # the fused QKV step, every mode; row: the backbone's at M = 1. Up to
    # quant.SPLITK_MAX_M rows (the frame loop: 1, 2, 8, 16) it runs the
    # split-K kernel's QKV mode: each case also through the first design
    # (`qkv_rope_step_tiled`, its bits held to the twin too), timed beside
    # it (kernel, tiled, tiled, kernel: the lesser of each pair), with the
    # plan and the share of the bound. 63 rows (the bucket-64 prefill): the
    # first design serves.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qkv_times = {}
    for form in ("int4i", "int8", "int4", "int4g", "int4ig"):
        for m in (1, 2, 8, 16, 63):
            for name, (k, h, g, hd) in (("backbone", (3072, 24, 8, 128)),
                                        ("decoder", (2048, 32, 8, 64))):
                n = (h + 2 * g) * hd
                w = make_weight(torch, gen, dev, form, k, n)
                x, nw = bf16(m, k), bf16(k)
                ang = torch.rand(hd // 2, generator=gen, device=dev) * 6.0
                cos, sin = (torch.cos(torch.cat([ang, ang])),
                            torch.sin(torch.cat([ang, ang])))
                args = (x, w, nw, 1e-5, cos, sin, h, g, hd)
                case = (nbytes(x, nw, cos, sin) + weight_bytes(w) + 2 * m * n,
                        2 * m * k * n)                    # q, k, v out: bf16
                run = lambda: qkv_step.qkv_rope_step(*args)
                ms, _ = check(qkv_row(form), f"{name} {k}->{n} M={m}", run,
                              lambda: qkv_step.qkv_rope_step_plain(*args),
                              case, row=m == 1 and name == "backbone")
                if m > quant.SPLITK_MAX_M:
                    continue
                tiled = lambda: qkv_step.qkv_rope_step_tiled(*args)
                refs = qkv_step.qkv_rope_step_plain(*args)
                for o, r in zip(tiled(), refs):
                    err = (o.float() - r.float()).abs().max().item()
                    if err > RTOL * r.float().abs().max().item():
                        fail(f"qkv_rope_step_tiled {form} {name} M={m}: "
                             f"max_abs_err {err:.4g}")
                tiled_ms = timer(tiled)
                tiled_ms, ms = min(tiled_ms, timer(tiled)), min(ms, timer(run))
                g_ = w.scale.shape[0] if w.scale.ndim == 2 else 0
                plan = quant.gemv_plan(m, k, n, g_, quant.LAYOUTS[type(w)], sms,
                                       qkv_step.QKV_MAX_SPLITS)
                bound_ms = bound(*case)[0]
                qkv_times[(form, name, m)] = (ms, tiled_ms)
                print(f"[3] qkv_rope_step {form} split-K {name} {k}->{n} M={m}: "
                      f"plan S={plan.splits} span={plan.span} "
                      f"({plan.blocks(m, n)} blocks, {sms} SMs): split-K "
                      f"{ms:.4f} ms, first design {tiled_ms:.4f} ms "
                      f"(x{tiled_ms / ms:.2f}); bound {bound_ms:.4f} ms, "
                      f"{bound_ms / ms:.1%} of it", flush=True)
    slower = [key for key, (ms, tiled_ms) in qkv_times.items()
              if ms >= tiled_ms]
    print(f"[3] qkv_rope_step: split-K faster than the first design at "
          f"{len(qkv_times) - len(slower)} of {len(qkv_times)} decode cases; "
          f"not at {slower}", flush=True)

    def yardstick_case(kind, form, label, k, n, m, w, x, kw, case, fn,
                       fn_tiled, lib_ms, rtol, times):
        """A planned kernel (``kind``: "split-K", rows 1, 4, 5 and 6 at a
        decode M, `quant.gemv_plan`; "tile", rows 1, 4, 5, 6, 7 and 8 above
        16 rows, `quant.tc_plan`): its tiled instance held to the twin and timed
        beside it and the library's GEMV (kernel, tiled, tiled, kernel: the
        lesser median of each pair, against a moment of noise in one), the
        plan and the share of the bound, kept in ``times``."""
        out, ref = fn_tiled(x, w.values, w.scale, **kw), quant.matmul_plain(x, w, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if err > rtol * ref.float().abs().max().item():
            fail(f"{form} tiled {label} M={m}: max_abs_err {err:.4g}")
        g = w.scale.shape[0] if w.scale.ndim == 2 else 0
        layout = quant.LAYOUTS[type(w)]
        if kind == "tile":
            plan = quant.tc_plan(m, k, n, g, sms, layout)
            shape = (f"bn={quant.tc_layout().bn} S={plan.splits} "
                     f"span={plan.span}")
            blocks = plan.blocks(m, n, layout)
        else:
            plan = quant.gemv_plan(m, k, n, g, layout, sms,
                                   wide=form == "int8")
            shape = (f"S={plan.splits} MT={plan.mt} tile={plan.tile} "
                     f"span={plan.span}")
            blocks = plan.blocks(m, n)
        if lib_ms is None:
            wp, group, sz = int4_tinygemm(w)
            lib_ms = timer(lambda: torch._weight_int4pack_mm(x, wp, group, sz))
        run = lambda: fn(x, w.values, w.scale, **kw)
        run_tiled = lambda: fn_tiled(x, w.values, w.scale, **kw)
        ms, tiled_ms = timer(run), timer(run_tiled)
        tiled_ms, ms = min(tiled_ms, timer(run_tiled)), min(ms, timer(run))
        bound_ms = bound(*case)[0]
        times[(form, label, m)] = (ms, tiled_ms, lib_ms)
        print(f"[3] {form} {kind} {label} {k}->{n} M={m}: plan {shape} "
              f"({blocks} blocks, {sms} SMs): {kind} {ms:.4f} ms, "
              f"tiled {tiled_ms:.4f} ms (x{tiled_ms / ms:.2f}), library GEMV "
              f"{lib_ms:.4f} ms (x{lib_ms / ms:.2f}); bound {bound_ms:.4f} ms, "
              f"{bound_ms / ms:.1%} of it; tiled vs twin {err:.3e}", flush=True)

    splitk_times, rows_tc_times = {}, {}
    # the GEMVs over K-axis-packed weights; row: the projection at M = 1,
    # a plain product, which the library computes too. M = 255 is the
    # prefill of a bucket-256 prompt and 510 its CFG pair, bound by
    # operations. Rows 1, 5 and 6 (int4i, int4ig, int4, int4g) run the
    # split-K kernel up to quant.SPLITK_MAX_M rows: at those M each shape is
    # also timed through the tiled instance and the library call (the GEMV
    # alone: no norm, residual or f32 cast), and the plan printed. Above
    # it rows 1 and 6 (int4i, int4ig, int4g) run the tensor-core tile
    # kernel, held and timed the same way, also at M = 510, at the served
    # QKV call with its norm and at the unfused MLP's shapes (gate / up and,
    # interleaved, the down-projection: alone above 128 rows); so does row 5
    # (int4, configuration D's prefills).
    tiled = {"int4i": quant.int4i_matmul_tiled,
             "int4ig": quant.int4i_matmul_tiled,
             "int4": quant.int4_matmul_tiled,
             "int4g": quant.int4g_matmul_tiled}
    rows_tc = ("int4i", "int4ig", "int4", "int4g")
    shapes = (("attn_proj +res", 3072, 3072, True, False, None),
              ("decoder attn_proj +res", 2048, 2048, True, False, None),
              ("audio_head f32", 2048, 12300, False, False, torch.float32),
              ("projection", 3072, 2048, False, False, None),
              ("prefill qkv", 3072, 5120, False, False, None))
    prefill = (("prefill qkv +norm", 3072, 5120, False, True, None),
               ("mlp gate/up", 3072, 8192, False, False, None),
               ("mlp_proj", 8192, 3072, False, False, None))
    for form in ("int4i", "int4ig", "int4", "int4g"):
        fn = {"int4i": quant.int4i_matmul, "int4ig": quant.int4i_matmul,
              "int4": quant.int4_matmul, "int4g": quant.int4g_matmul}[form]
        ms_list = (1, 2, 8, 16, 63, 255, 510)
        for m in ms_list:
            cases = shapes
            if form in rows_tc and m > quant.SPLITK_MAX_M:
                # the K-split trees' down-projection is column-packed (row 8)
                cases += prefill[:2] if form in ("int4", "int4g") else prefill
            for label, k, n, res, norm, out_dtype in cases:
                w = make_weight(torch, gen, dev, form, k, n)
                x = bf16(m, k)
                kw = dict(out_dtype=out_dtype,
                          residual=bf16(m, n) if res else None,
                          pre_norm=(bf16(k), 1e-5) if norm else None)
                out_bytes = 4 if out_dtype is torch.float32 else 2
                case = (nbytes(x) + weight_bytes(w) + 2 * k * norm
                        + (2 * res + out_bytes) * m * n, 2 * m * k * n)
                library = None
                row = m == 1 and label == "projection"
                if row or (form in tiled and m > quant.SPLITK_MAX_M):
                    # the prefills' kernels beside the library too
                    wp, group, sz = int4_tinygemm(w)

                    def library():
                        return torch._weight_int4pack_mm(x, wp, group, sz)
                grouped = form.endswith("g") and not res
                rtol = RTOL_GROUPED if grouped else RTOL
                _, lib_ms = check(GEMV_ROWS[form], f"{label} {k}->{n} M={m}",
                               lambda: fn(x, w.values, w.scale, **kw),
                               lambda: quant.matmul_plain(x, w, **kw), case,
                               library, row=row, rtol=rtol)
                if form in tiled and m <= quant.SPLITK_MAX_M:
                    yardstick_case("split-K", form, label, k, n, m, w, x, kw,
                                   case, fn, tiled[form], lib_ms, rtol,
                                   splitk_times)
                elif form in rows_tc:
                    yardstick_case("tile", form, label, k, n, m, w, x, kw,
                                   case, fn, tiled[form], lib_ms, rtol,
                                   rows_tc_times)
                if row:
                    lib_err = (library().float() - quant.matmul_plain(
                        x, w).float()).abs().max().item()
                    print(f"[3] {GEMV_ROWS[form]} library _weight_int4pack_mm "
                          f"(groups of {group}) vs twin: max_abs_err "
                          f"{lib_err:.3e}", flush=True)
    slower = [key for key, (ms, tiled_ms, _) in splitk_times.items()
              if ms >= tiled_ms]
    print(f"[3] split-K faster than the tiled instance at "
          f"{len(splitk_times) - len(slower)} of {len(splitk_times)} decode "
          f"cases; not at {slower}", flush=True)
    slower = [key for key, (ms, tiled_ms, _) in rows_tc_times.items()
              if ms >= tiled_ms]
    beats = [key for key, (ms, _, lib_ms) in rows_tc_times.items()
             if ms < lib_ms]
    print(f"[3] rows 1, 5 and 6: tile kernel faster than the tiled instance at "
          f"{len(rows_tc_times) - len(slower)} of {len(rows_tc_times)} cases "
          f"above {quant.SPLITK_MAX_M} rows; not at {slower}; faster than the "
          f"library at {len(beats)} of them; not at "
          f"{[key for key in rows_tc_times if key not in beats]}", flush=True)
    # the column-packed GEMVs (the MLP down-projection): alone they run at a
    # prefill of more than 128 rows (255 and, as the CFG pair, 510), where
    # they launch the tensor-core tile kernel (csrc/gemv_int4_tc.cuh) above
    # quant.SPLITK_MAX_M rows and the tiled instance at 16 rows or fewer;
    # row: the backbone's at M = 255. At every M > 16 also the tiled
    # instance and the library's GEMV, each timed in the same run.
    tc_times = {}
    for form in ("int4c", "int4cg"):
        fn, fn_tiled = {"int4c": (quant.int4c_matmul, quant.int4c_matmul_tiled),
                        "int4cg": (quant.int4cg_matmul,
                                   quant.int4cg_matmul_tiled)}[form]
        rtol = RTOL_GROUPED if form == "int4cg" else RTOL
        for m in (1, 2, 63, 255, 510):
            for label, k, n in (("mlp_proj", 8192, 3072),
                                ("decoder mlp_proj", 8192, 2048)):
                w = make_weight(torch, gen, dev, form, k, n)
                x = bf16(m, k)
                case = (nbytes(x) + weight_bytes(w) + 2 * m * n, 2 * m * k * n)
                library = None
                if m > quant.SPLITK_MAX_M:
                    wp, group, sz = int4_tinygemm(w)

                    def library():
                        return torch._weight_int4pack_mm(x, wp, group, sz)
                _, lib_ms = check(GEMV_ROWS[form], f"{label} {k}->{n} M={m}",
                                  lambda: fn(x, w.values, w.scale),
                                  lambda: quant.matmul_plain(x, w), case,
                                  library, row=m == 255 and label == "mlp_proj",
                                  rtol=rtol)
                if m > quant.SPLITK_MAX_M:
                    yardstick_case("tile", form, label, k, n, m, w, x, {},
                                   case, fn, fn_tiled, lib_ms, rtol, tc_times)
    slower = [key for key, (ms, tiled_ms, _) in tc_times.items()
              if ms >= tiled_ms]
    beats = [key for key, (ms, _, lib_ms) in tc_times.items() if ms < lib_ms]
    print(f"[3] tile kernel faster than the tiled instance at "
          f"{len(tc_times) - len(slower)} of {len(tc_times)} column-packed "
          f"cases above {quant.SPLITK_MAX_M} rows; not at {slower}; faster "
          f"than the library at {len(beats)} of them", flush=True)
    # the fused SwiGLU half-block in the forms the serving trees hold, with
    # the norm and the residual, at the frame loop's M (1, 2, 8, 16: two
    # split-K passes) and the bucket-64 prefill's (63 and the CFG pair's
    # 126: two tile passes), each case beside the first design's two tiled
    # passes, `fused_swiglu_tiled` (its bits held to the twin too), with the
    # plan and the share of the bound. Rows: the backbone's at M = 1, and
    # for the tile passes (SWIGLU_TILE) `int4i+int4i`'s backbone at M = 63.
    swiglu_times = {}
    for up, down in (("int4i", "int4i"), ("int8", "int8"), ("int4", "int4c"),
                     ("int4g", "int4cg"), ("int4ig", "int4ig")):
        form = f"{up}+{down}"
        for m in (1, 2, 8, 16, 63, 126):
            for label, k, i in (("backbone", 3072, 8192),
                                ("decoder", 2048, 8192)):
                w1, w2 = (make_weight(torch, gen, dev, up, k, i)
                          for _ in range(2))
                w3 = make_weight(torch, gen, dev, down, i, k)
                x = bf16(m, k)
                kw = dict(norm_w=bf16(k), residual=bf16(m, k))
                case = (nbytes(x, kw["norm_w"], kw["residual"])
                        + sum(weight_bytes(w) for w in (w1, w2, w3))
                        + 2 * m * k, 6 * m * k * i)
                run = lambda: fused_mlp.fused_swiglu(x, w1, w2, w3, **kw)
                plain = lambda: fused_mlp.fused_swiglu_plain(x, w1, w2, w3, **kw)
                tiled = lambda: fused_mlp.fused_swiglu_tiled(x, w1, w2, w3, **kw)
                tile = m > quant.SPLITK_MAX_M
                also = (SWIGLU_TILE, form == "int4i+int4i" and m == 63
                        and label == "backbone") if tile else None
                ms, _ = check(swiglu_row(form), f"{label} {k}->{i}->{k} M={m}",
                              run, plain, case, row=m == 1 and label == "backbone",
                              also=also)
                ms = min(ms, timer(run))
                bound_ms, by = bound(*case)
                ref = plain().float()
                err = (tiled().float() - ref).abs().max().item()
                if err > RTOL * ref.abs().max().item():
                    fail(f"fused_swiglu_tiled {form} {label} M={m}: "
                         f"max_abs_err {err:.4g}")
                tiled_ms = min(timer(tiled), timer(tiled))
                g12, g3 = (w.scale.shape[0] if w.scale.ndim == 2 else 0
                           for w in (w1, w3))
                shape = (m, k, i, k, g12, quant.LAYOUTS[type(w1)], g3,
                         quant.LAYOUTS[type(w3)], sms)
                plan = fused_mlp.swiglu_plan(*shape)
                swiglu_times[(form, label, m)] = (ms, tiled_ms)
                print(f"[3] fused_swiglu {form} {label} M={m}: plan {plan.kind} "
                      f"S={plan.up.splits} span={plan.up.span} | "
                      f"S={plan.down.splits} span={plan.down.span}: {ms:.4f} "
                      f"ms, two tiled passes {tiled_ms:.4f} ms "
                      f"(x{tiled_ms / ms:.2f}); bound {bound_ms:.4f} ms ({by}), "
                      f"{bound_ms / ms:.1%} of it", flush=True)
    for kind, rows in (("split-K", lambda m: m <= quant.SPLITK_MAX_M),
                       ("tile", lambda m: m > quant.SPLITK_MAX_M)):
        cases = {key: v for key, v in swiglu_times.items() if rows(key[2])}
        slower = [key for key, (ms, tiled_ms) in cases.items()
                  if ms >= tiled_ms]
        print(f"[3] fused_swiglu ({kind} passes) faster than the two tiled "
              f"passes at {len(cases) - len(slower)} of {len(cases)} cases; "
              f"not at {slower}", flush=True)
    # the byte-order pairs above 16 rows: a K-split tree (K-split gate / up,
    # column-packed down) and its interleaved copy, the same levels and
    # scales (`quant.to_interleaved`), get one plan and the same bits: pass
    # 1's h and pass 2's output, plain and with the norm and the residual
    # (calls made to compare, through `fused_mlp._tile_passes`, uncounted)
    for m in (17, 63, 126, 128):
        for label, k, i in (("backbone", 3072, 8192), ("decoder", 2048, 8192)):
            for up, down, twin_form in (("int4", "int4c", "int4i+int4i"),
                                        ("int4g", "int4cg", "int4ig+int4ig")):
                ksplit = (make_weight(torch, gen, dev, up, k, i),
                          make_weight(torch, gen, dev, up, k, i),
                          make_weight(torch, gen, dev, down, i, k))
                inter = tuple(quant.to_interleaved(w) for w in ksplit)
                x = bf16(m, k)
                for folds in ({}, dict(norm_w=bf16(k), residual=bf16(m, k))):
                    got = []
                    for w1, w2, w3 in (ksplit, inter):
                        x2, res2, *_, g12, g3 = fused_mlp._operands(
                            "fused_swiglu", x, w1, w2, w3,
                            folds.get("norm_w"), folds.get("residual"))
                        plan = fused_mlp.swiglu_plan(
                            m, k, i, k, g12, quant.LAYOUTS[type(w1)], g3,
                            quant.LAYOUTS[type(w3)], sms)
                        got.append((plan, *fused_mlp._tile_passes(
                            x2, w1, w2, w3, folds.get("norm_w"), 1e-5, res2,
                            plan)))
                    torch.cuda.synchronize()
                    (pk, ok, hk), (pi, oi, hi) = got
                    dh = (hk.float() - hi.float()).abs().max().item()
                    do = (ok.float() - oi.float()).abs().max().item()
                    same_h, same_out = torch.equal(hk, hi), torch.equal(ok, oi)
                    print(f"[3] byte orders: {up}+{down} vs {twin_form} {label} "
                          f"M={m} {'norm+res' if folds else 'plain'}: plans "
                          f"{'equal' if pk == pi else f'{pk} vs {pi}'}; pass 1 "
                          f"h {'the same bits' if same_h else f'differs, max {dh:.4g}'}"
                          f", pass 2 output "
                          f"{'the same bits' if same_out else f'differs, max {do:.4g}'}",
                          flush=True)
                    if pk != pi or not (same_h and same_out):
                        fail(f"fused_swiglu {up}+{down} and {twin_form} {label} "
                             f"M={m}: not the same bits on the same levels (h "
                             f"{dh:.4g}, output {do:.4g})")
    # row 4, the int8 GEMV (configurations A and B, and the text lm_head in
    # every configuration): at the frame loop's M (1, 2, 8, 16) the split-K
    # kernel (the lm_head's wide-N instance where the plan says), above 16
    # rows (the bucket-64 prefill's 63 and 126, bucket 256's 255 and 510)
    # the tile kernel; each case beside the tiled instance
    # (`int8_matmul_tiled`, held to the twin too) and the library's
    # `torch._weight_int8pack_mm` (bf16 scales and output, the GEMV alone),
    # with the plan and the share of the bound. Row: the lm_head at M = 1.
    int8_times = {}
    for label, k, n, res, norm, out_dtype in (
            ("attn_proj +res", 3072, 3072, True, False, None),
            ("decoder attn_proj +res", 2048, 2048, True, False, None),
            ("projection", 3072, 2048, False, False, None),
            ("audio_head f32", 2048, 12300, False, False, torch.float32),
            ("prefill qkv +norm", 3072, 5120, False, True, None),
            ("lm_head f32", 3072, 128256, False, False, torch.float32)):
        w = make_weight(torch, gen, dev, "int8", k, n)
        w_lib = w.values[:, :n].T.contiguous()     # (N, K) int8 for the library
        s_lib = w.scale.to(torch.bfloat16)
        lm_head = label.startswith("lm_head")
        for m in (1, 2, 8, 16, 63) if lm_head else (1, 2, 8, 16, 63, 126, 255,
                                                    510):
            x = bf16(m, k)
            kw = dict(out_dtype=out_dtype,
                      residual=bf16(m, n) if res else None,
                      pre_norm=(bf16(k), 1e-5) if norm else None)
            out_bytes = 4 if out_dtype is torch.float32 else 2
            case = (nbytes(x) + weight_bytes(w) + 2 * k * norm
                    + (2 * res + out_bytes) * m * n, 2 * m * k * n)

            def library():
                return torch._weight_int8pack_mm(x, w_lib, s_lib)
            _, lib_ms = check(
                "int8_matmul", f"{label} {k}->{n} M={m}",
                lambda: quant.int8_matmul(x, w.values, w.scale, **kw),
                lambda: quant.int8_matmul_plain(x, w.values, w.scale, **kw),
                case, library, row=lm_head and m == 1)
            yardstick_case("split-K" if m <= quant.SPLITK_MAX_M else "tile",
                           "int8", label, k, n, m, w, x, kw, case,
                           quant.int8_matmul, quant.int8_matmul_tiled, lib_ms,
                           RTOL, int8_times)
        del w, w_lib
    slower = [key for key, (ms, tiled_ms, _) in int8_times.items()
              if ms >= tiled_ms]
    beats = [key for key, (ms, _, lib_ms) in int8_times.items() if ms < lib_ms]
    print(f"[3] row 4 (int8): faster than the tiled instance at "
          f"{len(int8_times) - len(slower)} of {len(int8_times)} cases; not at "
          f"{slower}; faster than the library at {len(beats)} of them",
          flush=True)

    def flash_plan_line(shape, case, ms, lib_ms):
        """The host's plan of a flash call and the shares of its bound that
        the kernel and SDPA reach."""
        plan = flash_attention.flash_plan(*shape)
        bk, stages, smem = flash_attention.flash_layout(shape[-1], plan.bq)
        bound_ms, by = bound(*case)
        print(f"[3] flash plan (B, H, G, T, hd) = {shape}: tile {plan.bq} rows "
              f"({plan.bq // 64} consumer warpgroups + a producer warp), "
              f"{bk}-key stages x {stages}, {plan.blocks} blocks on "
              f"{sms} SMs, {smem} B shared; kernel {ms:.4f} ms = "
              f"{bound_ms / ms:.1%} of the {by} bound, SDPA {lib_ms:.4f} ms = "
              f"{bound_ms / lib_ms:.1%} (kernel / SDPA x{ms / lib_ms:.2f})",
              flush=True)

    for b, t in ((2, 186), (2, 374), (2, 750), (2, 130), (1, 130)):
        h, hd = 24, 64
        q, k, v = (bf16(b, h, t, hd) for _ in range(3))
        scale = hd ** -0.5
        case = (nbytes(q, k, v) * 4 // 3, 4 * b * h * t * t * hd)   # + o
        ms, lib_ms = check(
            "flash_attention", f"(B, H, T, hd) = ({b}, {h}, {t}, {hd})",
            lambda: flash_attention.flash_attention(q, k, v, scale),
            lambda: flash_attention.attention_plain(q, k, v, scale), case,
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
            row=(b, t) == (2, 750), per_row=True)  # the 30 s window
        flash_plan_line((b, h, h, t, hd), case, ms, lib_ms)
        print(f"[3] flash_attention T={t}: SDPA ran {sdpa_backend(torch, q, k, v)}",
              flush=True)
    # the float32 form (the codec's default float32 tree) at the same
    # shapes: three TF32 products a product on the tensor cores, its bound
    # that work at the TF32 rate (PEAK_TF32 / 3 of float32 work), beside
    # the first design on the CUDA cores (`flash_attention_f32_simt`, its
    # rows held to the twin too) and its bound at float32's rate outside
    # the tensor cores; TF32 is off, so the twin's products are float32 too
    for b, t in ((2, 186), (2, 374), (2, 750), (2, 130), (1, 130)):
        h, hd = 24, 64
        q, k, v = (torch.randn((b, h, t, hd), generator=gen, device=dev)
                   for _ in range(3))
        scale = hd ** -0.5
        flops = 4 * b * h * t * t * hd
        case = (nbytes(q, k, v) * 4 // 3, 3 * flops, PEAK_TF32)
        ms, lib_ms = check(
            "flash_attention:f32", f"(B, H, T, hd) = ({b}, {h}, {t}, {hd})",
            lambda: flash_attention.flash_attention(q, k, v, scale),
            lambda: flash_attention.attention_plain(q, k, v, scale), case,
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
            row=(b, t) == (2, 750), rtol=RTOL_F32, per_row=True)
        simt = lambda: flash_attention.flash_attention_f32_simt(q, k, v, scale)
        ref = flash_attention.attention_plain(q, k, v, scale)
        d = (simt() - ref).abs().amax(-1) / ref.abs().amax(-1)
        if not d.max().item() <= RTOL_F32:
            fail(f"flash_attention_f32_simt T={t}: a row's max_abs_err is "
                 f"{d.max().item():.4g} x its max|twin|")
        simt_ms = timer(simt)
        simt_ms, ms = min(simt_ms, timer(simt)), min(ms, timer(
            lambda: flash_attention.flash_attention(q, k, v, scale)))
        tc_bound, simt_bound = bound(*case)[0], bound(case[0], flops, PEAK_F32)[0]
        print(f"[3] flash_attention:f32 (B, T) = ({b}, {t}): 3xTF32 {ms:.4f} ms "
              f"= {tc_bound / ms:.1%} of its bound {tc_bound:.4f} ms; SIMT "
              f"{simt_ms:.4f} ms = {simt_bound / simt_ms:.1%} of the float32 "
              f"bound {simt_bound:.4f} ms (x{simt_ms / ms:.2f}); SDPA "
              f"{lib_ms:.4f} ms (x{lib_ms / ms:.2f})", flush=True)
        if t == 750:
            print(f"[3] flash_attention:f32 T={t}: SDPA ran "
                  f"{sdpa_backend(torch, q, k, v)}", flush=True)
    # the causal GQA form: the backbone's prefill probe at T = 2048 (the row)
    # and T = 1000 (a tail tile); the head map reads 8 K/V groups in place.
    # Held row by row: causal row i averages i + 1 values, so late rows are
    # ~sqrt(1 / i) the size of row 0 (a copy of v[0]), and a bound on the
    # whole output's max would not see them.
    for t in (2048, 1000):
        b, h, g, hd = 1, 24, 8, 128
        q, k, v = bf16(b, h, t, hd), bf16(b, g, t, hd), bf16(b, g, t, hd)
        scale = hd ** -0.5
        case = (nbytes(q, k, v) + nbytes(q), 2 * b * h * t * t * hd)
        ms, lib_ms = check(
            "flash_attention:causal", f"(B, H, G, T, hd) = ({b}, {h}, {g}, {t}, {hd})",
            lambda: flash_attention.flash_attention(q, k, v, scale, causal=True),
            lambda: flash_attention.attention_plain(q, k, v, scale, causal=True),
            case, lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            row=t == 2048, per_row=True)
        flash_plan_line((b, h, g, t, hd), case, ms, lib_ms)
    # the split-K int8 GEMV at the GEMV probe's six shapes; row: (3072, 8192).
    # Kernel and twin add exact products in f32 in another order: one bf16
    # ulp. The library call takes bf16 scales.
    for k, n in profile_gemv.SHAPES + profile_gemv.MORE_SHAPES:
        w = quant.quantize(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        x = bf16(1, k)
        w_lib, s_lib = w.values[:, :n].T.contiguous(), w.scale.to(torch.bfloat16)
        check("int8_splitk_gemv", f"(K, N) = ({k}, {n}) M=1",
              lambda: splitk_gemv.int8_splitk_gemv(x, w.values, w.scale),
              lambda: splitk_gemv.int8_splitk_gemv_plain(x, w.values, w.scale),
              (nbytes(x, w.scale) + k * n + 2 * n, 2 * k * n),
              lambda: torch._weight_int8pack_mm(x, w_lib, s_lib),
              row=(k, n) == (3072, 8192), rtol=RTOL_GROUPED)
        del w, w_lib
    def ring_case(row, label, k, n, m, run, simt, splitk, library, times):
        """Rows 11 and 13's TMA-ring kernel timed beside its first design
        (the lesser of its kept forms ``simt``: {name: fn}), the split-K
        wrapper of the same function and bits and the library call
        (kernel, the others, kernel: the lesser of the kernel's two), with
        the plan and the share of the bound, kept in ``times``."""
        ms = timer(run)
        simt_ms = {name: timer(fn) for name, fn in simt.items()}
        splitk_ms, lib_ms = timer(splitk), timer(library)
        ms = min(ms, timer(run))
        best = min(simt_ms, key=simt_ms.get)
        bound_ms = bound(2 * m * (k + n) + 4 * n + k * n // 2, 2 * m * k * n)[0]
        times[(label, k, n, m)] = (ms, simt_ms[best], splitk_ms, lib_ms)
        first = next(iter(simt_ms))
        print(f"[3] {row} ring {label} {k}->{n} M={m}: TMA ring {ms:.4f} ms, "
              f"first design {simt_ms[first]:.4f} ms {first} (x"
              f"{simt_ms[first] / ms:.2f}), its fastest kept form "
              f"{simt_ms[best]:.4f} ms {best} (x{simt_ms[best] / ms:.2f}), "
              f"split-K {splitk_ms:.4f} ms (x{splitk_ms / ms:.2f}), library "
              f"{lib_ms:.4f} ms (x{lib_ms / ms:.2f}); bound {bound_ms:.4f} ms, "
              f"{bound_ms / ms:.1%} of it", flush=True)

    def faster_line(row, times):
        slower = [key for key, (ms, simt_ms, _, _) in times.items()
                  if ms >= simt_ms]
        print(f"[3] {row}: the TMA ring faster than its first design at "
              f"{len(times) - len(slower)} of {len(times)} timed cases; not at "
              f"{slower}", flush=True)

    # row 11, the TMA-ring split-K kernel (I4, its default form), at the
    # int4 probe's shapes and the batched path's M; row: (3072, 8192) at
    # M = 1, row-major. Twin: one bf16 ulp; the two byte orders the same
    # bits; at M <= 16 the bits of quant.int4i_matmul (the split-K kernel
    # on the same plan). The first design (`int4_native_matmul_simt`) the
    # bits of gemv_int4i.cu's tiled instance, which it was written against.
    # Timed beside the first design, the split-K wrapper and the library at
    # (256, 512) (the design's fixed cost) and (3072, 8192), M = 1 and 16.
    native_times = {}
    tiny = torch.zeros(1, device=dev)
    print(f"[3] the timer's floor, one launch of a one-element fill: "
          f"{timer(lambda: tiny.zero_()):.4f} ms", flush=True)
    for k, n in int4_native_probe.SHAPES:
        w = quant.to_interleaved(quant.quantize4(
            torch.randn((k, n), generator=gen, device=dev) * 0.02))
        chunked = int4_native_probe.chunk_major(w.values, 512)
        wp, group, sz = int4_tinygemm(w)
        for m in int4_native_probe.ROWS:
            x = bf16(m, k)
            for label, vals in (("row-major", w.values),
                                ("chunk-major", chunked)):
                row = (k, n, m) == (3072, 8192, 1) and label == "row-major"
                check("int4_native_gemv", f"(K, N) = ({k}, {n}) M={m} {label}",
                      lambda: int4_native.int4_native_matmul(x, vals, w.scale),
                      lambda: int4_native.int4_native_matmul_plain(
                          x, w.values, w.scale),
                      (nbytes(x, w.scale) + k * n // 2 + 2 * m * n,
                       2 * m * k * n),
                      (lambda: torch._weight_int4pack_mm(x, wp, group, sz))
                      if row else None, row=row, rtol=RTOL_GROUPED)
            out = int4_native.int4_native_matmul(x, w.values, w.scale)
            bits = {"chunk-major": torch.equal(out, int4_native.int4_native_matmul(
                        x, chunked, w.scale)),
                    "split-K": torch.equal(out, quant.int4i_matmul(
                        x, w.values, w.scale)),
                    "first design = tiled": torch.equal(
                        int4_native.int4_native_matmul_simt(x, w.values, w.scale),
                        quant.int4i_matmul_tiled(x, w.values, w.scale))}
            print(f"[3] int4_native_gemv (K, N) = ({k}, {n}) M={m}: the same "
                  f"bits: {json.dumps(bits)}", flush=True)
            if not all(bits.values()):
                fail(f"int4_native_gemv (K, N) = ({k}, {n}) M={m}: the bits "
                     f"differ: {bits}")
            if (k, n) != (512, 1024) and m in (1, 16):
                ring_case("int4_native_gemv", "row-major", k, n, m,
                          lambda: int4_native.int4_native_matmul(
                              x, w.values, w.scale),
                          {"simt": lambda: int4_native.int4_native_matmul_simt(
                              x, w.values, w.scale)},
                          lambda: quant.int4i_matmul(x, w.values, w.scale),
                          lambda: torch._weight_int4pack_mm(x, wp, group, sz),
                          native_times)
    faster_line("int4_native_gemv", native_times)
    # row 13, the K-split GEMV's twelve forms at the backbone's qkv and the
    # audio head (a partial last tile), M = 1 and 16: every form and the
    # first design's kept forms against the twin; form 0 the bits of
    # quant.int4_matmul (the split-K K4 kernel on the same plan), the first
    # design's form 0 those of gemv_int4.cu's tiled instance; the host's
    # shared-memory reckoning against the header's. Every form timed at
    # (3072, 5120), M = 1; row: the fastest form there (rechecked as the
    # row). Form 0 timed beside the first design's kept forms, the split-K
    # wrapper and the library at both shapes and M.
    int4_sweep.check_forms()
    fastest, sweep_times = {}, {}
    lib = _cuda.lib()
    for name, k, n in (sweep_gemv_blocks.SHAPES[0], sweep_gemv_blocks.SHAPES[3]):
        w = quant.quantize4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        wp, group, sz = int4_tinygemm(w)
        for m in (1, 16):
            x = bf16(m, k)
            case = (nbytes(x, w.scale) + k * n // 2 + 2 * m * n, 2 * m * k * n)
            for i, form in enumerate(int4_sweep.FORMS):
                splits, span = int4_stream.stream_plan(m, k, n, sms, form)
                smem = int4_stream.smem_bytes(form, m, span)
                if smem != lib.ua2_gemv_int4_stream_smem(
                        form.tn, form.bk, form.stages, m, span):
                    fail(f"int4_stream.smem_bytes disagrees with the header "
                         f"at {form.name} M={m}")
                check("int4_sweep_gemv", f"{name} {k}->{n} M={m} {form.name}",
                      lambda: int4_sweep.int4_sweep_matmul(x, w.values,
                                                           w.scale, i),
                      lambda: int4_sweep.int4_sweep_matmul_plain(
                          x, w.values, w.scale), case, rtol=RTOL_GROUPED)
                if (name, m) == ("bb_qkv", 1):
                    fastest[i] = timer(lambda: int4_sweep.int4_sweep_matmul(
                        x, w.values, w.scale, i))
            for i, form in enumerate(int4_sweep.SIMT_FORMS):
                out = int4_sweep.int4_sweep_matmul_simt(x, w.values, w.scale, i)
                ref = int4_sweep.int4_sweep_matmul_plain(x, w.values, w.scale)
                err = (out.float() - ref.float()).abs().max().item()
                if err > RTOL_GROUPED * ref.float().abs().max().item():
                    fail(f"int4_sweep_matmul_simt {form.name} {name} M={m}: "
                         f"max_abs_err {err:.4g}")
            bits = {"form 0 = split-K": torch.equal(
                        int4_sweep.int4_sweep_matmul(x, w.values, w.scale),
                        quant.int4_matmul(x, w.values, w.scale)),
                    "first design form 0 = tiled": torch.equal(
                        int4_sweep.int4_sweep_matmul_simt(x, w.values, w.scale),
                        quant.int4_matmul_tiled(x, w.values, w.scale))}
            print(f"[3] int4_sweep_gemv {name} {k}->{n} M={m}: the same bits: "
                  f"{json.dumps(bits)}", flush=True)
            if not all(bits.values()):
                fail(f"int4_sweep_gemv {name} M={m}: the bits differ: {bits}")
            ring_case("int4_sweep_gemv", name, k, n, m,
                      lambda: int4_sweep.int4_sweep_matmul(x, w.values, w.scale),
                      {f.name: (lambda i=i: int4_sweep.int4_sweep_matmul_simt(
                          x, w.values, w.scale, i))
                       for i, f in enumerate(int4_sweep.SIMT_FORMS)},
                      lambda: quant.int4_matmul(x, w.values, w.scale),
                      lambda: torch._weight_int4pack_mm(x, wp, group, sz),
                      sweep_times)
            if name == "bb_qkv" and m == 1:
                best = min(fastest, key=fastest.get)
                print(f"[3] int4_sweep_gemv {name} M=1 forms (ms): "
                      f"{json.dumps({int4_sweep.FORMS[i].name: t for i, t in fastest.items()})}",
                      flush=True)
                check("int4_sweep_gemv",
                      f"{name} {k}->{n} M=1 {int4_sweep.FORMS[best].name} (fastest)",
                      lambda: int4_sweep.int4_sweep_matmul(x, w.values,
                                                           w.scale, best),
                      lambda: int4_sweep.int4_sweep_matmul_plain(
                          x, w.values, w.scale), case,
                      lambda: torch._weight_int4pack_mm(x, wp, group, sz),
                      row=True, rtol=RTOL_GROUPED)
                results["int4_sweep_gemv"]["form"] = int4_sweep.FORMS[best].name
    faster_line("int4_sweep_gemv", sweep_times)
    # row 14, the stacked-layer GEMV with the layer index read on the card,
    # on the scan-slice probe's (28, 3072, 8192) stack: every layer the bits
    # of the production K-split kernel on its slice; row: layer 27, against
    # the twin (one bf16 ulp) and the library on the layer's slice.
    stacked, layers = profile_scan_slice.weights(dev)
    n_layers, k = stacked.values.shape[0], 2 * stacked.values.shape[1]
    n = stacked.scale.shape[1]
    index = torch.arange(n_layers, dtype=torch.int32, device=dev)
    x = bf16(1, k)
    same = [torch.equal(int4_stacked.int4_stacked_matmul(x, stacked,
                                                         index[l:l + 1]),
                        quant.int4_matmul_tiled(x, w.values, w.scale))
            for l, w in enumerate(layers)]
    print(f"[3] int4_stacked_gemv (L, K, N) = ({n_layers}, {k}, {n}) M=1: "
          f"the bits of gemv_int4.cu's tiled instance on every layer's slice: "
          f"{all(same)} ({sum(same)} of {n_layers})", flush=True)
    if not all(same):
        fail("int4_stacked_gemv does not give the bits of gemv_int4.cu's "
             "tiled instance")
    last = n_layers - 1
    wp, group, sz = int4_tinygemm(layers[last])
    check("int4_stacked_gemv",
          f"(L, K, N) = ({n_layers}, {k}, {n}) M=1 layer {last}",
          lambda: int4_stacked.int4_stacked_matmul(x, stacked,
                                                   index[last:last + 1]),
          lambda: int4_stacked.int4_stacked_matmul_plain(x, stacked,
                                                         index[last:last + 1]),
          (nbytes(x, layers[last].scale, index[:1]) + k * n // 2 + 2 * n,
           2 * k * n),
          lambda: torch._weight_int4pack_mm(x, wp, group, sz),
          row=True, rtol=RTOL_GROUPED)
    del stacked, layers, wp
    lean_cases(torch, dev, gen, timer, results)
    return results


# Full-width leaves of the train step's fused update: one layer's fc1_w,
# the stacked norm gains, the understanding expert's stacked qkv_w,
# audio_embeddings, and the largest leaf (the backbone's stacked fc1_w),
# which is the kernels line's row.
LEAN_SHAPES = ((3072, 8192), (28, 3072), (3, 3072, 5120), (98400, 3072),
               (28, 3072, 8192))
LEAN_ROW = (28, 3072, 8192)


def lean_args(torch, dev, gen, shape):
    """Inputs of one leaf's fused update: bf16 g and p, the int8 moment and
    its block scales, and rsqrt factors of a plausible size."""
    nsb = shape[-1] // 256
    return ((torch.randn(shape, generator=gen, device=dev) * 1e-3).bfloat16(),
            torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8),
            torch.rand(shape[:-1] + (nsb,), generator=gen, device=dev) * 1e-5,
            (torch.randn(shape, generator=gen, device=dev) * 0.02).bfloat16(),
            torch.rand(shape[:-1], generator=gen, device=dev) + 0.5,
            torch.rand(shape[:-2] + shape[-1:], generator=gen, device=dev) * 1e-3)


def lean_cases(torch, dev, gen, timer, results):
    """The fused lean update against its twin, both on the card: every
    output must be bit-identical."""
    from uniaudio2_tpu_torch.ops import lean_update as lu

    kw = dict(b1=0.9, wd=0.01, eps=1e-8)
    scalars = (1.0 / (1.0 - 0.9 ** 3), 3e-4)          # inv_mc at step 3, lr
    entry = results.setdefault("lean_update", {"max_abs_err": 0.0})
    for shape in LEAN_SHAPES:
        args = lean_args(torch, dev, gen, shape)

        def run():
            return lu.fused_lean_update(*args, *scalars, **kw)

        def plain():
            return lu.fused_lean_update_plain(*args, *scalars, **kw)

        out, ref = run(), plain()
        torch.cuda.synchronize()
        diffs = [int((o != r).sum()) for o, r in zip(out, ref)]
        err = max((o.float() - r.float()).abs().max().item()
                  for o, r in zip(out, ref))
        if any(diffs):
            fail(f"lean_update {shape}: kernel != twin, mismatches "
                 f"(upd, m_q, m_scale) = {diffs}, max_abs_err {err:.3e}")
        ms, plain_ms = timer(run), timer(plain, reps=5)
        n = args[0].numel()
        # g, m_q, p read and upd, m_q' written (8 B an element); the block
        # scales read and written, the rsqrt factors read once; ~14 float32
        # operations an element (3 FMAs, 2 divisions) off the tensor cores
        n_bytes = 8 * n + nbytes(args[2]) * 2 + nbytes(args[4], args[5])
        bound_ms, bound_by = bound(n_bytes, 14 * n, PEAK_F32)
        row = shape == LEAN_ROW
        if row:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        print(f"[3] lean_update     {str(shape):34s} mismatches {diffs} "
              f"(bit-identical required) kernel {ms:.4f} ms twin "
              f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), "
              f"{n_bytes / ms / 1e6:.0f} GB/s; library none{' [row]' if row else ''}",
              flush=True)
        del args, out, ref


def build_model(torch, dev):
    """The seeded bf16 tree (kept for phase 8) and its int4all serving
    form."""
    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.ops import quant

    cfg = UnifiedModelConfig()
    t0 = time.perf_counter()
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(0)
        base = unified.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
        before = torch.cuda.memory_allocated()
        params = unified.prepare_serving_params(
            quant.quantize_unified_params(base, int4_modules=INT4ALL))
    torch.cuda.synchronize()
    print(f"[4] full UnifiedModelConfig int4all serving params in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{(torch.cuda.memory_allocated() - before) / 2 ** 30:.2f} GiB on the "
          f"card beside the {before / 2 ** 30:.2f} GiB bf16 tree", flush=True)
    return cfg, base, params


def prompts(cfg):
    import numpy as np
    from uniaudio2_tpu_torch.engine import tasks

    prompt = np.arange(1, 24, dtype=np.int64) % 100       # bench.py's TTS
    text = np.arange(5, 17, dtype=np.int64) % 100
    tts = tasks.prepare_tts(prompt, text, cfg.tokens)
    neg = tasks.prepare_tts_cfg_negative(prompt, text, cfg.tokens)
    rng = np.random.default_rng(0)                        # bench.py's ASR
    asr = tasks.prepare_asr(np.arange(1, 12, dtype=np.int64) % 100,
                            rng.integers(0, 100, (10, 8)),
                            rng.integers(0, 200, (24, 8)), cfg.tokens)
    return tts, neg, asr


def counters():
    """Row of the kernels line -> (wrapper, form or None for a wrapper of
    one form)."""
    from uniaudio2_tpu_torch.ops import fused_mlp, qkv_step, quant

    rows = {"int8_matmul": (quant.int8_matmul, None),
            "int4i_matmul": (quant.int4i_matmul, "int4i"),
            "int4i_matmul:int4ig": (quant.int4i_matmul, "int4ig"),
            "int4_matmul": (quant.int4_matmul, None),
            "int4g_matmul": (quant.int4g_matmul, None),
            "int4c_matmul": (quant.int4c_matmul, None),
            "int4cg_matmul": (quant.int4cg_matmul, None)}
    for form in ("int4i", "int8", "int4", "int4g", "int4ig"):
        rows[qkv_row(form)] = (qkv_step.qkv_rope_step, form)
    for form in ("int4i+int4i", "int8+int8", "int4+int4c", "int4g+int4cg",
                 "int4ig+int4ig"):
        rows[swiglu_row(form)] = (fused_mlp.fused_swiglu, form)
    rows[SWIGLU_TILE] = (fused_mlp.swiglu_tc, None)
    return rows


def reset_counts():
    from uniaudio2_tpu_torch.ops import _cuda, quant

    for fn, _ in counters().values():
        _cuda.reset_count(fn)
    _cuda.reset_count(quant.gemv_tc)


def read_counts():
    """Launches by row since `reset_counts`; fails on a form no row lists."""
    rows = counters()
    got = {name: fn.launches if form is None else fn.forms.get(form, 0)
           for name, (fn, form) in rows.items()}
    for fn in {fn for fn, _ in rows.values()}:
        listed = {form for f, form in rows.values() if f is fn}
        extra = set(fn.forms) - listed
        if extra:
            fail(f"{fn.__name__} launched forms no row lists: {extra}")
    return got


# The fused SwiGLU's launches at a prefill (17-128 rows: the tile passes
# serve there), by row, of every request `expected_launches` was asked for:
# the prefills' share of that row's launches, which the counted launches
# match in total.
PREFILL_SWIGLU = {}


def expected_launches(cfg, params, mode: str, frames: int, prefill_rows: int):
    """Kernel launches of one request over the serving tree ``params``, by
    row, for ``frames`` frames run on the device (the engine's
    ``last_frames_run``: the eager loop's frames, or the graph path's
    warm-up frames and replays): each launch goes to the kernel and form
    of its weight's container.
    Prefill of the 3 + 28 + 2 expert and backbone layers: QKV and attn_proj
    GEMVs and, up to 128 rows, the fused MLP (its tile passes above 16
    rows), else gate, up and down GEMVs.
    Then per frame every layer's QKV step, attn_proj (+residual) and fused
    MLP; audio frames add the 4-layer decoder x 8 codebooks, 8 audio heads
    and the projection; text frames add the lm_head."""
    from uniaudio2_tpu_torch.ops.fused_mlp import FORMS
    from uniaudio2_tpu_torch.ops.quant import SPLITK_MAX_M

    def gemv(w):
        return GEMV_ROWS[FORMS[type(w)]]

    want = dict.fromkeys(counters(), 0)
    ncb = cfg.tokens.num_codebooks
    steps = {"understanding_expert": frames, "backbone": frames,
             "generation_expert": frames,
             "decoder": ncb * frames if mode == "audio" else 0}
    for sub, n in steps.items():
        for layer in params[sub]["layers"]:
            qkv, proj = layer["qkv_w"], layer["attn_proj_w"]
            up, down = layer["fc1_w"], layer["mlp_proj_w"]
            mlp = swiglu_row(f"{FORMS[type(up)]}+{FORMS[type(down)]}")
            want[qkv_row(FORMS[type(qkv)])] += n
            want[gemv(proj)] += n
            want[mlp] += n
            if sub == "decoder":
                continue                      # the prefill skips the decoder
            want[gemv(qkv)] += 1
            want[gemv(proj)] += 1
            if prefill_rows <= 128:
                want[mlp] += 1
                PREFILL_SWIGLU[mlp] = PREFILL_SWIGLU.get(mlp, 0) + 1
                if prefill_rows > SPLITK_MAX_M:
                    want[SWIGLU_TILE] += 1
            else:
                want[gemv(up)] += 2
                want[gemv(down)] += 1
    if mode == "audio":
        for head in params["audio_head"]:
            want[gemv(head)] += frames
        want[gemv(params["projection_w"])] += frames
    else:
        want[gemv(params["backbone"]["lm_head_w"])] += frames
    return want


# The weight forms whose GEMV runs the tensor-core tile kernel above
# quant.SPLITK_MAX_M rows (rows 1, 4, 5, 6, 7 and 8), as `quant.gemv_tc`
# counts them.
TILE_FORMS = ("int4i", "int4ig", "int4", "int4g", "int4c", "int4cg", "int8")


def expected_tile(params, prefill_rows: int):
    """Launches of the tile kernel, by form, in one request over ``params``:
    its prefill's GEMVs of the tile forms (QKV and attn_proj; above 128
    rows gate, up and down; at 17-128 rows the fused MLP's pass 2, the
    down-projection, counted under its form); no decode step has more than
    16 rows."""
    from uniaudio2_tpu_torch.ops.fused_mlp import FORMS
    from uniaudio2_tpu_torch.ops.quant import SPLITK_MAX_M

    want = {}

    def add(w, n=1):
        form = FORMS[type(w)]
        if form in TILE_FORMS:
            want[form] = want.get(form, 0) + n

    for sub in ("understanding_expert", "backbone", "generation_expert"):
        for layer in params[sub]["layers"]:
            add(layer["qkv_w"])
            add(layer["attn_proj_w"])
            if prefill_rows > 128:
                add(layer["fc1_w"], 2)
                add(layer["mlp_proj_w"])
            elif prefill_rows > SPLITK_MAX_M:
                add(layer["mlp_proj_w"])
    return want


def check_tile(tag, want):
    """The tile kernel's launches since `reset_counts` against ``want``."""
    from uniaudio2_tpu_torch.ops import quant

    got = nonzero(quant.gemv_tc.forms)
    print(f"{tag} tile kernel launches {json.dumps(got)} expected "
          f"{json.dumps(nonzero(want))}", flush=True)
    if got != nonzero(want):
        fail(f"{tag} tile kernel launches {got} != the prefills' {want}")


def add_to(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def phase_model(torch, dev, cfg, params):
    import numpy as np
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    (g, m), (ng, nm), (ag, am) = prompts(cfg)
    ts = cfg.tokens
    # warm-up outside the counted run (allocator, cuBLAS / cuRAND set-up)
    DecodeEngine(params, cfg, max_frames=2, buckets=(64,)).generate_audio(
        g, m, temperature=0.9, topk=50, seed=0)
    eng = DecodeEngine(params, cfg, max_frames=FRAMES, buckets=(64,))
    reset_counts()
    want, want_tile = dict.fromkeys(counters(), 0), {}
    runs = (("tts", "audio", dict(use_cfg=False)),
            ("tts_cfg", "audio", dict(use_cfg=True, cfg_scale=1.5,
                                      neg_grid=ng, neg_mask=nm)),
            ("asr", "text", {}))
    for label, mode, kw in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "audio":
            reason, semantic = eng.generate_audio(g, m, temperature=0.9,
                                                  topk=50, seed=1, **kw)
            out = np.concatenate([reason, semantic], axis=1)
            if out.shape[0] != ts.num_codebooks or out.size and (
                    out.min() < 0 or out.max() >= ts.audio_vocab):
                fail(f"{label}: bad audio tokens {out.shape}")
        else:
            out = eng.generate_text(ag, am, temperature=0.9, topk=50, seed=1)
            if out.size and (out.min() < 0
                             or out.max() >= cfg.backbone.padded_vocab_size):
                fail(f"{label}: bad text tokens")
        dt = time.perf_counter() - t0
        n = eng.last_steps
        if n < 1:
            fail(f"{label}: no frame decoded")
        rows = 63 * (2 if kw.get("use_cfg") else 1)
        for k, v in expected_launches(cfg, params, mode, eng.last_frames_run,
                                      rows).items():
            want[k] += v
        add_to(want_tile, expected_tile(params, rows))
        rate = n / dt
        extra = (f", {rate * ts.num_codebooks:.1f} audio tokens/s"
                 if mode == "audio" else "")
        print(f"[4] {label}: {n} frames in {dt:.3f} s = {rate:.2f} frames/s"
              f"{extra}; output {out.shape}", flush=True)
    got = read_counts()
    print(f"[4] launches {json.dumps(nonzero(got))} expected "
          f"{json.dumps(nonzero(want))}", flush=True)
    if got != want:
        fail(f"launch counts {got} != the path's {want}")
    check_tile("[4]", want_tile)
    missing = [k for k in ("qkv_rope_step", "fused_swiglu", SWIGLU_TILE,
                           "int4i_matmul", "int8_matmul") if got[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    print(f"[4] peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return got


def first_frame(torch, cfg, params, grid, mask, device, bucket=64):
    """Prefill + the first frame on ``device`` (kernels on the card, twins on
    the CPU): the text logits, the codebook-0 logits, and the K rows the
    frame wrote into the 28 backbone layers' caches (the QKV + RoPE
    kernel's output, which the logits of a random model barely see). The
    prompt is padded to ``bucket``, so the prefill runs bucket - 1 rows."""
    from uniaudio2_tpu_torch.models import gpt, unified
    from uniaudio2_tpu_torch.ops.kv_cache import init_cache
    from uniaudio2_tpu_torch.ops.quant import matmul

    par = cfg.tokens.parallel_number
    length = grid.shape[0]
    g = torch.zeros((1, bucket, par), dtype=torch.int64)
    msk = torch.zeros((1, bucket, par), dtype=torch.bool)
    g[0, :length] = torch.from_numpy(grid)
    msk[0, :length] = torch.from_numpy(mask)
    g, msk = g.to(device), msk.to(device)
    with torch.no_grad():
        caches = unified.init_caches(cfg, 1, dtype=torch.bfloat16,
                                     seq_len=bucket + 192, as_lists=True,
                                     device=device)
        unified.prefill(params, cfg, g[:, :-1], msk[:, :-1], caches)
        last = length - 1
        h, _ = unified.decode_hidden(
            params, cfg, g[:, last:last + 1], msk[:, last:last + 1], caches,
            torch.full((1,), last, dtype=torch.int64, device=device))
        text = gpt.lm_head(params["backbone"], h, cfg.backbone)
        h0 = matmul(h, params["projection_w"]).to(torch.bfloat16)
        cache = init_cache(cfg.decoder, 1, cfg.tokens.num_codebooks,
                           dtype=torch.bfloat16, device=device)
        dh, _ = gpt.decode_step(params["decoder"], cfg.decoder, h0[:, None],
                                cache, 0)
        cb0 = matmul(dh[:, -1], params["audio_head"][0],
                     out_dtype=torch.float32)
        k_rows = torch.stack([k[0, :, last] for k in caches.backbone.k])
    k_rows = k_rows.float().cpu()
    return {"text": text.float().cpu(), "codebook0": cb0.float().cpu(),
            "k_rows": k_rows, "k_early": k_rows[:EARLY_LAYERS]}


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(to_cpu(v) for v in tree))
    return tree.cpu()


def swap_nibbles(torch, w):
    """``w`` with the two nibbles of every byte swapped: what an int4 kernel
    that took row 2r from the HIGH nibble would compute on ``w``."""
    v = w.values.to(torch.int32) & 0xFF
    v = (((v << 4) | (v >> 4)) & 0xFF).to(torch.uint8).view(torch.int8)
    return type(w)(v.contiguous(), w.scale)


def negate_levels(torch, w):
    """The int8 container ``w`` with every level negated: what an int8
    kernel that read its levels with the wrong sign would compute."""
    return type(w)((-w.values.to(torch.int16)).to(torch.int8).contiguous(),
                   w.scale)


def with_attn_proj(torch, params, subs, only=None):
    """``params`` with every attn_proj leaf of ``subs`` (or only layer
    ``only``) nibble-swapped."""
    out = dict(params)
    for sub in subs:
        gp = dict(params[sub])
        gp["layers"] = [
            dict(lay, attn_proj_w=swap_nibbles(torch, lay["attn_proj_w"]))
            if only is None or i == only else lay
            for i, lay in enumerate(gp["layers"])]
        out[sub] = gp
    return out


def rope_sign_flipped():
    """Within the block, the QKV kernel rotates q and k the wrong way (its
    sin table negated), as a kernel with a sign error in the RoPE epilogue
    would."""
    from uniaudio2_tpu_torch.ops import qkv_step

    orig = qkv_step.qkv_rope_step

    def flipped(x, w, nw, eps, cos, sin, *rest):
        return orig(x, w, nw, eps, cos, -sin, *rest)

    # the wrapper counts its launches on the function its module holds
    flipped.launches, flipped.forms = 0, {}
    return mock.patch.object(qkv_step, "qkv_rope_step", flipped)


def compare(torch, name, a, b):
    """(max|a-b| / max|b|, cosine) of one compared output."""
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        fail(f"{name} not finite")
    rel = (a - b).abs().max().item() / b.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        a.flatten(), b.flatten(), dim=0).item()
    return rel, cos


def rejected(torch, tag, label, got, ref, bounds):
    """Print each compared output of a first frame against ``ref``; return
    the names that fall outside ``bounds``."""
    caught = []
    for name, (rtol, min_cos) in bounds.items():
        rel, cos = compare(torch, name, got[name], ref[name])
        ok = rel <= rtol and cos >= min_cos
        if not ok:
            caught.append(name)
        same = ("" if name.startswith("k_") else ", argmax equal %d" % int(
            (got[name].argmax(-1) == ref[name].argmax(-1)).all()))
        print(f"{tag} {label}: {name} {tuple(got[name].shape)} max_abs_err "
              f"{rel:.4e} x max|ref| (tol {rtol}), cosine {cos:.6f} (min "
              f"{min_cos}){same}{'' if ok else '  REJECTED'}", flush=True)
    return caught


def phase_logits(torch, dev, cfg, params):
    """The first frame through the kernels against the twins, then planted
    faults (controls) that the same comparison must reject. Returns the
    sound run's outputs on the card."""
    import contextlib

    (g, m), _, _ = prompts(cfg)
    t0 = time.perf_counter()
    plain = first_frame(torch, cfg, to_cpu(params), g, m, "cpu")
    t1 = time.perf_counter()
    every = ("understanding_expert", "backbone", "generation_expert", "decoder")
    runs = (
        ("sound", params, contextlib.nullcontext),
        ("control: attn_proj nibbles swapped, every layer",
         with_attn_proj(torch, params, every), contextlib.nullcontext),
        ("control: attn_proj nibbles swapped, backbone layer 14 only",
         with_attn_proj(torch, params, ("backbone",), only=14),
         contextlib.nullcontext),
        ("control: RoPE sign flipped in the QKV kernel", params,
         rope_sign_flipped))
    verdicts, sound = {}, None
    for label, p, ctx in runs:
        with ctx():
            kern = first_frame(torch, cfg, p, g, m, dev)
        if label == "sound":
            sound = kern
        verdicts[label] = rejected(torch, "[5]", label, kern, plain, BOUNDS)
    print(f"[5] twins {t1 - t0:.1f} s on the CPU", flush=True)
    if verdicts["sound"]:
        fail(f"{verdicts['sound']}: kernels and twins disagree")
    missed = [k for k, v in verdicts.items() if k != "sound" and not v]
    if missed:
        fail(f"the comparison passed planted faults: {missed}")
    return sound


# Phase 8's serving configurations, as the JAX CLI spells them: (int4
# modules, grouped scales, row-interleaved layout) and the rows of the
# kernels line each must launch.
INT4 = ("decoder", "audio_head", "projection_w")
FORMATS = {
    "A int8": ((), False, True,
               ("int8_matmul", "qkv_rope_step:int8", "fused_swiglu:int8+int8",
                SWIGLU_TILE)),
    "B int4": (INT4, False, True,
               ("int8_matmul", "int4i_matmul", "qkv_rope_step:int8",
                "qkv_rope_step", "fused_swiglu:int8+int8", "fused_swiglu", SWIGLU_TILE)),
    "C int4allg": (INT4ALL, True, True,
                   ("int8_matmul", "int4i_matmul:int4ig", "qkv_rope_step:int4ig",
                    "fused_swiglu:int4ig+int4ig", SWIGLU_TILE)),
    "D int4all, not interleaved": (
        INT4ALL, False, False,
        ("int8_matmul", "int4_matmul", "int4c_matmul", "qkv_rope_step:int4",
         "fused_swiglu:int4+int4c", SWIGLU_TILE)),
    "E int4allg, not interleaved": (
        INT4ALL, True, False,
        ("int8_matmul", "int4g_matmul", "int4cg_matmul", "qkv_rope_step:int4g",
         "fused_swiglu:int4g+int4cg", SWIGLU_TILE)),
}


def serve(torch, cfg, params, tag, runs):
    """Serve each request of ``runs`` ((name, engine, mode, prefill rows,
    (grid, mask), generate kwargs)); check its tokens and print its frames/s.
    Returns the launches by row against the tree's count, and per request
    (name, frames, seconds, the engine's resolved policy, first position)."""
    import numpy as np

    reset_counts()
    want, want_tile = dict.fromkeys(counters(), 0), {}
    done = []
    for name, engine, mode, rows, (grid, mask), kw in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "audio":
            reason, semantic = engine.generate_audio(
                grid, mask, temperature=0.9, topk=50, seed=1, **kw)
            out = np.concatenate([reason, semantic], axis=1)
            bad = out.shape[0] != cfg.tokens.num_codebooks or out.size and (
                out.min() < 0 or out.max() >= cfg.tokens.audio_vocab)
        else:
            out = engine.generate_text(grid, mask, temperature=0.9, topk=50,
                                       seed=1)
            bad = out.size and (out.min() < 0 or out.max()
                                >= cfg.backbone.padded_vocab_size)
        dt = time.perf_counter() - t0
        n = engine.last_steps
        if bad or n < 1:
            fail(f"{tag} {name}: bad tokens {out.shape} after {n} frames")
        for k, v in expected_launches(cfg, params, mode,
                                      engine.last_frames_run, rows).items():
            want[k] += v
        add_to(want_tile, expected_tile(params, rows))
        print(f"{tag} {name}: {n} frames in {dt:.3f} s = {n / dt:.2f} "
              f"frames/s (prefill of {rows} rows included); output {out.shape}",
              flush=True)
        done.append((name, n, dt, dict(engine.last_policy), grid.shape[0] - 1))
    got = read_counts()
    print(f"{tag} launches {json.dumps(nonzero(got))}", flush=True)
    if got != want:
        fail(f"{tag} launch counts {nonzero(got)} != the tree's {nonzero(want)}")
    check_tile(tag, want_tile)
    return got, done


def serve_format(torch, cfg, params, label, ksplit):
    """Serve the TTS prompt, one CFG pair and the ASR prompt (and, for the
    K-split trees, a bucket-256 prompt alone and as a CFG pair, whose
    512-slot cache takes the int8 KV cache and block-128 reads under
    "auto") from ``params``. Returns the launches."""
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    (g, m), (ng, nm), (ag, am) = prompts(cfg)
    eng = DecodeEngine(params, cfg, max_frames=FORMAT_FRAMES, buckets=(64,))
    cfg_kw = dict(use_cfg=True, cfg_scale=1.5)
    runs = [("tts", eng, "audio", 63, (g, m), {}),
            ("tts_cfg", eng, "audio", 126, (g, m),
             dict(cfg_kw, neg_grid=ng, neg_mask=nm)),
            ("asr", eng, "text", 63, (ag, am), {})]
    if ksplit:
        long_eng = DecodeEngine(params, cfg, max_frames=FORMAT_FRAMES // 2,
                                buckets=(256,))
        (lg, lm), (lng, lnm), _ = bucket_prompts(cfg, 256)
        runs += [("tts bucket 256", long_eng, "audio", 255, (lg, lm), {}),
                 ("tts_cfg bucket 256", long_eng, "audio", 510, (lg, lm),
                  dict(cfg_kw, neg_grid=lng, neg_mask=lnm))]
    got, done = serve(torch, cfg, params, f"[8] {label}:", runs)
    for name, _, _, policy, _ in done:
        if name.endswith("256") and (policy["kv_dtype"] != torch.int8
                                     or policy["attn_block"] != 128):
            fail(f"{label} {name}: auto picked {policy}, not int8 and block 128")
    bucket64_prefills(torch, cfg, params, label, eng)
    if ksplit:
        prefill_seconds(torch, cfg, params, long_eng, label,
                        (("tts bucket 256", lg, lm, None, None),
                         ("tts_cfg bucket 256", lg, lm, lng, lnm)))
    return got


PREFILL_SECONDS = {}     # (configuration, request) -> phase 8's median


def bucket256_prefills(torch, cfg, params, label):
    """`prefill_seconds` of the bucket-256 prompt alone and as a CFG pair
    (255 and 510 prefill rows) through a bucket-256 engine over
    ``params``."""
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    eng = DecodeEngine(params, cfg, max_frames=FORMAT_FRAMES // 2,
                       buckets=(256,))
    (lg, lm), (lng, lnm), _ = bucket_prompts(cfg, 256)
    prefill_seconds(torch, cfg, params, eng, label,
                    (("tts bucket 256", lg, lm, None, None),
                     ("tts_cfg bucket 256", lg, lm, lng, lnm)))


def bucket64_prefills(torch, cfg, params, label, eng=None):
    """`prefill_seconds` of bench's TTS prompt alone and as a CFG pair (63
    and 126 prefill rows: the fused MLP's tile passes) through a bucket-64
    engine over ``params``."""
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    if eng is None:
        eng = DecodeEngine(params, cfg, max_frames=FORMAT_FRAMES,
                           buckets=(64,))
    (g, m), (ng, nm), _ = prompts(cfg)
    prefill_seconds(torch, cfg, params, eng, label,
                    (("tts bucket 64", g, m, None, None),
                     ("tts_cfg bucket 64", g, m, ng, nm)))


def prefill_seconds(torch, cfg, params, eng, label, requests):
    """The host-clock seconds of each request's prefill as ``eng`` runs it
    (its padded grid into a fresh cache of 512 slots), synchronised before
    and after: one warm-up, then the median of three, kept in
    `PREFILL_SECONDS`. These launches are not in the phase's counts."""
    from uniaudio2_tpu_torch.models import unified

    for name, grid, mask, neg_grid, neg_mask in requests:
        g, m, _, _ = eng._pad_grid(grid, mask, neg_grid is not None, neg_grid,
                                   neg_mask)
        caches = eng._caches(g.shape[0], 512)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                unified.prefill(params, cfg, g[:, :-1], m[:, :-1], caches)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rows = g.shape[0] * (g.shape[1] - 1)
        PREFILL_SECONDS[(label, name)] = statistics.median(times[1:])
        print(f"[8] {label}: {name} prefill of {rows} rows: "
              f"{statistics.median(times[1:]):.4f} s (host clock, median of 3 "
              f"after a warm-up: {', '.join(f'{t:.4f}' for t in times)})",
              flush=True)
        # one more under torch.profiler: the device's share of it, and the
        # GEMV kernels' part of the device time
        prof = torch.profiler
        with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                      prof.ProfilerActivity.CUDA]) as p:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                unified.prefill(params, cfg, g[:, :-1], m[:, :-1], caches)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by = {}
        for e in p.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kind = ("tile kernel" if "gemv_tc_kernel" in e.name
                        or "rows_kernel" in e.name else
                        "SwiGLU tile pass 1" if "swiglu_tc_kernel" in e.name else
                        "tiled GEMV" if "gemv_kernel" in e.name else
                        "tiled SwiGLU pass 1" if "swiglu_up_kernel" in e.name
                        else "other")
                n, ms = by.get(kind, (0, 0.0))
                by[kind] = (n + 1, ms + e.device_time / 1e3)
        busy = sum(ms for _, ms in by.values())
        print(f"[8] {label}: {name} prefill profiled: wall {wall:.1f} ms, "
              f"device {busy:.1f} ms (busy share {busy / wall:.3f}); "
              + ", ".join(f"{k} {n} kernels {ms:.2f} ms"
                          for k, (n, ms) in sorted(by.items())), flush=True)
        del caches


def with_layer(params, sub, index, change):
    """``params`` with ``change`` applied to every quantized leaf of layer
    ``index`` of ``sub``."""
    out = dict(params)
    gp = dict(params[sub])
    gp["layers"] = [
        {k: change(k, v) if isinstance(v, tuple) else v for k, v in lay.items()}
        if i == index else lay for i, lay in enumerate(gp["layers"])]
    out[sub] = gp
    return out


# The compared first frames of phase 8: (name, prompt index, bucket).
FORMAT_PROBES = (("tts prompt, bucket 64", 0, 64),
                 ("tts prompt, bucket 256", 0, 256),
                 ("asr prompt, bucket 64", 2, 64))


def first_frames(torch, cfg, dev, p, which=FORMAT_PROBES):
    pr = prompts(cfg)
    return {name: first_frame(torch, cfg, p, *pr[i], dev, bucket)
            for name, i, bucket in which}


def format_bounds(probe):
    return {k: v for k, v in FORMAT_BOUNDS.items()
            if k != "codebook0" or probe.startswith("tts")}


def format_tree(torch, base, label):
    """The serving tree of configuration ``label`` built from ``base``."""
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.ops import quant

    modules, grouped, interleave, _ = FORMATS[label]
    with torch.no_grad():
        return unified.prepare_serving_params(
            quant.quantize_unified_params(base, int4_modules=modules,
                                          grouped=grouped),
            interleave=interleave)


def int4all_tree(torch, dev, cfg, seed):
    """The bf16 tree of ``seed`` and its interleaved int4all serving form."""
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.ops import quant

    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(seed)
        base = unified.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
        return base, unified.prepare_serving_params(
            quant.quantize_unified_params(base, int4_modules=INT4ALL))


def layout_verdicts(torch, cfg, dev, label, params, ref_frames, tag):
    """D against interleaved int4all / E against C on every probe, then the
    two planted faults of ``label``'s layout, each in backbone layer 14
    (which all layers' K rows must reject) and layer 1 (the early layers'
    K rows must). Returns {comparison: the outputs out of bounds}."""
    letter = label[0]
    ref = "int4all" if letter == "D" else "C"
    verdicts = {}
    for probe, out in first_frames(torch, cfg, dev, params).items():
        verdicts[f"{tag}{letter} vs {ref}, {probe}"] = rejected(
            torch, "[8]", f"{tag}{label} vs {ref} (interleaved), {probe}",
            out, ref_frames[probe], format_bounds(probe))
    if letter == "D":
        what = "K-split halves swapped in the attn_proj of backbone layer"
        change = lambda k, v: (swap_nibbles(torch, v)
                               if k == "attn_proj_w" else v)
    else:
        what = "group scales shifted by one group in backbone layer"
        change = lambda k, v: type(v)(
            v.values, torch.roll(v.scale, 1, 0).contiguous())
    for layer, must in ((14, "k_rows"), (1, "k_early")):
        bad = with_layer(params, "backbone", layer, change)
        for probe, out in first_frames(torch, cfg, dev, bad,
                                       FORMAT_PROBES[::2]).items():
            fault = f"control: {tag}{what} {layer}, {probe}"
            caught = rejected(torch, "[8]", fault, out, ref_frames[probe],
                              format_bounds(probe))
            verdicts[fault] = [k for k in caught if k == must]
        del bad
    return verdicts


def int8_verdicts(torch, cfg, dev, label, params):
    """Configuration A (int8: row 4 serves every projection outside the
    fused QKV and MLP steps, the lm_head, and every prefill GEMV) against
    its CPU twins on the TTS prompt's first frame under BOUNDS, then a
    planted fault that the same comparison must reject: backbone layer 14's
    attn_proj with its int8 levels negated."""
    (g, m), _, _ = prompts(cfg)
    t0 = time.perf_counter()
    plain = first_frame(torch, cfg, to_cpu(params), g, m, "cpu")
    print(f"[8] {label}: twins {time.perf_counter() - t0:.1f} s on the CPU",
          flush=True)
    verdicts = {"A vs the CPU twins": rejected(
        torch, "[8]", f"{label} vs the CPU twins",
        first_frame(torch, cfg, params, g, m, dev), plain, BOUNDS)}
    what = "control: A, int8 attn_proj levels negated in backbone layer 14"
    bad = with_layer(params, "backbone", 14, lambda k, v: (
        negate_levels(torch, v) if k == "attn_proj_w" else v))
    verdicts[what] = rejected(torch, "[8]", what,
                              first_frame(torch, cfg, bad, g, m, dev), plain,
                              BOUNDS)
    return verdicts


def phase_formats(torch, dev, cfg, base, int4all, sound64):
    """Phase 8: every other serving configuration from the bf16 tree
    ``base``. ``int4all`` is phase 4's tree and ``sound64`` its first frame
    on the card (phase 5). Then the layout comparisons and their planted
    faults again on the trees of a second seed. Returns the launches by
    row, summed, and the second seed's int4all tree (for phase 9)."""
    from uniaudio2_tpu_torch.ops import quant

    (g, m), _, _ = prompts(cfg)
    total = dict.fromkeys(counters(), 0)
    # configuration letter -> probe name -> outputs
    frames = {"int4all": {FORMAT_PROBES[0][0]: sound64,
                          **first_frames(torch, cfg, dev, int4all,
                                         FORMAT_PROBES[1:])}}
    verdicts = {}
    bucket64_prefills(torch, cfg, int4all, "int4all (phase 4's tree)")
    bucket256_prefills(torch, cfg, int4all, "int4all (phase 4's tree)")
    for label, (_, _, interleave, need) in FORMATS.items():
        letter = label[0]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = format_tree(torch, base, label)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        scales = sum(v.scale.numel() * 4 for sub in (
            "backbone", "decoder", "understanding_expert", "generation_expert")
            for lay in params[sub]["layers"] for v in lay.values()
            if isinstance(v, quant.GROUPED))
        print(f"[8] {label}: serving params in {time.perf_counter() - t0:.1f} s, "
              f"{held / 2 ** 30:.2f} GiB on the card beside the bf16 embeddings "
              f"they share with the bf16 tree ({scales / 2 ** 30:.3f} GiB of it "
              f"the layers' group scales)", flush=True)
        torch.cuda.reset_peak_memory_stats()
        got = serve_format(torch, cfg, params, label, ksplit=not interleave)
        print(f"[8] {label}: peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
              f" GiB (the bf16 tree and phase 4's int4all tree included)",
              flush=True)
        missing = [k for k in need if got[k] == 0]
        if missing:
            fail(f"{label}: kernels never launched: {missing}")
        for k, v in got.items():
            total[k] += v
        if letter == "A":
            verdicts.update(int8_verdicts(torch, cfg, dev, label, params))
        if letter == "C":
            bucket256_prefills(torch, cfg, params, label)
            t0 = time.perf_counter()
            plain = first_frame(torch, cfg, to_cpu(params), g, m, "cpu")
            print(f"[8] {label}: twins {time.perf_counter() - t0:.1f} s on the "
                  f"CPU", flush=True)
            frames["C"] = first_frames(torch, cfg, dev, params)
            verdicts["C vs the CPU twins"] = rejected(
                torch, "[8]", f"{label} vs the CPU twins",
                frames["C"][FORMAT_PROBES[0][0]], plain, BOUNDS)
        if letter in "DE":
            ref = frames["int4all" if letter == "D" else "C"]
            verdicts.update(layout_verdicts(torch, cfg, dev, label, params,
                                            ref, ""))
        del params
        torch.cuda.empty_cache()
    for bucket, rows in ((64, "63 / 126"), (256, "255 / 510")):
        print(f"[8] bucket-{bucket} prefill seconds ({rows} rows): " + "; ".join(
            f"{label} {PREFILL_SECONDS[(label, f'tts bucket {bucket}')]:.4f} / "
            f"{PREFILL_SECONDS[(label, f'tts_cfg bucket {bucket}')]:.4f}"
            for label in dict.fromkeys(k[0] for k in PREFILL_SECONDS)
            if (label, f"tts bucket {bucket}") in PREFILL_SECONDS), flush=True)
    # the same layout comparisons on the trees of a second seed
    base1, int4all1 = int4all_tree(torch, dev, cfg, SECOND_SEED)
    tag = f"seed {SECOND_SEED}: "
    ref1 = {"int4all": first_frames(torch, cfg, dev, int4all1)}
    for label in ("C int4allg", "D int4all, not interleaved",
                  "E int4allg, not interleaved"):
        params = format_tree(torch, base1, label)
        if label[0] == "C":
            ref1["C"] = first_frames(torch, cfg, dev, params)
        else:
            verdicts.update(layout_verdicts(
                torch, cfg, dev, label, params,
                ref1["int4all" if label[0] == "D" else "C"], tag))
        del params
        torch.cuda.empty_cache()
    del base1
    torch.cuda.empty_cache()
    wrong = [k for k, v in verdicts.items() if not k.startswith("control") and v]
    if wrong:
        fail(f"configurations disagree with their reference: {wrong}")
    missed = [k for k, v in verdicts.items() if k.startswith("control") and not v]
    if missed:
        fail(f"phase 8's comparisons passed planted faults: {missed}")
    return total, int4all1


# Phase 9: `DecodeEngine(params, cfg)` with no policy argument. The engine's
# default 500 frames serve one TTS and one ASR request on bench's prompts
# (cache 768: int8 KV, block-128 reads, six levels); the other requests
# take the fewest frames at which "auto" still picks the same policies
# (cache >= 512 slots; bucket 1024: 1536 slots, twelve levels).
DEFAULT_FRAMES = 500
SHORT_FRAMES = {64: 200, 1024: 260}
SECOND_SEED = 1
# The first decode position past a prefix-level boundary (block 128): the
# inline path's boundary frame (the slots it may attend pass 128), and the
# deferred path's (the current token is not in the cache yet).
BOUNDARY_POS = {"inline": 128, "deferred": 129}


def bucket_prompts(cfg, bucket):
    """A TTS prompt, its CFG negative, and an ASR prompt in ``bucket``."""
    import numpy as np
    from uniaudio2_tpu_torch.engine import decode, tasks

    n = {128: 95, 256: 200, 1024: 900}[bucket]
    prompt = np.arange(1, 24, dtype=np.int64) % 100
    text = np.arange(5, 5 + n, dtype=np.int64) % 100
    rng = np.random.default_rng(0)
    asr = tasks.prepare_asr(np.arange(1, 12, dtype=np.int64) % 100,
                            rng.integers(0, 100, (10, 8)),
                            rng.integers(0, 200, (n, 8)), cfg.tokens)
    out = (tasks.prepare_tts(prompt, text, cfg.tokens),
           tasks.prepare_tts_cfg_negative(prompt, text, cfg.tokens), asr)
    for grid, _ in (out[0], out[2]):
        if decode.pick_bucket(grid.shape[0]) != bucket:
            fail(f"a prompt of {grid.shape[0]} steps is not in bucket {bucket}")
    return out


def cache_bytes(cfg, batch, policy):
    """Device bytes of the three KV caches under ``policy``."""
    from uniaudio2_tpu_torch.models import unified

    caches = unified.init_caches(cfg, batch, dtype=policy["kv_dtype"],
                                 seq_len=policy["cache_len"], device="meta")

    def size(x):
        if isinstance(x, (list, tuple)):
            return sum(size(y) for y in x)
        return x.numel() * x.element_size()

    return size(list(caches))


def levels_read(policy, first_pos, frames):
    """The prefix levels the frames at positions first_pos ... read."""
    from uniaudio2_tpu_torch.models.gpt import _prefix_levels
    from uniaudio2_tpu_torch.ops.attention import pick_level

    levels = _prefix_levels(policy["cache_len"], policy["attn_block"])
    if levels is None:
        return []
    own = policy["kv_write"] == "inline"
    return sorted({pick_level(levels, p + own)
                   for p in range(first_pos, first_pos + frames)})


def scale_one_slot_late():
    """The int8 cache's per-slot scales written one slot past their values,
    as a write with an off-by-one offset would."""
    from uniaudio2_tpu_torch.ops import kv_cache

    orig = kv_cache._update_entry

    def late(entry, new, pos, slot_dim):
        if not isinstance(entry, kv_cache.QuantKV):
            return orig(entry, new, pos, slot_dim)
        qn = kv_cache.quantize_slots(new)
        t = new.shape[slot_dim]
        kv_cache._write(entry.q, slot_dim, kv_cache._slots(pos, t), qn.q)
        kv_cache._write(entry.s, slot_dim, kv_cache._slots(pos + 1, t), qn.s)
        return entry

    return mock.patch.object(kv_cache, "_update_entry", late)


def level_one_block_short():
    """The first frame past a level boundary reads the level below it, as
    a pick that compared with > instead of >= would."""
    from uniaudio2_tpu_torch.ops import attention

    orig = attention.pick_level

    def short(levels, filled):
        lvl = orig(levels, filled)
        i = list(levels).index(lvl)
        return levels[i - 1] if i and filled == levels[i - 1] + 1 else lvl

    return mock.patch.object(attention, "pick_level", short)


def deferred_write_one_slot_late():
    """The deferred path's coalesced frame write lands one slot past the
    frame's position, as a write with an off-by-one offset would."""
    from uniaudio2_tpu_torch.models import gpt

    orig = gpt.update_stacked

    def late(k_all, v_all, k_new, v_new, pos):
        return orig(k_all, v_all, k_new, v_new, pos + 1)

    return mock.patch.object(gpt, "update_stacked", late)


def boundary_frames(torch, cfg, params, dev, kv_dtype, attn_block, kv_write,
                    seed=0, until=max(BOUNDARY_POS.values())):
    """Prefill a TTS prompt of 120 steps (bucket 128) into a 768-slot
    cache, then teacher-forced decode steps (the same seeded audio frames
    fed back in every run) from position 119 across the level boundary at
    128 to position ``until`` (by default the deferred path's boundary
    frame). Returns, at each position of BOUNDARY_POS it reaches, the text
    and codebook-0 logits and the K rows the frame wrote into the backbone
    layers (all, and the first EARLY_LAYERS)."""
    import numpy as np
    from uniaudio2_tpu_torch.models import gpt, unified
    from uniaudio2_tpu_torch.ops.kv_cache import QuantKV, init_cache, layer_entry
    from uniaudio2_tpu_torch.ops.quant import matmul

    (grid, mask), _, _ = bucket_prompts(cfg, 128)
    ts, par, bucket = cfg.tokens, cfg.tokens.parallel_number, 128
    length = grid.shape[0]
    g = torch.zeros((1, bucket, par), dtype=torch.int64)
    msk = torch.zeros((1, bucket, par), dtype=torch.bool)
    g[0, :length] = torch.from_numpy(grid)
    msk[0, :length] = torch.from_numpy(mask)
    g, msk = g.to(dev), msk.to(dev)
    rng = np.random.default_rng(seed)
    feed_mask = torch.zeros((1, 1, par), dtype=torch.bool, device=dev)
    feed_mask[..., :-1] = True
    out = {}
    with torch.no_grad():
        caches = unified.init_caches(cfg, 1, dtype=kv_dtype, seq_len=768,
                                     as_lists=kv_write == "inline", device=dev)
        unified.prefill(params, cfg, g[:, :-1], msk[:, :-1], caches)
        last = length - 1
        tok, tm = g[:, last:last + 1], msk[:, last:last + 1]
        pos = torch.full((1,), last, dtype=torch.int64, device=dev)
        for p in range(last, until + 1):
            h, _ = unified.decode_hidden(params, cfg, tok, tm, caches, pos,
                                         attn_block=attn_block,
                                         kv_write=kv_write, host_pos=p)
            if p in BOUNDARY_POS.values():
                text = gpt.lm_head(params["backbone"], h, cfg.backbone)
                h0 = matmul(h, params["projection_w"]).to(torch.bfloat16)
                dcache = init_cache(cfg.decoder, 1, ts.num_codebooks,
                                    dtype=torch.bfloat16, device=dev)
                dh, _ = gpt.decode_step(params["decoder"], cfg.decoder,
                                        h0[:, None], dcache, 0)
                cb0 = matmul(dh[:, -1], params["audio_head"][0],
                             out_dtype=torch.float32)
                rows = []
                for i in range(cfg.backbone.n_layer):
                    e = layer_entry(caches.backbone.k, i)
                    rows.append(e.q[0, :, p].float() * e.s[0, :, p, None]
                                if isinstance(e, QuantKV) else e[0, :, p].float())
                k_rows = torch.stack(rows).cpu()
                out[p] = {"text": text.float().cpu(), "codebook0": cb0.float().cpu(),
                          "k_rows": k_rows, "k_early": k_rows[:EARLY_LAYERS]}
            codes = rng.integers(0, min(200, ts.audio_vocab), ts.num_codebooks)
            tok = torch.zeros((1, 1, par), dtype=torch.int64, device=dev)
            tok[0, 0, :-1] = torch.from_numpy(codes).to(dev)
            tm = feed_mask
            pos += 1
    return out


# Phase 9's comparisons at the boundary frame, on the card: (max|diff| /
# max|ref|, min cosine) per output.
#  * int8 against bf16 KV (both block 128, inline): three absmax-int8
#    roundings (the cache write, the queries, the probabilities) in each of
#    33 layers' attention, through the residual stream. On the H100 the two
#    seeds read text 0.199 / 0.9807, codebook 0 0.245 / 0.9566, K rows
#    0.120 / 0.99572, early K rows 0.056 / 0.99904 at worst; the scale
#    written one slot late at best 1.30 / 0.092, 1.24 / 0.064, 1.05 /
#    0.336, 0.91 / 0.576. Each bound sits near the geometric middle of the
#    two (in 1 - cosine for the cosines). The gap is the int8 scheme's, not
#    the card path's: the CPU path reads the same (the witness below);
#  * block 128 against 0 (both int8, inline): the masked tail adds exact
#    zeros and the integer sums are exact; both seeds read 0 on every
#    output. The level one block short at best 0.455 / 0.940 (early K
#    rows). The bound leaves only the float32 softmax's reduction order;
#  * deferred against inline (int8, block 128), at the deferred boundary:
#    the current token's score and value come from its exact fresh K/V
#    instead of its int8 slot, in every layer of every frame. Sound: text
#    0.148 / 0.9911, codebook 0 0.203 / 0.9823, K rows 0.072 / 0.99808,
#    early K rows 0.037 / 0.99956 at worst; the deferred frame write one
#    slot late at best 0.987 / 0.480, 1.10 / 0.261, 1.30 / 0.100, 1.53 /
#    0.037. The bounds are twice the worst sound reading (in 1 - cosine
#    for the cosines); the fault reads 3.3-19x the error bound and 21-960x
#    the 1 - cosine bound.
# The planted faults: the per-slot scale written one slot late must fail
# the first; the level chosen one block short at the boundary the second;
# the deferred write one slot late the third. Readings in PERF.md.
DEFAULTS_BOUNDS = {
    "int8 vs bf16 KV": {"text": (0.5, 0.87), "codebook0": (0.55, 0.8),
                        "k_rows": (0.35, 0.95), "k_early": (0.22, 0.98)},
    "block 128 vs 0": {"text": (1e-3, 0.99999), "codebook0": (1e-3, 0.99999),
                       "k_rows": (1e-3, 0.99999), "k_early": (1e-3, 0.99999)},
    "deferred vs inline": {"text": (0.3, 0.98), "codebook0": (0.4, 0.965),
                           "k_rows": (0.15, 0.996), "k_early": (0.08, 0.999)},
}


def defaults_verdicts(torch, cfg, params, dev, seed):
    """The three comparisons and two planted faults on one tree."""
    import contextlib

    runs = {  # name -> (kv dtype, block, write, fault)
        "bf16 KV": (torch.bfloat16, 128, "inline", contextlib.nullcontext),
        "block 0": (torch.int8, 0, "inline", contextlib.nullcontext),
        "defaults": (torch.int8, 128, "inline", contextlib.nullcontext),
        "deferred": (torch.int8, 128, "deferred", contextlib.nullcontext),
        "scale late": (torch.int8, 128, "inline", scale_one_slot_late),
        "level short": (torch.int8, 128, "inline", level_one_block_short),
        "write late": (torch.int8, 128, "deferred",
                       deferred_write_one_slot_late),
    }
    got = {}
    for name, (dtype, block, write, ctx) in runs.items():
        with ctx():
            got[name] = boundary_frames(torch, cfg, params, dev, dtype, block,
                                        write, seed)
    inline, deferred = BOUNDARY_POS["inline"], BOUNDARY_POS["deferred"]
    plan = (("int8 vs bf16 KV", "defaults", "bf16 KV", inline),
            ("block 128 vs 0", "defaults", "block 0", inline),
            ("deferred vs inline", "deferred", "defaults", deferred),
            ("control: scale one slot late", "scale late", "bf16 KV", inline),
            ("control: level one block short", "level short", "block 0", inline),
            ("control: deferred write one slot late", "write late", "defaults",
             deferred))
    verdicts = {}
    for label, a, b, pos in plan:
        bounds = DEFAULTS_BOUNDS[{
            "control: scale one slot late": "int8 vs bf16 KV",
            "control: level one block short": "block 128 vs 0",
            "control: deferred write one slot late": "deferred vs inline",
        }.get(label, label)]
        verdicts[f"seed {seed}: {label}"] = rejected(
            torch, "[9]", f"seed {seed}: {label} ({a} vs {b}, position {pos})",
            got[a][pos], got[b][pos], bounds)
    return verdicts


# The int8-vs-bf16 gap's second witness: the comparison of DEFAULTS_BOUNDS
# at the inline boundary frame, on the tree cut to its first WITNESS_DEPTH
# backbone layers and WITNESS_EXPERT_DEPTH layers of each expert (the CPU
# path at full depth would take minutes: its twins dequantize every weight
# at every call, so the cost goes by the layers the prefill and the ten
# teacher-forced frames pass; with both experts whole, 3 + 2 layers, it
# took 181 s), run on the card and on the CPU (the twins and the plain int8
# attention the CPU tests hold token-identical to the JAX engine). If the
# card path added to the gap, the card would read more than the CPU: its
# error may be at most WITNESS_FACTOR x the CPU's, and its 1 - cosine
# WITNESS_FACTOR^2 x. The scale written one slot late, on the card, must
# fail the same test.
# On the H100 (seed 0), with both experts whole, the card read text
# 8.49e-2 / 0.99589, codebook 0 0.103 / 0.99205, K rows 5.58e-2 / 0.99904,
# the CPU 8.10e-2 / 0.99644, 0.103 / 0.99323, 5.13e-2 / 0.99919: the card
# added at most 1.09x the error and 1.18x the 1 - cosine; the fault read
# >= 1.30 / <= 0.525. Readings at this depth in PERF.md.
WITNESS_DEPTH = EARLY_LAYERS
WITNESS_EXPERT_DEPTH = 1
WITNESS_FACTOR = 2.0
EXPERTS = ("understanding_expert", "generation_expert")


def cut_depth(cfg, params, depth, expert_depth=None):
    """``cfg`` and its serving tree with only the first ``depth`` backbone
    layers and, given ``expert_depth``, the first ``expert_depth`` layers of
    each expert (views of the full tree's)."""
    import dataclasses

    keep = {"backbone": depth}
    if expert_depth is not None:
        keep.update(dict.fromkeys(EXPERTS, expert_depth))

    class Cut(type(cfg)):
        @property
        def backbone(self):
            return super().backbone.replace(n_layer=keep["backbone"])

        @property
        def understanding_expert(self):
            c = super().understanding_expert
            return c.replace(n_layer=keep.get(EXPERTS[0], c.n_layer))

        @property
        def generation_expert(self):
            c = super().generation_expert
            return c.replace(n_layer=keep.get(EXPERTS[1], c.n_layer))

    cut = Cut(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    tree = dict(params)
    for sub, n in keep.items():
        tree[sub] = dict(params[sub], layers=params[sub]["layers"][:n])
    return cut, tree


def defaults_witness(torch, cfg, params, dev):
    """The int8-vs-bf16 KV gap at the inline boundary frame on the card and
    on the CPU, at WITNESS_DEPTH backbone layers and WITNESS_EXPERT_DEPTH
    of each expert; returns the outputs on which the card's gap outgrows
    the CPU's, for the sound run and for the planted fault."""
    import contextlib

    wcfg, tree = cut_depth(cfg, params, WITNESS_DEPTH, WITNESS_EXPERT_DEPTH)
    pos = BOUNDARY_POS["inline"]
    t0 = time.perf_counter()

    def frame(where, p, dtype, ctx=contextlib.nullcontext):
        with ctx():
            return boundary_frames(torch, wcfg, p, where, dtype, 128, "inline",
                                   until=pos)[pos]

    host = to_cpu(tree)
    cpu = {d: frame("cpu", host, d) for d in (torch.int8, torch.bfloat16)}
    del host
    t1 = time.perf_counter()
    card_bf16 = frame(dev, tree, torch.bfloat16)
    runs = {"sound": frame(dev, tree, torch.int8),
            "control: scale one slot late": frame(dev, tree, torch.int8,
                                                  scale_one_slot_late)}
    verdicts = {}
    for label, card_int8 in runs.items():
        caught = []
        for name in ("text", "codebook0", "k_rows"):
            err, cos = compare(torch, name, card_int8[name], card_bf16[name])
            cerr, ccos = compare(torch, name, cpu[torch.int8][name],
                                 cpu[torch.bfloat16][name])
            ok = (err <= WITNESS_FACTOR * cerr
                  and 1 - cos <= WITNESS_FACTOR ** 2 * (1 - ccos))
            if not ok:
                caught.append(name)
            print(f"[9w] {label}: int8 vs bf16 KV at {WITNESS_DEPTH} backbone "
                  f"layers ({WITNESS_EXPERT_DEPTH} of each expert), "
                  f"position {pos}: {name} card {err:.4e} x max|ref| / "
                  f"cosine {cos:.6f}, CPU {cerr:.4e} / {ccos:.6f}"
                  f"{'' if ok else '  REJECTED'}", flush=True)
        verdicts[label] = caught
    print(f"[9w] CPU path {t1 - t0:.1f} s", flush=True)
    return verdicts


def phase_defaults(torch, dev, cfg, params, params1):
    """Phase 9: `DecodeEngine(params, cfg)` with no policy argument on the
    interleaved int4all tree: TTS, the CFG pair and ASR on bench's prompts
    and on bucket-1024 prompts, inline and deferred; frames/s, cache bytes,
    the policy "auto" chose and the levels read. Then the boundary-frame
    comparisons and planted faults on the trees of two seeds. Returns the
    launches by row."""
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    (g, m), (ng, nm), (ag, am) = prompts(cfg)
    (lg, lm), (lng, lnm), (lag, lam) = bucket_prompts(cfg, 1024)
    pair = dict(use_cfg=True, cfg_scale=1.5)
    total = dict.fromkeys(counters(), 0)
    for write in ("inline", "deferred"):
        kw = {} if write == "inline" else {"kv_write": write}
        eng = DecodeEngine(params, cfg, **kw)       # max_frames 500
        short = {b: DecodeEngine(params, cfg, max_frames=f, **kw)
                 for b, f in SHORT_FRAMES.items()}
        runs = [("tts_cfg", short[64], "audio", 126, (g, m),
                 dict(pair, neg_grid=ng, neg_mask=nm)),
                ("tts bucket 1024", short[1024], "audio", 1023, (lg, lm), {}),
                ("tts_cfg bucket 1024", short[1024], "audio", 2046, (lg, lm),
                 dict(pair, neg_grid=lng, neg_mask=lnm)),
                ("asr bucket 1024", short[1024], "text", 1023, (lag, lam), {})]
        first = [("tts", eng, "audio", 63, (g, m), {}),
                 ("asr", eng, "text", 63, (ag, am), {})]
        if write == "inline":
            runs = first + runs
        else:
            runs = [(n, short[64], mode, r, gm, k)
                    for n, _, mode, r, gm, k in first] + runs
        got, done = serve(torch, cfg, params, f"[9] {write}:", runs)
        for k, v in got.items():
            total[k] += v
        for name, n, dt, policy, first_pos in done:
            batch = 2 if "cfg" in name else 1
            if (policy["kv_dtype"] != torch.int8 or policy["attn_block"] != 128
                    or policy["kv_write"] != write
                    or policy["cache_len"] < 512):
                fail(f"[9] {name}: auto picked {policy}")
            levels = levels_read(policy, first_pos, n)
            print(f"[9] {write}: {name}: {n / dt:.2f} frames/s; cache "
                  f"{policy['cache_len']} slots, int8 KV, attn_block "
                  f"{policy['attn_block']}: {cache_bytes(cfg, batch, policy) / 2 ** 20:.1f}"
                  f" MiB (bf16 would be {cache_bytes(cfg, batch, dict(policy, kv_dtype=torch.bfloat16)) / 2 ** 20:.1f}"
                  f" MiB); positions {first_pos}-{first_pos + n - 1} read "
                  f"levels {levels}", flush=True)
    verdicts = {}
    for seed, tree in ((0, params), (SECOND_SEED, params1)):
        verdicts.update(defaults_verdicts(torch, cfg, tree, dev, seed))
    witness = defaults_witness(torch, cfg, params, dev)
    if witness.pop("sound"):
        fail("[9w] the card's int8-vs-bf16 gap outgrows the CPU path's")
    if not all(witness.values()):
        fail(f"[9w] the witness passed a planted fault: {witness}")
    wrong = [k for k, v in verdicts.items() if "control" not in k and v]
    if wrong:
        fail(f"the engine's policies disagree beyond their bounds: {wrong}")
    missed = [k for k, v in verdicts.items() if "control" in k and not v]
    if missed:
        fail(f"phase 9's comparisons passed planted faults: {missed}")
    return total


# Phase 10: batched serving, beam search and n-gram blocking on phase 4's
# tree, the engine at its own policies. 8 rows of a bucket-64 batch decode
# in a 256-slot cache (bucket + frames + 1, rounded up to 256), where
# "auto" picks the int8 KV cache for any batch of 8 rows and no prefix
# levels (below 512 slots); the host-driven paths (beam, n-gram) decode in
# a cache of max_seq_len = 2048 slots: int8 KV, block-128 reads.
BATCH_FRAMES = 64
BEAM_STEPS = 32
# Gate (b), on the card: (max|diff| / max|ref|, min cosine) of each row's
# first-frame text and codebook-0 logits and backbone K rows (slot 63),
# the 8-row batch against each item run alone, left-padded in the same
# bucket, both with the int8 KV cache. They do not run the same kernels:
# the batch's prefill has 504 rows, past the fused SwiGLU kernel's 128, so
# its MLPs run the unfused GEMVs where an item alone (63 rows) runs the
# fused kernel, and bf16 roundings that differ spread through 33 layers
# (phase 8's byte orders read the same size). On the H100 the two seeds
# read at worst text 0.100 / 0.99730, codebook 0 0.137 / 0.99422, K rows
# 0.0504 / 0.99930; a row's key_valid dropped and a row's left pad off by
# one slot at best 0.947 / 0.933, 0.938 / 0.930, 0.745 / 0.959. Each
# bound sits at the geometric middle (in 1 - cosine for the cosines); both
# faults must fail it. Readings in PERF.md.
BATCH_BOUNDS = {"text": (0.3, 0.987), "codebook0": (0.35, 0.98),
                "k_rows": (0.19, 0.9946)}


def batch_prompts(cfg):
    """8 ASR prompts (bench's, and cuts of its audio: 49 down to 35 steps),
    8 TTS prompts (bench's, and cuts of its text: 37 down to 30 steps) and
    the TTS prompts' CFG negatives; all in bucket 64."""
    import numpy as np
    from uniaudio2_tpu_torch.engine import tasks

    asr, tts, neg = [], [], []
    prompt = np.arange(1, 24, dtype=np.int64) % 100
    for i in range(8):
        rng = np.random.default_rng(0)
        asr.append(tasks.prepare_asr(np.arange(1, 12, dtype=np.int64) % 100,
                                     rng.integers(0, 100, (10, 8)),
                                     rng.integers(0, 200, (24, 8))[:24 - 2 * i],
                                     cfg.tokens))
        text = np.arange(5, 17 - i, dtype=np.int64) % 100
        tts.append(tasks.prepare_tts(prompt, text, cfg.tokens))
        neg.append(tasks.prepare_tts_cfg_negative(prompt, text, cfg.tokens))
    return asr, tts, neg


def batch_first_frame(torch, cfg, params, eng, rows):
    """Prefill + first frame of ``rows`` through the engine's batched
    inputs (left padding, key_valid, its cache policy): per row the text
    and codebook-0 logits and the K rows the frame wrote into the 28
    backbone layers."""
    from uniaudio2_tpu_torch.models import gpt, unified
    from uniaudio2_tpu_torch.ops.kv_cache import QuantKV, init_cache, layer_entry
    from uniaudio2_tpu_torch.ops.quant import matmul

    g, m, key_valid, bucket, cache_len = eng._left_padded(rows)
    caches = eng._caches(g.shape[0], cache_len)
    last = bucket - 1
    with torch.no_grad():
        unified.prefill(params, cfg, g[:, :-1], m[:, :-1], caches,
                        key_valid=key_valid[:, :last])
        h, _ = unified.decode_hidden(
            params, cfg, g[:, -1:], m[:, -1:], caches,
            torch.full((1,), last, dtype=torch.int64, device=g.device),
            key_valid=key_valid, attn_block=eng.last_policy["attn_block"],
            kv_write=eng.kv_write, host_pos=last)
        text = gpt.lm_head(params["backbone"], h, cfg.backbone)
        h0 = matmul(h, params["projection_w"]).to(torch.bfloat16)
        dcache = init_cache(cfg.decoder, g.shape[0], cfg.tokens.num_codebooks,
                            dtype=torch.bfloat16, device=g.device)
        dh, _ = gpt.decode_step(params["decoder"], cfg.decoder, h0[:, None],
                                dcache, 0)
        cb0 = matmul(dh[:, -1], params["audio_head"][0],
                     out_dtype=torch.float32)
        rows_k = []
        for i in range(cfg.backbone.n_layer):
            e = layer_entry(caches.backbone.k, i)
            rows_k.append(e.q[:, :, last].float() * e.s[:, :, last, None]
                          if isinstance(e, QuantKV) else e[:, :, last].float())
    return {"text": text.float().cpu(), "codebook0": cb0.float().cpu(),
            "k_rows": torch.stack(rows_k, dim=1).cpu()}


def key_valid_dropped(row):
    """Row ``row`` of the batch attends its left-pad slots: its key_valid
    all true, as a mask built from the wrong length would be."""
    from uniaudio2_tpu_torch.engine import decode

    orig = decode.left_pad_valid

    def dropped(lengths, bucket, cache_len, device):
        valid = orig(lengths, bucket, cache_len, device)
        valid[row] = True
        return valid

    return mock.patch.object(decode, "left_pad_valid", dropped)


def left_pad_one_short(row):
    """Row ``row``'s prompt placed one slot to the left (its last token at
    bucket - 2, a pad slot last), as a packing off by one would."""
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    orig = DecodeEngine._pack_left

    def shifted(self, items):
        g, m, lengths, bucket = orig(self, items)
        g[row], m[row] = g[row].roll(-1, 0), m[row].roll(-1, 0)
        return g, m, lengths, bucket

    return mock.patch.object(DecodeEngine, "_pack_left", shifted)


def batch_verdicts(torch, cfg, params, seed):
    """Gate (b) and its two planted faults on one tree: returns {label:
    outputs outside BATCH_BOUNDS}."""
    import contextlib
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    asr, tts, _ = batch_prompts(cfg)
    rows = asr[:4] + tts[4:]
    eng = DecodeEngine(params, cfg, max_frames=BATCH_FRAMES, buckets=(64,),
                       kv_quant="on")
    alone = [batch_first_frame(torch, cfg, params, eng, [r]) for r in rows]
    alone = {k: torch.cat([a[k] for a in alone]) for k in alone[0]}
    shortest = min(range(len(rows)), key=lambda i: rows[i][0].shape[0])
    runs = (("sound", contextlib.nullcontext()),
            (f"control: row {shortest}'s key_valid dropped",
             key_valid_dropped(shortest)),
            (f"control: row {shortest}'s left pad one slot short",
             left_pad_one_short(shortest)))
    verdicts = {}
    for label, ctx in runs:
        with ctx:
            got = batch_first_frame(torch, cfg, params, eng, rows)
        verdicts[f"seed {seed}: {label}"] = rejected(
            torch, "[10]", f"seed {seed}: {label} (8 rows vs each alone)",
            got, alone, BATCH_BOUNDS)
    return verdicts


def phase_batched(torch, dev, cfg, params, params1):
    """Phase 10: `generate_text_batch` (8 ragged ASR prompts, greedy and
    with per-row seeds at topk 5), `generate_audio_batch` (8 TTS prompts;
    4 CFG utterances, 8 rows), `generate_text_beam` (beam 4, 32 steps),
    `generate_text(no_repeat_ngram=3)` and beam 1 against greedy decoding;
    frames/s, row-frames/s, cache bytes, the policy "auto" chose, the
    levels read, launches against the tree's count. Then gate (a), the
    batch in reverse order, and gate (b) with its planted faults on the
    trees of two seeds. Returns the launches by row."""
    import numpy as np
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    ts = cfg.tokens
    asr, tts, neg = batch_prompts(cfg)
    (_, _, (ag, am)) = prompts(cfg)
    eng = DecodeEngine(params, cfg, max_frames=BATCH_FRAMES, buckets=(64,))
    pair = DecodeEngine(params, cfg, max_frames=BEAM_STEPS, buckets=(64,),
                        kv_quant="on", attn_block=128)
    greedy = dict(topk=1, temperature=1.0)
    last = ag.shape[0] - 1          # the one-request paths' first position
    runs = (  # name, engine, mode, rows, items, first position, call
        ("asr x8, greedy", eng, "text", 8, 8, 63,
         lambda: eng.generate_text_batch(asr, **greedy)),
        ("asr x8, topk 5, per-row seeds", eng, "text", 8, 8, 63,
         lambda: eng.generate_text_batch(asr, topk=5, temperature=0.9,
                                         seeds=list(range(8)))),
        ("tts x8, greedy", eng, "audio", 8, 8, 63,
         lambda: eng.generate_audio_batch(tts, **greedy)),
        ("tts cfg x4 (8 rows), greedy", eng, "audio", 8, 4, 63,
         lambda: eng.generate_audio_batch(tts[:4], use_cfg=True, cfg_scale=1.5,
                                          neg_items=neg[:4], **greedy)),
        ("asr beam 4", eng, "text", 4, 1, last,
         lambda: [eng.generate_text_beam(ag, am, beam_size=4,
                                         max_steps=BEAM_STEPS)]),
        ("asr no_repeat_ngram 3", eng, "text", 1, 1, last,
         lambda: [eng.generate_text(ag, am, no_repeat_ngram=3)]),
        ("asr beam 1 (int8 KV, block 128)", pair, "text", 1, 1, last,
         lambda: [pair.generate_text_beam(ag, am, beam_size=1)]),
        ("asr greedy (int8 KV, block 128)", pair, "text", 1, 1, last,
         lambda: [pair.generate_text(ag, am, **greedy)]),
    )
    reset_counts()
    want = dict.fromkeys(counters(), 0)
    outs = {}
    for name, engine, mode, rows, items, first, fn in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        n, policy = engine.last_steps, dict(engine.last_policy)
        outs[name] = out
        if len(out) != items or n < 1:
            fail(f"[10] {name}: {len(out)} outputs after {n} frames")
        for o in out:
            toks = np.concatenate(o, axis=1) if mode == "audio" else o
            top = ts.audio_vocab if mode == "audio" else \
                cfg.backbone.padded_vocab_size
            if toks.size and (toks.min() < 0 or toks.max() >= top):
                fail(f"[10] {name}: tokens out of range")
        for k, v in expected_launches(cfg, params, mode,
                                      engine.last_frames_run,
                                      rows * 63).items():
            want[k] += v
        audio = (f", {ts.num_codebooks * items * n / dt:.1f} audio tokens/s"
                 if mode == "audio" else "")
        print(f"[10] {name}: {n} frames in {dt:.3f} s = {n / dt:.2f} frames/s,"
              f" {rows * n / dt:.1f} row-frames/s{audio}; cache "
              f"{policy['cache_len']} slots x {rows} rows, "
              f"{'int8' if policy['kv_dtype'] == torch.int8 else 'bf16'} KV, "
              f"attn_block {policy['attn_block']}: "
              f"{cache_bytes(cfg, rows, policy) / 2 ** 20:.1f} MiB; levels "
              f"{levels_read(policy, first, n)}; lengths "
              f"{[len(o) if mode == 'text' else o[0].shape[1] + o[1].shape[1] for o in out]}",
              flush=True)
        if rows == 8 and policy["kv_dtype"] != torch.int8:
            fail(f"[10] {name}: auto picked {policy} for 8 rows")
    got = read_counts()
    print(f"[10] launches {json.dumps(nonzero(got))}", flush=True)
    if got != want:
        fail(f"[10] launch counts {nonzero(got)} != the tree's {nonzero(want)}")
    beam1, greedy_out = (outs["asr beam 1 (int8 KV, block 128)"][0],
                         outs["asr greedy (int8 KV, block 128)"][0])
    print(f"[10] beam 1 {beam1.tolist()[:8]}... vs greedy "
          f"{greedy_out.tolist()[:8]}...: equal {np.array_equal(beam1, greedy_out)}",
          flush=True)
    if not np.array_equal(beam1, greedy_out):
        fail("[10] beam 1 is not greedy decoding")
    # gate (a): the batch in reverse order, each item's greedy tokens
    rev = eng.generate_text_batch(asr[::-1], **greedy)[::-1]
    fwd = outs["asr x8, greedy"]
    same = [bool(np.array_equal(a, b)) for a, b in zip(fwd, rev)]
    print(f"[10] (a) reversed batch, greedy tokens per item equal: {same}",
          flush=True)
    if not all(same):
        fail("[10] (a) an item's greedy tokens depend on its place in the batch")
    verdicts = {}
    for seed, tree in ((0, params), (SECOND_SEED, params1)):
        verdicts.update(batch_verdicts(torch, cfg, tree, seed))
    wrong = [k for k, v in verdicts.items() if "control" not in k and v]
    if wrong:
        fail(f"[10] (b) a batched row differs from its item alone: {wrong}")
    missed = [k for k, v in verdicts.items() if "control" in k and not v]
    if missed:
        fail(f"[10] (b) passed planted faults: {missed}")
    return got


# Phase 11: the frame loop through captured CUDA graphs (the engine's
# default on the card) against the eager loop (`DecodeEngine(graph=False)`)
# on phase 4's tree: each request once through each, greedy and with
# per-row seeds, tokens identical; the launch counters hold the replays.
GRAPH_PROFILE_FRAMES = 16
GRAPH_FAULT_FRAMES = 16
# Sampled requests at the engine's policies: 200 frames take a 512-slot
# cache (int8 KV, block-128 levels) for a bucket-64 and a bucket-256
# prompt, so one program serves both and the second needs new levels.
SAMPLED_FRAMES = 200
# The kernels a counted wrapper launches in a frame (up to
# quant.SPLITK_MAX_M rows), by the traced name's base: a GEMV wrapper one
# `gemv_kernel` (rows 1, 4, 5 and 6 one `gemv_splitk_kernel` instead),
# `qkv_rope_step` one `gemv_splitk_kernel` in its QKV mode (MODE 3; above
# 16 rows one `qkv_rope_kernel`), `fused_swiglu` two `gemv_splitk_kernel`
# (its two passes). "gemv_splitk_kernel QKV" counts the QKV instances,
# "gemv_splitk_kernel" the others.
QKV_SPLITK = "gemv_splitk_kernel QKV"
TRACED_FAMILIES = ("gemv_kernel", "gemv_splitk_kernel", QKV_SPLITK,
                   "qkv_rope_kernel")
# The counts a replay adds are held to the kernel nodes of the captured
# graph itself (`CUDAGraph.debug_dump`), not to a profiled trace: in this
# script's process the trace of a 16-frame window loses some kernel
# records (1 to 3 of ~4,300 hand-written kernels, on an H100), eager or
# replayed; the windows print both counts.


def feedback_left_out():
    """The frame graph's step never copies a frame's tokens into its static
    input, so every frame is fed the first one's, as a step that rebinds a
    fresh tensor instead of copying into the captured buffer would."""
    from uniaudio2_tpu_torch.engine.frame_graph import FrameGraph

    return mock.patch.object(FrameGraph, "_feedback",
                             lambda self, frame: None)


def counter_not_advanced():
    """The position advances but the frame counter does not, so every frame
    writes output slot 0."""
    from uniaudio2_tpu_torch.engine.frame_graph import FrameGraph

    def advance(self, live):
        self.pos.add_(live)

    return mock.patch.object(FrameGraph, "_advance", advance)


def same_tokens(a, b) -> bool:
    import numpy as np

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tokens(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(a, b))


def families(names):
    """How many of ``names`` (kernel names, demangled or mangled, or lines
    naming at most one kernel) belong to each of `TRACED_FAMILIES`."""
    out = dict.fromkeys(TRACED_FAMILIES, 0)
    for name in names:
        if re.search(r"gemv_splitk_kernel(<\d+, \w+, 3>|ILi\dELb\dELi3E)", name):
            out[QKV_SPLITK] += 1
            continue
        for fam in TRACED_FAMILIES:
            if f"{fam}<" in name or f"{len(fam)}{fam}I" in name:
                out[fam] += 1
    return out


def busy_window(torch, fn, rows):
    """``fn()`` (frames of ``rows`` activation rows) under torch.profiler
    (the second of two profiled runs): (wall ms, device kernels traced,
    their device ms, the counters' families over that run, the traced
    families, `by_family` of the traced kernels)."""
    from uniaudio2_tpu_torch.ops import _cuda

    prof = torch.profiler
    for _ in range(2):
        with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                      prof.ProfilerActivity.CUDA]) as p:
            torch.cuda.synchronize()
            before = _cuda.counts()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counted = counted_families(_cuda.counts_since(before), rows)
    kernels = [e for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (wall, len(kernels), sum(e.device_time for e in kernels) / 1e3,
            counted, families(e.name for e in kernels), by_family(kernels))


def by_family(kernels):
    """Device ms and calls of traced ``kernels`` by the kernel's name without
    its namespace, template arguments and parameters, the largest first;
    the split-K kernel by mode (a GEMV, the fused SwiGLU's pass 1 or 2,
    the QKV step)."""
    out = {}
    for e in kernels:
        name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
        mode = re.search(r"gemv_splitk_kernel<\d+, \w+, (\d)>", name)
        name = re.split(r"[<(]", name)[0].split("::")[-1]
        if mode:
            name += {"0": " GEMV", "1": " SwiGLU pass 1",
                     "2": " SwiGLU pass 2", "3": " QKV"}[mode.group(1)]
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + e.device_time / 1e3, n + 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def debug_graphs(torch):
    """While active, every `torch.cuda.CUDAGraph()` keeps its template
    (``keep_graph``: instantiated at its first replay) for `debug_dump`."""
    make = torch.cuda.CUDAGraph

    def kept():
        graph = make(keep_graph=True)
        graph.enable_debug_mode()
        return graph

    return mock.patch.object(torch.cuda, "CUDAGraph", kept)


def graph_nodes(graph):
    """The kernel nodes of a captured graph (made under `debug_graphs`) in
    each of `TRACED_FAMILIES`, read from its DOT dump."""
    path = ROOT / "build" / "frame_graph_debug.dot"
    path.parent.mkdir(parents=True, exist_ok=True)
    graph.debug_dump(str(path))
    try:
        return families(path.read_text().splitlines())  # a node a line
    finally:
        path.unlink()


def counted_families(counted, rows):
    """The kernels of `TRACED_FAMILIES` that the counters' increments
    ``counted`` say were launched by frames of ``rows`` (up to
    quant.SPLITK_MAX_M) activation rows."""
    from uniaudio2_tpu_torch.ops import fused_mlp, qkv_step, quant

    want = dict.fromkeys(TRACED_FAMILIES, 0)
    gemvs = {fn for fn, _ in counters().values()} - {
        fused_mlp.fused_swiglu, fused_mlp.swiglu_tc, qkv_step.qkv_rope_step}
    splitk = {quant.int4i_matmul, quant.int4_matmul, quant.int4g_matmul,
              quant.int8_matmul}
    for fn, (launches, _) in counted.items():
        if fn is qkv_step.qkv_rope_step:
            want[QKV_SPLITK if rows <= quant.SPLITK_MAX_M
                 else "qkv_rope_kernel"] += launches
        elif fn is fused_mlp.fused_swiglu and rows <= quant.SPLITK_MAX_M:
            want["gemv_splitk_kernel"] += 2 * launches
        elif fn in splitk and rows <= quant.SPLITK_MAX_M:
            want["gemv_splitk_kernel"] += launches
        elif fn in gemvs:
            want["gemv_kernel"] += launches
    return want


def phase_graphs(torch, dev, cfg, params):
    """Phase 11: TTS (128 frames, bucket 64, 256 slots, bf16 cache), the CFG
    pair and ASR at batch 1; TTS and ASR at the engine's defaults (500
    frames, 768 slots, int8 KV, block-128 levels: five graphs a program),
    inline; TTS deferred at the fewest frames that keep those policies
    (200 frames, 512 slots, int8 KV, block-128 levels: phase 9 runs
    deferred writes at the defaults); sampled TTS (the default topk 200 from the shared
    generator, 200 frames, 512 slots, int8 KV, block-128 levels): a
    bucket-64 prompt that runs to max_frames, then a bucket-256 prompt
    through the same program, which captures two new levels, and a CFG
    pair; 8 ASR rows greedy and with per-row seeds and 8 TTS rows (64
    frames): each once with ``graph=False`` and once through the graphs.
    Gates: the same tokens, and every kernel form's launches equal to the
    tree's count over the frames run (replays included); two planted
    faults must break the first. Prints frames/s and row-frames/s of both
    in the same run, capture seconds, the graph pool's bytes, and one
    profiled window of 16 frames each way with the device busy share and
    its traced and counted hand-written kernels. A replay's counts must
    equal, family by family, the kernel nodes of its graph. Returns the
    launches by row."""
    from uniaudio2_tpu_torch.engine import frame_graph
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine
    from uniaudio2_tpu_torch.ops import _cuda

    (g, m), (ng, nm), (ag, am) = prompts(cfg)
    (lg, lm), _, _ = bucket_prompts(cfg, 256)
    asr8, tts8, _ = batch_prompts(cfg)
    greedy = dict(topk=1, temperature=1.0)
    pair = dict(use_cfg=True, cfg_scale=1.5, neg_grid=ng, neg_mask=nm)
    bench = dict(max_frames=FRAMES, buckets=(64,))
    batch = dict(max_frames=BATCH_FRAMES, buckets=(64,))
    groups = (  # engine kwargs, [(name, mode, rows, prefill rows, call)]
        (bench, [
            ("tts", "audio", 1, 63, lambda e: e.generate_audio(g, m, **greedy)),
            ("tts_cfg", "audio", 2, 126,
             lambda e: e.generate_audio(g, m, **greedy, **pair)),
            ("asr", "text", 1, 63,
             lambda e: [e.generate_text(ag, am, **greedy)])]),
        ({}, [
            ("tts defaults inline", "audio", 1, 63,
             lambda e: e.generate_audio(g, m, **greedy)),
            ("asr defaults inline", "text", 1, 63,
             lambda e: [e.generate_text(ag, am, **greedy)])]),
        ({"kv_write": "deferred", "max_frames": SAMPLED_FRAMES}, [
            ("tts deferred, 200 frames", "audio", 1, 63,
             lambda e: e.generate_audio(g, m, **greedy))]),
        ({"max_frames": SAMPLED_FRAMES}, [
            ("tts, topk 200, seed 5", "audio", 1, 63,
             lambda e: e.generate_audio(g, m, seed=5)),
            ("tts, topk 200, seed 5, bucket-256 prompt", "audio", 1, 255,
             lambda e: e.generate_audio(lg, lm, seed=5)),
            ("tts_cfg, topk 200, seed 6", "audio", 2, 126,
             lambda e: e.generate_audio(g, m, seed=6, **pair))]),
        (batch, [
            ("asr x8", "text", 8, 8 * 63,
             lambda e: e.generate_text_batch(asr8, **greedy)),
            ("asr x8, topk 5, per-row seeds", "text", 8, 8 * 63,
             lambda e: e.generate_text_batch(asr8, topk=5, temperature=0.9,
                                             seeds=list(range(8)))),
            ("tts x8", "audio", 8, 8 * 63,
             lambda e: e.generate_audio_batch(tts8, **greedy))]),
    )
    reset_counts()
    want = dict.fromkeys(counters(), 0)
    different = []
    engines = {}
    for kw, runs in groups:
        eager = DecodeEngine(params, cfg, graph=False, **kw)
        graph = DecodeEngine(params, cfg, **kw)
        engines[tuple(sorted(kw.items()))] = (eager, graph)
        for name, mode, rows, prefill, call in runs:
            outs, rates = [], []
            for eng in (eager, graph):
                cap0 = eng.capture_seconds
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(call(eng))
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                cap = eng.capture_seconds - cap0
                n = eng.last_steps
                for k, v in expected_launches(cfg, params, mode,
                                              eng.last_frames_run,
                                              prefill).items():
                    want[k] += v
                rates.append((n, dt, cap, eng.last_frames_run))
            (n_e, dt_e, _, _), (n_g, dt_g, cap, run_g) = rates
            same = same_tokens(*outs) and n_e == n_g
            if not same:
                different.append(name)
            p = graph.last_policy
            if name.startswith("tts, topk 200") and (
                    n_g != SAMPLED_FRAMES or p["attn_block"] != 128
                    or p["cache_len"] != 512):
                fail(f"[11] {name}: {n_g} frames under {p}: not a run to "
                     f"max_frames through block-128 levels of 512 slots")
            print(f"[11] {name}: eager {n_e} frames in {dt_e:.3f} s = "
                  f"{n_e / dt_e:.2f} frames/s ({rows * n_e / dt_e:.1f} "
                  f"row-frames/s); graph {n_g} frames ({run_g} run on the "
                  f"device) in {dt_g:.3f} s of which {cap:.3f} s warm-up and "
                  f"capture = {n_g / (dt_g - cap):.2f} frames/s "
                  f"({rows * n_g / (dt_g - cap):.1f} row-frames/s) without "
                  f"capture, {n_g / dt_g:.2f} with; x"
                  f"{dt_e / (dt_g - cap):.2f}; cache {p['cache_len']} slots, "
                  f"{'int8' if p['kv_dtype'] == torch.int8 else 'bf16'} KV, "
                  f"attn_block {p['attn_block']}, {p['kv_write']}; tokens "
                  f"identical: {same}", flush=True)
    got = read_counts()
    print(f"[11] launches {json.dumps(nonzero(got))}", flush=True)
    if got != want:
        fail(f"[11] launch counts {nonzero(got)} != the tree's {nonzero(want)}")
    if different:
        fail(f"[11] the graph path's tokens differ from the eager loop's: "
             f"{different}")
    for key, (_, graph) in engines.items():
        n_graphs = sum(len(f.graphs) for f in graph.frame_graphs.values())
        pool = frame_graph.pool_bytes(graph.graph_pool)
        print(f"[11] engine {dict(key) or 'defaults'}: {n_graphs} graphs "
              f"over {len(graph.frame_graphs)} programs, captured in "
              f"{graph.capture_seconds:.3f} s (warm-up included); graph pool "
              f"{'not measured' if pool is None else f'{pool / 2 ** 20:.1f} MiB'}",
              flush=True)
    # one window of 16 TTS frames each way, the prefill outside it
    eager, graph = engines[tuple(sorted(bench.items()))]
    (fg,) = [f for k, f in graph.frame_graphs.items()
             if k[0] == "audio" and k[1] == 1 and not k[8]]
    first = g.shape[0] - 1
    tok, tmask = fg.tokens.clone(), fg.tmask.clone()
    stream = torch.Generator(device=dev)
    windows = {
        "eager": lambda: eager._frames(
            "audio", fg.caches, tok, tmask, first,
            first + GRAPH_PROFILE_FRAMES, stream, temperature=1.0, topk=1,
            use_cfg=False, cfg_scale=1.0),
        "graph": lambda: fg.run(tok, tmask, first, GRAPH_PROFILE_FRAMES,
                                seed=0)}
    for label, fn in windows.items():
        wall, n_kernels, busy, counted, traced, split = busy_window(
            torch, fn, 1)
        share = (f"busy share {busy / wall:.3f}" if n_kernels
                 else "busy share not measured (no kernel traced)")
        print(f"[11] profiled window, {GRAPH_PROFILE_FRAMES} TTS frames "
              f"{label}: wall {wall:.1f} ms ({wall / GRAPH_PROFILE_FRAMES:.2f} "
              f"ms a frame), {n_kernels} device kernels traced, {busy:.1f} ms "
              f"of device time, {share}; hand-written kernels traced "
              f"{traced}, counted {counted}", flush=True)
        print(f"[11] {label} window by kernel family (device ms a frame, "
              f"calls a frame, share of device time): " + "; ".join(
                  f"{name} {ms / GRAPH_PROFILE_FRAMES:.4f} ms "
                  f"{n / GRAPH_PROFILE_FRAMES:.1f} {ms / busy:.3f}"
                  for name, (ms, n) in list(split.items())[:14]), flush=True)
    # what a replay counts against the kernel nodes of its graph: TTS and
    # ASR at 512 slots (int8 KV, block-128 levels), two graphs each
    snapshot = _cuda.counts()
    with debug_graphs(torch):
        eng = DecodeEngine(params, cfg, max_frames=SAMPLED_FRAMES)
        eng.generate_audio(g, m, **greedy)
        eng.generate_text(ag, am, **greedy)
    _cuda.set_counts(snapshot)
    for key, f in eng.frame_graphs.items():
        for lvl, (cuda_graph, per_replay) in f.graphs.items():
            nodes = graph_nodes(cuda_graph)
            want = counted_families(per_replay, key[1])
            print(f"[11] {key[0]} graph, level {lvl}: kernel nodes {nodes}, "
                  f"a replay counts {want}", flush=True)
            if nodes != want or not nodes["gemv_splitk_kernel"] \
                    or not nodes[QKV_SPLITK]:
                fail(f"[11] a replay of the {key[0]} graph of level {lvl} "
                     f"counts {want}, its graph holds {nodes}")
    del eng
    # the planted faults, each captured into fresh graphs
    fault_kw = dict(max_frames=GRAPH_FAULT_FRAMES, buckets=(64,))
    ref = DecodeEngine(params, cfg, graph=False, **fault_kw).generate_audio(
        g, m, **greedy)
    caught = {}
    for label, ctx in (("feedback copy left out", feedback_left_out()),
                       ("frame counter not advanced", counter_not_advanced())):
        with ctx:
            out = DecodeEngine(params, cfg, **fault_kw).generate_audio(
                g, m, **greedy)
        caught[label] = not same_tokens(out, ref)
        print(f"[11] control: {label}: tokens identical to the eager loop: "
              f"{not caught[label]}{'' if not caught[label] else '  REJECTED'}",
              flush=True)
    if not all(caught.values()):
        fail(f"[11] the token gate passed a planted fault: {caught}")
    reset_counts()
    return got


def build_codec(torch, dev):
    from uniaudio2_tpu_torch.codec.decoder import (
        CodecConfig, CodecDecoder, init_decode_params,
    )

    cfg = CodecConfig()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    params = init_decode_params(gen, cfg, dtype=torch.bfloat16, device=dev)
    dec = CodecDecoder(params, cfg)
    del params
    torch.cuda.synchronize()
    print(f"[6] full CodecConfig codec decode params (DiT {cfg.dit.num_layers} x "
          f"{cfg.dit.num_heads} x {cfg.dit.head_dim}, ScalarAE default_24k) in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{(torch.cuda.memory_allocated() - before) / 2 ** 30:.2f} GiB",
          flush=True)
    return cfg, dec


def phase_estimator(torch, dev, cfg, params, dtype, bounds, tag):
    """One DiT evaluation of ``params`` in ``dtype`` through the flash
    kernel against the same evaluation through the twin, both on the card,
    within ``bounds``; then planted faults that must fall outside them.
    (a): the bf16 tree, DIT_BOUNDS; (e): the float32 tree, DIT_F32_BOUNDS."""
    from uniaudio2_tpu_torch.codec import dit
    from uniaudio2_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 374, cfg.dit.in_channels), generator=gen,
                    device=dev).to(dtype)
    t = torch.full((2,), 0.5, device=dev)
    kernel = fa.flash_attention

    def scale_twice(q, k, v, scale):
        return kernel(q, k, v, scale * scale)

    def mask_dropped(q, k, v, scale):
        hd = q.shape[3]                   # the last stage's zero keys join in
        pad = -q.shape[2] % fa.flash_layout(hd, fa.flash_plan(1, 1, 1, 1, hd).bq)[0]
        padded = [torch.nn.functional.pad(z, (0, 0, 0, pad)) for z in (q, k, v)]
        return kernel(*padded, scale)[:, :, :q.shape[2]]

    # the wrapper counts its launches on the function its module holds
    scale_twice.launches = mask_dropped.launches = 0
    scale_twice.forms, mask_dropped.forms = {}, {}

    def run(attn):
        """The velocity, and every layer's (q, k, v, attention output)."""
        seen = []

        def record(q, k, v, scale):
            o = attn(q, k, v, scale)
            seen.append((q, k, v, o))
            return o

        record.launches, record.forms = 0, {}
        with mock.patch.object(fa, "flash_attention", record):
            vel = dit.forward(params, cfg.dit, x, t)
        return vel.float(), seen

    def fro(a, b):
        return ((a - b).norm() / b.norm()).item()

    # the readings in float64: a float32 cosine of 37 million values is
    # off by ~1e-7 from the rounding of its own sums (two float32 steps
    # below 1), the size of DIT_F32_BOUNDS' 1 - cosine
    ref, _ = run(fa.attention_plain)
    ref = ref.double()
    scale = cfg.dit.head_dim ** -0.5
    verdicts = {}
    for label, attn in (("sound", kernel),
                        ("control: hd^-0.5 applied twice", scale_twice),
                        ("control: key mask dropped (T padded to 384)",
                         mask_dropped)):
        vel, seen = run(attn)
        vel = vel.double()
        o = torch.stack([s[3] for s in seen]).double()
        o_ref = torch.stack([fa.attention_plain(q, k, v, scale)
                             for q, k, v, _ in seen]).double()
        readings = {"velocity": compare(torch, "velocity", vel, ref)[0:2],
                    "attention": (fro(o, o_ref), compare(torch, "attention",
                                                         o, o_ref)[1])}
        caught = []
        for name, (err, cos) in readings.items():
            tol, min_cos = bounds[name]
            ok = err <= tol and cos >= min_cos
            if not ok:
                caught.append(name)
            what = (f"velocity {tuple(vel.shape)} max_abs_err {err:.4e} x max|ref|"
                    if name == "velocity" else f"attention outputs "
                    f"{tuple(o.shape)} ||diff|| {err:.4e} x ||ref||")
            print(f"[{tag}] {label}: {what} (tol {tol}), cosine {cos:.9f} "
                  f"(min {min_cos}){'' if ok else '  REJECTED'}", flush=True)
        verdicts[label] = caught
    if verdicts.pop("sound"):
        fail(f"[{tag}] DiT through the flash kernel disagrees with the twin")
    missed = [k for k, caught in verdicts.items() if not caught]
    if missed:
        fail(f"[{tag}] the DiT comparison passed planted faults: {missed}")


def chunk_noise(i, shape):
    """The solver noise of window ``i`` (the same for every decode here)."""
    import numpy as np

    return np.random.default_rng(100 + i).standard_normal(shape, np.float32)


def phase_decode(torch, cfg, dec):
    """(b) Offline decodes of 125 and 500 rec frames. Returns the flash
    launches and the 500-frame codes and waveform."""
    import numpy as np
    from uniaudio2_tpu_torch.ops import flash_attention as fa

    from uniaudio2_tpu_torch.codec import dit

    rng = np.random.default_rng(3)
    dec.decode(rng.integers(0, cfg.rec_codebook_size, (8, 125)), num_steps=10,
               noise_fn=chunk_noise)               # warm-up (cuDNN, cuBLAS)
    launches = 0
    for frames, windows in ((125, 1), (500, 2)):
        codes = rng.integers(0, cfg.rec_codebook_size, (8, frames))
        fa.flash_attention.launches = 0
        dit._attention.plain_launches = 0
        t0 = time.perf_counter()
        wav = dec.decode(codes, num_steps=10, guidance_scale=1.5,
                         noise_fn=chunk_noise)     # returns host numpy
        dt = time.perf_counter() - t0
        n, plain = fa.flash_attention.launches, dit._attention.plain_launches
        want = windows * 10 * cfg.dit.num_layers
        audio_s = frames / cfg.rec_hz
        length = int(frames / cfg.rec_hz * cfg.sample_rate)
        print(f"[6b] decode {frames} frames ({audio_s:.0f} s, {windows} "
              f"window(s)): {dt:.3f} s, RTF {dt / audio_s:.4f}; wav "
              f"{wav.shape} max|x| {np.abs(wav).max():.4f}; DiT attention: "
              f"flash launches {n} (expected {want}), plain path {plain}",
              flush=True)
        if wav.shape != (1, length):
            fail(f"decode of {frames} frames: {wav.shape} != (1, {length})")
        if not np.isfinite(wav).all():
            fail(f"decode of {frames} frames: non-finite samples")
        if n != want or plain:
            fail(f"flash launches {n} != windows x steps x layers = {want}, "
                 f"or {plain} attentions took the plain path")
        launches += n
    return launches, codes, wav


def cast_tree(torch, tree, dtype):
    """``tree`` (nested dicts and lists) with every floating tensor in
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(torch, v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(torch, v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


# The codec's default float32 tree against the same weights in bf16, one
# window on the card: ||bf16 - f32|| / ||f32|| of the waveform, and its
# cosine. The bf16 run rounds every DiT product, the flash kernel's
# probabilities and the ScalarAE's convolutions; the float32 run (TF32 off)
# rounds none. On the H100, with the float32 attention on the einsum path,
# the two read 7.4e-3 and 0.999987 (PERF.md); the bounds allow 4x that
# error and 40x its 1 - cosine. At random init the attention barely moves
# the velocity (phase 6a), so this holds the path as a whole (finite, the
# right length, the same waveform), not the attention: DIT_F32_BOUNDS does.
CODEC_F32_BOUNDS = (0.03, 0.9995)
# The float32 DiT at B = 2, T = 374, the float32 flash kernel vs the twin,
# both on the card, TF32 off, as DIT_BOUNDS: (1) the velocity, (2) the 32
# layers' attention outputs. Both keep every product in f32 and sum in
# another order: set before the first reading at ~100x the f32 rounding
# the sums can stack (2^-24 x sqrt(T) per dot product, a few 1e-7); the
# planted faults of phase 6a read 1e-2 to 0.1 in bf16.
DIT_F32_BOUNDS = {"velocity": (1e-4, 0.9999999), "attention": (1e-5, 0.9999999)}


def phase_codec_f32(torch, dev, cfg):
    """(e) The default float32 codec tree (`init_decode_params` with no
    dtype) at full width: one DiT evaluation through the float32 flash
    kernel against the twin and the planted faults (`phase_estimator`,
    DIT_F32_BOUNDS); then one 125-frame window decoded on the card through
    the float32 kernel, and the same weights cast to bf16 through the bf16
    kernel: the DiT's kernel and plain counts of each, finite samples, and
    the two waveforms within CODEC_F32_BOUNDS. Returns the float32
    kernel's launches in the float32 decode."""
    import numpy as np
    from uniaudio2_tpu_torch.codec import dit
    from uniaudio2_tpu_torch.codec.decoder import CodecDecoder, init_decode_params
    from uniaudio2_tpu_torch.ops import _cuda
    from uniaudio2_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(11)
    p32 = init_decode_params(gen, cfg, device=dev)
    phase_estimator(torch, dev, cfg, p32["dit"], torch.float32,
                    DIT_F32_BOUNDS, "6e")
    codes = np.random.default_rng(12).integers(0, cfg.rec_codebook_size, (8, 125))
    want = 10 * cfg.dit.num_layers
    waves, f32_launches = {}, 0
    for label, params, form in (("float32", p32, "f32"),
                                ("bf16", cast_tree(torch, p32, torch.bfloat16),
                                 None)):
        dec = CodecDecoder(params, cfg)
        _cuda.reset_count(fa.flash_attention)
        dit._attention.plain_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = dec.decode(codes, num_steps=10, guidance_scale=1.5,
                         noise_fn=chunk_noise)
        dt = time.perf_counter() - t0
        got = (fa.flash_attention.launches, dict(fa.flash_attention.forms),
               dit._attention.plain_launches)
        expect = (want, {form: want} if form else {}, 0)
        print(f"[6e] {label} tree, decode 125 frames (one window): {dt:.3f} s; "
              f"wav {wav.shape} max|x| {np.abs(wav).max():.4f}; DiT attention: "
              f"flash kernel {got[0]} {got[1]}, plain path {got[2]} "
              f"(expected {expect[0]} {expect[1]}, {expect[2]})", flush=True)
        if got != expect:
            fail(f"{label} codec tree: DiT attention launches {got} != {expect}")
        if not np.isfinite(wav).all() or wav.shape != (
                1, int(125 / cfg.rec_hz * cfg.sample_rate)):
            fail(f"{label} codec tree: bad waveform {wav.shape}")
        if form:
            f32_launches = got[1][form]
        waves[label] = wav.astype(np.float64)
        del dec, params
    ref, got = waves["float32"], waves["bf16"]
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    cos = float((got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref)))
    tol, min_cos = CODEC_F32_BOUNDS
    print(f"[6e] the bf16 cast through the bf16 flash kernel vs the float32 "
          f"tree through the float32 kernel: ||diff|| {err:.4e} x ||f32|| (tol "
          f"{tol}), cosine {cos:.6f} (min {min_cos})", flush=True)
    if not (err <= tol and cos >= min_cos):
        fail("the float32 codec tree and its bf16 cast disagree")
    return f32_launches


def phase_stream(cfg, dec, codes, offline):
    """(c) The streaming decoder fed the 500 frames in pieces."""
    import numpy as np
    from uniaudio2_tpu_torch.codec.streaming_decoder import StreamingCodecDecoder

    sd = StreamingCodecDecoder(None, cfg, num_steps=10, guidance_scale=1.5,
                               noise_fn=chunk_noise, decoder=dec)
    outs, t0 = [], time.perf_counter()
    for s in range(0, codes.shape[1], 60):
        outs.append(sd.feed(codes[:, s: s + 60]))
    outs.append(sd.flush())
    dt = time.perf_counter() - t0
    wav = np.concatenate(outs, axis=-1)
    if wav.shape != offline.shape:
        fail(f"streaming decode {wav.shape} != offline {offline.shape}")
    print(f"[6c] streaming decode of {codes.shape[1]} frames in pieces of 60: "
          f"{dt:.3f} s; max|streaming - offline| {np.abs(wav - offline).max():.6g}",
          flush=True)


def phase_tts(torch, cfg, params, ccfg, dec):
    """(d) TTS end to end: LLM stage 1 then the codec, RTF over 10 s."""
    import numpy as np
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    audio_s = 10.0
    frames = int(audio_s * (ccfg.reason_hz + ccfg.rec_hz))   # 175
    sem = int(audio_s * ccfg.rec_hz)                          # 125
    (g, m), _, _ = prompts(cfg)
    eng = DecodeEngine(params, cfg, max_frames=frames, buckets=(64,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reason, semantic = eng.generate_audio(g, m, temperature=0.9, topk=50, seed=1)
    t1 = time.perf_counter() - t0
    codes = np.random.default_rng(4).integers(0, ccfg.rec_codebook_size, (8, sem))
    t0 = time.perf_counter()
    wav = dec.decode(codes, num_steps=10, guidance_scale=1.5, seed=2)
    t2 = time.perf_counter() - t0
    if not np.isfinite(wav).all() or wav.shape[1] != int(sem / ccfg.rec_hz
                                                         * ccfg.sample_rate):
        fail(f"TTS stage 2: bad waveform {wav.shape}")
    print(f"[6d] TTS end to end: stage1_s {t1:.3f} ({eng.last_steps} frames, "
          f"{eng.capture_seconds:.3f} s of it the graphs' warm-up and capture, "
          f"reason {reason.shape} semantic {semantic.shape}), stage2_s "
          f"{t2:.3f} (codec decode of {sem} random semantic frames), RTF "
          f"{(t1 + t2) / audio_s:.4f}", flush=True)


def profile_codec(torch, dev, cfg, dec):
    """One 30 s window (T = 750) solve + ScalarAE decode under
    torch.profiler: device time by kernel class, and the top kernels."""
    import numpy as np
    from uniaudio2_tpu_torch.codec import scalar_ae

    win = cfg.window_rec_frames
    rec = np.random.default_rng(5).integers(0, cfg.rec_codebook_size, (1, win, 8))
    noise = torch.as_tensor(chunk_noise(0, (1, 2 * win, cfg.latent_dim)),
                            device=dev)

    def solve():
        lat = dec._solve(cfg, rec, None, None, noise, 10, 1.5)
        wav = scalar_ae.decode(dec.params["scalar"], cfg.scalar, lat)
        torch.cuda.synchronize()
        return wav

    solve()                                       # warm-up
    prof = torch.profiler
    walls = []
    # the first profiled run pays the tracer's start-up; the second is read
    for _ in range(2):
        with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                      prof.ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            solve()
            walls.append((time.perf_counter() - t0) * 1e3)
    wall = walls[-1]
    kernels, launches = {}, 0
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time / 1e3
            launches += 1

    def kind(name):
        n = name.lower()
        if "flash_attn_kernel" in n:
            return "flash attention (this port)"
        if any(s in n for s in ("conv", "cudnn", "dgrad", "fprop", "wgrad")):
            return "convolutions (cuDNN)"
        if any(s in n for s in ("gemm", "cutlass", "nvjet", "cublas")):
            return "GEMMs (cuBLAS)"
        return "other (elementwise, norms, copies)"

    classes = {}
    for name, ms in kernels.items():
        classes[kind(name)] = classes.get(kind(name), 0.0) + ms
    busy = sum(kernels.values())
    print(f"[P] one 30 s window: 10 steps x CFG pair x {cfg.dit.num_layers} "
          f"layers + ScalarAE; wall {wall:.1f} ms (profiler on; the first "
          f"profiled run {walls[0]:.1f} ms), {launches} device kernels, "
          f"{busy:.1f} ms (busy share {busy / wall:.3f})", flush=True)
    for k, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"[P] {k:38s} {ms:9.3f} ms  {ms / busy:.3f} of device time",
              flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
        print(f"[P]   {ms:9.3f} ms  {kind(name)[:12]:12s} {name[:110]}", flush=True)


# The synthetic training set: TTS and ASR examples of 1900-2000 grid steps,
# so that LengthBatcher (batch_scale 4096, max_length 2048) packs two a batch.
TRAIN_EXAMPLES = 8
TRAIN_LR = 3e-4


def train_examples(cfg, seed=0):
    """{id: example} as `data.loading.load_task_dataset` returns them: text
    ids below 128000, reasoning codes below reason_bos, semantic codes below
    semantic_bos."""
    import numpy as np
    from uniaudio2_tpu_torch.engine.tasks import TASK_FORMATS

    rng = np.random.default_rng(seed)
    ts = cfg.tokens
    out = {}
    for i in range(TRAIN_EXAMPLES):
        task = ("TTS", "ASR")[i % 2]
        n_text = 60 + 10 * i
        # grid steps: text + 2 specials, two audio segments + BOS/EOS each
        audio = 2000 - 12 * i - n_text - 6
        out[f"{task}_utt{i}"] = {
            "task": task, "loss_key": list(TASK_FORMATS[task]["loss_key"]),
            "transcription_seq": " ".join(
                str(x) for x in rng.integers(0, 128000, n_text)),
            "reason_seq": rng.integers(0, ts.reason_bos, (8, audio // 2)),
            "semantic_seq": rng.integers(0, ts.semantic_bos,
                                         (8, audio - audio // 2)),
        }
    return out


def train_flops(cfg, b, s):
    """Model FLOPs of one train step at batch (b, s): 3x the forward's
    matrix products (forward + backward, the remat recompute not counted):
    every stack's linear layers and its attention products (the full S x S
    square, as computed), the projection, and the text and audio heads of
    the chunked CE."""
    def stack(g, rows, seq):
        hd, h, q = g.head_size, g.n_head, g.n_query_groups
        lin = g.n_embd * (h + 2 * q) * hd + h * hd * g.n_embd \
            + 3 * g.n_embd * g.intermediate_size
        return g.n_layer * (2 * lin * rows * seq + 4 * rows * seq * seq * h * hd)

    ncb = cfg.tokens.num_codebooks
    d, dd = cfg.backbone.n_embd, cfg.decoder.n_embd
    fwd = (stack(cfg.backbone, b, s) + stack(cfg.understanding_expert, b, s)
           + stack(cfg.generation_expert, b, s) + stack(cfg.decoder, b * s, ncb)
           + 2 * d * dd * b * s * ncb
           + 2 * d * cfg.backbone.padded_vocab_size * b * s
           + ncb * 2 * dd * cfg.tokens.audio_vocab * b * s)
    return 3 * fwd


def build_training(torch, dev):
    """Full-width params, the adamw_lean train step and one fixed batch."""
    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.data.batching import LengthBatcher
    from uniaudio2_tpu_torch.models import gpt, unified
    from uniaudio2_tpu_torch.train import schedule, trainer
    from uniaudio2_tpu_torch.train.train import IntTok

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = UnifiedModelConfig()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = unified.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                     dtype=torch.bfloat16, device=dev)
    sched = schedule.warmup_lr(TRAIN_LR, 1)
    tx = trainer.make_optimizer(sched, grad_clip=1.0, optimizer="adamw_lean")
    state = trainer.init_train_state(params, tx, device=dev)
    del params
    torch.cuda.synchronize()
    batcher = LengthBatcher(train_examples(cfg), cfg.tokens, batch_scale=4096,
                            text_tokenizer=IntTok(), max_length=2048)
    raw = next(batcher.batches(epoch=0))
    batch = trainer.to_batch(raw, dev)
    print(f"[7a] full UnifiedModelConfig, {gpt.param_count(state.params) / 1e9:.3f} "
          f"B bf16 params + adamw_lean state in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB; batch grid "
          f"{tuple(raw['grid'].shape)} ({len(batcher._built)} examples)", flush=True)
    step = trainer.build_train_step(cfg, tx, remat=True)
    return cfg, sched, state, step, batch, raw


def phase_train(torch, dev):
    """(a) The full-width adamw_lean train step. Returns the lean kernel's
    launches on the main path."""
    from uniaudio2_tpu_torch.ops import lean_update as lu
    from uniaudio2_tpu_torch.train import lean_opt, optim, trainer

    cfg, sched, state, step, batch, raw = build_training(torch, dev)
    leaves = optim.tree_leaves(state.params)
    lean = state.opt_state[1]
    fused = sum(lean_opt.fused_leaf(p, s) for p, s in
                zip(leaves, optim.tree_leaves(lean.leaves)))
    b, s1, _ = batch.grid.shape
    s = s1 - 1
    real = int((raw["grid_mask"].any(-1).sum(-1) - 1).sum())   # unpadded
    torch.cuda.reset_peak_memory_stats()
    lu.fused_lean_update.launches = 0
    losses, secs = [], []
    for i in range(6):                               # 1 warm-up + 5 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[7a] step {i} ({'warm-up' if i == 0 else 'timed'}): loss {loss:.4f} "
              f"grad_norm {gnorm:.4f} {dt:.3f} s", flush=True)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train step {i}: loss {loss} grad_norm {gnorm} not finite")
        if i:
            losses.append(loss)
            secs.append(dt)
    launches = lu.fused_lean_update.launches
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs)
    flops = train_flops(cfg, b, s)
    print(f"[7a] batch (B, S) = ({b}, {s}): {b * s} tokens a step ({real} "
          f"unpadded); step {step_s:.3f} s (median of 5, min {min(secs):.3f}) = "
          f"{b * s / step_s:.0f} train tokens/s ({real / step_s:.0f} unpadded); "
          f"peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)", flush=True)
    print(f"[7a] model FLOPs a step {flops:.4g} (3 x the forward's products: "
          f"linear layers, full S x S attention, projection, CE heads; remat "
          f"not counted) = {flops / step_s / 1e12:.1f} TFLOP/s, "
          f"{flops / step_s / PEAK_BF16:.4f} of 989 TFLOP/s", flush=True)
    print(f"[7a] lean launches {launches} = {launches / 6:.1f} per optimizer step; "
          f"the leaf predicate gives {fused} fused leaves of {len(leaves)}",
          flush=True)
    if launches != 6 * fused or launches == 0:
        fail(f"lean launches {launches} != 6 steps x {fused} fused leaves")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over the timed steps: {losses}")

    # one optimizer update from the same gradients and state, kernel vs twin
    params = state.params
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = trainer.loss_fn(params, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
    del loss
    lean = state.opt_state[1]
    mc, vc, inv_mc, lr = lean_opt.step_scalars(lean.count + 1, sched, 0.9, 0.95)
    kw = dict(b1=0.9, wd=0.01, eps=1e-8)
    compared, mism = 0, [0, 0, 0]
    for g, p, st in zip(grads, leaves, optim.tree_leaves(lean.leaves)):
        if not lean_opt.fused_leaf(p, st):
            continue
        _, a_row, b_col = lean_opt.fused_inputs(g, st, vc, 0.95)
        args = (g.contiguous(), st.m_q, st.m_scale, p, a_row, b_col, inv_mc, lr)
        kern = lu.fused_lean_update(*args, **kw)
        twin = lu.fused_lean_update_plain(*args, **kw)
        for j, (x, y) in enumerate(zip(kern, twin)):
            mism[j] += int((x != y).sum())
        compared += 1
        del kern, twin, args, a_row, b_col
    torch.cuda.synchronize()
    print(f"[7a] one update through the kernel and the twin on the card: "
          f"{compared} fused leaves, mismatches (upd, m_q, m_scale) = {mism}",
          flush=True)
    if any(mism) or compared != fused:
        fail(f"full-tree update: kernel != twin ({mism}) over {compared} leaves")
    return launches


def write_train_files(cfg, root):
    """The synthetic set as the reference's task files: reason.pt and
    semantic.pt (id -> (8, T) codes), trans.txt (id ids...) and one task
    json each for TTS and ASR."""
    import torch

    ex = train_examples(cfg)
    root.mkdir(parents=True, exist_ok=True)
    codes = {k: {} for k in ("reason_seq", "semantic_seq")}
    with open(root / "trans.txt", "w", encoding="utf-8") as f:
        for eid, e in ex.items():
            uid = eid.split("_", 1)[1]
            for k in codes:
                codes[k][uid] = torch.from_numpy(e[k])
            f.write(f"{uid} {e['transcription_seq']}\n")
    keys = {"transcription_seq": str(root / "trans.txt")}
    for k, v in codes.items():
        torch.save(v, str(root / f"{k}.pt"))
        keys[k] = str(root / f"{k}.pt")
    for task in ("TTS", "ASR"):
        (root / f"{task.lower()}.json").write_text(
            json.dumps({"task": task, "keys": keys}))
    return str(root / "*.json")


def phase_train_cli(torch, dev):
    """(b) The train entry point at full width: 2 steps, a checkpoint, and
    the checkpoint read back into a fresh state."""
    import shutil
    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.models import unified
    from uniaudio2_tpu_torch.train import checkpoint as ckpt
    from uniaudio2_tpu_torch.train import schedule, trainer
    from uniaudio2_tpu_torch.train import train as train_cli

    cfg = UnifiedModelConfig()
    root = ROOT / "build" / "smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    pattern = write_train_files(cfg, root / "data")
    exp = root / "exp"
    free = shutil.disk_usage(ROOT).free
    saves = []
    save = ckpt.save_checkpoint

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        path = save(*args, **kw)
        saves.append((time.perf_counter() - t0, path))
        return path

    t0 = time.perf_counter()
    with mock.patch.object(ckpt, "save_checkpoint", timed_save):
        state = train_cli.main([
            "--train_data_jsons", pattern, "--exp_dir", str(exp),
            "--debug_steps", "2", "--n_epoch", "1", "--optimizer", "adamw_lean",
            "--batch_scale", "4096", "--max_length", "2048"])
    wall = time.perf_counter() - t0
    if len(saves) != 1 or state.step != 2:
        fail(f"train.main: {len(saves)} checkpoints, step {state.step}")
    write_s, path = saves[0]
    size = sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())
    print(f"[7b] train.main at full width, 2 steps + ep0.checkpoint: {wall:.1f} s; "
          f"checkpoint written in {write_s:.1f} s, {size / 2 ** 30:.2f} GiB "
          f"({free / 2 ** 30:.0f} GiB free before)", flush=True)
    with torch.no_grad():
        fresh = unified.init_params(cfg, torch.Generator(device=dev).manual_seed(5),
                                    dtype=torch.bfloat16, device=dev)
    tx = trainer.make_optimizer(schedule.warmup_lr(1e-4, 10000),
                                optimizer="adamw_lean")
    init = trainer.init_train_state(fresh, tx, device=dev)
    del fresh
    t0 = time.perf_counter()
    got, start, _ = ckpt.maybe_resume(str(exp), init)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    same = (torch.equal(got.params["projection_w"], state.params["projection_w"])
            and torch.equal(got.opt_state[1].leaves["audio_embeddings"].m_q,
                            state.opt_state[1].leaves["audio_embeddings"].m_q))
    print(f"[7b] maybe_resume read it back in {read_s:.1f} s: start epoch {start}, "
          f"step {got.step}, projection_w and the audio_embeddings moment "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if start != 1 or got.step != 2 or not same:
        fail("the checkpoint did not restore the state train.main ended with")
    shutil.rmtree(root)


def profile_train(torch, dev):
    """Phase 7a's train step under torch.profiler: device time by class."""
    cfg, _, state, step, batch, _ = build_training(torch, dev)
    state, _ = step(state, batch)                      # warm-up
    torch.cuda.synchronize()
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, launches = {}, 0
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time / 1e3
            launches += 1

    def kind(name):
        n = name.lower()
        if "lean_update_kernel" in n:
            return "lean update (this port)"
        if any(k in n for k in ("gemm", "nvjet", "cutlass", "cublas", "xmma")):
            return "GEMMs (cuBLAS)"
        if any(k in n for k in ("softmax", "reduce", "norm")):
            return "softmax, reductions, norms"
        if any(k in n for k in ("index", "scatter", "gather", "embedding")):
            return "gathers and scatters"
        return "other (elementwise, copies)"

    classes = {}
    for name, ms in kernels.items():
        classes[kind(name)] = classes.get(kind(name), 0.0) + ms
    busy = sum(kernels.values())
    print(f"[P] one full-width train step: wall {wall:.1f} ms (profiler on), "
          f"{launches} device kernels, {busy:.1f} ms (busy share {busy / wall:.3f})",
          flush=True)
    for k, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"[P] {k:32s} {ms:10.3f} ms  {ms / busy:.3f} of device time", flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        print(f"[P]   {ms:10.3f} ms  {kind(name)[:12]:12s} {name[:110]}", flush=True)


def phase_probes(torch):
    """The five probe scripts, each launch of their kernels counted: the
    split-K GEMV (every shape with UA2_GEMV_ALL=1), the causal flash kernel
    (the backbone prefill case; the DiT case runs row 10's form), the two
    int4 probes (their timed launches: each resets its counter after its
    checks) and the scan-slice probe (row 14's launches after its checks,
    graph replays included). Returns the launches of the five rows."""
    import os
    from uniaudio2_tpu_torch.ops import (
        _cuda, flash_attention, int4_native, int4_stacked, int4_sweep,
        splitk_gemv,
    )
    from uniaudio2_tpu_torch.probes import (
        int4_native_probe, profile_attention, profile_gemv, profile_scan_slice,
        sweep_gemv_blocks,
    )

    _cuda.reset_count(splitk_gemv.int8_splitk_gemv)
    _cuda.reset_count(flash_attention.flash_attention)
    with mock.patch.dict(os.environ, {"UA2_GEMV_ALL": "1", "UA2_GEMV_ITERS": "200"}):
        gemv = profile_gemv.main()
    attn = profile_attention.main()
    native = int4_native_probe.main()
    sweep = sweep_gemv_blocks.main()
    scan = profile_scan_slice.main()
    launches = {"int8_splitk_gemv": splitk_gemv.int8_splitk_gemv.launches,
                "flash_attention:causal":
                    flash_attention.flash_attention.forms.get("causal", 0),
                "int4_native_gemv": int4_native.int4_native_matmul.launches,
                "int4_sweep_gemv": int4_sweep.int4_sweep_matmul.launches,
                "int4_stacked_gemv": int4_stacked.int4_stacked_matmul.launches}
    print(f"[P] probes: {len(gemv)} GEMV shapes, {len(attn)} attention lines, "
          f"{len(native)} int4 native lines, {len(sweep)} sweep lines, "
          f"{len(scan)} scan-slice forms; launches {json.dumps(launches)}",
          flush=True)
    # the TMA ring: the split-K kernel's bits at M <= 16 (every probe row
    # is); the first designs: the tiled instances'
    if not all(line["bit_identical_to_int4i_splitk"]
               and line["simt_bit_identical_to_int4i_tiled"] for line in native) \
            or not all(line["form0_bit_identical_to_int4_splitk"]
                       and line["simt_form0_bit_identical_to_int4_tiled"]
                       for line in sweep):
        fail("an int4 probe kernel left the production kernel's order")
    if not all(launches.values()):
        fail(f"a probe kernel was never launched: {launches}")
    return launches


def main():
    t0 = time.perf_counter()

    def stamp(done):
        print(f"[t] {done} done at {time.perf_counter() - t0:.1f} s", flush=True)

    dev, card = phase_device()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if "--profile-codec" in sys.argv[1:]:
        ccfg, dec = build_codec(torch, dev)
        profile_codec(torch, dev, ccfg, dec)
        return
    if "--profile-train" in sys.argv[1:]:
        profile_train(torch, dev)
        return
    stamp("build")
    kernels = phase_kernels(torch, dev)
    stamp("phase 3")
    cfg, base, params = build_model(torch, dev)
    launches = phase_model(torch, dev, cfg, params)
    sound = phase_logits(torch, dev, cfg, params)
    stamp("phases 4-5")
    formats, params1 = phase_formats(torch, dev, cfg, base, params, sound)
    stamp("phase 8")
    del base
    torch.cuda.empty_cache()
    defaults = phase_defaults(torch, dev, cfg, params, params1)
    stamp("phase 9")
    batched = phase_batched(torch, dev, cfg, params, params1)
    stamp("phase 10")
    del params1
    torch.cuda.empty_cache()
    graphs = phase_graphs(torch, dev, cfg, params)
    stamp("phase 11")
    for k in launches:
        launches[k] += formats[k] + defaults[k] + batched[k] + graphs[k]
    print(f"[t] of these, the fused SwiGLU at a prefill of 17-128 rows (the "
          f"tile passes): {json.dumps(PREFILL_SWIGLU)}", flush=True)
    ccfg, dec = build_codec(torch, dev)
    phase_estimator(torch, dev, ccfg, dec.params["dit"], torch.bfloat16,
                    DIT_BOUNDS, "6a")
    launches["flash_attention"], codes, wav = phase_decode(torch, ccfg, dec)
    phase_stream(ccfg, dec, codes, wav)
    launches["flash_attention:f32"] = phase_codec_f32(torch, dev, ccfg)
    phase_tts(torch, cfg, params, ccfg, dec)
    stamp("phase 6")
    del params, dec, codes, wav
    torch.cuda.empty_cache()
    launches["lean_update"] = phase_train(torch, dev)
    torch.cuda.empty_cache()
    phase_train_cli(torch, dev)
    stamp("phase 7")
    launches.update(phase_probes(torch))
    stamp("the probes")
    qkv = ("qkv_rope.cu", "uniaudio2_tpu/ops/qkv_step.py:172")
    mlp = ("fused_swiglu.cu", "uniaudio2_tpu/ops/fused_mlp.py:225")
    i4 = ("gemv_int4i.cu", "uniaudio2_tpu/ops/quant.py:948")
    meta = {"int4i_matmul": i4, "int4i_matmul:int4ig": i4,
            "int8_matmul": ("gemv_int8.cu", "uniaudio2_tpu/ops/quant.py:483"),
            "int4_matmul": ("gemv_int4.cu", "uniaudio2_tpu/ops/quant.py:597"),
            "int4g_matmul": ("gemv_int4g.cu", "uniaudio2_tpu/ops/quant.py:712"),
            "int4c_matmul": ("gemv_int4c.cu", "uniaudio2_tpu/ops/quant.py:799"),
            "int4cg_matmul": ("gemv_int4cg.cu", "uniaudio2_tpu/ops/quant.py:864"),
            "flash_attention": ("flash_attn.cu", "uniaudio2_tpu/codec/dit.py:174"),
            "flash_attention:f32": ("flash_attn_f32.cu",
                                    "uniaudio2_tpu/codec/dit.py:174"),
            "lean_update": ("lean_update.cu", "uniaudio2_tpu/ops/lean_update.py:100"),
            "int8_splitk_gemv": ("gemv_int8_splitk.cu", "scripts/profile_gemv.py:82"),
            "flash_attention:causal": ("flash_attn.cu",
                                       "scripts/profile_attention.py:102"),
            "int4_native_gemv": ("gemv_int4_native.cu",
                                 "scripts/int4_native_probe.py:72"),
            "int4_sweep_gemv": ("gemv_int4_sweep.cu",
                                "scripts/sweep_gemv_blocks.py:60"),
            "int4_stacked_gemv": ("gemv_int4_stacked.cu",
                                  "scripts/profile_scan_slice.py:114")}
    for name in counters():
        if name.startswith("qkv_rope_step"):
            meta[name] = qkv
        elif name == SWIGLU_TILE:
            meta[name] = ("gemv_int4_tc.cuh", mlp[1])
        elif name.startswith("fused_swiglu"):
            meta[name] = mlp
    rows = []
    for name, (src, replaces) in meta.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"uniaudio2_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if any(not math.isfinite(r["ms"]) for r in rows):
        fail("a kernel time is not finite")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
