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
   SDPA reach; the int8 GEMV probe's kernel, the TMA ring's int8 form,
   at the GEMV probe's six shapes, to the production int8 kernel's bits
   and beside its two-pass first design), with the median CUDA-event time of each (L2 flushed before
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
   (``graph=False``) on phase 4's tree: TTS (64 frames, bucket 64,
   256 slots), the CFG pair and ASR; TTS deferred and inline, sampled TTS
   and greedy ASR at 193 frames (512 slots, int8 KV, block-128 levels, the
   policies of the engine's defaults, which phase 9 serves); 8 ASR
   rows (greedy and with per-row seeds at topk 5) and 8 TTS rows (32
   frames); each request once each way: the same tokens,
   and every kernel form's launches equal to the tree's count over the
   frames run (warm-up frames and replays included); frames/s and
   row-frames/s both ways, capture seconds, the graph pool's bytes, and
   one profiled window of 8 TTS frames each way with its device busy
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
12. (run after phase 6, on phase 4's tree and phase 6's codec) audio in:
   the full `EncoderConfig()` (Whisper-medium 24 x 1024, WavLM-base 12 x
   768, BEST-RQ 24 x 1024, reasoning 5 x 768, 8 x 4096 and 8 x 8192
   codebooks) with seeded random float32 weights tokenizes a seeded
   synthetic 10 s clip at 24 kHz from a wav file under build/ (two 30 s
   windows in one batch): reason (8, 51) and semantic (8, 126), every id in
   its codebook, the same ids from a second call; encode seconds and each
   stage's device ms (CUDA events); then a witness at cut depth (every
   tower at one layer, full width, the same weights) on the card against
   the CPU: the tower features within WITNESS_RTOL, the reason and rec ids
   identical but for certified ties, printed, and a planted fault (the
   resampler's up phases reversed) that must fail; then `prepare_asr` of
   the tokens and greedy `generate_text` on phase 4's tree (a bucket-256
   prefill, 64 frames) eagerly and through the frame graphs, the same
   tokens, launches against the tree's count, and the wav -> text wall
   seconds; then `detokenize` of the codes through phase 6's decoder:
   finite samples, flash launches = steps x layers (one window);
13. (run after phase 12, phase 4's tree freed) the CLI on the card:
   `uniaudio2_tpu_torch.cli.main` in this process at the full
   `UnifiedModelConfig()` (no yaml, random bf16 weights from seed 0,
   ``--quantize int4all``, 64 frames, greedy), its text tokenizer a
   stand-in of whitespace-separated integer ids and its codec phase 12's
   encoder joined to phase 6's decoder (the CLI's two seams; `tokenizers`
   and `sentencepiece` are absent on the card's machine); the tree is
   built once and the later runs take the same runner: (a) ASR from
   phase 12's wav file: the token files equal phase 12's tokens and the
   results file the engine's greedy `generate_text` on the same grid;
   (b) TTS ``--stage all``: the token files equal `generate_audio` on the
   same grid, the wav finite with 1920 samples a frame the codec decoded;
   (c) three utterances from ``--token_dir`` (the batched path): each line
   equal to its item decoded in a batch of three copies of itself (the
   same rows and bucket); (d) `BatchingServer` on the CLI's engine, 8
   threads submitting 4 ASR and 4 TTS requests: results equal the direct
   batched calls, two launches of 4 rows; (e) `InferenceHTTPServer` on
   127.0.0.1: one `/v1/asr` and one `/v1/tts` equal the engine's call for
   a batch of one; (f) every kernel row's launches equal the tree's count
   over the frames each call ran, the flash kernel's steps x layers; wall
   seconds of each stage, requests/s and rows per launch;
14. (run after phase 12, on phase 4's tree and phase 6's codec) continuous
   batching and streaming TTS (`engine/continuous.py`,
   `engine/stream_tts.py`): (a) `run_offline` over 24 ASR requests
   (prompts 8-63 tokens, budgets 64 and 128) through 8 rows, greedy, a
   256-slot int8 cache: two runs bit-identical, every request within its
   budget, every admission's first frame (backbone K rows rotated back to
   position 0, text logits) against the same request refilled alone into
   an empty engine at the same position (phase 5's bounds and a tight
   line) and the rows live on the device against the host's; three
   planted faults (`valid_from` one slot early, the prompt ending one
   position early, a finished row left active) each fail a line;
   (b) `step_online` at the defaults (4 rows, ladder auto, two windows,
   512 slots: int8 KV, block-128 levels) over 32 TTS requests arriving by
   a seeded Poisson process at 0.7 of the rate they reach submitted at
   once to `run_until_drained`: TTFT p50 / p99, TPOT p50, requests/s,
   the scheduler's stats, one eager refill's seconds and busy share, one
   segment window's busy share; CFG pairs (4 rows, 8 requests): both rows
   of a pair the same frames; (c) a one-row engine's `stream()` equal to
   its `run_until_drained`, and `stream_tts` fed phase 6's codes by a
   scripted frame source equal to phase 6's offline waveform bit for bit,
   with its time to first audio; launches of every window against the
   frames and refills the engines ran;
15. (run after phase 8, with phase 4's tree, phase 8's bf16 base and its
   second seed's int4all tree) speculative decoding
   (`engine/speculative.py`, k = 4): the int8 target (configuration A,
   built from the base) with three drafts (itself, phase 4's int4all tree
   of the same base, the second seed's) on the TTS prompt (128 frames,
   bucket 64) and the ASR prompt (64 frames); (a) each stream against the
   target's plain greedy decode on its graph path: identical up to the
   first difference, which must be a certified tie (the target's top two
   at M = 1, teacher-forced on the common prefix, closer than the same
   row's difference between M = 1 and M = k + 1), and every frame within
   SPEC_STREAM_TOL of the target teacher-forced on the stream itself;
   acceptance, rounds and frames/s; three planted faults (a frame
   accepted past the first mismatch, the position one short, the fresh
   frame from the row before) rejected by both lines; (b) the cost probe
   (`probes/bench_speculative.py`) at k = 4: plain frame ms, round ms
   accept-all and reject-all, the projection against alpha, one replayed
   round's device time and busy share (torch.profiler), capture seconds
   and pool bytes; (c) every window's launches equal to its prefills' and
   its rounds times the round's count by row, each graph's kernel nodes
   equal to a replay's counts, and row 3 above 16 rows launched 0 times;
7. training at full `UnifiedModelConfig()` width (the serving model and
   the codec freed first), seeded random bf16 weights, `adamw_lean`:
   (a) `build_train_step` (grad clip 1.0, per-layer remat, chunked CE) on
   one fixed batch from `LengthBatcher` over a synthetic TTS + ASR set
   (max_length 2048, batch_scale 4096), lr 3e-4 after a 1-step warm-up:
   one warm-up step, 3 timed steps; loss, grad_norm and seconds per step,
   tokens/s, peak memory, model-FLOP share of 989 TFLOP/s, lean launches
   against the leaf predicate's count; then one optimizer update from the
   same gradients and state through the kernel and through its twin, both
   on the card, bit-identical on every fused leaf;
   (b) `python -m uniaudio2_tpu_torch.train.train` (its `main`) at full
   width on the same set written as .pt / text / task-json files under
   build/: 2 steps, one epoch, `ep0.checkpoint` written, then read back
   through `maybe_resume` into a fresh state and compared, then deleted.
16. the mesh path (`parallel/mesh.py`) on a one-rank NCCL group (a
   FileStore under build/; one card cannot hold two NCCL ranks): (b) (run
   after phase 14) phase 4's int4all tree through `DecodeEngine(mesh=,
   use_tp=True)` and the plain engine on phase 11's TTS and ASR prompts:
   the same greedy tokens, the first frame's backbone K rows bit for bit,
   the same launches by row (added to the kernels line) and the frame time
   both ways; (a) (run after phase 7, 7a's state freed) 7a's configuration
   through the mesh step, two steps: loss, grad_norm and three leaves equal
   to 7a's bit for bit, the lean kernel on every fused leaf, a planted
   control (one leaf's second update dropped) rejected; (c) the train CLI
   with ``--data-parallel fsdp`` for one step under the group.

Phase 3 also holds the fused lean-update kernel to its twin at full-width
leaf shapes (bit-identical, bf16 g and p), and the stacked-layer int4
GEMV (the TMA ring, the layer index read on the card) to its twin and to
the bits of the production K-split kernel (the split-K kernel) on every
layer of a (28, 3072, 8192) stack, NaN past it, beside its first design.

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

    python3 chip_smoke.py --speculative

runs phases 1-2, phase 4's tree, the second seed's int4all tree and
phase 15 alone.

    python3 chip_smoke.py --asr WAV

runs phases 1-2, then transcribes the wav file with phase 4's int4all tree
and the full encoder (random weights from their seeds): the reason and
semantic token shapes, the greedy text ids and the seconds of each stage,
as one JSON line.

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
                (ring, r"gemv_stream_kernelILi(\d)ELi(\d+)ELi(\d+)ELi(\d)ELi(\d)ELb(\d)E")):
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
    for (layout, tn, bk, stages, unpack, stacked), got in sorted(ring.items()):
        print(f"[2] gemv_stream_kernel<layout {names[layout]}, TN {tn}, BK {bk}, "
              f"{stages} stages, {unpacks[unpack]}"
              f"{', stacked' if stacked == '1' else ''}> (rows 11-14's TMA "
              f"ring): {got.get('registers')} registers, "
              f"{got.get('spill stores', 0)} bytes of spill stores", flush=True)
    if _cuda.build_info["log"] and len(ring) != 13:
        fail(f"ptxas reported {len(ring)} of the 13 TMA-ring kernels (row "
             f"11's I4 form, row 12's INT8 form, row 13's ten K4 instances, "
             f"row 14's stacked K4 instance)")
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
    def ring_case(row, label, k, n, m, run, simt, splitk, library, times,
                  w_bytes=None):
        """Rows 11-14's TMA-ring kernel timed beside its first design
        (the lesser of its kept forms ``simt``: {name: fn}), the split-K
        wrapper of the same function and bits and the library call
        (kernel, the others, kernel: the lesser of the kernel's two), with
        the share of the bound (``w_bytes`` of weights: K N / 2 unless
        given), kept in ``times``."""
        ms = timer(run)
        simt_ms = {name: timer(fn) for name, fn in simt.items()}
        splitk_ms, lib_ms = timer(splitk), timer(library)
        ms = min(ms, timer(run))
        best = min(simt_ms, key=simt_ms.get)
        w_bytes = k * n // 2 if w_bytes is None else w_bytes
        bound_ms = bound(2 * m * (k + n) + 4 * n + w_bytes, 2 * m * k * n)[0]
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

    # row 12, the int8 GEMV probe on the TMA ring's int8 form (one launch)
    # at the GEMV probe's six shapes; row: (3072, 8192).
    # Kernel and twin add exact products in f32 in another order: one bf16
    # ulp. On the split-K plan (N <= 8192: the wide-N rule never fires) the
    # bits of quant.int8_matmul; the two-pass first design within one bf16
    # ulp of the twin. Timed beside the first design, the split-K wrapper
    # and the library (bf16 scales) at every shape; the host's
    # shared-memory reckoning against the header's at (3072, 8192).
    int8_times = {}
    lib = _cuda.lib()
    for k, n in profile_gemv.SHAPES + profile_gemv.MORE_SHAPES:
        w = quant.quantize(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        x = bf16(1, k)
        w_lib, s_lib = w.values[:, :n].T.contiguous(), w.scale.to(torch.bfloat16)
        ring = lambda: splitk_gemv.int8_splitk_gemv(x, w.values, w.scale)
        plain = lambda: splitk_gemv.int8_splitk_gemv_plain(x, w.values, w.scale)
        library = lambda: torch._weight_int8pack_mm(x, w_lib, s_lib)
        case = (nbytes(x, w.scale) + k * n + 2 * n, 2 * k * n)
        check("int8_splitk_gemv", f"(K, N) = ({k}, {n}) M=1", ring, plain,
              case, library, row=(k, n) == (3072, 8192), rtol=RTOL_GROUPED)
        ref = plain()
        err = (splitk_gemv.int8_splitk_gemv_twopass(x, w.values, w.scale).float()
               - ref.float()).abs().max().item()
        if err > RTOL_GROUPED * ref.float().abs().max().item():
            fail(f"int8_splitk_gemv_twopass ({k}, {n}): max_abs_err {err:.4g}")
        bits = {"split-K": torch.equal(ring(), quant.int8_matmul(
            x, w.values, w.scale))}
        print(f"[3] int8_splitk_gemv (K, N) = ({k}, {n}) M=1: the same bits: "
              f"{json.dumps(bits)}", flush=True)
        if not all(bits.values()):
            fail(f"int8_splitk_gemv ({k}, {n}): the bits differ: {bits}")
        if (k, n) == (3072, 8192):
            form = splitk_gemv.FORM
            _, span = int4_stream.stream_plan(1, k, n, sms, form,
                                              quant.LAYOUT_INT8)
            if int4_stream.smem_bytes(form, 1, span, quant.LAYOUT_INT8) != \
                    lib.ua2_gemv_int4_stream_smem(form.tn, 2 * form.bk,
                                                  form.stages, 1, span):
                fail("int4_stream.smem_bytes disagrees with the header at "
                     "int8")
        ring_case("int8_splitk_gemv", "", k, n, 1, ring,
                  {"two-pass": lambda: splitk_gemv.int8_splitk_gemv_twopass(
                      x, w.values, w.scale)},
                  lambda: quant.int8_matmul(x, w.values, w.scale), library,
                  int8_times, w_bytes=k * n)
        del w, w_lib
    faster_line("int8_splitk_gemv", int8_times)

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
    # row 14, the stacked-layer GEMV on the TMA ring over one map of the
    # stack, the layer index read on the card, on the scan-slice probe's
    # (28, 3072, 8192) stack: every layer the bits of quant.int4_matmul
    # (the split-K kernel on the same plan) on its slice, NaN for the index
    # past the stack; the first design the bits of gemv_int4.cu's tiled
    # instance and NaN likewise; row: layer 27, against the twin (one bf16
    # ulp) and the library on the layer's slice, timed beside the first
    # design, the split-K wrapper and the library.
    stacked, layers = profile_scan_slice.weights(dev)
    n_layers, k = stacked.values.shape[0], 2 * stacked.values.shape[1]
    n = stacked.scale.shape[1]
    index = torch.arange(n_layers + 1, dtype=torch.int32, device=dev)
    x = bf16(1, k)
    same = [torch.equal(int4_stacked.int4_stacked_matmul(x, stacked,
                                                         index[l:l + 1]),
                        quant.int4_matmul(x, w.values, w.scale))
            for l, w in enumerate(layers)]
    simt_same = [torch.equal(int4_stacked.int4_stacked_matmul_simt(
                                 x, stacked, index[l:l + 1]),
                             quant.int4_matmul_tiled(x, w.values, w.scale))
                 for l, w in enumerate(layers)]
    past = [bool(torch.isnan(fn(x, stacked, index[n_layers:]).float()).all())
            for fn in (int4_stacked.int4_stacked_matmul,
                       int4_stacked.int4_stacked_matmul_simt)]
    print(f"[3] int4_stacked_gemv (L, K, N) = ({n_layers}, {k}, {n}) M=1: "
          f"the split-K kernel's bits on every layer's slice: {all(same)} "
          f"({sum(same)} of {n_layers}); the first design the tiled "
          f"instance's: {all(simt_same)} ({sum(simt_same)} of {n_layers}); "
          f"NaN past the stack: {past}", flush=True)
    if not (all(same) and all(simt_same) and all(past)):
        fail("int4_stacked_gemv: the bits differ or an index past the stack "
             "gave numbers")
    last = n_layers - 1
    wp, group, sz = int4_tinygemm(layers[last])
    ring = lambda: int4_stacked.int4_stacked_matmul(x, stacked,
                                                    index[last:last + 1])
    library = lambda: torch._weight_int4pack_mm(x, wp, group, sz)
    check("int4_stacked_gemv",
          f"(L, K, N) = ({n_layers}, {k}, {n}) M=1 layer {last}", ring,
          lambda: int4_stacked.int4_stacked_matmul_plain(x, stacked,
                                                         index[last:last + 1]),
          (nbytes(x, layers[last].scale, index[:1]) + k * n // 2 + 2 * n,
           2 * k * n), library, row=True, rtol=RTOL_GROUPED)
    stacked_times = {}
    ring_case("int4_stacked_gemv", f"layer {last}", k, n, 1, ring,
              {"simt": lambda: int4_stacked.int4_stacked_matmul_simt(
                  x, stacked, index[last:last + 1])},
              lambda: quant.int4_matmul(x, layers[last].values,
                                        layers[last].scale),
              library, stacked_times)
    faster_line("int4_stacked_gemv", stacked_times)
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


def dequantized_once():
    """While active, `quant.dequantize_any` gives each container's weight
    from a memo: one dequantization per leaf and dtype, the same bytes the
    twins would make anew at every call (each CPU twin dequantizes its
    whole weight per call: most of `[9w]`'s CPU path, and every weight
    twice in a prefill and first frame, phases 5 and 8)."""
    from uniaudio2_tpu_torch.ops import quant

    orig, memo = quant.dequantize_any, {}

    def once(w, dtype=None):
        dtype = dtype or orig.__defaults__[0]
        key = (w.values.data_ptr(), w.scale.data_ptr(), dtype)
        if key not in memo:
            memo[key] = (w, orig(w, dtype))     # w kept: its pointers stay
        return memo[key][1]

    return mock.patch.object(quant, "dequantize_any", once)


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
    with dequantized_once():
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
    with dequantized_once():
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
            with dequantized_once():
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


# Phase 15: speculative decoding (`engine/speculative.py`) at k = SPEC_K
# with the int8 target (configuration A of phase 8's base) and three drafts.
# Each stream is held to the target's plain greedy decode
# (`DecodeEngine.generate_*(topk=1)`, its graph path). On the card a row's
# arithmetic depends on M (the verify runs the target at M = k + 1, the
# score at M = k, the plain decode at M = 1), so the gate is: the tokens
# are identical up to the first difference, and a difference passes only
# at a certified tie: there, the target's logits teacher-forced on the
# common prefix at M = 1 put the plain stream's token first, and its gap
# to the speculative stream's token lies within the largest difference
# between those logits and the same row's at M = k + 1 (the verify's
# T = k + 1 step, the score's k rows). Three planted faults must fail it.
SPEC_K = 4
SPEC_KS = (4,)      # 15b's k: 2 and 8 cut, to keep the phase inside ~90 s
SPEC_RUNS = {"tts": ("audio", 128), "asr": ("text", 64)}
# At random init near-ties are common (the streams part at frame 0 or 10),
# so a first-difference gate alone would leave most of a stream unread.
# The whole-stream line holds every frame's token within SPEC_STREAM_TOL
# (logit units) of the target's best, teacher-forced on the stream itself
# at M = n; the plain stream's reading beside it is the same check's noise.
# On the H100 the sound streams read at most 0.316 (the plain stream itself
# 0.528), the planted faults at least 5.72; readings in PERF.md.
SPEC_STREAM_TOL = 1.0


def spec_round_launches(cfg, draft, target, mode, k):
    """Kernel launches of one speculation round, by row: k draft frames and
    the draft's ingest (M = 1), the target's verify (M = k + 1: the QKV
    GEMV with the norm folded, attn_proj, the fused MLP), then in audio
    mode the teacher-forced score (M = k) and the fresh frame's local
    decoder (M = 1), each the projection, 4 layers x 8 codebooks and 8
    heads; in text mode the lm_head at M = k and M = 1."""
    from uniaudio2_tpu_torch.ops.fused_mlp import FORMS

    want = dict.fromkeys(counters(), 0)

    def gemv(w, n):
        want[GEMV_ROWS[FORMS[type(w)]]] += n

    def layers(params, subs, n, qkv_step=True):
        for sub in subs:
            for layer in params[sub]["layers"]:
                if qkv_step:
                    want[qkv_row(FORMS[type(layer["qkv_w"])])] += n
                else:
                    gemv(layer["qkv_w"], n)
                gemv(layer["attn_proj_w"], n)
                want[swiglu_row(f"{FORMS[type(layer['fc1_w'])]}+"
                                f"{FORMS[type(layer['mlp_proj_w'])]}")] += n

    stacks = ("understanding_expert", "backbone", "generation_expert")
    layers(draft, stacks, k + 1)
    layers(target, stacks, 1, qkv_step=False)
    if mode == "audio":
        ncb = cfg.tokens.num_codebooks
        for params, n in ((draft, k), (target, 2)):
            layers(params, ("decoder",), ncb * n)
            for head in params["audio_head"]:
                gemv(head, n)
            gemv(params["projection_w"], n)
    else:
        gemv(draft["backbone"]["lm_head_w"], k)
        gemv(target["backbone"]["lm_head_w"], 2)
    return want


def rows_of(delta):
    """A counts delta (`_cuda.counts_since`) by row of the kernels line."""
    out = {}
    for name, (fn, form) in counters().items():
        launches, forms = delta.get(fn, (0, {}))
        n = launches if form is None else forms.get(form, 0)
        if n:
            out[name] = n
    return out


def spec_stream(out, mode):
    """(frames (n, 8) or (n, 1), phases (n,)) of an engine's raw outputs."""
    text, audio, phases, n = out
    return (audio[:n] if mode == "audio" else text[:n, None]), phases[:n]


def local_logits(torch, cfg, params, h, frames, c, forbid):
    """The logits (N, V) of codebooks 0..c of the serving tree's local
    decoder at rows ``h`` (N, D), teacher-forced on ``frames``, ids below
    ``forbid`` (an int or (N, 1)) masked: `_local_decoder_score`'s
    arithmetic."""
    from uniaudio2_tpu_torch.models import gpt, unified
    from uniaudio2_tpu_torch.ops.quant import matmul
    from uniaudio2_tpu_torch.ops.sampling import _mask_prefix

    cache, steps = unified.init_local_cache(cfg, h.shape[0], h.dtype, h.device)
    table = params["audio_embeddings_proj"]
    curr = matmul(h, params["projection_w"]).to(table.dtype)[:, None, :]
    out = []
    for i in range(c + 1):
        dec_h, cache = gpt.decode_step(params["decoder"], cfg.decoder, curr,
                                       cache, steps[i:i + 1])
        out.append(_mask_prefix(matmul(dec_h[:, -1, :], params["audio_head"][i],
                                       out_dtype=torch.float32), forbid))
        curr = table[frames[:, i] + i * cfg.tokens.audio_vocab][:, None, :]
    return out


def forbids_of(cfg, frames):
    """The ``forbid_prefix`` each audio frame of a stream was drawn under:
    0 until the reasoning phase's switch frame (8 x reason_eos), the
    reason card after it."""
    ts, out, forbid = cfg.tokens, [], 0
    for fr in frames:
        out.append(forbid)
        if not forbid and (fr == ts.reason_eos).all():
            forbid = ts.audio_reason_card
    return out


def stream_inputs(torch, cfg, mode, grid, mask, frames, n, dev):
    """The padded bucket-64 prompt (1, 64, 9) and the (1, n, 9) inputs from
    the prompt's last step: that step, then each frame's feedback."""
    import numpy as np

    ts, par, last = cfg.tokens, cfg.tokens.parallel_number, grid.shape[0] - 1
    g = np.zeros((1, 64, par), np.int64)
    m = np.zeros((1, 64, par), bool)
    g[0, :last + 1], m[0, :last + 1] = grid, mask
    feed = np.zeros((1, n, par), np.int64)
    fmask = np.zeros((1, n, par), bool)
    feed[0, 0], fmask[0, 0] = grid[last], mask[last]
    for j in range(min(len(frames), n - 1)):
        if mode == "audio":
            feed[0, j + 1, :-1], fmask[0, j + 1, :-1] = frames[j], True
        else:
            tok = frames[j, 0]
            feed[0, j + 1, -1] = ts.text_eos if tok < 0 else tok
            fmask[0, j + 1, -1] = True
    return tuple(torch.from_numpy(x).to(dev) for x in (g, m, feed, fmask))


def stream_gaps(torch, cfg, target, mode, grid, mask, frames):
    """Each frame of a stream against the target teacher-forced on the
    stream itself (one prefill, one T = n step over its inputs, the local
    decoder 16 rows at a time): per frame, the largest gap over its
    codebooks between the target's best logit and the stream's token's."""
    import numpy as np
    from uniaudio2_tpu_torch.models import gpt, unified

    dev, n = target["audio_embeddings"].device, len(frames)
    g, m, feed, fmask = stream_inputs(torch, cfg, mode, grid, mask, frames, n,
                                      dev)
    toks = np.where(frames < 0, cfg.tokens.text_eos, frames)
    with torch.no_grad():
        caches = unified.init_caches(cfg, 1, seq_len=256, as_lists=True,
                                     device=dev)
        unified.prefill(target, cfg, g[:, :-1], m[:, :-1], caches)
        h, _ = unified.decode_hidden_all(target, cfg, feed, fmask, caches,
                                         grid.shape[0] - 1)
        if mode == "text":
            logits = [gpt.lm_head(target["backbone"], h[0], cfg.backbone)]
        else:
            forbid = torch.tensor(forbids_of(cfg, frames), device=dev)[:, None]
            rows = torch.from_numpy(toks).to(dev)
            parts = [local_logits(torch, cfg, target, h[0, i:i + 16],
                                  rows[i:i + 16], 7, forbid[i:i + 16])
                     for i in range(0, n, 16)]
            logits = [torch.cat(c) for c in zip(*parts)]
    gaps = np.zeros(n)
    for c, lg in enumerate(logits):
        lg = lg.float().cpu().numpy()
        gaps = np.maximum(gaps, lg.max(axis=1) - lg[np.arange(n), toks[:, c]])
    return gaps


def tie_at(torch, cfg, target, mode, k, grid, mask, frames, f, c, a, b):
    """The target's logits at frame ``f`` (codebook ``c``) of the plain
    stream ``frames``, teacher-forced on frames 0..f-1 and frame f's
    codebooks below c, at M = 1 (T = 1 steps, one row) and at M = k + 1
    (one T = k + 1 step over the rows from frame max(0, f - k + 1), the
    score's k rows). Returns (L1[a] - L1[b], max |L1 - Lk|, whether ``a``
    and ``b`` are L1's top two)."""
    import numpy as np
    from uniaudio2_tpu_torch.engine.speculative import _decode_hidden_all
    from uniaudio2_tpu_torch.models import gpt, unified
    from uniaudio2_tpu_torch.ops.kv_cache import KVCache

    ts, dev, last = cfg.tokens, target["audio_embeddings"].device, grid.shape[0] - 1
    g, m, feed, fmask = stream_inputs(torch, cfg, mode, grid, mask, frames,
                                      f + k + 1, dev)
    s = max(0, f - k + 1)
    with torch.no_grad():
        caches = unified.init_caches(cfg, 1, seq_len=256, as_lists=True,
                                     device=dev)
        unified.prefill(target, cfg, g[:, :-1], m[:, :-1], caches)

        def step(j):
            return unified.decode_hidden(target, cfg, feed[:, j:j + 1],
                                         fmask[:, j:j + 1], caches,
                                         last + j)[0]

        for j in range(s):
            step(j)
        copy = type(caches)(*(KVCache([t.clone() for t in c.k],
                                      [t.clone() for t in c.v])
                              for c in caches))
        h_all, _ = _decode_hidden_all(target, cfg, feed[:, s:s + k + 1],
                                      fmask[:, s:s + k + 1], copy, last + s)
        for j in range(s, f + 1):
            h1 = step(j)
        if mode == "text":
            l1 = gpt.lm_head(target["backbone"], h1, cfg.backbone)[0]
            lk = gpt.lm_head(target["backbone"], h_all[0, :k],
                             cfg.backbone)[f - s]
        else:
            forbid = forbids_of(cfg, frames[:f + 1])[f]
            rows = np.zeros((k, 8), np.int64)
            rows[:min(k, len(frames) - s)] = frames[s:s + k]
            rows = torch.from_numpy(rows).to(dev)
            l1 = local_logits(torch, cfg, target, h1, rows[f - s:f - s + 1], c,
                              forbid)[c][0]
            lk = local_logits(torch, cfg, target, h_all[0, :k], rows, c,
                              forbid)[c][f - s]
    b = ts.text_eos if b < 0 else b
    a = ts.text_eos if a < 0 else a
    l1, lk = l1.float().cpu(), lk.float().cpu()
    second = float(l1.topk(2).values[1])
    return (float(l1[a] - l1[b]), float((l1 - lk).abs().max()),
            int(l1.argmax()) == a and float(l1[b]) >= second)


def spec_verdict(torch, cfg, target, mode, grid, mask, plain, spec, k):
    """The gate of one speculative stream against the plain one: its first
    difference (None where the streams are equal; else frame, codebook,
    both ids, the tie's gap, the M-plan spread and whether it is a
    certified tie), and the whole stream against the target teacher-forced
    on it (`stream_gaps`: the largest gap, its frame, the frames whose
    token is not the check's argmax). ``ok`` holds both."""
    import numpy as np

    pf, pp = spec_stream(plain, mode)
    sf, sp = spec_stream(spec, mode)
    n = min(len(pf), len(sf))
    diff = np.argwhere(pf[:n] != sf[:n])
    first = None
    if len(diff):
        f, c = (int(x) for x in diff[0])
        a, b = int(pf[f, c]), int(sf[f, c])
        gap, spread, top = tie_at(torch, cfg, target, mode, k, grid, mask, pf,
                                  f, c, a, b)
        first = {"frame": f, "codebook": c, "plain": a, "speculative": b,
                 "gap": gap, "spread": spread,
                 "certified": top and abs(gap) <= spread}
    elif len(pf) != len(sf) or not np.array_equal(pp, sp):
        first = {"frame": n, "codebook": None, "certified": False,
                 "why": "lengths or phase tags differ"}
    gaps = stream_gaps(torch, cfg, target, mode, grid, mask, sf)
    stream = {"max_gap": float(gaps.max()), "at": int(gaps.argmax()),
              "off_argmax": int((gaps > 0).sum()), "frames": len(gaps)}
    ok = (first is None or first["certified"]) \
        and stream["max_gap"] <= SPEC_STREAM_TOL
    return {"first_difference": first, "stream": stream, "ok": ok}


def accepted_past_mismatch():
    """One drafted frame accepted past the first mismatch."""
    from uniaudio2_tpu_torch.engine.speculative import _Program

    k = SPEC_K
    return mock.patch.object(_Program, "_accept", staticmethod(
        lambda match: (match.long().cumprod(0).sum() + 1).clamp(max=k)
        .reshape(1)))


def pos_one_short():
    """The position advanced by n_acc instead of n_acc + 1."""
    from uniaudio2_tpu_torch.engine.speculative import _Program

    emit = _Program._emit

    def short(self, drafted, n_acc, fresh):
        emit(self, drafted, n_acc, fresh)
        self.pos.sub_(1)

    return mock.patch.object(_Program, "_emit", short)


def fresh_row_one_early():
    """The fresh frame taken from h_all[n_acc - 1]."""
    from uniaudio2_tpu_torch.engine.speculative import _Program

    fresh = _Program._fresh
    return mock.patch.object(
        _Program, "_fresh", lambda self, h_all, n_acc, forbids: fresh(
            self, h_all, (n_acc - 1).clamp(min=0), forbids))


def phase_speculative(torch, dev, cfg, base, int4all, params1, card):
    """Phase 15: (a) the int8 target (A, from ``base``) with three drafts
    (itself, phase 4's int4all tree of the same base, the int4all tree of
    SECOND_SEED) on the TTS prompt (128 frames, bucket 64) and the ASR
    prompt (64 frames) against the target's plain greedy decode, each
    window's launches against the rounds it ran, each graph's kernel
    nodes against a replay's counts, and three planted faults; (b) the
    cost probe (`probes/bench_speculative.py`) at k in SPEC_KS; (c) row
    3 above 16 rows launched 0 times. Returns the launches by row of the
    checked windows of (a)."""
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine
    from uniaudio2_tpu_torch.engine.speculative import SpeculativeEngine
    from uniaudio2_tpu_torch.probes import bench_speculative

    t0 = time.perf_counter()
    k = SPEC_K
    target = format_tree(torch, base, "A int8")
    (g, m), _, (ag, am) = prompts(cfg)
    requests = {name: (mode, frames, grid, mask) for (name, (mode, frames)),
                (grid, mask) in zip(SPEC_RUNS.items(), ((g, m), (ag, am)))}
    total = dict.fromkeys(counters(), 0)
    plain = {}
    for name, (mode, frames, grid, mask) in requests.items():
        reset_counts()
        ref = DecodeEngine(target, cfg, max_frames=frames, buckets=(64,))
        plain[name] = ref._run(mode, grid, mask, temperature=0.9, topk=1,
                               seed=888)
        want = expected_launches(cfg, target, mode, ref.last_frames_run, 63)
        got = read_counts()
        if got != want:
            fail(f"[15a] plain {name}: launches {nonzero(got)} != "
                 f"{nonzero(want)}")
        add_to(total, got)
        gaps = stream_gaps(torch, cfg, target, mode, grid, mask,
                           spec_stream(plain[name], mode)[0])
        print(f"[15a] the plain greedy stream, {name}: against the target "
              f"teacher-forced on it at M = {len(gaps)}, largest gap "
              f"{gaps.max():.4f} (frame {gaps.argmax()}), "
              f"{(gaps > 0).sum()} of {len(gaps)} frames off the check's "
              f"argmax ({card})", flush=True)
    drafts = {"the target itself": target,
              "int4all, same base (phase 4's tree)": int4all,
              f"int4all, seed {SECOND_SEED}": params1}
    per_round, bad = {}, []
    for dname, draft in drafts.items():
        for name, (mode, frames, grid, mask) in requests.items():
            reset_counts()
            with debug_graphs(torch):
                eng = SpeculativeEngine(draft, target, cfg, k=k,
                                        max_frames=frames, buckets=(64,))
                t1 = time.perf_counter()
                out = eng._run(mode, grid, mask)
                dt = time.perf_counter() - t1
            got = read_counts()
            rnd = spec_round_launches(cfg, draft, target, mode, k)
            want = dict.fromkeys(counters(), 0)
            for tree in (draft, target):
                add_to(want, expected_launches(cfg, tree, mode, 0, 63))
            for key, v in rnd.items():
                want[key] += eng.rounds_run * v
            if got != want:
                fail(f"[15c] {dname} {name}: launches {nonzero(got)} != the "
                     f"prefills' + {eng.rounds_run} rounds x "
                     f"{nonzero(rnd)}: {nonzero(want)}")
            add_to(total, got)
            per_round[mode] = rnd
            (prog,) = eng.programs.values()
            for lvl, (graph, counts) in prog.graphs.items():
                nodes = graph_nodes(graph)
                fams = counted_families(counts, k + 1)
                if nodes != fams or rows_of(counts) != nonzero(rnd):
                    fail(f"[15c] {dname} {name} level {lvl}: kernel nodes "
                         f"{nodes}, a replay counts {fams} "
                         f"({rows_of(counts)} against {nonzero(rnd)})")
            st = eng.last_stats
            verdict = spec_verdict(torch, cfg, target, mode, grid, mask,
                                   plain[name], out, k)
            n = out[3]
            print(f"[15a] {dname}, {name} ({frames} frames, k = {k}): "
                  f"{n} frames in {dt:.3f} s = {n / dt:.2f} frames/s "
                  f"(capture {eng.capture_seconds:.3f} s included; {card}); "
                  f"{st['rounds']} rounds, acceptance "
                  f"{st['acceptance_rate']:.4f} ({st['accepted']} of "
                  f"{st['drafted']}), {eng.rounds_run} rounds run; "
                  f"{json.dumps(verdict)}", flush=True)
            if not verdict["ok"]:
                bad.append(f"{dname} {name}")
            del eng
    # planted faults, on the ASR request (their launches not counted)
    mode, frames, grid, mask = requests["asr"]
    caught = {}
    for label, ctx, draft in (
            ("control: a frame accepted past the first mismatch",
             accepted_past_mismatch, params1),
            ("control: the position advanced by n_acc",
             pos_one_short, target),
            ("control: the fresh frame from h[n_acc - 1]",
             fresh_row_one_early, target)):
        with ctx():
            eng = SpeculativeEngine(draft, target, cfg, k=k,
                                    max_frames=frames, buckets=(64,))
            out = eng._run(mode, grid, mask)
        verdict = spec_verdict(torch, cfg, target, mode, grid, mask,
                               plain["asr"], out, k)
        first = verdict["first_difference"]
        caught[label] = (first is not None and not first["certified"],
                         verdict["stream"]["max_gap"] > SPEC_STREAM_TOL)
        print(f"[15a] {label} (asr): {json.dumps(verdict)}; rejected by the "
              f"first difference: {caught[label][0]}, by the whole stream: "
              f"{caught[label][1]} ({card})", flush=True)
        del eng
    print(f"[15a] {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    # 15b: the cost probe, its engines' rounds profiled (not counted)
    t1 = time.perf_counter()

    def on_engine(kk, label, eng):
        (prog,) = eng.programs.values()
        (graph, counts), = prog.graphs.values()
        wall, n_kernels, busy, _, _, split = busy_window(
            torch, graph.replay, kk + 1)
        pool = eng.pool_bytes()
        print(f"[15b] k = {kk}, {label}: one round replayed: wall {wall:.3f} "
              f"ms, {n_kernels} device kernels traced, {busy:.3f} ms of "
              f"device time, busy share "
              f"{busy / wall if n_kernels else float('nan'):.3f}; capture "
              f"{eng.capture_seconds:.3f} s, graph pool "
              f"{'not measured' if pool is None else f'{pool / 2 ** 20:.1f} MiB'}"
              f"; launches a round by row {json.dumps(rows_of(counts))}; "
              f"device ms by kernel: " + "; ".join(
                  f"{name} {ms:.4f} ({calls})"
                  for name, (ms, calls) in list(split.items())[:8])
              + f" ({card})", flush=True)

    lines = bench_speculative.bench(cfg, int4all, target, params1, ks=SPEC_KS,
                                    frames=128, cache_dtype=torch.bfloat16,
                                    buckets=(64,), on_engine=on_engine)
    print(f"[15b] the lines above on {card}; k = 2 and 8 cut (the phase's "
          f"time); {time.perf_counter() - t1:.1f} s", flush=True)
    if [x["metric"] for x in lines] != ["plain_greedy_frame_ms"] + [
            "speculative_round_cost"] * len(SPEC_KS):
        fail(f"[15b] the probe printed {lines}")
    # 15c: row 3 above 16 rows: the QKV steps run at M = 1 and M = k
    qkv = sum(v for key, v in total.items() if key.startswith("qkv_rope_step"))
    print(f"[15c] launches by row {json.dumps(nonzero(total))}; a round by "
          f"row: audio {json.dumps(nonzero(per_round['audio']))}, text "
          f"{json.dumps(nonzero(per_round['text']))}; row 3 (qkv_rope_step) "
          f"{qkv} launches, all at M = 1 or k = {k}: row 3 above 16 rows "
          f"launched 0 times; phase 15 {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    if bad:
        fail(f"[15a] streams left the plain greedy stream: {bad}")
    missed = [label for label, hit in caught.items() if not all(hit)]
    if missed:
        fail(f"[15a] the gate passed planted faults: {missed}")
    if k > 16 or not qkv:
        fail("[15c] row 3's launches")
    del target
    torch.cuda.empty_cache()
    return total


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
# took 181 s; `dequantized_once` now dequantizes each weight once for
# both CPU runs, the same bits; readings in PERF.md), run on the card and
# on the CPU (the twins and the plain int8
# attention the CPU tests hold token-identical to the JAX engine). If the
# card path added to the gap, the card would read more than the CPU: its
# error may be at most WITNESS_FACTOR x the CPU's, and its 1 - cosine
# WITNESS_FACTOR^2 x. The scale written one slot late, on the card, must
# fail the same test.
# On the H100 (seed 0), with both experts whole, the card read text
# 8.49e-2 / 0.99589, codebook 0 0.103 / 0.99205, K rows 5.58e-2 / 0.99904,
# the CPU 8.10e-2 / 0.99644, 0.103 / 0.99323, 5.13e-2 / 0.99919: the card
# added at most 1.09x the error and 1.18x the 1 - cosine; the fault read
# >= 1.30 / <= 0.525. The witness ran at 4 backbone layers until phase 14
# was added (its CPU path 144 s); at 2 it read card 4.29e-2 / 0.99919
# against the CPU's 4.66e-2 / 0.99924 on the text, the fault >= 0.797 /
# <= 0.797, in 88-91 s; at 1 the CPU path passes 3 layers, not 6.
# Readings at this depth in PERF.md.
WITNESS_DEPTH = 1
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
    with dequantized_once():
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
GRAPH_PROFILE_FRAMES = 8      # 16 before, cut for time
GRAPH_FAULT_FRAMES = 16
# Phase 11's bench-config and batched groups: the frames that keep their
# programs (bucket 64 in 256 slots, bf16 KV) at half of bench's and phase
# 10's depth (cut for time; 128 and 64 before)
GRAPH_BENCH_FRAMES = 64
GRAPH_BATCH_FRAMES = 32
# Sampled requests at the engine's policies: 193 frames (the fewest: 64 +
# 193 > 256) take a 512-slot cache (int8 KV, block-128 levels) for a
# bucket-64 and a bucket-256 prompt, so one program serves both and the
# second needs new levels (200 before, cut for time).
SAMPLED_FRAMES = 193
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
    """Phase 11: TTS (`GRAPH_BENCH_FRAMES` frames, bucket 64, 256 slots,
    bf16 cache), the CFG pair and ASR at batch 1; TTS deferred and inline at the fewest frames
    that keep the defaults' policies (`SAMPLED_FRAMES`, 512 slots, int8 KV,
    block-128 levels: phase 9 serves both at the defaults, 500 frames);
    greedy inline TTS, then sampled TTS (the default topk 200 from the shared
    generator, through the same engine): a
    bucket-64 prompt that runs to max_frames, then a bucket-256 prompt
    through the same program, which captures two new levels, and a CFG
    pair, then greedy ASR (`SAMPLED_FRAMES` through the same policies: phase 9
    serves ASR at the defaults, phase 12 runs ASR graph against eager at
    512 slots too); 8 ASR rows greedy and with per-row seeds and 8 TTS rows
    (`GRAPH_BATCH_FRAMES` frames): each once with ``graph=False`` and once
    through the graphs.
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
    bench = dict(max_frames=GRAPH_BENCH_FRAMES, buckets=(64,))
    batch = dict(max_frames=GRAPH_BATCH_FRAMES, buckets=(64,))
    groups = (  # engine kwargs, [(name, mode, rows, prefill rows, call)]
        (bench, [
            ("tts", "audio", 1, 63, lambda e: e.generate_audio(g, m, **greedy)),
            ("tts_cfg", "audio", 2, 126,
             lambda e: e.generate_audio(g, m, **greedy, **pair)),
            ("asr", "text", 1, 63,
             lambda e: [e.generate_text(ag, am, **greedy)])]),
        ({"kv_write": "deferred", "max_frames": SAMPLED_FRAMES}, [
            (f"tts deferred, {SAMPLED_FRAMES} frames", "audio", 1, 63,
             lambda e: e.generate_audio(g, m, **greedy))]),
        ({"max_frames": SAMPLED_FRAMES}, [
            (f"tts inline, {SAMPLED_FRAMES} frames", "audio", 1, 63,
             lambda e: e.generate_audio(g, m, **greedy)),
            ("tts, topk 200, seed 5", "audio", 1, 63,
             lambda e: e.generate_audio(g, m, seed=5)),
            ("tts, topk 200, seed 5, bucket-256 prompt", "audio", 1, 255,
             lambda e: e.generate_audio(lg, lm, seed=5)),
            ("tts_cfg, topk 200, seed 6", "audio", 2, 126,
             lambda e: e.generate_audio(g, m, seed=6, **pair)),
            (f"asr, {SAMPLED_FRAMES} frames", "text", 1, 63,
             lambda e: [e.generate_text(ag, am, **greedy)])]),
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
    sections = [("start", time.perf_counter())]
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
        sections.append((f"group {len(sections)}", time.perf_counter()))
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
    sections.append(("profiled windows", time.perf_counter()))
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
    sections.append(("graph nodes", time.perf_counter()))
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
    sections.append(("controls", time.perf_counter()))
    print("[11] seconds by section: " + ", ".join(
        f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t)
        in zip(sections, sections[1:])), flush=True)
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
TRAIN_STEPS = 4     # phase 7a: a warm-up step and 3 timed (6 before)


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


def build_training(torch, dev, mesh=None, tag="7a"):
    """Full-width params, the adamw_lean train step and one fixed batch;
    with ``mesh`` the state is sharded on it and the step is the mesh's."""
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
    state = trainer.init_train_state(params, tx, device=dev, mesh=mesh)
    del params
    torch.cuda.synchronize()
    batcher = LengthBatcher(train_examples(cfg), cfg.tokens, batch_scale=4096,
                            text_tokenizer=IntTok(), max_length=2048)
    raw = next(batcher.batches(epoch=0))
    batch = trainer.to_batch(raw, dev)
    print(f"[{tag}] full UnifiedModelConfig, {gpt.param_count(state.params) / 1e9:.3f} "
          f"B bf16 params + adamw_lean state in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB; batch grid "
          f"{tuple(raw['grid'].shape)} ({len(batcher._built)} examples)", flush=True)
    step = trainer.build_train_step(cfg, tx, remat=True, mesh=mesh)
    return cfg, sched, state, step, batch, raw


# Phase 16(a) holds the mesh step to these leaves of phase 7a's state after
# its second step, bit for bit: a lean-kernel leaf (projection_w), a rank-1
# leaf on the plain chain, and a stacked leaf of the local decoder.
MESH_LEAVES = (("projection_w",), ("backbone", "ln_f_w"),
               ("decoder", "layers", "qkv_w"))


def leaf_at(params, path):
    for k in path:
        params = params[k]
    return params


def leaf_diff(torch, a, b):
    """(bit-equal, share of elements that differ, max|a - b| / max|b|)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return (bool(torch.equal(a, b)), float((diff > 0).float().mean()),
            float(diff.max() / b.abs().max().clamp_min(1e-30)))


def phase_train(torch, dev):
    """(a) The full-width adamw_lean train step. Returns the lean kernel's
    launches on the main path and phase 16(a)'s reference: the first two
    steps' loss and grad_norm, `MESH_LEAVES` after the second."""
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
    ref = {"loss": [], "grad_norm": []}     # phase 16(a)'s reference
    for i in range(TRAIN_STEPS):                     # 1 warm-up, the rest timed
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
        if i < 2:
            ref["loss"].append(loss)
            ref["grad_norm"].append(gnorm)
        if i == 1:
            ref["leaves"] = [leaf_at(state.params, p).detach().cpu().clone()
                             for p in MESH_LEAVES]
        if i:
            losses.append(loss)
            secs.append(dt)
    launches = lu.fused_lean_update.launches
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs)
    flops = train_flops(cfg, b, s)
    print(f"[7a] batch (B, S) = ({b}, {s}): {b * s} tokens a step ({real} "
          f"unpadded); step {step_s:.3f} s (median of {len(secs)}, min "
          f"{min(secs):.3f}) = "
          f"{b * s / step_s:.0f} train tokens/s ({real / step_s:.0f} unpadded); "
          f"peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)", flush=True)
    print(f"[7a] model FLOPs a step {flops:.4g} (3 x the forward's products: "
          f"linear layers, full S x S attention, projection, CE heads; remat "
          f"not counted) = {flops / step_s / 1e12:.1f} TFLOP/s, "
          f"{flops / step_s / PEAK_BF16:.4f} of 989 TFLOP/s", flush=True)
    print(f"[7a] lean launches {launches} = {launches / TRAIN_STEPS:.1f} per optimizer step; "
          f"the leaf predicate gives {fused} fused leaves of {len(leaves)}",
          flush=True)
    if launches != TRAIN_STEPS * fused or launches == 0:
        fail(f"lean launches {launches} != {TRAIN_STEPS} steps x {fused} "
             f"fused leaves")
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
    return launches, ref


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


# ---------------------------------------------------------------------------
# Phase 12: audio in
# ---------------------------------------------------------------------------
# The full EncoderConfig() with seeded random float32 weights tokenizes a
# seeded synthetic 10 s clip at 24 kHz from a wav file (two 30 s windows in
# one batch); phase 4's int4all tree transcribes the tokens (ASR) through
# the frame graphs and eagerly; phase 6's codec decodes them back.
AUDIO_SECONDS = 10.0
ASR_FRAMES = 64
ASR_PROMPT = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)     # bench's ASR task prompt
# The cut-depth witness: every tower cut to one layer at full width, the
# same weights, one encode of the clip's two windows on the card (TF32 off)
# and on the CPU, both float32: each tower's features within
# max|card - cpu| <= WITNESS_RTOL x max|cpu|. Both sides keep every product
# in f32 and sum in another order (cuBLAS / cuDNN against oneDNN) over at
# most 4096 terms, through a log-mel, a GroupNorm and one layer: ~1e-6
# expected, the bound set before the first reading ~1000x above that. On
# the H100 the sound run reads 1.7e-6 (Whisper) to 4.7e-6 (BEST-RQ); the
# planted fault (the resampler's up phases in reverse order) 0.40 and 0.43
# on the Whisper and WavLM features (PERF.md). Ids must be identical, but for a
# certified tie: an id whose CPU distance lies within twice the measured
# distance error of the CPU's best (the features' error seen in distance
# space); a tie excuses the later quantizers of its frame and, in the
# reasoning RVQ, the rec frames its 5 Hz frame conditions.
WITNESS_RTOL = 1e-3


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def build_encoder(torch, dev):
    from uniaudio2_tpu_torch.codec.encoder import EncoderConfig, init_encode_params

    cfg = EncoderConfig()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    params = init_encode_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    w, wl, s, r = cfg.whisper, cfg.wavlm, cfg.ssl, cfg.reasoning
    rec = params["rvq_phone"]["codebooks"].shape[1]
    print(f"[12] full EncoderConfig encode params (Whisper {w.n_layers} x "
          f"{w.d_model}, WavLM {wl.num_layers} x {wl.hidden_size}, BEST-RQ "
          f"{s.num_layers} x {s.hidden_size}, reasoning {r.depth} x {r.dim}, "
          f"{r.num_quantizers} x {r.codebook_size} and 8 x {rec} codebooks): "
          f"{n / 1e9:.3f} B parameters, "
          f"{(torch.cuda.memory_allocated() - before) / 2 ** 30:.2f} GiB float32, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def synthetic_clip(sr, seconds, seed=12):
    """Six seeded tones under a slow swell, plus a little noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in zip(
        rng.uniform(80, 4000, 6), rng.uniform(0.02, 0.1, 6),
        rng.uniform(0, 2 * np.pi, 6)))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 0.5 * t))
    return (x + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def tower_ms(torch, cfg, ccfg, params, windows):
    """CUDA-event ms of each stage of one encode of ``windows``."""
    from uniaudio2_tpu_torch.codec import (
        encoder, mel, reasoning, ssl_encoder, wavlm_encoder, whisper_encoder,
    )

    dev = params["reasoning"]["cls_token"].device
    wav = torch.as_tensor(windows, device=dev)
    ms = {}

    def timed(name, fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = round(start.elapsed_time(end), 3)
        return out

    with torch.no_grad():
        wav16 = timed("resample", lambda: mel.resample(wav, ccfg.sample_rate, 16000))
        mels = timed("log_mel", lambda: mel.log_mel_spectrogram(
            wav16, cfg.whisper.n_mels)[:, : 2 * cfg.whisper.max_positions])
        timed("whisper", lambda: whisper_encoder.forward(
            params["whisper"], cfg.whisper, mels))
        timed("bestrq", lambda: ssl_encoder.acoustic_semantic_features(
            params["ssl"], cfg.ssl, wav, layers=cfg.ssl_layers))
        wavlm_in = torch.cat([wav16, wav16.new_zeros((wav16.shape[0], 160))], -1)
        timed("wavlm", lambda: wavlm_encoder.phone_features(
            params["wavlm"], cfg.wavlm, wavlm_in))
        feats = timed("towers_total", lambda: encoder.tower_features(
            params, cfg, ccfg, wav))
        _, reason_q = timed("reasoning", lambda: reasoning.encode(
            params["reasoning"], cfg.reasoning, feats["whisper"], feats["bestrq_sem"]))
        timed("fusion_rvq", lambda: encoder.fuse_and_quantize(
            params, feats["whisper"], feats["wavlm"], feats["bestrq_ac"],
            feats["bestrq_sem"], reason_q))
    return ms


def cut_encoder(cfg, params):
    """Every tower cut to its first layer (the reasoning transformer to its
    first block), the same weights: WavLM's phone features the mean of the
    embedding and layer 0, BEST-RQ's both outputs layer 0."""
    from dataclasses import replace

    def first(tree, key):
        return dict(tree, **{key: {k: v[:1] for k, v in tree[key].items()}})

    cut_cfg = replace(
        cfg, whisper=replace(cfg.whisper, n_layers=1),
        wavlm=replace(cfg.wavlm, num_layers=1, phone_layers=(0, 2)),
        ssl=replace(cfg.ssl, num_layers=1),
        reasoning=replace(cfg.reasoning, depth=1), ssl_layers=(0, 0))
    cut = dict(params, whisper=first(params["whisper"], "layers"),
               wavlm=first(params["wavlm"], "layers"),
               ssl=first(params["ssl"], "layers"),
               reasoning=first(params["reasoning"], "blocks"))
    return cut_cfg, cut


def encode_recorded(torch, cfg, ccfg, params, wav):
    """One encode of ``wav``: the tower features, the reason and rec codes
    and the input of every `rvq.encode` (reasoning, phone, semantic,
    acoustic), all on the CPU."""
    from uniaudio2_tpu_torch.codec import encoder, rvq

    inputs, real = [], rvq.encode

    def record(p, x):
        inputs.append(x)
        return real(p, x)

    with torch.no_grad(), mock.patch.object(rvq, "encode", record):
        feats = encoder.tower_features(params, cfg, ccfg, wav)
        reason, rec = encoder.encode_features(params, cfg, feats)
    return ({k: v.cpu() for k, v in feats.items()}, reason.cpu(), rec.cpu(),
            [x.cpu() for x in inputs])


def certify(torch, label, p, x_card, x_cpu, got, ref, excused):
    """The card's ids ``got`` against the CPU's ``ref`` (..., T, Q) of one
    RVQ with parameters ``p`` (on the CPU), walking both residual streams:
    a difference at a frame not in ``excused`` must be a certified tie.
    Returns (ties, frames excused after this RVQ, problems)."""
    from uniaudio2_tpu_torch.codec import rvq

    r_c = x_card @ p["project_in_w"] + p["project_in_b"]
    r_p = x_cpu @ p["project_in_w"] + p["project_in_b"]
    excused = excused.clone()
    ties, problems = [], []
    for q, cb in enumerate(p["codebooks"]):
        d_c, d_p = rvq.distances(r_c, cb), rvq.distances(r_p, cb)
        live = ~excused
        err = float((d_c - d_p).abs()[live].max()) if live.any() else 0.0
        for pos in torch.nonzero((got[..., q] != ref[..., q]) & live).tolist():
            pos = tuple(pos)
            row = d_p[pos]
            gap = float(row[int(got[pos][q])] - row[int(ref[pos][q])])
            entry = (f"{label} frame {pos} quantizer {q}: card {int(got[pos][q])}, "
                     f"cpu {int(ref[pos][q])}, distance gap {gap:.3e}, measured "
                     f"distance error {err:.3e}")
            (ties if gap <= 2 * err else problems).append(entry)
            excused[pos] = True
        r_c = r_c - cb[got[..., q].long()]
        r_p = r_p - cb[ref[..., q].long()]
    return ties, excused, problems


def witness_verdict(torch, cut_cpu, got, ref):
    """(tower errors, certified ties, problems) of a card encode ``got``
    against the CPU's ``ref`` (`encode_recorded`)."""
    feats, reason, rec, x_card = got
    feats_r, reason_r, rec_r, x_cpu = ref
    problems = []
    errs = {}
    for name, v in feats_r.items():
        if feats[name].shape != v.shape:
            problems.append(f"{name} features {tuple(feats[name].shape)} != "
                            f"{tuple(v.shape)}")
            continue
        errs[name] = float((feats[name] - v).abs().max() / v.abs().max())
        if not errs[name] <= WITNESS_RTOL:
            problems.append(f"{name} features off by {errs[name]:.3e} x max|cpu|")
    if reason.shape != reason_r.shape or rec.shape != rec_r.shape:
        problems.append(f"code shapes {tuple(reason.shape)} {tuple(rec.shape)} "
                        f"against {tuple(reason_r.shape)} {tuple(rec_r.shape)}")
    if problems:
        return errs, [], problems
    rvqs = [cut_cpu["reasoning"]["rvq"], cut_cpu["rvq_phone"],
            cut_cpu["rvq_semantic"], cut_cpu["rvq_acoustic"]]
    ties, bad, excused_reason = [], [], torch.zeros(reason.shape[:2], dtype=torch.bool)
    t, e, b = certify(torch, "reason", rvqs[0], x_card[0], x_cpu[0], reason,
                      reason_r, excused_reason)
    ties += t
    bad += b
    # a rec frame j is conditioned by reason frame floor(j / 2.5)
    j = torch.arange(rec.shape[1])
    excused_rec = e[:, (j / 2.5).floor().long().clamp(max=e.shape[1] - 1)]
    cols = ((0, 1), (1, 2), (2, 8))
    for name, p, xc, xp, (lo, hi) in zip(("phone", "semantic", "acoustic"),
                                         rvqs[1:], x_card[1:], x_cpu[1:], cols):
        n = min(xc.shape[1], rec.shape[1])
        t, _, b = certify(torch, name, p, xc[:, :n], xp[:, :n], rec[:, :n, lo:hi],
                          rec_r[:, :n, lo:hi], excused_rec[:, :n])
        ties += t
        bad += b
    return errs, ties, problems + bad


def reversed_phases(kernel_fn):
    """The planted fault: the resampler's ``up`` phases in reverse order."""
    def fn(*args):
        kernel, width = kernel_fn(*args)
        return kernel[::-1].copy(), width
    return fn


def phase_audio_witness(torch, dev, cfg, ccfg, params, windows):
    """The cut-depth witness and its planted fault (see WITNESS_RTOL)."""
    from uniaudio2_tpu_torch.codec import mel

    cut_cfg, cut = cut_encoder(cfg, params)
    cut_cpu = to_cpu(cut)
    wav = torch.from_numpy(windows)
    t0 = time.perf_counter()
    ref = encode_recorded(torch, cut_cfg, ccfg, cut_cpu, wav)
    cpu_s = time.perf_counter() - t0
    got = encode_recorded(torch, cut_cfg, ccfg, cut, wav.to(dev))
    errs, ties, problems = witness_verdict(torch, cut_cpu, got, ref)
    print(f"[12] witness, every tower at one layer, full width, card vs CPU "
          f"({cpu_s:.1f} s of CPU): features max|diff| / max|cpu| "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
          f"(bound {WITNESS_RTOL}); reason {tuple(got[1].shape)} and rec "
          f"{tuple(got[2].shape)} ids: {len(ties)} certified tie(s), "
          f"{(got[1] != ref[1]).sum().item() + (got[2] != ref[2]).sum().item()} "
          f"ids differ in all", flush=True)
    for tie in ties:
        print(f"[12] certified tie: {tie}", flush=True)
    if problems:
        fail(f"audio-in witness: {problems}")
    with mock.patch.object(mel, "_resample_kernel",
                           reversed_phases(mel._resample_kernel)):
        bad = encode_recorded(torch, cut_cfg, ccfg, cut, wav.to(dev))
    errs, _, problems = witness_verdict(torch, cut_cpu, bad, ref)
    print(f"[12] planted fault (the resampler's up phases reversed): features "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
          f"{'rejected' if problems else 'PASSED'}: {problems[:3]}", flush=True)
    if not problems:
        fail("the audio-in witness passed the reversed resampler phases")


def phase_audio_in(torch, dev, cfg, params, ccfg, dec):
    """Phase 12: tokenize a wav file at full width, twice; each stage's
    device ms; the cut-depth witness; ASR from the tokens through the
    graphs and eagerly, launches against the tree's count; detokenize
    through phase 6's decoder. Returns the launches by row, and the
    tokenizer, the clip's tokens and its path for phase 13."""
    import numpy as np
    from uniaudio2_tpu_torch.codec import dit
    from uniaudio2_tpu_torch.codec.tokenizer import ReasoningCodecTokenizer, save_wav
    from uniaudio2_tpu_torch.engine import tasks
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine, pick_bucket
    from uniaudio2_tpu_torch.ops import _cuda
    from uniaudio2_tpu_torch.ops import flash_attention as fa

    enc_cfg, enc_params = build_encoder(torch, dev)
    tok = ReasoningCodecTokenizer(enc_params, None, enc_cfg, ccfg)
    tok.decoder = dec                                 # phase 6's codec
    sr = ccfg.sample_rate
    root = ROOT / "build" / "smoke_audio"
    root.mkdir(parents=True, exist_ok=True)
    path = str(root / "clip.wav")
    save_wav(path, synthetic_clip(sr, AUDIO_SECONDS), sr)
    tok.tokenize(path)                              # warm-up (cuDNN, cuBLAS)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(tok.tokenize(path))
        runs[-1] += (time.perf_counter() - t0,)
    (reason, semantic, encode_s), (reason2, semantic2, encode2_s) = runs
    want = ((8, int(AUDIO_SECONDS * ccfg.reason_hz) + 1),
            (8, int(AUDIO_SECONDS * ccfg.rec_hz) + 1))
    windows = tok.windows(synthetic_clip(sr, AUDIO_SECONDS))
    print(f"[12] tokenize a {AUDIO_SECONDS:.0f} s clip at {sr} Hz from "
          f"{Path(path).relative_to(ROOT)} ({windows.shape[0]} windows of "
          f"{windows.shape[1]} samples, one batch): reason {reason.shape} "
          f"semantic {semantic.shape} in {encode_s:.3f} s (again {encode2_s:.3f} s)",
          flush=True)
    if (reason.shape, semantic.shape) != want:
        fail(f"tokenize shapes {reason.shape} {semantic.shape} != {want}")
    if (reason.min() < 0 or reason.max() >= ccfg.reason_codebook_size
            or semantic.min() < 0 or semantic.max() >= ccfg.rec_codebook_size):
        fail("tokenize: an id outside its codebook")
    if not (np.array_equal(reason, reason2) and np.array_equal(semantic, semantic2)):
        fail("two tokenizations of the same clip differ")
    print(f"[12] encode device ms by stage (CUDA events, both windows): "
          f"{json.dumps(tower_ms(torch, enc_cfg, ccfg, enc_params, windows))}",
          flush=True)
    phase_audio_witness(torch, dev, enc_cfg, ccfg, enc_params, windows)

    grid, mask = tasks.prepare_asr(np.asarray(ASR_PROMPT), reason.T, semantic.T,
                                   cfg.tokens)
    bucket = pick_bucket(grid.shape[0])
    if bucket != 256:
        fail(f"the ASR grid ({grid.shape[0]} rows) is not in bucket 256")
    reset_counts()
    want, want_tile, outs = dict.fromkeys(counters(), 0), {}, []
    engines = {}
    for graph in (False, True):
        eng = engines[graph] = DecodeEngine(params, cfg, max_frames=ASR_FRAMES,
                                            graph=graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.generate_text(grid, mask, topk=1))
        dt = time.perf_counter() - t0
        add_to(want, expected_launches(cfg, params, "text", eng.last_frames_run,
                                       bucket - 1))
        add_to(want_tile, expected_tile(params, bucket - 1))
        print(f"[12] ASR, {'graphs' if graph else 'eager'}: grid {grid.shape[0]} "
              f"rows (bucket {bucket}), {eng.last_steps} frames in {dt:.3f} s"
              f"{f', {eng.capture_seconds:.3f} s of it capture' if graph else ''}; "
              f"text {outs[-1].shape}", flush=True)
    # wav file -> text once more, on the captured programs
    eng = engines[True]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, s = tok.tokenize(path)
    g, m = tasks.prepare_asr(np.asarray(ASR_PROMPT), r.T, s.T, cfg.tokens)
    text = eng.generate_text(g, m, topk=1)
    wall = time.perf_counter() - t0
    add_to(want, expected_launches(cfg, params, "text", eng.last_frames_run,
                                   bucket - 1))
    add_to(want_tile, expected_tile(params, bucket - 1))
    print(f"[12] wav -> text wall {wall:.3f} s ({len(text)} text ids, "
          f"{eng.last_steps} frames)", flush=True)
    if not (same_tokens(outs[0], outs[1]) and same_tokens(outs[1], text)):
        fail("ASR from audio: graph and eager tokens differ")
    got = read_counts()
    print(f"[12] launches {json.dumps(nonzero(got))} expected "
          f"{json.dumps(nonzero(want))}", flush=True)
    if got != want:
        fail(f"phase 12 launch counts {got} != the path's {want}")
    check_tile("[12]", want_tile)
    del engines, eng
    torch.cuda.empty_cache()

    _cuda.reset_count(fa.flash_attention)
    dit._attention.plain_launches = 0
    t0 = time.perf_counter()
    wav = tok.detokenize(reason, semantic, steps=10, seed=2)
    dt = time.perf_counter() - t0
    # the 126 frames fit the half-window bucket: one window
    flash = fa.flash_attention.launches
    want_flash = 10 * ccfg.dit.num_layers
    print(f"[12] detokenize the codes (10 steps): {dt:.3f} s, wav {wav.shape} "
          f"max|x| {np.abs(wav).max():.4f}; flash launches {flash} (expected "
          f"{want_flash}), plain path {dit._attention.plain_launches}", flush=True)
    if wav.shape != (1, int(semantic.shape[1] / ccfg.rec_hz * sr)) or not np.isfinite(
            wav).all():
        fail(f"detokenize: bad waveform {wav.shape}")
    if flash != want_flash or dit._attention.plain_launches:
        fail(f"detokenize: flash launches {flash} != {want_flash}")
    got["flash_attention"] = flash
    return got, (tok, reason, semantic, path)


def asr_from_wav(torch, dev, path):
    """``--asr WAV``: phase 4's int4all tree and the full encoder, both
    random from their seeds, transcribe one wav file: its tokens, the text
    ids and the wall seconds of each stage."""
    import numpy as np
    from uniaudio2_tpu_torch.codec.decoder import CodecConfig
    from uniaudio2_tpu_torch.codec.tokenizer import ReasoningCodecTokenizer
    from uniaudio2_tpu_torch.engine import tasks
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    cfg, base, params = build_model(torch, dev)
    del base
    torch.cuda.empty_cache()
    enc_cfg, enc_params = build_encoder(torch, dev)
    tok = ReasoningCodecTokenizer(enc_params, None, enc_cfg, CodecConfig())
    eng = DecodeEngine(params, cfg, max_frames=ASR_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reason, semantic = tok.tokenize(path)
    t1 = time.perf_counter()
    grid, mask = tasks.prepare_asr(np.asarray(ASR_PROMPT), reason.T, semantic.T,
                                   cfg.tokens)
    text = eng.generate_text(grid, mask, topk=1)
    t2 = time.perf_counter()
    print(json.dumps({"wav": path, "reason": list(reason.shape),
                      "semantic": list(semantic.shape), "text": text.tolist(),
                      "tokenize_s": round(t1 - t0, 3),
                      "generate_text_s": round(t2 - t1, 3),
                      "capture_s": round(eng.capture_seconds, 3)}), flush=True)


# ---------------------------------------------------------------------------
# Phase 13: the CLI on the card
# ---------------------------------------------------------------------------
# `cli.main` at full width through the seams a caller can replace: the text
# tokenizer (the card's machine has neither `tokenizers` nor `sentencepiece`)
# and the codec (phase 12's). The first run builds the int4all tree; the
# later runs, the server and the HTTP endpoint take the same runner.
# Phase 14: continuous batching (`engine/continuous.py`) and streaming TTS
# (`engine/stream_tts.py`) on phase 4's int4all tree of the full config.
# (a) offline: `run_offline` over CONT_REQUESTS ASR requests through
# CONT_ROWS rows (bucket 64, greedy, batch eval's cache rule: 256 slots, so
# "auto" picks the int8 KV cache at 8 rows and no prefix levels). Every
# admission is probed (`admission_probes`): right after the refill, the
# admitted row's first frame is re-run alone (M = 1, eagerly, its launches
# not counted; the replayed frame then rewrites the slot it wrote) and its
# backbone K rows and text logits are held to the same request refilled
# alone into row 0 of an empty engine (phase 5's bounds; the two sit at
# different positions, so RoPE rounds differently in bf16), and the rows
# live on the device to the rows the host holds busy. Three planted faults
# must each fail a line: `valid_from` one slot early (a pad slot visible),
# the prompt refilled to end one position before the window's, a finished
# row left active (the step never clears ``active``).
# (b) online: `step_online` at the engine's defaults (4 rows, ladder auto,
# two windows, 512 slots: int8 KV, block-128 levels) over ONLINE_REQUESTS
# TTS requests of ONLINE_FRAMES frames arriving by a seeded Poisson process
# at ONLINE_LOAD of the rate the same requests reach submitted at once to
# `run_until_drained`; then CFG pairs (4 rows, CFG_BURST requests at once):
# both rows of a pair get the same frames.
# (c) stream: a one-row engine's `stream()` gives its `run_until_drained`
# tokens (same position, same M), and `stream_tts` fed phase 6's codes by a
# scripted frame source gives phase 6's offline waveform bit for bit.
CONT_REQUESTS = 24
CONT_ROWS = 8
CONT_BUDGETS = (64, 128)
ONLINE_REQUESTS = 32
ONLINE_FRAMES = 32
ONLINE_LOAD = 0.7
CFG_BURST = 8
CFG_FRAMES = 16
STREAM_FRAMES = 64
CONT_BOUNDS = {"text": BOUNDS["text"], "k_rows": BOUNDS["k_rows"]}
CONT_TIGHT = {"text": (1e-3, 0.99999), "k_rows": (1e-3, 0.99999)}


def continuous_requests(cfg, n, seed=14):
    """``n`` ASR requests (grid, mask, budget): prompts 8-63 tokens long,
    budgets mixed between CONT_BUDGETS."""
    import numpy as np
    from uniaudio2_tpu_torch.engine import tasks

    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        g, m = tasks.prepare_asr(
            np.arange(1, int(rng.integers(2, 8)), dtype=np.int64),
            rng.integers(0, 100, (int(rng.integers(1, 16)), 8)),
            rng.integers(0, 200, (int(rng.integers(1, 40)), 8)), cfg.tokens)
        if 8 <= g.shape[0] <= 63:
            out.append((g, m, int(rng.choice(CONT_BUDGETS))))
    return out


def tts_requests(cfg, n, seed=15):
    """``n`` TTS requests on bench's prompt, texts of 6-20 ids."""
    import numpy as np
    from uniaudio2_tpu_torch.engine import tasks

    rng = np.random.default_rng(seed)
    prompt = np.arange(1, 24, dtype=np.int64) % 100
    return [tasks.prepare_tts(prompt, rng.integers(5, 100, int(rng.integers(
        6, 21))), cfg.tokens) for _ in range(n)]


def continuous_expected(cfg, params, mode, frames, refills):
    """Kernel launches of ``frames`` frames and ``refills`` refills (each
    the bucket-64 prompt's 63 rows through the experts and the backbone, as
    a prefill), by row, and the tile kernel's by form."""
    saved = dict(PREFILL_SWIGLU)
    one = expected_launches(cfg, params, mode, 0, 63)
    run = expected_launches(cfg, params, mode, frames, 63)
    PREFILL_SWIGLU.clear()
    PREFILL_SWIGLU.update(saved)
    want = {k: run[k] - one[k] + refills * one[k] for k in run}
    tile = {k: v * refills for k, v in expected_tile(params, 63).items()}
    return want, tile


def check_continuous(tag, cfg, params, eng, mode, frames0, refills0):
    """The counted launches since `reset_counts` against the engine's frames
    and refills since (``frames0``, ``refills0``); returns them."""
    want, tile = continuous_expected(cfg, params, mode,
                                     eng.frames_run - frames0,
                                     eng.refills_run - refills0)
    got = read_counts()
    print(f"{tag} launches {json.dumps(nonzero(got))} over "
          f"{eng.frames_run - frames0} frames and "
          f"{eng.refills_run - refills0} refills", flush=True)
    if got != want:
        fail(f"{tag} launch counts {got} != the path's {want}")
    check_tile(tag, tile)
    return got


def k_rows_at(torch, gcfg, cache, row, p):
    """The K rows a frame wrote at slot ``p`` of one batch row of ``cache``,
    every layer, rotated back from position ``p`` to 0 (so that rows written
    at two positions compare), float32 on the host."""
    from uniaudio2_tpu_torch.models import gpt
    from uniaudio2_tpu_torch.ops.kv_cache import QuantKV, unstack_cache
    from uniaudio2_tpu_torch.ops.rope import apply_rope

    rows = torch.stack([
        e.q[row, :, p].float() * e.s[row, :, p, None]
        if isinstance(e, QuantKV) else e[row, :, p].float()
        for e in unstack_cache(cache).k])                      # (L, G, hd)
    cos, sin = gpt._rope_tables(gcfg, cache.max_seq, rows.device)
    return apply_rope(rows, cos[p:p + 1], -sin[p:p + 1]).cpu()


def admission_probes(torch, probes):
    """While active, every refill is followed by a probe of each admitted
    row's first frame (appended to ``probes`` as {rid, text, k_rows, live}),
    its launches taken back out of the counters."""
    from uniaudio2_tpu_torch.engine import continuous
    from uniaudio2_tpu_torch.models import gpt, unified
    from uniaudio2_tpu_torch.ops import _cuda

    orig = continuous.ContinuousEngine._refill

    def probed(self, win, refills):
        orig(self, win, refills)
        if not refills:
            return
        before = _cuda.counts()
        s = win.state
        busy = {u * self._pair + j for u, slot in enumerate(win.slots)
                if slot.request_id >= 0 for j in range(self._pair)}
        live = set(torch.nonzero(s.active).flatten().tolist())
        pos = torch.full((1,), win.pos, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for u, req in refills:
                r = u * self._pair
                h, _ = unified.decode_hidden(
                    self.params, self.cfg, s.frame_tokens[r:r + 1],
                    s.frame_mask[r:r + 1], continuous.row_caches(s.caches, r),
                    pos, key_valid=self._slot_idx[None, :]
                    >= s.valid_from[r:r + 1, None],
                    attn_block=self.attn_block, host_pos=win.pos)
                text = gpt.lm_head(self.params["backbone"], h,
                                   self.cfg.backbone)
                probes.append({"rid": req.rid, "pos": win.pos,
                               "text": text.float().cpu(),
                               "k_rows": k_rows_at(torch, self.cfg.backbone,
                                                   s.caches.backbone, r,
                                                   win.pos),
                               "live": live == busy})
        _cuda.set_counts(before)

    return mock.patch.object(continuous.ContinuousEngine, "_refill", probed)


def valid_from_one_early():
    """The refill opens the row's cache mask one slot early: a pad slot of
    the prompt (or the row's stale data) becomes visible."""
    from uniaudio2_tpu_torch.engine import continuous

    orig = continuous._refill_one

    def early(params, cfg, s, row, *args, **kw):
        orig(params, cfg, s, row, *args, **kw)
        s.valid_from[row] -= 1

    return mock.patch.object(continuous, "_refill_one", early)


def prompt_one_short():
    """The refill writes the prompt to end one position before the
    window's, and its mask and budget from there."""
    from uniaudio2_tpu_torch.engine import continuous

    orig = continuous._refill_one

    def short(params, cfg, s, row, grid, mask, length, max_frames, bucket,
              pos, *rest):
        orig(params, cfg, s, row, grid, mask, length, max_frames, bucket,
             pos - 1, *rest)

    return mock.patch.object(continuous, "_refill_one", short)


def finished_left_active():
    """The step never clears a row's ``active`` flag: a row that finished
    stays live on the device (patched before the capture: a fresh
    engine)."""
    from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine

    orig = ContinuousEngine._frame

    def stuck(self, win, host_pos):
        before = win.state.active.clone()
        orig(self, win, host_pos)
        win.state.active.logical_or_(before)

    return mock.patch.object(ContinuousEngine, "_frame", stuck)


def offline_engine(cfg, params):
    from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine

    bucket, frames = 64, max(CONT_BUDGETS)
    return ContinuousEngine(params, cfg, mode="text", rows=CONT_ROWS,
                            bucket=bucket, max_frames=frames, topk=1,
                            cache_len=-(-(bucket + frames + 1) // 256) * 256)


def alone_probes(torch, cfg, params, requests, admitted):
    """Each request of the ``admitted`` probes refilled alone into row 0 of
    an empty engine at the position it was admitted at, probed."""
    from uniaudio2_tpu_torch.engine.continuous import _Request, _Slot

    eng = offline_engine(cfg, params)
    probes = []
    with admission_probes(torch, probes):
        for a in admitted:
            g, m, mf = requests[a["rid"]]
            win = eng._win
            eng._fresh(win)
            win.pos = a["pos"]
            win.state.pos.fill_(a["pos"])
            win.slots[0] = _Slot(request_id=a["rid"], max_frames=mf)
            eng._refill(win, [(0, _Request(a["rid"], g, m, mf))])
    return probes


def gate_admissions(torch, cfg, params, label, requests, probes):
    """Gate 3's lines over one run's probes, each against its request
    admitted alone at the same position: returns the names rejected."""
    caught = set()
    for p, ref in zip(probes, alone_probes(torch, cfg, params, requests,
                                           probes)):
        for tag, bounds in (("", CONT_BOUNDS), (" (tight)", CONT_TIGHT)):
            caught.update(k + tag for k in rejected(
                torch, "[14a]", f"{label}: request {p['rid']} at position "
                f"{p['pos']}{tag}", p, ref, bounds))
        if not p["live"]:
            caught.add("live rows")
            print(f"[14a] {label}: request {p['rid']}: rows live on the "
                  f"device != rows the host holds  REJECTED", flush=True)
    return caught


def phase_continuous_offline(torch, cfg, params):
    """Phase 14a; returns the counted launches."""
    items = continuous_requests(cfg, CONT_REQUESTS)
    eng = offline_engine(cfg, params)
    print(f"[14a] {len(items)} ASR requests, prompts "
          f"{min(g.shape[0] for g, _, _ in items)}-"
          f"{max(g.shape[0] for g, _, _ in items)} tokens, budgets "
          f"{sorted(set(mf for _, _, mf in items))}; {CONT_ROWS} rows, "
          f"cache {eng.cache_len} slots, KV {eng._cache_dtype}, levels "
          f"{eng.levels}", flush=True)
    probes = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with admission_probes(torch, probes):
        first = eng.run_offline(items)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = check_continuous("[14a]", cfg, params, eng, "text", 0, 0)
    frames = eng.frames_run
    t0 = time.perf_counter()
    second = eng.run_offline(items)
    dt2 = time.perf_counter() - t0
    row_frames = sum(len(t) for t in first)
    print(f"[14a] run_offline: {dt:.3f} s with the probes, {dt2:.3f} s "
          f"without ({eng.frames_run - frames} frames, "
          f"{len(items) / dt2:.2f} requests/s, {row_frames} tokens: "
          f"{row_frames / dt2:.1f} tokens/s)", flush=True)
    # gate 1: bit for bit; gate 2: EOS or the budget
    if not same_tokens(first, second):
        fail("[14a] two offline runs gave different tokens")
    for (g, m, mf), toks in zip(items, first):
        if len(toks) > mf or (toks.size and (toks.min() < 0 or toks.max()
                                             >= cfg.backbone.padded_vocab_size)):
            fail(f"[14a] a request's tokens {toks.shape} break its budget {mf}")
    print(f"[14a] two runs identical; tokens per request "
          f"{[len(t) for t in first]} within budgets", flush=True)
    # gate 3 and its planted faults
    if len(probes) != len(items):
        fail(f"[14a] {len(probes)} admissions probed of {len(items)}")
    caught = gate_admissions(torch, cfg, params, "sound", items, probes)
    if caught:
        fail(f"[14a] an admitted request's first frame left its bounds: "
             f"{sorted(caught)}")
    # the planted faults' runs: CONT_ROWS + 1 requests of the shortest
    # budget, so that the last is admitted into a window whose other rows
    # finished together and stay free
    few = [it for it in items if it[2] == min(CONT_BUDGETS)][:CONT_ROWS + 1]
    if len(few) < CONT_ROWS + 1:
        fail(f"[14a] {len(few)} requests of budget {min(CONT_BUDGETS)}")
    missed = []
    for label, fault, fresh in (("valid_from one slot early",
                                 valid_from_one_early, False),
                                ("prompt ending one position early",
                                 prompt_one_short, False),
                                ("finished row left active",
                                 finished_left_active, True)):
        faulty = []
        with fault(), admission_probes(torch, faulty):
            (offline_engine(cfg, params) if fresh else eng).run_offline(few)
        caught = gate_admissions(torch, cfg, params, f"control: {label}",
                                 few, faulty)
        print(f"[14a] control: {label}: rejected by {sorted(caught)}",
              flush=True)
        if not caught:
            missed.append(label)
    if missed:
        fail(f"[14a] gate 3 passed planted faults: {missed}")
    return got


def percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def phase_continuous_online(torch, cfg, params):
    """Phase 14b; returns the counted launches."""
    import numpy as np
    from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine

    reqs = tts_requests(cfg, ONLINE_REQUESTS)
    eng = ContinuousEngine(params, cfg, mode="audio")
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    print(f"[14b] defaults: {eng.rows} rows, bucket {eng.bucket}, segments "
          f"{eng.seg_ladder}, windows {eng.max_windows}, cache "
          f"{eng.cache_len} slots, KV {eng._cache_dtype}, levels {eng.levels};"
          f" warm-up (captures of both windows) {time.perf_counter() - t0:.2f}"
          f" s", flush=True)
    reset_counts()
    frames0, refills0 = eng.frames_run, eng.refills_run
    rids = [eng.submit(g, m, max_frames=ONLINE_FRAMES) for g, m in reqs]
    t0 = time.perf_counter()
    burst = eng.run_until_drained()
    rate = len(rids) / (time.perf_counter() - t0)
    if set(burst) != set(rids):
        fail("[14b] run_until_drained lost a request")
    print(f"[14b] all {len(rids)} at once through run_until_drained: "
          f"{rate:.3f} requests/s; stats {eng.stats}", flush=True)
    rng = np.random.default_rng(14)
    arrivals = np.cumsum(rng.exponential(1.0 / (ONLINE_LOAD * rate),
                                         len(reqs)))
    stats0 = dict(eng.stats)
    results, pending, ids = {}, list(range(len(reqs))), []
    t0 = time.monotonic()
    while len(results) < len(reqs):
        now = time.monotonic() - t0
        while pending and arrivals[pending[0]] <= now:
            g, m = reqs[pending.pop(0)]
            ids.append(eng.submit(g, m, max_frames=ONLINE_FRAMES))
        done = eng.step_online()
        results.update(done)
        idle = (eng._overlap is None and eng._queue.empty()
                and not any(s.request_id >= 0 for s in eng._win.slots))
        if idle and pending:
            time.sleep(max(0.0, arrivals[pending[0]] - (time.monotonic() - t0)))
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    got = check_continuous("[14b]", cfg, params, eng, "audio", frames0,
                           refills0)
    t = [eng.timings[r] for r in ids]
    if set(results) != set(ids) or any(
            x["frames"] > ONLINE_FRAMES or "done" not in x for x in t):
        fail("[14b] a request did not complete within its budget")
    ttft = [x["first"] - x["submitted"] for x in t]
    tpot = [(x["done"] - x["first"]) / max(1, x["frames"] - 1) for x in t]
    stats = {k: eng.stats[k] - stats0[k] for k in stats0}
    print(f"[14b] {len(ids)} requests at {ONLINE_LOAD} x {rate:.3f} = "
          f"{ONLINE_LOAD * rate:.3f} requests/s offered (Poisson, seed 14): "
          f"TTFT p50 {percentile(ttft, 50) * 1e3:.1f} ms, p99 "
          f"{percentile(ttft, 99) * 1e3:.1f} ms; TPOT p50 "
          f"{percentile(tpot, 50) * 1e3:.2f} ms; {len(ids) / wall:.3f} "
          f"requests/s served over {wall:.2f} s; stats {stats}", flush=True)
    # one eager refill and one 16-frame segment window, under the profiler
    from uniaudio2_tpu_torch.engine.continuous import _Request, _Slot

    win = eng._win
    g, m = reqs[0]
    refill_s = []
    for _ in range(5):
        eng._fresh(win)
        win.slots[0] = _Slot(request_id=0, max_frames=ONLINE_FRAMES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng._refill(win, [(0, _Request(0, g, m, ONLINE_FRAMES))])
        torch.cuda.synchronize()
        refill_s.append(time.perf_counter() - t1)
    wall_ms, n, dev_ms, _, _, fam = busy_window(
        torch, lambda: eng._refill(win, [(0, _Request(0, g, m,
                                                       ONLINE_FRAMES))]), 63)
    print(f"[14b] one eager refill (63 rows through the experts and the "
          f"backbone): mean {statistics.mean(refill_s) * 1e3:.2f} ms of 5; "
          f"profiled {wall_ms:.2f} ms wall, {n} kernels, {dev_ms:.2f} ms "
          f"device: busy {dev_ms / wall_ms:.1%}; top "
          f"{json.dumps({k: round(v[0], 3) for k, v in list(fam.items())[:4]})}",
          flush=True)
    for u in range(1, eng.rows):
        win.slots[u] = _Slot(request_id=u, max_frames=ONLINE_FRAMES)
        eng._refill(win, [(u, _Request(u, g, m, ONLINE_FRAMES))])
    wall_ms, n, dev_ms, _, _, _ = busy_window(
        torch, lambda: eng._segment(win, [], eng.seg_frames), eng.rows)
    print(f"[14b] one segment window ({eng.seg_frames} replays, {eng.rows} "
          f"live rows): {wall_ms:.2f} ms wall, {dev_ms:.2f} ms device, busy "
          f"{dev_ms / wall_ms:.1%}", flush=True)
    eng._fresh(win)
    # CFG pairs: both rows of a pair take the same frames
    ceng = ContinuousEngine(params, cfg, mode="audio", rows=4, use_cfg=True,
                            cfg_scale=1.5, max_frames=CFG_FRAMES)
    ncb = cfg.tokens.num_codebooks
    split = []
    orig = ceng._harvest

    def harvest(win, slab):
        for u, slot in enumerate(win.slots):
            if slot.request_id >= 0 and not np.array_equal(
                    slab[2 * u, :, 1:1 + ncb], slab[2 * u + 1, :, 1:1 + ncb]):
                split.append(slot.request_id)
        orig(win, slab)

    ceng._harvest = harvest
    (g, m), (ng, nm), _ = prompts(cfg)
    reset_counts()
    rids = [ceng.submit(g, m, neg_grid=ng, neg_mask=nm)
            for _ in range(CFG_BURST)]
    t0 = time.perf_counter()
    out = ceng.run_until_drained()
    dt = time.perf_counter() - t0
    add_to(got, check_continuous("[14b] cfg", cfg, params, ceng, "audio", 0,
                                 0))
    if set(out) != set(rids) or split:
        fail(f"[14b] CFG pairs: rows of a pair parted on requests {split}")
    print(f"[14b] CFG: {CFG_BURST} requests through 2 pair slots in "
          f"{dt:.3f} s, both rows of every pair the same frames; stats "
          f"{ceng.stats}", flush=True)
    return got


class ScriptedFrames:
    """A frame source for `stream_tts`: a reasoning frame, the generated
    semantic-BOS frame (dropped, as the offline split drops it), then the
    codes' frames in the semantic phase with a dropped frame after the
    third."""

    def __init__(self, cfg, codes):
        self.cfg, self.codes = cfg, codes

    def stream(self, grid, mask, max_frames=None):
        import numpy as np
        from uniaudio2_tpu_torch.engine.decode import (
            PHASE_DROPPED, PHASE_REASON, PHASE_SEMANTIC,
        )

        card = self.cfg.tokens.audio_reason_card
        yield PHASE_REASON, np.zeros(8, np.int64)
        yield PHASE_SEMANTIC, np.full(8, self.cfg.tokens.semantic_bos + card,
                                      np.int64)
        for t in range(self.codes.shape[1]):
            yield PHASE_SEMANTIC, self.codes[:, t] + card
            if t == 2:
                yield PHASE_DROPPED, np.zeros(8, np.int64)


def phase_continuous_stream(torch, cfg, params, ccfg, dec, codes, offline):
    """Phase 14c; returns the counted launches."""
    import numpy as np
    from uniaudio2_tpu_torch.engine.continuous import ContinuousEngine
    from uniaudio2_tpu_torch.engine.decode import split_two_phase
    from uniaudio2_tpu_torch.engine.stream_tts import stream_tts

    (g, m), _, _ = prompts(cfg)
    bucket = 64
    eng = ContinuousEngine(params, cfg, mode="audio", rows=1, bucket=bucket,
                           max_frames=STREAM_FRAMES,
                           cache_len=-(-(bucket + STREAM_FRAMES + 1) // 256)
                           * 256)
    reset_counts()
    rid = eng.submit(g, m)
    reason, semantic = eng.run_until_drained()[rid]
    eng._reset(eng._win)
    frames, first = [], None
    t0 = time.perf_counter()
    for phase, frame in eng.stream(g, m):
        if first is None:
            first = time.perf_counter() - t0
        frames.append((phase, frame))
    dt = time.perf_counter() - t0
    got = check_continuous("[14c]", cfg, params, eng, "audio", 0, 0)
    r2, s2 = split_two_phase(np.stack([f for _, f in frames]),
                             np.asarray([p for p, _ in frames]), len(frames),
                             cfg.tokens.audio_reason_card)
    if not (np.array_equal(r2, reason) and np.array_equal(s2, semantic)):
        fail("[14c] stream() frames differ from run_until_drained's")
    print(f"[14c] one-row stream(): {len(frames)} frames in {dt:.3f} s, the "
          f"first after {first * 1e3:.1f} ms (one {eng.seg_frames}-frame "
          f"segment), equal to run_until_drained's reason {reason.shape} / "
          f"semantic {semantic.shape}", flush=True)
    chunks, ttfa = [], None
    t0 = time.perf_counter()
    for wav in stream_tts(ScriptedFrames(cfg, codes), dec.params, ccfg, None,
                          None, num_steps=10, guidance_scale=1.5,
                          noise_fn=chunk_noise):
        if ttfa is None:
            ttfa = time.perf_counter() - t0
        chunks.append(wav)
    dt = time.perf_counter() - t0
    full = np.concatenate(chunks, axis=-1)
    if full.shape != offline.shape or not np.array_equal(full, offline):
        fail(f"[14c] stream_tts {full.shape} != the offline waveform "
             f"{offline.shape}: max diff "
             f"{np.abs(full - offline).max() if full.shape == offline.shape else 'n/a'}")
    print(f"[14c] stream_tts over phase 6's {codes.shape[1]} codes (scripted "
          f"frames): {len(chunks)} chunks in {dt:.3f} s, time to first audio "
          f"{ttfa:.3f} s ({chunks[0].shape[-1] / ccfg.sample_rate:.2f} s of "
          f"audio), equal to the offline decode bit for bit", flush=True)
    return got


def phase_continuous(torch, cfg, params, ccfg, dec, codes, offline):
    """Phase 14: 14a, 14b, 14c; returns the counted launches of their
    serving runs by row."""
    t0 = time.perf_counter()
    total = dict.fromkeys(counters(), 0)
    for tag, fn in (("14a", lambda: phase_continuous_offline(torch, cfg,
                                                             params)),
                    ("14b", lambda: phase_continuous_online(torch, cfg,
                                                            params)),
                    ("14c", lambda: phase_continuous_stream(
                        torch, cfg, params, ccfg, dec, codes, offline))):
        t1 = time.perf_counter()
        add_to(total, fn())
        print(f"[{tag}] {time.perf_counter() - t1:.1f} s", flush=True)
    qkv = sum(v for k, v in total.items() if k.startswith("qkv_rope_step"))
    print(f"[14] launches by row {json.dumps(nonzero(total))}; row 3 "
          f"(qkv_rope_step) {qkv} launches, all in frames of at most "
          f"{CONT_ROWS} rows (the refills' QKV is row 1's tile GEMV): row 3 "
          f"above 16 rows (its first design) launched 0 times; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    missing = [k for k in ("fused_swiglu", SWIGLU_TILE,
                           "int4i_matmul", "int8_matmul")
               if total.get(k, 0) == 0]
    if missing or qkv == 0:
        fail(f"[14] kernels of the path never launched: {missing}")
    return total


CLI_FRAMES = 64
CLI_CODEC_STEPS = 10
TTS_PROMPT = tuple(range(1, 24))                      # bench's TTS prompt
TTS_TEXT = tuple(range(5, 17))


class IdTok:
    """The text tokenizer's stand-in: whitespace-separated integers are the
    ids (no BOS / EOS), and ids decode to such a string."""

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def decode(self, ids):
        import numpy as np

        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


class SmokeCodec:
    """Phase 12's tokenizer (its encoder, phase 6's decoder) behind the
    CLI's codec seam, each call timed. The random LM emits no semantic
    phase (that needs a frame of eight reason_eos), so an empty semantic
    stream is replaced by ``fallback`` (the clip's semantic codes); the
    frames each decode took are kept in ``decoded``."""

    def __init__(self, torch, tok, fallback):
        self.torch, self.tok, self.cfg = torch, tok, tok.cfg
        self.fallback = fallback
        self.seconds = {"encode": 0.0, "codec decode": 0.0}
        self.decoded = []

    def _timed(self, stage, fn, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.seconds[stage] += time.perf_counter() - t0
        return out

    def tokenize(self, wav):
        return self._timed("encode", self.tok.tokenize, wav)

    def detokenize_no_reason(self, semantic, **kw):
        codes = semantic if semantic.shape[-1] else self.fallback
        self.decoded.append(self.tok.find_length(codes))
        return self._timed("codec decode", self.tok.detokenize_no_reason,
                           codes, **kw)


def record_engine(torch, eng, log):
    """Wraps the engine's generate entry points: every call appends (mode,
    prefill rows, frames run, seconds) to ``log``, from whichever thread
    makes it."""
    from uniaudio2_tpu_torch.engine.decode import pick_bucket

    def wrap(name, mode, batched):
        fn = getattr(eng, name)

        def call(first, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(first, *args, **kw)
            torch.cuda.synchronize()
            rows = 2 if kw.get("use_cfg") else 1
            grids = [g for g, _ in first] if batched else [first]
            bucket = pick_bucket(max(g.shape[0] for g in grids), eng.buckets)
            log.append((mode, len(grids) * rows * (bucket - 1),
                        eng.last_frames_run, time.perf_counter() - t0))
            return out

        setattr(eng, name, call)

    for name, mode, batched in (("generate_text", "text", False),
                                ("generate_audio", "audio", False),
                                ("generate_text_batch", "text", True),
                                ("generate_audio_batch", "audio", True)):
        wrap(name, mode, batched)


def read_ids(path):
    """``{task}_results.txt`` -> {name: text ids}."""
    import numpy as np

    out = {}
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        name, _, text = line.partition("\t")
        out[name] = np.asarray([int(t) for t in text.split()], np.int64)
    return out


def phase_cli(torch, dev, card, tok, reason, semantic, clip):
    """Phase 13: `cli.main` on the card at full width (ASR from the wav,
    TTS through the codec, a batch from ``--token_dir``), then the batching
    server and the HTTP endpoint on the CLI's engine. Gates (a)-(f) of the
    module docstring. Returns the launches by row."""
    import gc
    import http.client
    import shutil
    import threading

    import numpy as np
    from uniaudio2_tpu_torch import cli
    from uniaudio2_tpu_torch.codec import dit
    from uniaudio2_tpu_torch.codec.tokenizer import load_wav
    from uniaudio2_tpu_torch.engine import tasks
    from uniaudio2_tpu_torch.engine.http_server import InferenceHTTPServer
    from uniaudio2_tpu_torch.engine.server import BatchingServer
    from uniaudio2_tpu_torch.ops import _cuda
    from uniaudio2_tpu_torch.ops import flash_attention as fa

    root = ROOT / "build" / "smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    token_dir = root / "tokens"
    token_dir.mkdir(parents=True)
    # three utterances: the clip's tokens, their time-reversed copies, and
    # their first three quarters (every ASR grid in bucket 256)
    utts = {"u0": (reason, semantic),
            "u1": (reason[:, ::-1], semantic[:, ::-1]),
            "u2": (reason[:, :3 * reason.shape[1] // 4],
                   semantic[:, :3 * semantic.shape[1] // 4])}
    for name, (r, s) in utts.items():
        cli.save_tokens(str(token_dir / f"{name}_reason.pt"), r)
        cli.save_tokens(str(token_dir / f"{name}_semantic.pt"), s)
    codec = SmokeCodec(torch, tok, semantic)
    log, built = [], {}
    real_build = cli.build_runner

    def build_runner(args):
        if not built:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built["runner"] = real_build(args)
            torch.cuda.synchronize()
            built["seconds"] = time.perf_counter() - t0
            record_engine(torch, built["runner"].engine, log)
        return built["runner"]

    asr_prompt = " ".join(map(str, ASR_PROMPT))
    common = ["--quantize", "int4all", "--model_dtype", "bfloat16",
              "--max_frames", str(CLI_FRAMES), "--topk", "1",
              "--codec_steps", str(CLI_CODEC_STEPS)]
    runs = {
        "asr": ["--task", "ASR", "--audio", clip, "--prompt_text", asr_prompt],
        "tts": ["--task", "TTS", "--stage", "all",
                "--text", " ".join(map(str, TTS_TEXT)),
                "--prompt_text", " ".join(map(str, TTS_PROMPT))],
        "batch": ["--task", "ASR", "--token_dir", str(token_dir),
                  "--prompt_text", asr_prompt]}
    reset_counts()
    _cuda.reset_count(fa.flash_attention)
    dit._attention.plain_launches = 0
    walls, lm = {}, {}
    with mock.patch.object(cli, "build_runner", build_runner), \
            mock.patch.object(cli, "load_text_tokenizer", lambda args: IdTok()), \
            mock.patch.object(cli, "load_codec_tokenizer",
                              lambda args, need_decode: codec):
        for name, argv in runs.items():
            before = len(log)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(argv + common + ["--output_dir", str(root / name)])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            lm[name] = sum(entry[3] for entry in log[before:])
    eng = built["runner"].engine
    cfg, ts, params = eng.cfg, eng.cfg.tokens, eng.params
    print(f"[13] {card}: cli.main at full width: the int4all tree built in "
          f"{built['seconds']:.1f} s (load_llm's random init, quantize, "
          f"serving layout); " + "; ".join(
              f"{name} {walls[name]:.3f} s (LM decode {lm[name]:.3f} s)"
              for name in runs)
          + f"; encode {codec.seconds['encode']:.3f} s, codec decode "
          f"{codec.seconds['codec decode']:.3f} s", flush=True)
    sample = dict(temperature=0.9, topk=1, seed=888)   # the CLI's greedy

    # (a) ASR from the wav file
    asr_dir = root / "asr"
    files_ok = (np.array_equal(cli.load_tokens(str(asr_dir / "clip_reason.pt")), reason)
                and np.array_equal(cli.load_tokens(str(asr_dir / "clip_semantic.pt")),
                                   semantic))
    g, m = tasks.prepare_asr(np.asarray(ASR_PROMPT), reason.T, semantic.T, ts)
    direct = eng.generate_text(g, m, **sample)
    got = read_ids(asr_dir / "asr_results.txt")["clip"]
    print(f"[13a] ASR: token files equal phase 12's tokens: {files_ok}; "
          f"{len(got)} text ids, equal to generate_text on the same grid: "
          f"{same_tokens(got, direct)}", flush=True)
    if not files_ok or not same_tokens(got, direct) or not len(got):
        fail("[13a] the CLI's ASR differs from phase 12's tokens or the engine")

    # (b) TTS, text -> tokens -> wav
    g, m = tasks.prepare_tts(np.asarray(TTS_PROMPT), np.asarray(TTS_TEXT), ts)
    want_r, want_s = eng.generate_audio(g, m, **sample)
    tts_dir = root / "tts"
    got_r = cli.load_tokens(str(tts_dir / "utt_0_reason.pt"))
    got_s = cli.load_tokens(str(tts_dir / "utt_0_semantic.pt"))
    wav = load_wav(str(tts_dir / "wavs" / "utt_0.wav"), tok.cfg.sample_rate)
    per_frame = int(tok.cfg.sample_rate / tok.cfg.rec_hz)
    tts_ok = same_tokens(got_r, want_r) and same_tokens(got_s, want_s)
    wav_ok = (len(codec.decoded) == 1 and np.isfinite(wav).all()
              and wav.shape[-1] == per_frame * codec.decoded[0])
    print(f"[13b] TTS: reason {got_r.shape} semantic {got_s.shape}, equal to "
          f"generate_audio on the same grid: {tts_ok}; wav {wav.shape[-1]} "
          f"samples = {per_frame} x {codec.decoded} frames decoded "
          f"({'the semantic stream' if got_s.shape[-1] else 'the clip codes: no semantic frame'}), "
          f"finite: {bool(np.isfinite(wav).all())}", flush=True)
    if not tts_ok or not wav_ok:
        fail("[13b] the CLI's TTS differs from the engine or its wav is wrong")

    # (c) the batched path: each line against its item in a batch of three
    # copies of itself (the same rows and bucket)
    got = read_ids(root / "batch" / "asr_results.txt")
    batch_ok = sorted(got) == sorted(utts)
    items = {}
    for name, (r, s) in utts.items():
        items[name] = tasks.prepare_asr(np.asarray(ASR_PROMPT), r.T, s.T, ts)
        alone = eng.generate_text_batch([items[name]] * 3, **sample)[0]
        batch_ok = batch_ok and same_tokens(got.get(name), alone)
    print(f"[13c] batched ASR from --token_dir: {len(got)} lines, "
          f"{[len(v) for v in got.values()]} ids, each equal to its item in "
          f"a batch of three copies: {batch_ok}", flush=True)
    if not batch_ok:
        fail("[13c] a line of the batched path differs from its item")

    # (d) the batching server: 8 threads, 4 ASR and 4 TTS requests
    asr4 = list(items.values()) + [tasks.prepare_asr(
        np.asarray(ASR_PROMPT), reason[:, ::2].T, semantic[:, ::2].T, ts)]
    tts4 = [tasks.prepare_tts(np.asarray(TTS_PROMPT), np.asarray(TTS_TEXT) + i, ts)
            for i in range(4)]
    requests = [("text", gm) for gm in asr4] + [("audio", gm) for gm in tts4]
    results = [None] * len(requests)
    gc.collect()
    srv = BatchingServer(eng, max_batch=4, max_wait_ms=60_000.0).start()

    def submit(i):
        mode, (gg, mm) = requests[i]
        results[i] = srv.submit(mode, gg, mm, **sample).result(timeout=600)

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    served_s = time.perf_counter() - t0
    srv.stop()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        fail("[13d] a request to the batching server did not return")
    stats = dict(srv.stats)
    seeds = [sample["seed"]] * 4
    kw = dict(temperature=0.9, topk=1, seeds=seeds)
    want = (eng.generate_text_batch(asr4, **kw)
            + eng.generate_audio_batch(tts4, **kw))
    server_ok = same_tokens(results, want)
    rows = stats["batched_requests"] / stats["batches"]
    print(f"[13d] BatchingServer, 8 threads (4 ASR, 4 TTS, greedy): "
          f"{len(requests) / served_s:.2f} requests/s ({served_s:.3f} s), "
          f"{stats['batches']} launches, {rows:.2f} rows a launch; results "
          f"equal the direct batched calls: {server_ok}", flush=True)
    if not server_ok or stats["batches"] != 2 or rows <= 1:
        fail(f"[13d] the batching server's results or launches: {stats}")

    # (e) the HTTP endpoint on the loopback
    http_srv = InferenceHTTPServer(eng, "127.0.0.1", 0, max_batch=4,
                                   max_wait_ms=5.0).start()
    replies = {}
    try:
        for path, payload in (
                ("/v1/asr", {"prompt_tokens": list(ASR_PROMPT),
                             "reason": reason.tolist(),
                             "semantic": semantic.tolist(), "topk": 1}),
                ("/v1/tts", {"prompt_tokens": list(TTS_PROMPT),
                             "text_tokens": list(TTS_TEXT), "topk": 1})):
            conn = http.client.HTTPConnection("127.0.0.1", http_srv.port,
                                              timeout=600)
            conn.request("POST", path, json.dumps(payload),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            replies[path] = (resp.status, json.loads(resp.read()))
            conn.close()
    finally:
        http_srv.stop()
    (sa, asr_body), (st, tts_body) = replies["/v1/asr"], replies["/v1/tts"]
    want_asr = eng.generate_text_batch(
        [tasks.prepare_asr(np.asarray(ASR_PROMPT), reason.T, semantic.T, ts)],
        temperature=0.9, topk=1, seeds=[888])[0]
    want_tts = eng.generate_audio_batch([(g, m)], temperature=0.9, topk=1,
                                        seeds=[888])[0]
    http_ok = (sa == st == 200
               and same_tokens(np.asarray(asr_body["tokens"]), want_asr)
               and same_tokens(np.asarray(tts_body["reason"]).reshape(8, -1), want_tts[0])
               and same_tokens(np.asarray(tts_body["semantic"]).reshape(8, -1),
                               want_tts[1]))
    print(f"[13e] InferenceHTTPServer on 127.0.0.1:{http_srv.port}: /v1/asr "
          f"{sa}, /v1/tts {st}, equal to the engine's call for a batch of "
          f"one: {http_ok}", flush=True)
    if not http_ok:
        fail(f"[13e] the HTTP endpoint's replies: {replies}")

    # (f) launches against the tree's count over every call's frames
    counts = read_counts()
    want, want_tile = dict.fromkeys(counters(), 0), {}
    for mode, prefill, frames, _ in log:
        add_to(want, expected_launches(cfg, params, mode, frames, prefill))
        add_to(want_tile, expected_tile(params, prefill))
    flash = fa.flash_attention.launches
    want_flash = CLI_CODEC_STEPS * tok.cfg.dit.num_layers * len(codec.decoded)
    print(f"[13f] {len(log)} engine calls; launches {json.dumps(nonzero(counts))} "
          f"expected {json.dumps(nonzero(want))}; flash {flash} (expected "
          f"{want_flash}), plain path {dit._attention.plain_launches}", flush=True)
    if counts != want:
        fail(f"[13f] launch counts {counts} != the path's {want}")
    check_tile("[13f]", want_tile)
    if flash != want_flash or dit._attention.plain_launches:
        fail(f"[13f] flash launches {flash} != {want_flash}")
    counts["flash_attention"] = flash
    return counts


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
    # is; the GEMV probe raises itself when its int8 ring leaves the
    # production int8 kernel's bits); the first designs: the tiled
    # instances'
    if not all(line["bit_identical_to_int4i_splitk"]
               and line["simt_bit_identical_to_int4i_tiled"] for line in native) \
            or not all(line["form0_bit_identical_to_int4_splitk"]
                       and line["simt_form0_bit_identical_to_int4_tiled"]
                       for line in sweep):
        fail("a probe kernel left the production kernel's order")
    if not all(launches.values()):
        fail(f"a probe kernel was never launched: {launches}")
    return launches

# ---------------------------------------------------------------------------
# Phase 16: the mesh path on one card
# ---------------------------------------------------------------------------


class mesh_group:
    """A one-rank NCCL process group on a FileStore under build/, and the
    (replica, fsdp, tp) = (1, 1, 1) mesh over it; destroyed on exit (phases
    13 and 7b run the CLIs without a group, which is their plain path)."""

    def __enter__(self):
        import datetime
        import shutil

        import torch.distributed as dist
        from uniaudio2_tpu_torch.parallel import mesh as meshlib

        root = ROOT / "build" / "mesh_store"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(root / "store"), 1), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        meshlib.quiet()
        self.mesh = meshlib.build_mesh(device_type="cuda")
        return self.mesh

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        return False


def first_frame_k(torch, eng, slot):
    """Every backbone layer's K rows at ``slot`` (the first frame's) of the
    engine's kept one-row caches."""
    (caches,) = [c for (rows, _, _), c in eng._kept.items() if rows == 1]
    k = caches.backbone.k
    layers = k if isinstance(k, list) else list(k.unbind(0))
    if hasattr(layers[0], "q"):
        return torch.stack([torch.cat([e.q[:, :, slot].float(),
                                       e.s[:, :, slot, None]], -1)
                            for e in layers])
    return torch.stack([e[:, :, slot] for e in layers])


def phase_mesh_serve(torch, dev, cfg, params, mesh):
    """16(b): phase 4's int4all tree through `DecodeEngine(mesh=,
    use_tp=True)` (the caches on the tp ranks' kv groups, the parameters
    whole for the kernels) and the plain engine, on phase 11's TTS and ASR
    prompts (greedy, 128 frames, the graph path; a warm-up call each, then
    two timed calls each, plain, mesh, mesh, plain): the same tokens, the
    first frame's backbone K rows bit for bit, the same launches by row,
    and the frame time both ways. Returns the mesh engine's launches
    (warm-ups not counted)."""
    from uniaudio2_tpu_torch.engine.decode import DecodeEngine

    (g, m), _, (ag, am) = prompts(cfg)
    greedy = dict(topk=1, temperature=1.0)
    calls = (("audio", lambda e: e.generate_audio(g, m, **greedy)),
             ("text", lambda e: [e.generate_text(ag, am, **greedy)]))
    engines = {}
    for label, kw in (("plain", {}), ("mesh", dict(mesh=mesh, use_tp=True))):
        eng = DecodeEngine(params, cfg, max_frames=FRAMES, buckets=(64,), **kw)
        for _, call in calls:          # warm-up and capture, not timed
            call(eng)
        engines[label] = eng
    runs = {label: ([], [[], []], None, dict.fromkeys(counters(), 0))
            for label in engines}
    for label in ("plain", "mesh", "mesh", "plain"):
        eng = engines[label]
        out, ms, k_rows, counts = runs[label]
        reset_counts()
        for j, (mode, call) in enumerate(calls):
            cap0 = eng.capture_seconds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call(eng)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0 - (eng.capture_seconds - cap0)
            ms[j].append(1e3 * dt / max(eng.last_steps, 1))
            if not out or len(out) < 2:
                out.append(res)
            if mode == "audio" and k_rows is None:
                k_rows = first_frame_k(torch, eng, g.shape[0] - 1)
        add_to(counts, read_counts())
        runs[label] = (out, ms, k_rows, counts)
    del engines, eng
    runs = {label: (out, [statistics.mean(v) for v in ms], k, n)
            for label, (out, ms, k, n) in runs.items()}
    (p_out, p_ms, p_k, p_n), (m_out, m_ms, m_k, m_n) = runs["plain"], runs["mesh"]
    same = [same_tokens(a, b) for a, b in zip(p_out, m_out)]
    k_same = torch.equal(p_k, m_k)
    print(f"[16b] TTS and ASR tokens identical: {same}; first frame's backbone "
          f"K rows {tuple(m_k.shape)} bit-equal: {k_same}", flush=True)
    print(f"[16b] frame ms (capture excluded; mean of two calls each, in the "
          f"order plain, mesh, mesh, plain after a warm-up call each) TTS "
          f"plain {p_ms[0]:.3f} mesh {m_ms[0]:.3f}; ASR plain {p_ms[1]:.3f} "
          f"mesh {m_ms[1]:.3f}", flush=True)
    print(f"[16b] launches by row, mesh {json.dumps(nonzero(m_n))}", flush=True)
    if not all(same) or not k_same:
        fail("[16b] the mesh engine's tokens or K rows differ from the plain "
             "engine's")
    if m_n != p_n or not any(m_n.values()):
        fail(f"[16b] mesh launches {nonzero(m_n)} != plain {nonzero(p_n)}")
    reset_counts()
    return m_n


def phase_mesh_train(torch, dev, mesh, ref):
    """16(a): phase 7a's configuration (seed, batch, adamw_lean) through the
    mesh path, two steps: each step's loss and grad_norm and `MESH_LEAVES`
    after the second equal to 7a's bit for bit (one device: the same ops),
    the lean kernel
    launched on every fused leaf; a planted control (the second update of
    projection_w dropped) must fail the leaf check. Returns the lean
    kernel's launches."""
    from uniaudio2_tpu_torch.ops import lean_update as lu
    from uniaudio2_tpu_torch.parallel import mesh as meshlib
    from uniaudio2_tpu_torch.train import lean_opt, optim

    cfg, _, state, step, batch, _ = build_training(torch, dev, mesh=mesh,
                                                   tag="16a")
    leaves = optim.tree_leaves(state.params)
    fused = sum(lean_opt.fused_leaf(meshlib.whole(p), meshlib.whole_tree(s))
                for p, s in zip(leaves,
                                optim.tree_leaves(state.opt_state[1].leaves)))
    lu.fused_lean_update.launches = 0
    got = {"loss": [], "grad_norm": []}
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        got["loss"].append(float(met["loss"]))
        got["grad_norm"].append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        print(f"[16a] mesh step {i}: loss {got['loss'][i]!r} (7a "
              f"{ref['loss'][i]!r}) grad_norm {got['grad_norm'][i]!r} (7a "
              f"{ref['grad_norm'][i]!r}) {time.perf_counter() - t0:.3f} s",
              flush=True)
        if i == 0:
            control = meshlib.whole(leaf_at(state.params, MESH_LEAVES[0])
                                    ).detach().cpu().clone()
    launches = lu.fused_lean_update.launches
    mine = [meshlib.whole(leaf_at(state.params, p)).detach().cpu()
            for p in MESH_LEAVES]
    diffs = [leaf_diff(torch, a, b) for a, b in zip(mine, ref["leaves"])]
    planted = leaf_diff(torch, control, ref["leaves"][0])
    bits = (got["loss"] == ref["loss"] and got["grad_norm"] == ref["grad_norm"]
            and all(d[0] for d in diffs))
    print(f"[16a] {type(leaves[0]).__name__} leaves on {mesh}; "
          f"{', '.join('/'.join(p) for p in MESH_LEAVES)} after two steps "
          f"against 7a's (bit-equal, share differing, max rel): {diffs}; "
          f"losses and grad norms bit-equal too: {bits}; control "
          f"(projection_w's second update dropped): {planted}"
          f"{'' if planted[0] else '  REJECTED'}; lean launches "
          f"{launches} = 2 steps x {fused} fused leaves", flush=True)
    if not bits or planted[0]:
        fail(f"[16a] mesh steps {got} / leaves {diffs} against 7a's "
             f"{ref['loss']} / {ref['grad_norm']}; the planted control "
             f"passed: {planted[0]}")
    if launches != 2 * fused or not fused:
        fail(f"[16a] lean launches {launches} != 2 x {fused} fused leaves")
    return launches


def phase_mesh_cli(torch, dev):
    """16(c): `python -m uniaudio2_tpu_torch.train.train --data-parallel
    fsdp` at full width under the one-rank group: one step, its checkpoint
    written (then deleted), the parameters DTensors on its mesh."""
    import shutil
    from uniaudio2_tpu_torch.config import UnifiedModelConfig
    from uniaudio2_tpu_torch.parallel import mesh as meshlib
    from uniaudio2_tpu_torch.train import train as train_cli

    cfg = UnifiedModelConfig()
    root = ROOT / "build" / "smoke_mesh_train"
    shutil.rmtree(root, ignore_errors=True)
    pattern = write_train_files(cfg, root / "data")
    t0 = time.perf_counter()
    state = train_cli.main([
        "--train_data_jsons", pattern, "--exp_dir", str(root / "exp"),
        "--debug_steps", "1", "--n_epoch", "1", "--optimizer", "adamw_lean",
        "--batch_scale", "4096", "--max_length", "2048",
        "--data-parallel", "fsdp"])
    torch.cuda.synchronize()
    leaf = state.params["projection_w"]
    finite = bool(torch.isfinite(meshlib.whole(leaf)).all())
    saved = (root / "exp" / "ep0.checkpoint" / "meta.json").is_file()
    print(f"[16c] train CLI --data-parallel fsdp on the one-rank group: step "
          f"{state.step} in {time.perf_counter() - t0:.1f} s (checkpoint "
          f"included), projection_w a DTensor {meshlib.is_dtensor(leaf)} "
          f"finite {finite}, ep0.checkpoint written {saved}", flush=True)
    if state.step != 1 or not meshlib.is_dtensor(leaf) or not finite \
            or not saved:
        fail("[16c] the train CLI's mesh step did not run")
    del state, leaf
    shutil.rmtree(root)


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
    if "--speculative" in sys.argv[1:]:
        cfg, base, params = build_model(torch, dev)
        _, params1 = int4all_tree(torch, dev, cfg, SECOND_SEED)
        phase_speculative(torch, dev, cfg, base, params, params1, card)
        return
    if "--asr" in sys.argv[1:]:
        asr_from_wav(torch, dev, sys.argv[sys.argv.index("--asr") + 1])
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
    spec = phase_speculative(torch, dev, cfg, base, params, params1, card)
    stamp("phase 15")
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
        launches[k] += (formats[k] + spec[k] + defaults[k] + batched[k]
                        + graphs[k])
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
    audio_in, (tok, reason, semantic, clip) = phase_audio_in(
        torch, dev, cfg, params, ccfg, dec)
    add_to(launches, audio_in)
    stamp("phase 12")
    add_to(launches, phase_continuous(torch, cfg, params, ccfg, dec, codes,
                                      wav))
    stamp("phase 14")
    with mesh_group() as mesh:
        add_to(launches, phase_mesh_serve(torch, dev, cfg, params, mesh))
    stamp("phase 16b")
    del params, dec, codes, wav
    torch.cuda.empty_cache()
    add_to(launches, phase_cli(torch, dev, card, tok, reason, semantic, clip))
    stamp("phase 13")
    del tok
    torch.cuda.empty_cache()
    launches["lean_update"], ref = phase_train(torch, dev)
    torch.cuda.empty_cache()
    phase_train_cli(torch, dev)
    stamp("phase 7")
    with mesh_group() as mesh:
        launches["lean_update"] += phase_mesh_train(torch, dev, mesh, ref)
        torch.cuda.empty_cache()
        stamp("phase 16a")
        phase_mesh_cli(torch, dev)
    torch.cuda.empty_cache()
    stamp("phase 16c")
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
