"""Unified multi-stream audio language model (port of
`uniaudio2_tpu/models/unified.py`, the reference's `Model_stage3`).

A Llama-3.2-class backbone, a 3-layer understanding expert and a 2-layer
generation expert (continuous in / continuous out), and a 4-layer local
RQ-decoder that emits 8 audio codebooks per frame plus one text token.
Parameters and KV caches are plain dicts / named tuples of tensors; caches
are updated in place. Decoding takes an explicit random stream (one
``torch.Generator`` for every row, or per-row `RowKeys`) and never
synchronises with the host inside a frame.

`forward` is the teacher-forced training forward (the reference's
`Model_stage3.forward`), with the local decoder run densely at every step
or at gathered audio steps (``decoder_positions``).

Batched decoding: with `RowKeys` each row's draws are a function of its own
key, the frame, the stream (text 0, audio 1) and the codebook, as JAX's
``fold_in`` tree (`uniaudio2_tpu/models/unified.py:582-586, 646-650`); under
CFG a pair samples from its cond row's stream and its cond row's
``forbid_prefix``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.models import gpt
from uniaudio2_tpu_torch.ops.kv_cache import KVCache, init_cache
from uniaudio2_tpu_torch.ops.quant import (
    QUANTIZED, dequantize_any, matmul, to_interleaved,
)
from uniaudio2_tpu_torch.ops.sampling import RowKeys, cfg_mix, sample_topk

Params = Dict[str, Any]


class UnifiedCaches(NamedTuple):
    backbone: KVCache
    understanding: KVCache
    generation: KVCache


class LocalCache(NamedTuple):
    """The local decoder's 8-slot cache and its slot indices (0..7): made
    per frame by default, or kept across frames by a caller that needs
    fixed buffers (a captured frame graph). Every frame writes slots 0..7
    in order before it reads them, so a kept cache gives the tokens of a
    fresh one."""

    cache: KVCache
    steps: torch.Tensor


def init_local_cache(cfg: UnifiedModelConfig, batch: int, dtype,
                     device="cuda") -> LocalCache:
    ncb = cfg.tokens.num_codebooks
    return LocalCache(init_cache(cfg.decoder, batch, ncb, dtype=dtype,
                                 device=device),
                      torch.arange(ncb, device=device))


def init_params(cfg: UnifiedModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    bcfg, dcfg = cfg.backbone, cfg.decoder
    audio_vocab = cfg.tokens.audio_vocab
    ncb = cfg.tokens.num_codebooks

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    return {
        "backbone": gpt.init_params(bcfg, generator, dtype, device),
        "decoder": gpt.init_params(dcfg, generator, dtype, device),
        "understanding_expert": gpt.init_params(
            cfg.understanding_expert, generator, dtype, device),
        "generation_expert": gpt.init_params(
            cfg.generation_expert, generator, dtype, device),
        "audio_embeddings": normal(audio_vocab * ncb, bcfg.n_embd),
        "projection_w": normal(bcfg.n_embd, dcfg.n_embd),
        "audio_head": normal(ncb, dcfg.n_embd, audio_vocab),
    }


def init_caches(cfg: UnifiedModelConfig, batch: int, dtype=torch.bfloat16,
                seq_len: Optional[int] = None, as_lists: bool = False,
                device="cuda") -> UnifiedCaches:
    s = seq_len or cfg.max_seq_len
    return UnifiedCaches(
        backbone=init_cache(cfg.backbone, batch, s, dtype, as_lists, device),
        understanding=init_cache(cfg.understanding_expert, batch, s, dtype,
                                 as_lists, device),
        generation=init_cache(cfg.generation_expert, batch, s, dtype,
                              as_lists, device),
    )


def prepare_serving_params(params: Params, dtype=torch.bfloat16,
                           unroll: bool = True,
                           interleave: bool = True) -> Params:
    """Serving-time layout (semantics unchanged):

    1. fold ``audio_embeddings @ projection_w`` into one gathered table
       ``audio_embeddings_proj`` (the local decoder's 7 embedding
       microsteps then skip the projection);
    2. with ``unroll``, per-layer weight lists and per-codebook heads;
    3. with ``unroll`` and ``interleave``, row-interleaved int4
       (`to_interleaved`) for every int4 leaf, per-channel or grouped.
       ``interleave=False`` keeps the K-split / column-packed bytes the
       quantizers wrote (the JAX package's ``UA2_INT4I=0``).

    The JAX package's chunk-major step is a TPU DMA layout; the port keeps
    weights row-major."""
    w = params["projection_w"]
    if isinstance(w, QUANTIZED):
        w = dequantize_any(w, torch.float32)
    out = dict(params)
    out["audio_embeddings_proj"] = torch.matmul(
        params["audio_embeddings"].float(), w.float()).to(dtype)
    if not unroll:
        return out
    relayout = to_interleaved if interleave else (lambda leaf: leaf)
    for sub in ("backbone", "decoder", "understanding_expert",
                "generation_expert"):
        gp = gpt.unstack_layers(out[sub])
        gp["layers"] = [{k: relayout(v) for k, v in layer.items()}
                        for layer in gp["layers"]]
        if "lm_head_w" in gp:
            gp["lm_head_w"] = relayout(gp["lm_head_w"])
        out[sub] = gp
    head = out["audio_head"]
    if not isinstance(head, list):
        ncb = (head[0] if isinstance(head, tuple) else head).shape[0]
        head = [gpt.index_leaf(head, i) for i in range(ncb)]
    out["audio_head"] = [relayout(h) for h in head]
    out["projection_w"] = relayout(out["projection_w"])
    return out


def _embed_audio_streams(params: Params, cfg: UnifiedModelConfig,
                         tokens: torch.Tensor) -> torch.Tensor:
    """(B, S, K) audio ids -> (B, S, K, D) with per-codebook offsets."""
    k = tokens.shape[-1]
    offsets = torch.arange(k, device=tokens.device) * cfg.tokens.audio_vocab
    return params["audio_embeddings"][tokens + offsets]


def _fuse_input(params: Params, cfg: UnifiedModelConfig, tokens: torch.Tensor,
                mask: torch.Tensor):
    """tokens/mask (B, S, 9) -> (masked codebook sum (B, S, D), text
    embeddings (B, S, D), audio step mask, text step mask (B, S, 1))."""
    dtype = params["audio_embeddings"].dtype
    audio_embeds = _embed_audio_streams(params, cfg, tokens[:, :, :-1])
    audio_input = (audio_embeds * mask[:, :, :-1, None].to(dtype)).sum(dim=2)
    text_embeds = gpt.embed(params["backbone"], tokens[:, :, -1])
    return (audio_input, text_embeds, mask[:, :, 0:1].to(dtype),
            mask[:, :, -1:].to(dtype))


def forward(params: Params, cfg: UnifiedModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, tokens_mask: torch.Tensor, *,
            extra_mask: Optional[torch.Tensor] = None,
            return_hidden: bool = False, remat_layers: bool = False,
            remat_backbone: "Optional[int]" = None,
            remat_small: Optional[bool] = None,
            decoder_positions: Optional[torch.Tensor] = None):
    """Training forward (reference `model_new.py:402-454`).

    tokens (B, S, 9) teacher-forced input grid; labels (B, S, 8) next-step
    audio codes; tokens_mask (B, S+1, 9) bool (one step longer, sliced
    here). ``remat_layers`` checkpoints every layer of every stack;
    ``remat_backbone`` (an int: the first k backbone layers) and
    ``remat_small`` (experts + local decoder) override it per stack.
    ``decoder_positions`` (B, C) runs the local decoder only at those steps.
    Returns text_logits (B, S, V_text) and audio_logits (B, S or C, 8,
    V_audio), or with ``return_hidden`` the pre-head pair ``(h_final
    (B, S, D), dec_h (B·S or B·C, 8, D_dec))`` for the chunked CE."""
    remat_bb = remat_layers if remat_backbone is None else remat_backbone
    remat_sm = remat_layers if remat_small is None else remat_small
    audio_input, text_embeds, a_mask, t_mask = _fuse_input(
        params, cfg, tokens, tokens_mask[:, :-1, :])
    h_audio = gpt.forward(params["understanding_expert"],
                          cfg.understanding_expert, audio_input,
                          extra_mask=extra_mask, remat=remat_sm)
    h = gpt.forward(params["backbone"], cfg.backbone,
                    h_audio * a_mask + text_embeds * t_mask,
                    extra_mask=extra_mask, remat=remat_bb)
    h_gen = gpt.forward(params["generation_expert"], cfg.generation_expert,
                        h * a_mask, extra_mask=extra_mask, remat=remat_sm)
    h_final = h_gen * a_mask + h * t_mask
    dec_in, dec_labels = h_final, labels
    if decoder_positions is not None:
        idx = decoder_positions.long()[:, :, None]
        dec_in = torch.take_along_dim(h_final, idx, dim=1)          # (B, C, D)
        dec_labels = torch.take_along_dim(labels, idx, dim=1)       # (B, C, 8)
    if return_hidden:
        return h_final, _local_decoder_teacher_forced(
            params, cfg, dec_in, dec_labels, return_hidden=True, remat=remat_sm)
    text_logits = gpt.lm_head(params["backbone"], h_final, cfg.backbone)
    return text_logits, _local_decoder_teacher_forced(params, cfg, dec_in,
                                                      dec_labels)


def _local_decoder_teacher_forced(params: Params, cfg: UnifiedModelConfig,
                                  h_final: torch.Tensor, labels: torch.Tensor,
                                  return_hidden: bool = False,
                                  remat: bool = False) -> torch.Tensor:
    """The local RQ-decoder over every step at once: per step t the 8-long
    causal sequence ``[h_final[t]; embed(labels[t, 0:7])]``, steps folded
    into the batch, so the decoder sees (B*S, 8, D). Returns the per-head
    logits (B, S, 8, V_audio) in float32, or the pre-head hidden states
    (B*S, 8, D_dec)."""
    b, s, d_b = h_final.shape
    ncb = cfg.tokens.num_codebooks
    local = _embed_audio_streams(params, cfg, labels[:, :, :ncb - 1])
    curr = torch.cat([h_final[:, :, None, :], local], dim=2).reshape(
        b * s, ncb, d_b)
    proj = matmul(curr, params["projection_w"])
    dec_h = gpt.forward(params["decoder"], cfg.decoder, proj, remat=remat)
    if return_hidden:
        return dec_h
    logits = torch.einsum("bnd,ndv->bnv", dec_h.float(),
                          params["audio_head"].float())
    return logits.reshape(b, s, ncb, -1)


def forward_text(params: Params, cfg: UnifiedModelConfig,
                 tokens: torch.Tensor, tokens_mask: torch.Tensor) -> torch.Tensor:
    """Text-logits-only forward (reference `forward_text`)."""
    audio_input, text_embeds, a_mask, t_mask = _fuse_input(
        params, cfg, tokens, tokens_mask)
    h_audio = gpt.forward(params["understanding_expert"],
                          cfg.understanding_expert, audio_input)
    h = gpt.forward(params["backbone"], cfg.backbone,
                    h_audio * a_mask + text_embeds * t_mask)
    h_gen = gpt.forward(params["generation_expert"], cfg.generation_expert,
                        h * a_mask)
    return gpt.lm_head(params["backbone"], h_gen * a_mask + h * t_mask,
                       cfg.backbone)


def prefill(params: Params, cfg: UnifiedModelConfig, tokens: torch.Tensor,
            tokens_mask: torch.Tensor, caches: UnifiedCaches,
            key_valid: Optional[torch.Tensor] = None) -> UnifiedCaches:
    """Run the prompt (B, S, 9) through experts and backbone at positions
    [0, S), filling the three caches (the local decoder is skipped).
    ``key_valid`` (B, S) masks slots no query may attend (ragged rows of a
    batch)."""
    audio_input, text_embeds, a_mask, t_mask = _fuse_input(
        params, cfg, tokens, tokens_mask)
    extra = None if key_valid is None else key_valid[:, None, :]
    h_audio, _ = gpt.prefill(params["understanding_expert"],
                             cfg.understanding_expert, audio_input,
                             caches.understanding, extra_mask=extra)
    h, _ = gpt.prefill(params["backbone"], cfg.backbone,
                       h_audio * a_mask + text_embeds * t_mask, caches.backbone,
                       extra_mask=extra)
    gpt.prefill(params["generation_expert"], cfg.generation_expert,
                h * a_mask, caches.generation, extra_mask=extra)
    return caches


def decode_hidden(params: Params, cfg: UnifiedModelConfig,
                  tokens: torch.Tensor, tokens_mask: torch.Tensor,
                  caches: UnifiedCaches, pos: "torch.Tensor | int",
                  key_valid: Optional[torch.Tensor] = None,
                  attn_block: Optional[int] = None, kv_write: str = "inline",
                  host_pos: Optional[int] = None
                  ) -> Tuple[torch.Tensor, UnifiedCaches]:
    """(B, 1, 9) tokens at ``pos`` -> (last hidden state (B, D), caches).
    ``key_valid`` (B, S_max), ``attn_block``, ``kv_write`` and ``host_pos``
    as in `gpt.decode_step`."""
    kw = dict(key_valid=key_valid, attn_block=attn_block, kv_write=kv_write,
              host_pos=host_pos)
    audio_input, text_embeds, a_mask, t_mask = _fuse_input(
        params, cfg, tokens, tokens_mask)
    h_audio, _ = gpt.decode_step(params["understanding_expert"],
                                 cfg.understanding_expert, audio_input,
                                 caches.understanding, pos, **kw)
    h, _ = gpt.decode_step(params["backbone"], cfg.backbone,
                           h_audio * a_mask + text_embeds * t_mask,
                           caches.backbone, pos, **kw)
    h_gen, _ = gpt.decode_step(params["generation_expert"],
                               cfg.generation_expert, h * a_mask,
                               caches.generation, pos, **kw)
    return (h_gen * a_mask + h * t_mask)[:, -1, :], caches


def _sample(stream, logits, topk, temperature, forbid_prefix, use_cfg,
            cfg_scale):
    """Sample per row, or per [cond, uncond] pair with the CFG mix and the
    pair's token given to both rows. A pair reads its cond row's keys and
    its cond row's ``forbid_prefix`` (both rows carry the same phase)."""
    if not use_cfg:
        return sample_topk(stream, logits, topk, temperature,
                           forbid_prefix=forbid_prefix)
    lg = logits.reshape(logits.shape[0] // 2, 2, -1)
    mixed = cfg_mix(lg[:, 0], lg[:, 1], cfg_scale)
    if isinstance(stream, RowKeys):
        stream = stream.rows(slice(0, None, 2))
    if isinstance(forbid_prefix, torch.Tensor) and forbid_prefix.ndim \
            and forbid_prefix.shape[0] == logits.shape[0]:
        forbid_prefix = forbid_prefix[0::2]
    s = sample_topk(stream, mixed, topk, temperature,
                    forbid_prefix=forbid_prefix)
    return s[:, None].expand(-1, 2).reshape(-1)     # each pair's token twice


def decode_frame(params: Params, cfg: UnifiedModelConfig,
                 tokens: torch.Tensor, tokens_mask: torch.Tensor,
                 caches: UnifiedCaches, pos: "torch.Tensor | int",
                 stream: "torch.Generator | RowKeys | None", *,
                 temperature: float, topk: int,
                 forbid_prefix: "torch.Tensor | int",
                 use_cfg: bool = False, cfg_scale: float = 1.0,
                 sample_text: bool = True, sample_audio: bool = True,
                 key_valid: Optional[torch.Tensor] = None,
                 attn_block: Optional[int] = None, kv_write: str = "inline",
                 host_pos: Optional[int] = None,
                 local: Optional[LocalCache] = None
                 ) -> Tuple[torch.Tensor, UnifiedCaches]:
    """One AR step: the previous frame's (B, 1, 9) tokens at ``pos`` -> the
    next frame's (B, 9) int64 tokens [text, cb0..cb7]. ``sample_text`` /
    ``sample_audio`` skip the unused head (its stream returns zeros); with
    ``use_cfg`` rows are [cond, uncond] pairs. ``stream`` is one generator
    for every row, or this frame's `RowKeys` (text draws from its fold 0,
    the audio codebooks from fold 1). ``forbid_prefix`` is an int, a 0-d
    tensor or per-row (B, 1). The cache policies as in `decode_hidden`;
    ``local`` is a kept local-decoder cache (else one is made)."""
    b = tokens.shape[0]
    last_h, caches = decode_hidden(params, cfg, tokens, tokens_mask, caches,
                                   pos, key_valid=key_valid,
                                   attn_block=attn_block, kv_write=kv_write,
                                   host_pos=host_pos)
    key_text = key_audio = stream
    if isinstance(stream, RowKeys):
        key_text, key_audio = stream.fold(0), stream.fold(1)
    if sample_text:
        text_logits = gpt.lm_head(params["backbone"], last_h, cfg.backbone)
        text_sample = _sample(key_text, text_logits, topk, temperature, None,
                              use_cfg, cfg_scale)
    else:
        text_sample = torch.zeros((b,), dtype=torch.int64, device=last_h.device)
    if sample_audio:
        audio = _local_decoder_generate(
            params, cfg, last_h, key_audio, temperature=temperature, topk=topk,
            forbid_prefix=forbid_prefix, use_cfg=use_cfg, cfg_scale=cfg_scale,
            local=local)
    else:
        audio = torch.zeros((b, cfg.tokens.num_codebooks), dtype=torch.int64,
                            device=last_h.device)
    return torch.cat([text_sample[:, None], audio], dim=1), caches


def _local_decoder_generate(params: Params, cfg: UnifiedModelConfig,
                            last_h: torch.Tensor,
                            stream: "torch.Generator | RowKeys | None", *,
                            temperature: float, topk: int,
                            forbid_prefix: "torch.Tensor | int",
                            use_cfg: bool, cfg_scale: float,
                            local: Optional[LocalCache] = None) -> torch.Tensor:
    """8 sequential local-decoder steps over an 8-slot cache (``local``, or
    a fresh one) -> (B, 8) codebook ids. With serving params the embedding
    projection is the folded table; only step 0 multiplies by
    ``projection_w``. Per-row keys draw codebook i from their fold i."""
    dcfg = cfg.decoder
    ncb = cfg.tokens.num_codebooks
    audio_vocab = cfg.tokens.audio_vocab
    if local is None:
        local = init_local_cache(cfg, last_h.shape[0], last_h.dtype,
                                 last_h.device)
    cache, steps = local
    proj_table = params.get("audio_embeddings_proj")
    heads = params["audio_head"]
    if proj_table is None:
        table, h = params["audio_embeddings"], last_h
    else:
        table = proj_table
        h = matmul(last_h, params["projection_w"]).to(proj_table.dtype)
    curr = h[:, None, :]
    samples = []
    for i in range(ncb):
        proj = curr if proj_table is not None \
            else matmul(curr, params["projection_w"])
        dec_h, cache = gpt.decode_step(params["decoder"], dcfg, proj, cache,
                                       steps[i:i + 1])
        head = heads[i] if isinstance(heads, list) \
            else gpt.index_leaf(heads, i)
        logits = matmul(dec_h[:, -1, :], head, out_dtype=torch.float32)
        key = stream.fold(i) if isinstance(stream, RowKeys) else stream
        s = _sample(key, logits, topk, temperature, forbid_prefix, use_cfg,
                    cfg_scale)
        samples.append(s)
        curr = table[s + i * audio_vocab][:, None, :]
    return torch.stack(samples, dim=1)
