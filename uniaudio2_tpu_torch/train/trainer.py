"""Training step and state for the unified audio LM (port of
`uniaudio2_tpu/train/trainer.py`), on one card or on a device mesh.

Batch layout (built by `data/batching.py` from the task grids):
    grid:            (B, S+1, 9) int teacher-forcing token grid
    grid_mask:       (B, S+1, 9) bool stream-activity mask
    text_loss_mask:  (B, S) bool — steps whose next token is a text target
    audio_loss_mask: (B, S) bool — steps whose next frame is an audio target
Inputs are ``grid[:, :-1]``; labels are ``grid[:, 1:, :8]`` (audio) and
``grid[:, 1:, -1]`` (text).

The train step runs eagerly: autograd for the gradients, then the
optimizer, then the updates added to the parameters in place (the state's
parameter tensors are the step's own; JAX returns new arrays instead).

On a mesh (``init_train_state(mesh=)``, ``build_train_step(mesh=)``; the
JAX package's SPMD step over `parallel/mesh.py`'s shardings) parameters
and optimizer state are DTensors placed by `mesh.shard_params`. Each rank
passes its own rows (`mesh.local_rows` of a global batch under
``("replica", "fsdp")``, replica major, or a data-parallel rank's own
batch; the tp ranks of a group pass the same rows). The stacks' layer
leaves are gathered a layer at a time as the layer runs, again in a remat
layer's backward (`gpt.forward`), the other leaves (embeddings, heads,
final norms, stacked norms whose layer axis the rules shard) once for
the forward (`mesh.gather`: FSDP's gather on use;
a gradient comes back reduce-scattered over fsdp and all-reduced over
replica), and the stacks run tensor parallel over ``tp``
(`gpt.forward(tp=)`, Megatron column / row). The loss divides each rank's
sums by the global mask counts; the reported metrics are summed over the
data-parallel ranks; the gradient norm sums every shard once. At one
device every collective is skipped and the step is the plain one's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from uniaudio2_tpu_torch.config import UnifiedModelConfig
from uniaudio2_tpu_torch.models import unified
from uniaudio2_tpu_torch.parallel import mesh as meshlib
from uniaudio2_tpu_torch.train import losses, optim
from uniaudio2_tpu_torch.train.masks import prefix_lm_mask

Params = Dict[str, Any]


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: int


class Batch(NamedTuple):
    grid: torch.Tensor              # (B, S+1, 9) int
    grid_mask: torch.Tensor         # (B, S+1, 9) bool
    text_loss_mask: torch.Tensor    # (B, S) bool
    audio_loss_mask: torch.Tensor   # (B, S) bool


def to_batch(raw: Dict[str, Any], device="cuda") -> Batch:
    """A batch of numpy arrays (`LengthBatcher` output) on ``device``."""
    return Batch(*(torch.as_tensor(raw[k]).to(device) for k in
                   ("grid", "grid_mask", "text_loss_mask", "audio_loss_mask")))


def make_optimizer(schedule, *, weight_decay: float = 0.01,
                   grad_clip: float = 1.0, b1: float = 0.9, b2: float = 0.95,
                   accum_steps: int = 1, optimizer: str = "adamw",
                   lean_fused: str = "auto") -> optim.GradientTransformation:
    """Global-norm clipping + AdamW, ``adamw_lean`` (the single-card
    memory configuration: int8 first moment, factored second moment) or
    Adafactor (optax's, ``decay_rate=b2``, no block clipping), with
    gradient accumulation over ``accum_steps`` calls."""
    if optimizer == "adamw_lean":
        from uniaudio2_tpu_torch.train.lean_opt import adamw_lean

        inner = adamw_lean(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                           fused=lean_fused)
    elif optimizer == "adamw":
        inner = optim.adamw(schedule, b1=b1, b2=b2, weight_decay=weight_decay)
    elif optimizer == "adafactor":
        inner = optim.adafactor(schedule, decay_rate=b2,
                                weight_decay_rate=weight_decay or None)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    tx = optim.chain(optim.clip_by_global_norm(grad_clip), inner)
    if accum_steps > 1:
        tx = optim.multi_steps(tx, accum_steps)
    return tx


def init_train_state(params: Params, tx: optim.GradientTransformation,
                     device="cuda", mesh=None, use_tp: bool = False
                     ) -> TrainState:
    """Parameters on ``device`` (moved there if they are elsewhere) and
    the optimizer's state beside them; with ``mesh`` placed by
    `mesh.shard_params` (every rank passes the same whole tree). The state
    owns the parameter tensors: the train step updates them in place, so
    a caller that wants to keep its originals passes copies."""
    params = optim.tree_map(lambda p: p.detach().to(device), params)
    if mesh is not None:
        params = meshlib.shard_params(params, mesh, use_tp=use_tp)
    return TrainState(params=params, opt_state=tx.init(params, device), step=0)


def audio_gather_indices(audio_loss_mask: torch.Tensor, capacity: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row positions of the first ``capacity`` audio-loss steps (a
    stable argsort floats each row's audio steps to the front), and their
    validity (B, C) bool. Rows with more than C audio steps lose the tail."""
    b, s = audio_loss_mask.shape
    capacity = min(capacity, s)
    order = torch.argsort((~audio_loss_mask).to(torch.int8), dim=1, stable=True)
    idx = order[:, :capacity]
    count = audio_loss_mask.sum(dim=1)
    valid = torch.arange(capacity, device=idx.device)[None, :] < count[:, None]
    return idx, valid


def loss_fn(params: Params, cfg: UnifiedModelConfig, batch: Batch, *,
            prefix_lm: bool = False,
            residual_weights: Sequence[float] = (1.0,) * 7,
            chunked_ce: bool = True, remat: bool = False,
            remat_backbone: Optional[int] = None,
            remat_small: Optional[bool] = None,
            audio_capacity: Optional[int] = None, tp=None, total=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's loss and metrics. ``chunked_ce`` (default) computes both
    CE losses from hidden states through the logit-free chunked CE (dense
    logits when the backbone softcaps its logits); ``remat`` checkpoints
    each layer of every stack (fused path); ``audio_capacity`` runs the
    local decoder and the audio CE only at gathered audio steps. ``tp``
    and ``total`` (a mesh): tensor parallelism and the data-parallel sum
    of the loss's counts."""
    tokens = batch.grid[:, :-1]
    audio_labels = batch.grid[:, 1:, :cfg.tokens.num_codebooks]
    text_labels = batch.grid[:, 1:, -1]
    extra_mask = None
    if prefix_lm:
        seg = batch.text_loss_mask | batch.audio_loss_mask
        extra_mask = prefix_lm_mask(seg, prefix_lm=True)
    if chunked_ce and cfg.backbone.final_logit_softcapping is None:
        a_labels, a_mask, dec_pos, dropped = (audio_labels,
                                              batch.audio_loss_mask, None, None)
        if audio_capacity is not None:
            dec_pos, a_mask = audio_gather_indices(batch.audio_loss_mask,
                                                   audio_capacity)
            a_labels = torch.take_along_dim(audio_labels, dec_pos[:, :, None],
                                            dim=1)
            count = batch.audio_loss_mask.sum(dim=1)
            dropped = torch.clamp_min(count - audio_capacity, 0).sum()
        h_final, dec_h = unified.forward(
            params, cfg, tokens, audio_labels, batch.grid_mask,
            extra_mask=extra_mask, return_hidden=True, remat_layers=remat,
            remat_backbone=remat_backbone, remat_small=remat_small,
            decoder_positions=dec_pos, tp=tp)
        loss, metrics = losses.unified_loss_fused(
            h_final, params["backbone"]["lm_head_w"], dec_h,
            params["audio_head"], text_labels, a_labels,
            batch.text_loss_mask, a_mask, residual_weights, total=total)
        if dropped is not None:
            metrics["audio_dropped"] = dropped
        return loss, metrics
    text_logits, audio_logits = unified.forward(
        params, cfg, tokens, audio_labels, batch.grid_mask,
        extra_mask=extra_mask, tp=tp)
    return losses.unified_loss(text_logits, audio_logits, text_labels,
                               audio_labels, batch.text_loss_mask,
                               batch.audio_loss_mask, residual_weights,
                               total=total)


def build_train_step(cfg: UnifiedModelConfig, tx: optim.GradientTransformation,
                     *, prefix_lm: bool = False,
                     residual_weights: Sequence[float] = (1.0,) * 7,
                     remat: bool = True, remat_backbone: Optional[int] = None,
                     remat_small: Optional[bool] = None,
                     chunked_ce: bool = True,
                     audio_capacity: Optional[int] = None, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``. With
    ``mesh`` the state is `init_train_state(mesh=)`'s and ``batch`` this
    rank's rows.

    ``remat``: per-layer checkpointing inside the model on the fused
    (chunked-CE) path, the whole loss checkpointed on the dense path (as
    the JAX package does). ``remat_backbone`` / ``remat_small``: selective
    overrides (fused path only). ``metrics["grad_norm"]`` is the global
    norm of the raw gradients."""
    fused = chunked_ce and cfg.backbone.final_logit_softcapping is None
    tp = meshlib.tensor_parallel(mesh)
    total = None if mesh is None or meshlib.dp_size(mesh) == 1 \
        else meshlib.dp_sum(mesh)

    def _loss(params, batch):
        if mesh is not None:
            params = meshlib.tree_map_with_path(
                lambda path, p: p if _per_layer(path, p)
                else meshlib.gather(p), params)
        return loss_fn(
            params, cfg, batch, prefix_lm=prefix_lm,
            residual_weights=residual_weights, chunked_ce=chunked_ce,
            remat=remat and fused,
            remat_backbone=remat_backbone if fused else None,
            remat_small=remat_small if fused else None,
            audio_capacity=audio_capacity if fused else None, tp=tp,
            total=total)

    def grad_source(params, batch):
        if remat and not fused:
            return checkpoint(_loss, params, batch, use_reentrant=False)
        return _loss(params, batch)

    def train_step(state: TrainState, batch: Batch):
        leaves = optim.tree_leaves(state.params)
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss, metrics = grad_source(state.params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        if total is not None:
            metrics = {k: total(v) for k, v in metrics.items()}
        metrics["grad_norm"] = optim.global_norm(grads)
        grads = _unflatten(state.params, iter(grads))
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        del grads
        optim.apply_updates(state.params, updates)
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return train_step


def _per_layer(path, p) -> bool:
    """Whether `gpt.forward` gathers a parameter a layer at a time: a
    stack's layer leaf, unless it is stacked with its layer axis sharded
    (the rule for a stacked norm), which cannot be split into layers
    before its gather."""
    if path[1:2] != ("layers",):
        return False
    return len(path) > 3 or not meshlib.shards_dim(p, 0)


def _unflatten(like, it):
    """A tree shaped like ``like`` whose leaves come from ``it`` in
    `optim.tree_leaves` order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, list):
        return [_unflatten(v, it) for v in like]
    return next(it)
