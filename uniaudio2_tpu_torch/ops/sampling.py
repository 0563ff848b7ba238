"""Token sampling (port of `uniaudio2_tpu/ops/sampling.py`).

Gumbel-max within the top-k candidate set, with explicit random streams in
place of JAX PRNG keys. A stream is either one ``torch.Generator`` shared
by every row (the JAX package's single key), or `RowKeys`: one 64-bit key
per row, from which each row's uniforms are a pure function of (its key,
the element index), so a row's draws never depend on which other rows
share the batch (the JAX package's per-row ``(B, 2)`` keys). `RowKeys`
folds in the frame, the stream and the codebook as JAX's ``fold_in`` tree
does, with a splitmix64 hash in int64 tensor ops on the rows' device.

The two frameworks draw different numbers from the same seed, so only the
greedy branch (``topk == 1``) is comparable token for token; the sampled
branches are held to their distributions. Top-k is exact (`torch.topk`);
the JAX package's TPU-only ``approx_max_k`` has no counterpart here. No
function here synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

NEG_INF = -1e30


def _signed(v: int) -> int:
    """A 64-bit constant as the int64 value with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)
_LOW23 = (1 << 23) - 1


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 tensors (products wrap mod 2^64)."""
    z = (z ^ _srl(z, 30)) * _M1
    z = (z ^ _srl(z, 27)) * _M2
    return z ^ _srl(z, 31)


class RowKeys(NamedTuple):
    """Per-row random streams: ``keys`` (B,) int64 on the rows' device.
    `fold` derives the keys of a sub-stream (JAX's ``fold_in``); `uniform`
    draws each row's numbers from its own key alone."""

    keys: torch.Tensor

    @staticmethod
    def from_seeds(seeds, device) -> "RowKeys":
        s = torch.as_tensor([int(v) for v in seeds], dtype=torch.int64,
                            device=device)
        return RowKeys(_mix(s * _GOLDEN + _GOLDEN))

    def fold(self, data: int) -> "RowKeys":
        return RowKeys(_mix(self.keys ^ _mix(torch.full_like(
            self.keys, int(data) + 1) * _GOLDEN)))

    def rows(self, index) -> "RowKeys":
        """The keys of some rows (``index`` a slice or index tensor)."""
        return RowKeys(self.keys[index])

    def uniform(self, n: int) -> torch.Tensor:
        """(B, n) float32 in (0, 1): element j of row b is the top 23 bits
        of hash(key_b + (j + 1) * golden), centred in its 2^-23 cell (exact
        in float32, so never 0 or 1)."""
        j = torch.arange(1, n + 1, dtype=torch.int64, device=self.keys.device)
        bits = _srl(_mix(self.keys[:, None] + j * _GOLDEN), 41) & _LOW23
        return (bits.float() + 0.5) * (1.0 / (1 << 23))


Stream = Union[torch.Generator, RowKeys, None]


def _mask_prefix(logits: torch.Tensor,
                 forbid_prefix: "torch.Tensor | int") -> torch.Tensor:
    """Mask token ids ``< forbid_prefix`` to -1e30. ``forbid_prefix`` is an
    int, a 0-d tensor, or a per-row (B, 1) tensor."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < forbid_prefix,
                       torch.full_like(logits, NEG_INF), logits)


def _gumbel(shape, stream: Stream, device) -> torch.Tensor:
    if isinstance(stream, RowKeys):
        if len(shape) != 2 or stream.keys.shape[0] != shape[0]:
            raise ValueError(f"per-row keys {tuple(stream.keys.shape)} need "
                             f"(B, n) draws, got {tuple(shape)}")
        u = stream.uniform(shape[1])
    else:
        u = torch.rand(shape, generator=stream, device=device,
                       dtype=torch.float32)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_topk(
    stream: Stream,
    logits: torch.Tensor,
    topk: int,
    temperature: float,
    forbid_prefix: "torch.Tensor | int | None" = None,
) -> torch.Tensor:
    """One token id per row from top-k(logits / temperature).

    ``logits`` (..., vocab) -> (...,) int64 ids; with `RowKeys` the logits
    are (B, vocab) and row b draws from key b. The greedy branch is the
    argmax of the scaled, prefix-masked logits (first index on ties, as
    ``jnp.argmax``)."""
    scaled = logits.float() / float(temperature)
    if forbid_prefix is not None:
        scaled = _mask_prefix(scaled, forbid_prefix)
    if topk == 1:
        return torch.argmax(scaled, dim=-1)
    if topk <= 0 or topk >= scaled.shape[-1]:
        g = _gumbel(scaled.shape, stream, scaled.device)
        return torch.argmax(scaled + g, dim=-1)
    vals, idxs = torch.topk(scaled, topk, dim=-1)
    g = _gumbel(vals.shape, stream, vals.device)
    choice = torch.argmax(vals + g, dim=-1, keepdim=True)
    return torch.gather(idxs, -1, choice)[..., 0]


def sample_topp(stream: Stream, logits: torch.Tensor, top_p: float,
                temperature: float = 1.0) -> torch.Tensor:
    """Nucleus sampling (`uniaudio2_tpu/ops/sampling.py:105-127`): keep the
    smallest set of tokens whose probabilities, largest first, reach
    ``top_p`` (a token is kept when the mass before it is <= top_p), and
    Gumbel-max within it."""
    scaled = logits.float() / float(temperature)
    probs = torch.softmax(scaled, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    inside = torch.cumsum(sorted_probs, dim=-1) - sorted_probs <= top_p
    thresh = torch.where(inside, sorted_probs,
                         torch.full_like(sorted_probs, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    masked = torch.where(probs >= thresh, scaled,
                         torch.full_like(scaled, NEG_INF))
    g = _gumbel(masked.shape, stream, masked.device)
    return torch.argmax(masked + g, dim=-1)


def cfg_mix(cond: torch.Tensor, uncond: torch.Tensor,
            scale: "torch.Tensor | float") -> torch.Tensor:
    """Classifier-free-guidance mix ``uncond + (cond - uncond) * scale``."""
    return uncond + (cond - uncond) * scale
