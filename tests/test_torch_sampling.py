"""Distributions of the port's sampled branches (`ops/sampling.py`).

The two frameworks draw other random numbers, so sampled tokens are held
to their distribution instead of JAX's tokens: 20,000 draws on fixed
logits must stay inside the kept set (top-k, or the nucleus) and each
kept token's frequency within 5 standard errors, 5 sqrt(p (1 - p) / n), of
its probability under the softmax over the kept set (a sound sampler
fails one of these 64 bounds with odds near 1e-5; the draws are seeded,
so the test is deterministic). Covered: `sample_topk` with one shared
generator, with per-row `RowKeys` across rows (one seed each) and across
frames (one row's key folded with each step), and with a prefix mask;
`sample_topp` against the set and the frequencies of JAX's `sample_topp`,
whose own draws are held to the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniaudio2_tpu.ops import sampling as jsampling

from uniaudio2_tpu_torch.ops import sampling
from uniaudio2_tpu_torch.ops.sampling import RowKeys

N = 20_000
V = 64
TOPK = 5
TEMP = 0.9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _logits(seed=0):
    return np.random.default_rng(seed).standard_normal(V).astype(np.float32) * 2


def _kept_probs(logits, kept):
    z = logits.astype(np.float64) / TEMP
    p = np.zeros(V)
    p[kept] = np.exp(z[kept] - z[kept].max())
    return p / p.sum()


def _check(samples, probs):
    samples = np.asarray(samples).reshape(-1)
    assert samples.shape == (N,)
    assert set(np.unique(samples)) <= set(np.flatnonzero(probs))
    freq = np.bincount(samples, minlength=V) / N
    tol = 5 * np.sqrt(probs * (1 - probs) / N)
    assert np.all(np.abs(freq - probs) <= tol), np.abs(freq - probs).max()


def _topk_probs(logits):
    return _kept_probs(logits, np.argsort(logits)[-TOPK:])


def test_topk_shared_generator():
    lg = _logits()
    x = torch.from_numpy(lg).expand(N, V)
    s = sampling.sample_topk(torch.Generator().manual_seed(0), x, TOPK, TEMP)
    _check(s.numpy(), _topk_probs(lg))


def test_topk_row_keys_across_rows():
    lg = _logits(1)
    x = torch.from_numpy(lg).expand(N, V)
    keys = RowKeys.from_seeds(range(N), "cpu").fold(5).fold(1).fold(3)
    _check(sampling.sample_topk(keys, x, TOPK, TEMP).numpy(), _topk_probs(lg))


def test_topk_row_keys_across_frames():
    """One row's stream over N frames: key(seed 42) folded with the frame,
    then with the text stream, as the batched loop draws it."""
    lg = _logits(2)
    base = RowKeys.from_seeds([42], "cpu")
    keys = RowKeys(torch.cat([base.fold(t).fold(0).keys for t in range(N)]))
    s = sampling.sample_topk(keys, torch.from_numpy(lg).expand(N, V), TOPK,
                             TEMP)
    _check(s.numpy(), _topk_probs(lg))


def test_topk_full_vocab_with_prefix_mask():
    """topk <= 0 draws over the whole vocabulary; ids below the forbidden
    prefix never come."""
    lg = _logits(3) * 0.5
    keys = RowKeys.from_seeds(range(N), "cpu")
    s = sampling.sample_topk(keys, torch.from_numpy(lg).expand(N, V), 0, TEMP,
                             forbid_prefix=torch.full((N, 1), 40)).numpy()
    _check(s, _kept_probs(lg, np.arange(40, V)))


@pytest.mark.parametrize("top_p", [0.5, 0.9])
def test_topp_matches_jax_nucleus(top_p):
    """The nucleus: tokens by falling probability while the mass before
    each is <= top_p. The port's and JAX's draws both stay in it, at the
    softmax frequencies over it."""
    lg = _logits(4)
    z = lg.astype(np.float64) / TEMP
    p = np.exp(z - z.max())
    p /= p.sum()
    order = np.argsort(-p)
    before = np.cumsum(p[order]) - p[order]
    kept = order[before <= top_p]
    probs = _kept_probs(lg, kept)
    keys = RowKeys.from_seeds(range(N), "cpu")
    got = sampling.sample_topp(keys, torch.from_numpy(lg).expand(N, V), top_p,
                               TEMP).numpy()
    _check(got, probs)
    jkeys = jax.random.split(jax.random.PRNGKey(0), N)
    want = np.asarray(jax.vmap(lambda k: jsampling.sample_topp(
        k, jnp.asarray(lg), top_p, TEMP))(jkeys))
    _check(want, probs)
    assert set(np.unique(got)) == set(np.unique(want)) == set(kept.tolist())


def test_greedy_branch_ignores_the_stream():
    lg = torch.from_numpy(np.stack([_logits(5), _logits(6)]))
    want = torch.argmax(lg / TEMP, dim=-1)
    for stream in (None, torch.Generator().manual_seed(1),
                   RowKeys.from_seeds([1, 2], "cpu")):
        assert torch.equal(sampling.sample_topk(stream, lg, 1, TEMP), want)
