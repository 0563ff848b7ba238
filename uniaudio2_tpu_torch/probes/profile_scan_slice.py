"""A serial chain over a stacked layer axis, on the H100 (port of
`scripts/profile_scan_slice.py`).

    python -m uniaudio2_tpu_torch.probes.profile_scan_slice

The TPU probe asked whether `lax.scan` over a stacked (L, K/2, N) int4
container copies each layer's slice before the Pallas kernel reads it, and
what a kernel that takes the layer index by scalar prefetch costs. On the
card the question is the frame graph's: does a loop over the stacked axis
cost anything against separate per-layer arrays, and what does a kernel
that reads the layer index on the device (`csrc/gemv_int4_stacked.cu`,
row 14) cost, which one captured body needs to walk every layer.

A 28-layer serial chain ``x = (gemv(x, layer)[:, :K]) * 1e-3`` at
(L, K, N) = (28, 3072, 8192), ITERS passes, on the bytes of the port's
``quantize4`` of seeded normals, in four forms:

* ``scan``: views of one stacked container (`gpt.index_leaf`, no copy)
  through row 5's kernel (`quant.int4_matmul`);
* ``unrolled``: 28 separate containers through row 5's kernel;
* ``prefetch``: row 14's kernel on the stack, the index taken from a
  device ``arange(L)``;
* ``one_layer_graph``: a CUDA graph of ONE layer of row 14's kernel plus
  a device increment of the index (mod L), replayed L x ITERS times: the
  card's counterpart of `lax.scan`'s one compiled body.

The first three run eagerly (one launch at a time from the host) and as a
captured graph of one pass over the 28 layers, replayed ITERS times. Each
form prints its ms for the whole chain, its GB/s of true weight bytes and
the byte bound (the weights, scales, activations and outputs at 3.35
TB/s). First, one pass of every form is held to the others to the bit,
layer by layer, and to the plain twin within one bf16 ulp; then each timed
chain's final output must equal the others'. The counter of row 14's
kernel counts the launches after those checks: each timed run's and its
warm-up's, replays included.
"""

from __future__ import annotations

import json

import torch

from uniaudio2_tpu_torch.models import gpt
from uniaudio2_tpu_torch.ops import _cuda, int4_stacked, quant

L, K, N = 28, 3072, 8192
ITERS = 256
ULP = 2.0 ** -7


def weights(dev):
    """The stacked container and its 28 layers as separate containers."""
    gen = torch.Generator(device=dev).manual_seed(14)
    layers = [quant.quantize4(torch.randn((K, N), generator=gen, device=dev)
                              .to(torch.bfloat16))
              for _ in range(L)]
    stacked = quant.QuantizedLinear4(torch.stack([w.values for w in layers]),
                                     torch.stack([w.scale for w in layers]))
    return stacked, layers


def chain_back(y):
    return y[:, :K] * 1e-3


class Forms:
    """One pass over the layers (``step(x, l)`` for l < L) in each form,
    writing into a static ``x`` buffer so that a graph can replay it."""

    def __init__(self, stacked, layers, dev):
        self.stacked, self.layers = stacked, layers
        self.index = torch.arange(L, dtype=torch.int32, device=dev)
        self.layer = torch.zeros(1, dtype=torch.int32, device=dev)
        self.x = torch.ones((1, K), dtype=torch.bfloat16, device=dev)

    def scan(self, l):
        w = gpt.index_leaf(self.stacked, l)
        return quant.int4_matmul(self.x, w.values, w.scale)

    def unrolled(self, l):
        w = self.layers[l]
        return quant.int4_matmul(self.x, w.values, w.scale)

    def prefetch(self, l):
        return int4_stacked.int4_stacked_matmul(self.x, self.stacked,
                                                self.index[l:l + 1])

    def one_layer(self):
        """One layer of row 14 at the device index, then the next index."""
        y = int4_stacked.int4_stacked_matmul(self.x, self.stacked, self.layer)
        self.x.copy_(chain_back(y))
        self.layer.copy_((self.layer + 1) % L)

    def run_pass(self, name):
        for l in range(L):
            self.x.copy_(chain_back(getattr(self, name)(l)))


def check(forms):
    """One pass from x = 1 of each form, layer by layer: the three forms
    the same bits, each layer within one bf16 ulp of the twin. Returns the
    worst |kernel - twin| / max|twin|."""
    worst = 0.0
    x = torch.ones((1, K), dtype=torch.bfloat16, device=forms.x.device)
    for l in range(L):
        forms.x.copy_(x)
        outs = [getattr(forms, name)(l) for name in
                ("scan", "unrolled", "prefetch")]
        forms.layer.fill_(l)
        forms.one_layer()
        twin = int4_stacked.int4_stacked_matmul_plain(
            x.cpu(), quant.QuantizedLinear4(forms.stacked.values[l:l + 1].cpu(),
                                            forms.stacked.scale[l:l + 1].cpu()),
            0)
        ref = outs[0]
        if not all(torch.equal(o, ref) for o in outs[1:]) or not torch.equal(
                forms.x, chain_back(ref)):
            raise AssertionError(f"layer {l}: the chain's forms disagree")
        err = (ref.float().cpu() - twin.float()).abs().max().item()
        mag = twin.float().abs().max().item()
        if err > ULP * mag:
            raise AssertionError(f"layer {l}: row 14's kernel is {err:.3e} "
                                 f"from its twin (> one bf16 ulp of {mag:.3e})")
        worst = max(worst, err / mag)
        x = chain_back(ref)
    return worst


def timed(fn, reps=1):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()                                        # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(device: str = "cuda"):
    """Run the probe; print one JSON line per form and return them."""
    from uniaudio2_tpu_torch.probes import PEAK_BYTES, card

    dev = torch.device(device)
    print(json.dumps({"probe": "profile_scan_slice", "card": card()}),
          flush=True)
    stacked, layers = weights(dev)
    forms = Forms(stacked, layers, dev)
    worst = check(forms)
    print(json.dumps({"check": "one pass, every form the same bits; kernel "
                      "vs twin", "max_err_over_max_twin": worst}), flush=True)
    layer_bytes = K // 2 * N + 4 * N + 2 * K + 2 * N
    total_bytes = L * ITERS * layer_bytes
    bound_ms = total_bytes / PEAK_BYTES * 1e3
    _cuda.reset_count(int4_stacked.int4_stacked_matmul)
    lines, finals = [], {}

    def report(name, ms):
        line = {"variant": name, "ms": ms, "us_per_layer": ms * 1e3 / (L * ITERS),
                "GBps": L * ITERS * (K // 2) * N / ms / 1e6,
                "bound_ms": bound_ms, "times_bound": ms / bound_ms}
        finals[name] = forms.x.clone()
        print(json.dumps(line), flush=True)
        lines.append(line)

    def reset():
        forms.x.fill_(1.0)
        forms.layer.zero_()

    for name in ("scan", "unrolled", "prefetch"):
        def eager():
            reset()
            for _ in range(ITERS):
                forms.run_pass(name)
        report(name, timed(eager))
        graph, per_replay = _cuda.capture_graph(lambda: forms.run_pass(name))

        def replayed():
            reset()
            for _ in range(ITERS):
                graph.replay()
            _cuda.add_counts(per_replay, ITERS)
        report(f"{name}_graph", timed(replayed))
        del graph
    graph, per_replay = _cuda.capture_graph(forms.one_layer)

    def one_body():
        reset()
        for _ in range(L * ITERS):
            graph.replay()
        _cuda.add_counts(per_replay, L * ITERS)
    report("one_layer_graph", timed(one_body))
    first = next(iter(finals.values()))
    if not all(torch.equal(v, first) for v in finals.values()):
        raise AssertionError("the chain's forms end on different outputs")
    return lines


if __name__ == "__main__":
    main()
