"""Ports of the JAX package's TPU measurement probes (`scripts/`), each a
script that runs on the card: `profile_gemv` (the split-K int8 GEMV against
the production int8 kernel, a bf16 product and an int8 x int8 product) and
`profile_attention` (the causal GQA flash kernel at the backbone's prefill
shape and the DiT's kernel, against the production einsum path and SDPA).
Each prints the card's name and power limit beside its numbers."""

import subprocess


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]
