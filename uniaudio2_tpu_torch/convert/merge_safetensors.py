"""Merging sharded HF safetensors into one state dict (the JAX package's
`uniaudio2_tpu/convert/merge_safetensors.py`): not ported yet. Both entry
points raise, naming ROADMAP queue 1 item 18. The converters that read a
merged or reference state dict are ported (`convert/torch_ckpt.py`,
`convert/codec.py`).
"""

from __future__ import annotations

_TODO = ("merging sharded safetensors is not ported yet (ROADMAP queue 1 "
         "item 18); convert a reference .pt / .checkpoint with "
         "convert/torch_ckpt.py instead")


def merge_safetensors(input_dir: str):
    raise NotImplementedError(_TODO)


def main(argv=None):
    raise NotImplementedError(_TODO)


if __name__ == "__main__":
    main()
