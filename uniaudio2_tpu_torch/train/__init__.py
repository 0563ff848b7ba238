"""Training of the unified LM on one card (port of `uniaudio2_tpu/train/`):
masks, schedules, the chunked cross-entropy, the losses, the optimizers
(AdamW and the memory-lean `adamw_lean` with its fused update kernel), the
train step, checkpoints, the reporter and the `train` entry point."""
