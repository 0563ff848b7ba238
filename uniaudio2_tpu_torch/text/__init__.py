"""Text tokenizer (port of `uniaudio2_tpu/text/`)."""
