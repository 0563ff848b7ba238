"""The ReasoningCodec (port of `uniaudio2_tpu/codec/`). Encode: the
resampler and log-mels, the Whisper, WavLM and BEST-RQ towers, the
reasoning transformer, the fusion chain and RVQ encode, and the tokenizer
facade. Decode: RVQ inverse lookup, the flow-matching DiT and its Euler
solver, the ScalarAE waveform decoder, and the windowed offline and
streaming decoders."""
