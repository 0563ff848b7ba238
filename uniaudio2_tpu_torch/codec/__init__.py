"""The ReasoningCodec's decode path (port of `uniaudio2_tpu/codec/`): RVQ
inverse lookup, the flow-matching DiT and its Euler solver, the ScalarAE
waveform decoder, and the windowed offline and streaming decoders."""
