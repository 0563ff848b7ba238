"""Device meshes, parameter placement and multi-rank checks (port of
`uniaudio2_tpu/parallel/`)."""
