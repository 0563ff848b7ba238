"""Training data (port of `uniaudio2_tpu/data/loading.py` and
`batching.py`): the task-dataset JSON DSL and length batching."""
