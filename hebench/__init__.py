"""The benchmark of ``heaac_tpu_torch``: ``python3 hebench/run.py``.
See ``harness.py`` for how a cell's files are found by name."""
