"""The benchmark's plain reference: a frozen copy of the JAX package's
single-stream NumPy decoder (``bitstream/``, ``tables/``,
``ops/sbr_np.py``, ``ops/ps_np.py``, ``ops/imdct.py``,
``codec/decoder.py``) with every element parsed in Python and the core's
IMDCT and windowing in NumPy (``codec/core.py``).  It imports NumPy
alone: nothing of the program, PyTorch or JAX."""
