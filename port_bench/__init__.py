"""The benchmark of ``stargcn_tpu_torch``, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  A cell is a
configuration (``configs/``) under a traffic mix (``traffic/``); each
per-layer metric is a reader in ``metrics/``; ``reference/`` is the plain
float32 model that decides ``correct``; ``graphs.py`` makes the graphs and
``flops.py`` holds the peaks and the operation and byte counts.  Nothing
here imports JAX or the JAX package.
"""
