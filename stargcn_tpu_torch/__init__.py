"""stargcn_tpu_torch — STAR-GCN in PyTorch, with hand-written Hopper kernels.

A port of ``stargcn_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch and CUDA on
an NVIDIA H100.  Module paths and names mirror ``stargcn_tpu`` so every
counterpart is easy to find; the JAX package stays the reference the tests
hold this one against.

The port imports ``torch``, numpy and PyYAML only — never ``jax``,
``flax`` or ``stargcn_tpu``.  Each Pallas kernel becomes a CUDA kernel
under ``ops/csrc/``, built with ``nvcc`` at first use; each has a plain
PyTorch version beside it that runs whenever its input lies on the CPU.

Covered so far: full-graph transductive training and serving on the
``bitdense`` backend (config -> synthetic graph -> ``DataIterator`` -> bit
packs -> ``train.Trainer`` -> ``serve.export_serving`` ->
``ServingArtifact`` -> ``Predictor``), with ``bit_expand_matmul`` and its
backward ``bit_reduce_matmul`` as CUDA kernels.  Entry points run on
``device="cuda"`` unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
