"""stargcn_tpu_torch — STAR-GCN in PyTorch, with hand-written Hopper kernels.

A port of ``stargcn_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch and CUDA on
an NVIDIA H100.  Module paths and names mirror ``stargcn_tpu`` so every
counterpart is easy to find; the JAX package stays the reference the tests
hold this one against.

The port imports ``torch``, numpy and PyYAML only — never ``jax``,
``flax`` or ``stargcn_tpu``.  Each Pallas kernel becomes a CUDA kernel
under ``ops/csrc/``, built with ``nvcc`` at first use; each has a plain
PyTorch version beside it that runs whenever its input lies on the CPU.

Covered so far: full-graph training and serving, transductive or
inductive, on a synthetic graph or a MovieLens archive already on disk
(config -> ``data.LoadData`` or a synthetic graph -> ``DataIterator`` ->
dense adjacencies or bit packs -> ``train.Trainer`` ->
``serve.export_serving`` -> ``ServingArtifact`` -> ``Predictor``), with
``bit_expand_matmul`` and its backward ``bit_reduce_matmul`` as CUDA kernels
on the ``bitdense`` backend; and sampled mini-batch
training (``graph.sampling.BlockSampler`` -> ``models.sampled.StackedPlan``
-> ``train.SampledTrainer``), whose ``pallas`` backend pools every frontier
through the three ELL kernels of ``ops.ell_kernels`` (``ell_spmm_fwd_only``,
``ell_spmm_transpose``, ``ell_sddmm``).  Both trainers also run on a
device mesh of ranks over ``torch.distributed`` (``parallel``), whose
collectives ``parallel.perfmodel`` states in advance.  Entry
points run on ``device="cuda"`` unless the caller asks for
``device="cpu"``.
"""

__version__ = "0.1.0"
