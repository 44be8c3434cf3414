"""H100 probes: the port of ``scripts/probe_bitcast.py`` and
``scripts/probe_int8_mxu.py``, each a CUDA kernel under ``ops/csrc/`` run
at the TPU probe's shapes (``python -m stargcn_tpu_torch.probes.<name>``)."""
