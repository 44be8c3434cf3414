"""The plain reference of STAR-GCN training: float32 PyTorch written from
the model's equations (``model.py``) and its optimiser (``train.py``).  It
imports nothing of the program and takes nothing the program made; the
benchmark hands it the graph, the weights and the batches it made or drew.
"""
