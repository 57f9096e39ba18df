"""The plain reference: GNN32 and GCN2 training steps and the per-epoch
metric row in plain PyTorch, worked out from the benchmark's inputs alone.

It imports neither JAX nor any part of ``plagnn_tpu`` or
``plagnn_tpu_torch``.
"""
