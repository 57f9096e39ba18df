"""The plain reference: training steps of a configuration's layers (each
layer kind's plain forward in ``kinds/<kind>.py``) and the per-epoch metric
row in plain PyTorch, worked out from the benchmark's inputs alone.

It imports neither JAX nor any part of ``plagnn_tpu`` or
``plagnn_tpu_torch``.
"""
