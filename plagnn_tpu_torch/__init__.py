"""plagnn-tpu-torch: the PyTorch/CUDA port of plagnn-tpu for one NVIDIA H100.

The fold-batched GNN32 training path (``train-normal`` / ``train-inter``)
runs on PyTorch, with the neighbourhood max-aggregation and its
argmax-routed backward as CUDA kernels written by hand for Hopper
(``csrc/``).  Every module here has a counterpart of the same name in
``plagnn_tpu``, which stays the reference the port is tested against; this
package imports neither JAX nor anything of ``plagnn_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU, where each
kernel is replaced by its plain PyTorch version.
"""
