"""The benchmark of the PyTorch and CUDA port (``plagnn_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``: it makes the inputs from the
seed on the card, builds the port's fold-batched runner in set-up, trains for
a timed window, reads the per-layer metrics from a traced tail where asked,
and holds the set-up's first training steps against the plain reference in
``reference/``.  See ``README.md``.
"""
