"""The hub cache's sizes: how many rows each direction's arena holds.

Port of ``plagnn_tpu/ops/pallas/spmm_kernels.py: pick_hub_sizes``
(:127-149).  The arena is the hub kernels' shared-memory copy of the k
most-fetched rows of one K-slice of the gathered operand
(``graph_format.HubTable``; the kernels in ``csrc/spmm_max_fwd.cu``,
``spmm_max_bwd.cu`` and ``spmm_sum.cu``).

What carries over and what does not:

* The accepted values: ``"off"``, ``"0"``, ``0`` and None give (0, 0); an
  integer (or its string) forces k on both directions; ``"auto"`` gives the
  measured policy below.
* The halving: k halves until the arena fits.  The TPU's 16 KB row rule
  and its 6 / 9 MB VMEM limits do not carry over.  Here an arena row is
  the kernels' K-slice, 32 bytes a lane (``HUB_SLICE_BYTES``, fewer where
  K is narrower), and the forward arena holds k such rows of the gathered
  operand; the backward's holds k rows of the gradient and k of the argmax
  (``spmm_kernels.argmax_bytes``: int16 for the id-based argmax up to 2^15
  padded rows, int32 past it, as a graph shard's gather space can be), as the JAX
  package's ``(kb + 1) * stride * 2 * esize`` holds fused gradient and
  argmax rows; the sum's arena holds k rows of the gathered operand both
  ways (``arg_size`` 0).  The budget is ``HUB_SMEM_BYTES``: the card's
  227 KB a block (``SMEM_BLOCK_BYTES``) less 1 KB for the kernels' own
  shared memory.  Every hub kernel's arena is pipelined, two stages of one
  K-slice each (``csrc/row_chunks.cuh: hub_pipeline``), so a stage gets
  half of it (``stage_budget``): k <= 113 rows of 1 KB (the max forward,
  the sum), 75 of 1.5 KB in the max backward in float32 with an int16
  argmax, 56 of 2 KB in bfloat16 or with an int32 one.
* Not ported, and why: ``_hub_machinery`` and ``_make_steal`` (:433-510)
  walk a separate stream of hub edges one group at a time and interleave
  it, Bresenham-paced, with the regular DMA-ring groups, so that the
  arena's compute-only groups hide under the DMA service time; the forward
  then merges the two streams with a (value, then smaller id) tie rule.
  On the card a hub edge stays in its place in the one (dst, src)-ordered
  edge stream and its warp reads its row from the arena instead of device
  memory (a warp-uniform branch), so there is no second stream to pace, no
  merge and no tie rule: the first maximum and the float32 add order are
  those of the kernels without the hub by construction.

``auto``: 0 in both directions, for every reduction and message size, on
one card and on a mesh shard's interior pass.  It would take, for each,
the k at which the hub kernel beat the kernel without the hub at the first
layer's shape by more than the run-to-run spread of the kernel without the
hub, provided the model's ms/epoch with it was not slower; no hub kernel
beat it anywhere.  ``chip_smoke.py --only-hub`` (phase 3h, 4h), NVIDIA
H100 80GB HBM3, 700.00 W, the 24,041-node graph at the first layer's K
(the max pair at 5,030: the cp.async fill route; the sum at GCN2's 4,000:
the TMA route), ms by k, at k = 0 (the structure with an empty arena),
and the kernel without the hub (the range of its 4 runs):

  max forward f32   32/64/75/113: 2.109/2.121/2.119/2.202, k=0 2.119; 1.905-1.915
  max backward f32  32/56/64/75:  2.947/2.887/3.269/3.239, k=0 2.960; 2.775-2.810
  max forward bf16  32/64/75/113: 1.660/1.696/1.665/1.693, k=0 1.645; 1.476-1.490
  max backward bf16 32/37/56:     2.199/2.204/2.380,       k=0 2.218; 2.170-2.200
  sum forward f32   32/64/75/113: 1.499/1.519/1.511/1.543, k=0 1.529; 1.311-1.351
  sum transpose f32 32/64/75/113: 1.481/1.481/1.466/1.511, k=0 1.513; 1.317-1.325
  sum forward bf16  32/64/75/113: 0.826/0.821/0.816/0.828, k=0 0.838; 0.709-0.723
  sum transpose bf16 32/64/75/113: 0.825/0.801/0.798/0.830, k=0 0.836; 0.706-0.748

GNN32 with ``--hub-cache 128`` (k = 64 / 64 in float32, 64 / 32 in
bfloat16) ran 70.546 ms/epoch against 69.421 without in float32, 70.124
against 69.990 in bfloat16, and GCN2 (k = 64 / 64) 15.121 against 14.492
(phase 4h, the same run; another run read 14.717 against 15.208, within
the host's spread of GCN2's epochs).  At 330,112 nodes (phase 4g,
id-based, int32 argmax, K = 8 x 503: the TMA route) an earlier full run
read, with the hub against without it at the rule's K-slice: forward f32
39.008 / 35.823 ms (k = 64), backward f32 79.940 / 70.311 (k = 32), bf16
21.401 / 21.231 and 68.419 / 56.086; on the mesh's interior shards (phase
4s) the hub kernels ran 21-74% slower at P = 2 and 4, and on config 5's
P = 2 interior the forward at (64, 32) 15.821 ms against 14.157 without
the hub at 1 KB.  So "auto" takes no hub on a shard either.  An explicit
k runs the hub kernels; on a mesh, on each rank's interior pass
(``parallel/partition.py``), whose shards are id-based at any size.
"""
from __future__ import annotations

from typing import Tuple

# Bytes of one K-slice row of the kernels: 32 lanes x 32 bytes.
HUB_SLICE_BYTES = 1024
# The card's most shared memory for one block (hopper-kernels guide).
SMEM_BLOCK_BYTES = 232_448
# Bytes an arena may take: a block's 227 KB less 1 KB for the kernel's own.
HUB_SMEM_BYTES = SMEM_BLOCK_BYTES - 1024


def arena_stride(k_width: int, esize: int) -> int:
    """Elements of one arena row: the hub kernels' K-slice, or K if it is
    narrower."""
    return min(HUB_SLICE_BYTES // esize, int(k_width))


def arena_bytes(k: int, k_width: int, esize: int, arg_size: int = 0) -> int:
    """Shared memory of one stage of k rows: the gathered operand's slice,
    plus the argmax's (``arg_size`` bytes an element; the max backward)."""
    return k * arena_stride(k_width, esize) * (esize + arg_size)


def stage_budget() -> int:
    """Bytes one stage of an arena may take: half the budget, as a hub
    kernel holds two K-slices' rows at once (``csrc/row_chunks.cuh:
    hub_pipeline``)."""
    return HUB_SMEM_BYTES // 2


def pick_hub_sizes(hub_cache, k_width: int, esize: int,
                   arg_size: int = 2) -> Tuple[int, int]:
    """(k_fwd, k_bwd) for aggregations K = ``k_width`` elements wide of
    ``esize``-byte messages: the forward's arena (max forward, sum) and
    the transpose's (max backward with an ``arg_size``-byte argmax,
    ``spmm_kernels.argmax_bytes`` of the graph that carries the hub; 0 for
    the sum's VJP, whose arena holds no argmax), each halved until a stage
    fits ``stage_budget``."""
    if hub_cache in ("off", "0", 0, None, "auto"):  # auto: the hub loses (above)
        return 0, 0
    kf = kb = int(hub_cache)
    if kf < 0:
        raise ValueError(f"hub_cache must be 'auto', 'off' or k >= 0, got {hub_cache!r}")
    budget = stage_budget()
    while kf and arena_bytes(kf, k_width, esize) > budget:
        kf //= 2
    while kb and arena_bytes(kb, k_width, esize, arg_size) > budget:
        kb //= 2
    return kf, kb
