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
  argmax rows.  The budget is ``HUB_SMEM_BYTES``: the card's 227 KB a
  block (``SMEM_BLOCK_BYTES``) less 1 KB for the kernels' own shared
  memory.  The max kernels' arena is pipelined, two stages of one K-slice
  each (``csrc/row_chunks.cuh: hub_pipeline``), so a stage gets half of it
  (``stage_budget``): k <= 113 rows of 1 KB forward, 75 of 1.5 KB backward
  in float32 with an int16 argmax, 56 of 2 KB in bfloat16 or with an int32
  one.  The sum keeps one stage.
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
hub, provided GNN32's ms/epoch with it was not slower; no hub kernel beat
it anywhere.  ``chip_smoke.py --only-hub`` (phase 3h, 4h), NVIDIA H100 80GB
HBM3, 700.00 W, the 24,041-node graph at the first layer's K (5,030: the cp.async fill
route), ms by k, at k = 0 (the structure with an empty arena), and the
kernel without the hub (the range of its 4 runs):

  max forward f32   32/64/75/113: 2.249/2.223/2.215/2.343, k=0 2.228; 1.974-1.996
  max backward f32  32/56/64/75:  2.998/2.920/3.304/3.372, k=0 3.055; 2.764-2.833
  max forward bf16  32/64/75/113: 1.599/1.660/1.582/1.601, k=0 1.565; 1.389-1.450
  max backward bf16 32/37/56:     2.112/2.106/2.284,       k=0 2.162; 2.077-2.133
  sum forward f32   32/64/128/226: 1.598/1.590/1.513/1.524;            1.313-1.331
  sum transpose f32 32/64/128/226: 1.602/1.564/1.502/1.536;            1.314-1.343

(the sum keeps its one-block-a-slice design; bfloat16 sums 0.836-0.898
against 0.692-0.720).  GNN32 with ``--hub-cache 128`` (k = 64 / 64 in
float32, 64 / 32 in bfloat16) ran 70.813 ms/epoch against 70.409 without in
float32, 70.299 against 70.104 in bfloat16 (phase 4h, the same run).  At
330,112 nodes (phase 4g, id-based, int32 argmax, K = 8 x 503: the TMA
route) the full script's run read, with the hub against without it at the
rule's K-slice: forward f32 39.008 / 35.823 ms (k = 64), backward f32
79.940 / 70.311 (k = 32), bf16 21.401 / 21.231 and 68.419 / 56.086; on the
mesh's interior shards (phase 4s) the hub kernels ran 32-92% slower at
P = 2 and 4.  So "auto" takes no hub on a shard either.  An explicit k runs
the hub kernels; on a mesh, on each rank's interior pass
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
# Stages of an arena: the max kernels' pipelined hub holds two K-slices'
# rows at once (csrc/row_chunks.cuh: hub_pipeline), the sum's one.
HUB_STAGES = {"max": 2, "sum": 1}


def arena_stride(k_width: int, esize: int) -> int:
    """Elements of one arena row: the hub kernels' K-slice, or K if it is
    narrower."""
    return min(HUB_SLICE_BYTES // esize, int(k_width))


def arena_bytes(k: int, k_width: int, esize: int, arg_size: int = 0) -> int:
    """Shared memory of one stage of k rows: the gathered operand's slice,
    plus the argmax's (``arg_size`` bytes an element; the max backward)."""
    return k * arena_stride(k_width, esize) * (esize + arg_size)


def stage_budget(reduce: str = "max") -> int:
    """Bytes one stage of the ``reduce`` kernels' arena may take: the
    budget shared by its stages."""
    return HUB_SMEM_BYTES // HUB_STAGES[reduce]


def pick_hub_sizes(hub_cache, k_width: int, esize: int, arg_size: int = 2,
                   reduce: str = "max") -> Tuple[int, int]:
    """(k_fwd, k_bwd) for aggregations K = ``k_width`` elements wide of
    ``esize``-byte messages: the forward's arena (max forward, sum) and
    the transpose's (max backward with an ``arg_size``-byte argmax,
    ``spmm_kernels.argmax_bytes`` of the graph that carries the hub; the
    sum's VJP needs less), each halved until a stage fits the ``reduce``
    kernels' ``stage_budget``."""
    if hub_cache in ("off", "0", 0, None, "auto"):  # auto: the hub loses (above)
        return 0, 0
    kf = kb = int(hub_cache)
    if kf < 0:
        raise ValueError(f"hub_cache must be 'auto', 'off' or k >= 0, got {hub_cache!r}")
    budget = stage_budget(reduce)
    while kf and arena_bytes(kf, k_width, esize) > budget:
        kf //= 2
    while kb and arena_bytes(kb, k_width, esize, arg_size) > budget:
        kb //= 2
    return kf, kb
