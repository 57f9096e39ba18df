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
  memory, since a hub block takes a whole SM (as many warps as the SM
  holds of the kernel without the hub).
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

``auto``: 0 in both directions, in float32 and bfloat16, because every hub
kernel measured slower than the kernel without the hub at every k tried.
``chip_smoke.py`` phase 3h, NVIDIA H100 80GB HBM3, 700.00 W, the 24,041-node
graph at the first layer's K, ms with the hub at k = 32 / 64 / 128 / 226
(the backward's largest k halved to fit) against the kernel without it:

  max forward f32   2.348 / 2.351 / 2.331 / 2.435   against 1.896
  max backward f32  3.235 / 3.219 / 3.296 / 3.299   against 2.720
  sum forward f32   1.552 / 1.524 / 1.510 / 1.503   against 1.283
  sum transpose f32 1.564 / 1.533 / 1.513 / 1.543   against 1.289
  max forward bf16  1.525 / 1.557 / 1.651 / 1.880   against 1.396
  max backward bf16 2.292 / 2.304 / 2.436 (k 113)    against 2.091
  sum forward bf16  0.883 / 0.871 / 0.863 / 0.866   against 0.735
  sum transpose bf16 0.834 / 0.827 / 0.820 / 0.817  against 0.688

with as many warps an SM as without the hub in each.  Phase 4g's
330,112-node graph (id-based, K = 8 x 503) is no better: 42.918 against
38.264 ms forward f32, 87.706 against 77.198 backward (on one card the
engine takes no hub past 2^15 nodes anyway: that graph is positional).  An
explicit k runs the hub kernels; on a mesh, on each rank's interior pass
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
    """Shared memory of an arena of k rows: the gathered operand's slice,
    plus the argmax's (``arg_size`` bytes an element; the max backward)."""
    return k * arena_stride(k_width, esize) * (esize + arg_size)


def pick_hub_sizes(hub_cache, k_width: int, esize: int,
                   arg_size: int = 2) -> Tuple[int, int]:
    """(k_fwd, k_bwd) for aggregations K = ``k_width`` elements wide of
    ``esize``-byte messages: the forward's arena (max forward, sum) and
    the transpose's (max backward with an ``arg_size``-byte argmax,
    ``spmm_kernels.argmax_bytes`` of the graph that carries the hub; the
    sum's VJP needs less), each halved until it fits ``HUB_SMEM_BYTES``."""
    if hub_cache in ("off", "0", 0, None, "auto"):  # auto: the hub loses (above)
        return 0, 0
    kf = kb = int(hub_cache)
    if kf < 0:
        raise ValueError(f"hub_cache must be 'auto', 'off' or k >= 0, got {hub_cache!r}")
    while kf and arena_bytes(kf, k_width, esize) > HUB_SMEM_BYTES:
        kf //= 2
    while kb and arena_bytes(kb, k_width, esize, arg_size) > HUB_SMEM_BYTES:
        kb //= 2
    return kf, kb
