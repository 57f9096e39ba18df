"""Mesh planner: the (fold, graph) factorization for D cards.

Port of ``plagnn_tpu/parallel/planner.py``.  The two mesh axes compose
(``parallel/sharded.py``):

* 'graph': P ranks split the graph by destination blocks and exchange halo
  rows once per layer.  It pays link bytes; the model projects its
  efficiency from the measured single-card rate and the partition's exact
  halo counts.
* 'fold': F groups split the fold batch.  It pays no bytes, but it narrows
  each card's fold batch (the kernels' rate by fold batch is measured, not
  flat) and can leave job slots empty when the run's jobs do not fill F x b.

``plan_mesh`` scores every factorization D = F x P with every feasible
local fold batch and returns the best with the whole table.  The model is
the JAX package's, unchanged: per layer max(interior pass, halo bytes over
the link) + boundary pass on the busiest rank, a structure tax on every
P > 1 candidate, an HBM bound on the local fold batch.  Two things differ
by design: the per-layer stride is the port's K = b x f (its fold-batched
rows carry no lane padding; ``STRIDE_ALIGN``), and the link is the card's
(``LINK_EGRESS``).  The rates are those of the max kernels without the hub
cache, which ``auto`` resolves to (``ops/hub.py``); a run with an explicit
``--hub-cache k`` takes the hub on each rank's interior pass, which the
model does not price.

Anchors: the measured numbers the model runs on (bf16 max forward +
backward rate by fold batch, the structure tax, the HBM fold ceiling at
24,041 nodes).  ``load_anchors`` reads them from an explicit path, else
``$PLAGNN_TORCH_ANCHORS``, else the baked constants below; the port never
reads the JAX package's anchors file or its ``$PLAGNN_ANCHORS``.
``chip_smoke.py`` phase 4q measures them on the card and writes the file
with ``write_anchors``.

``counts_2d`` models a 2-D (source x destination) grid partition that no
runner implements: candidates only, to judge whether it would be worth one.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .partition import snake_rows as _snake_rows

# Measured bf16 max forward (with argmax) + backward rate, edge-folds/s
# (E x B over the two kernels' time), at layer 1's K = B x 503 on the
# synthetic PPI (24,041 nodes, 724,041 edges with self-loops): chip_smoke.py
# --only-planner (phase 4q), median of 10 launches each by CUDA events, on
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi's name and power limit).
MEASURED_BF16_RATES: Dict[int, float] = {
    10: 2.0577e9,
    16: 2.3325e9,
    20: 2.2804e9,
    24: 2.2829e9,
    28: 2.2802e9,
    32: 2.3637e9,
    48: 2.3733e9,
    64: 2.4502e9,
}
# Rates past the largest measured fold batch are not extrapolated.
MAX_MEASURED_B = max(MEASURED_BF16_RATES)

# The largest fold batch whose GNN32 training epoch fits the card at the
# full 24,041-node graph, in both message dtypes (the same run: the peak
# reserve of one epoch at B = 10 and 20, 6.39 and 11.82 GiB in float32, its
# per-fold slope against the 78.27 GiB the allocator can reach, one float32
# epoch at B = 142 peaking at 76.68 GiB).  The working set scales with nodes
# x fold batch, so a graph partition raises it and a bigger graph lowers it.
HBM_FOLD_CEILING_FULL_GRAPH = 142
HBM_REF_NODES = 24041

# The sharded runner's ms/epoch on a graph axis of size 1 (a NCCL group of
# one rank) over the single-card runner's at B = 10, the median of 4 steady
# epochs each (the same run: 68.997 against 68.943 ms).  Applied to every
# P > 1 candidate.
SHARD_STRUCTURE_TAX = 1.0008

# Per-card link egress, one way, bytes/s.  Nominal, from NVIDIA's H100
# datasheet, not measured: SXM's NVLink 4 (18 links, 900 GB/s both ways),
# PCIe Gen5 x16.  No multi-card machine has checked them.
LINK_EGRESS = {"h100-sxm": 450e9, "h100-pcie": 64e9}

# Row stride of a layer's fold-batched rows, in elements, is b x f rounded up
# to this alignment: the port's rows carry no padding.
STRIDE_ALIGN = {"bfloat16": 1, "float32": 1}

F_DIM = 503
HIDDEN = (400, 300, 200)

ANCHORS_ENV = "PLAGNN_TORCH_ANCHORS"


def load_anchors(path: Optional[str] = None) -> Dict:
    """Resolve the planner's anchors: explicit ``path`` -> $PLAGNN_TORCH_ANCHORS
    -> the baked constants.

    Returns {"rates": {b: edge_folds_per_s}, "tax": float, "hbm_ceiling":
    int, "max_b": int, "source": str}.  A malformed or missing file, an empty
    or non-positive rate table or a tax below 1 falls through to the next
    source, so a stale file never crashes a plan.  ``path="baked"`` pins the
    baked constants."""
    if path == "baked":
        sources = ()
    else:
        sources = (path, os.environ.get(ANCHORS_ENV))
    for p in sources:
        if not p:
            continue
        try:
            with open(p) as f:
                raw = json.load(f)
            rates = {int(k): float(v) for k, v in raw["bf16_rates"].items()}
            if not rates or any(v <= 0 for v in rates.values()):
                raise ValueError("non-positive rate")
            tax = float(raw.get("structure_tax", SHARD_STRUCTURE_TAX))
            if tax < 1.0:
                raise ValueError("structure_tax < 1")
            ceiling = int(raw.get("hbm_fold_ceiling_full_graph",
                                  HBM_FOLD_CEILING_FULL_GRAPH))
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError, AttributeError):
            continue
        return {"rates": rates, "tax": tax, "hbm_ceiling": ceiling,
                "max_b": max(rates), "source": p}
    return {"rates": dict(MEASURED_BF16_RATES), "tax": SHARD_STRUCTURE_TAX,
            "hbm_ceiling": HBM_FOLD_CEILING_FULL_GRAPH,
            "max_b": MAX_MEASURED_B, "source": "baked"}


def write_anchors(fields: dict, writer: str, path: str) -> str:
    """Merge ``fields`` into the anchors file at ``path`` (nested dicts merge
    per key, so a partial sweep refreshes only the fold batches it
    measured; other keys are kept) and stamp each field's provenance with
    ``writer`` and the time.  Schema: ``bf16_rates`` {fold batch: edge-folds/s},
    ``structure_tax`` (>= 1), ``hbm_fold_ceiling_full_graph`` (int),
    ``provenance`` {field: writer @ time}."""
    data = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            data = {}
    for k, v in fields.items():
        if isinstance(v, dict) and isinstance(data.get(k), dict):
            data[k].update(v)
        else:
            data[k] = v
    prov = data.setdefault("provenance", {})
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    for k in fields:
        prov[k] = f"{writer} @ {stamp}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    return path


def rate_single_chip(b: int, rates: Optional[Dict[int, float]] = None) -> float:
    """Interpolated measured single-card rate (edge-folds/s) at fold batch b:
    linear between anchors, proportional to b below the smallest (a per-edge
    floor the folds amortize), flat past the largest."""
    rates = rates or MEASURED_BF16_RATES
    bs = sorted(rates)
    if b <= bs[0]:
        return rates[bs[0]] * b / bs[0]
    if b >= bs[-1]:
        return rates[bs[-1]]
    hi = next(x for x in bs if x >= b)
    lo = bs[bs.index(hi) - 1]
    t = (b - lo) / (hi - lo)
    return rates[lo] * (1 - t) + rates[hi] * t


def _packed_stride(b: int, f: int, align: int) -> int:
    n = b * f
    return ((n + align - 1) // align) * align


def counts_1d(src: np.ndarray, dst: np.ndarray, n_real: int, p: int,
              balanced: bool = True) -> Dict[str, np.ndarray]:
    """Halo accounting of the P-way destination-block partition (the
    blocks of ``partition.partition_graph``, C = ceil(n / P) rows each)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    c = -(-n_real // p)
    if balanced and p > 1:
        deg = np.bincount(dst, minlength=n_real).astype(np.int64)
        node_row = _snake_rows(deg, p, c)
        src, dst = node_row[src], node_row[dst]
    owner_dst = dst // c
    owner_src = src // c
    cross = owner_src != owner_dst
    edges_per_chip = np.bincount(owner_dst, minlength=p)
    boundary = np.bincount(owner_dst[cross], minlength=p)
    recv_pairs = np.unique(
        np.stack([owner_dst[cross], src[cross]], axis=1), axis=0)
    recv_rows = np.bincount(recv_pairs[:, 0], minlength=p)
    send_trip = np.unique(np.stack(
        [owner_src[cross], owner_dst[cross], src[cross]], axis=1), axis=0)
    send_rows = np.bincount(send_trip[:, 0], minlength=p)
    return {
        "own_rows": c,
        "edges_per_chip": edges_per_chip,
        "interior_per_chip": edges_per_chip - boundary,
        "boundary_per_chip": boundary,
        "halo_recv_rows": recv_rows,
        "halo_send_rows": send_rows,
    }


def counts_2d(src: np.ndarray, dst: np.ndarray, n_real: int,
              pr: int, pc: int, balanced: bool = True) -> Dict[str, np.ndarray]:
    """Comm accounting of a 2-D (source x destination) edge partition.

    Grid pr x pc: card (i, j) owns the edges from source super-block j to
    destination super-block i; features stay one block a card (row-major
    over the grid).  Per layer, forward: a column gather (the distinct
    source rows a card's edges touch, from their feature owners) and a row
    reduce (partial maxima sent to each destination row's owner).  The
    caller counts the backward's transpose.  Balancing deals nodes by total
    degree over the finer grid axis.  Per-card arrays of shape (pr*pc,)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    p = pr * pc
    c_dst = -(-n_real // pr)     # dst super-block rows
    c_src = -(-n_real // pc)     # src super-block rows
    if balanced and p > 1:
        deg = (np.bincount(dst, minlength=n_real)
               + np.bincount(src, minlength=n_real)).astype(np.int64)
        node_row = _snake_rows(deg, max(pr, pc), -(-n_real // max(pr, pc)))
        order = np.argsort(node_row)   # row -> node rank
        rank = np.empty(n_real, np.int64)
        rank[order] = np.arange(n_real)
        src, dst = rank[src], rank[dst]
    bi = dst // c_dst            # grid row of each edge
    bj = src // c_src            # grid column of each edge
    chip = bi * pc + bj
    edges_per_chip = np.bincount(chip, minlength=p)

    # column gather: distinct (card, src) pairs whose row another card owns
    own_block = -(-n_real // p)
    feat_owner_src = src // own_block
    pairs = np.unique(np.stack([chip, src], axis=1), axis=0)
    pair_owner = pairs[:, 1] // own_block
    gather_recv = np.bincount(
        pairs[pair_owner != pairs[:, 0], 0], minlength=p)
    send_pairs = pairs[pair_owner != pairs[:, 0]]
    gather_send = np.bincount(send_pairs[:, 1] // own_block, minlength=p)

    # row reduce: distinct (card, dst) partial rows owned by another card
    rpairs = np.unique(np.stack([chip, dst], axis=1), axis=0)
    rowner = rpairs[:, 1] // own_block
    reduce_send = np.bincount(rpairs[rowner != rpairs[:, 0], 0], minlength=p)
    reduce_recv = np.bincount(rowner[rowner != rpairs[:, 0]], minlength=p)

    return {
        "own_rows": own_block,
        "edges_per_chip": edges_per_chip,
        # interior / boundary: edges whose source the card owns / does not
        "interior_per_chip": np.bincount(
            chip[feat_owner_src == chip], minlength=p),
        "boundary_per_chip": np.bincount(
            chip[feat_owner_src != chip], minlength=p),
        "halo_recv_rows": gather_recv + reduce_recv,
        "halo_send_rows": gather_send + reduce_send,
    }


@dataclasses.dataclass
class Candidate:
    mesh_fold: int
    mesh_graph: int
    b_local: int
    fold_batch: int              # global fold batch per chunk (F * b_local)
    scheme: str                  # '1d' | '2d:RxC'
    eff_graph: float             # graph-axis efficiency (overlap model)
    utilization: float           # job-slot fill over the whole run
    efficiency: float            # vs D x the best single card (the score;
                                 # > 1 where the single card is HBM-bound)
    eff_vs_plateau: float        # vs D x the rate at the largest measured b
    edge_folds_per_s: float      # modeled mesh throughput
    halo_mb_per_step: float


@dataclasses.dataclass
class MeshPlan:
    n_devices: int
    chosen: Candidate
    table: List[Candidate]
    b_single: int = HBM_FOLD_CEILING_FULL_GRAPH  # single-card baseline batch
    b_min_measured: int = min(MEASURED_BF16_RATES)
    anchors_source: str = "baked"  # which anchor source scored this plan

    def summary(self) -> str:
        note = ""
        if self.b_single < self.b_min_measured:
            note = (f" [single-card baseline HBM-limited to "
                    f"b={self.b_single}]")
        lines = [
            f"mesh planner: D={self.n_devices} -> fold={self.chosen.mesh_fold}"
            f" x graph={self.chosen.mesh_graph} (b_local="
            f"{self.chosen.b_local}, fold_batch={self.chosen.fold_batch}, "
            f"modeled efficiency {self.chosen.efficiency:.3f}){note}",
            f"  anchors: {self.anchors_source}",
            "  F xP   scheme b_loc  eff_graph  util   eff   eff_plat"
            "  Medge-folds/s",
        ]
        for c in self.table:
            mark = " *" if c is self.chosen else "  "
            lines.append(
                f"{mark}{c.mesh_fold:>2}x{c.mesh_graph:<3} {c.scheme:>6} "
                f"{c.b_local:>5}  {c.eff_graph:>8.3f}  {c.utilization:>5.3f} "
                f"{c.efficiency:>6.3f}  {c.eff_vs_plateau:>6.3f} "
                f"{c.edge_folds_per_s / 1e6:>9.1f}"
            )
        return "\n".join(lines)


def _graph_axis_model(
    cts: Dict[str, np.ndarray], e_tot: int, b: int, *,
    agg_dtype: str = "bfloat16", part: str = "h100-sxm",
    layer_widths: Sequence[int] = (F_DIM, HIDDEN[0], HIDDEN[1]),
    rates: Optional[Dict[int, float]] = None,
) -> Tuple[float, float]:
    """(efficiency, halo MB per step) of a graph partition at local fold
    batch b: the per-edge time from the measured rate at b, scaled per layer
    by the stride ratio; the halo egress-bound on the busiest card; the
    interior pass overlapping the exchange, the boundary pass after it; the
    step waits for the worst card."""
    dt_bytes = 2 if agg_dtype == "bfloat16" else 4
    align = STRIDE_ALIGN[agg_dtype]
    egress = LINK_EGRESS[part]
    strides = [_packed_stride(b, f, align) for f in layer_widths]
    tau_ref = 1.0 / rate_single_chip(b, rates)
    taus = [tau_ref * s / strides[0] for s in strides]
    t1 = e_tot * b * sum(taus)
    p = len(cts["edges_per_chip"])
    if p == 1:
        return 1.0, 0.0
    t_step = 0.0
    halo_mb = 0.0
    for s_l, tau in zip(strides, taus):
        t_int = cts["interior_per_chip"].max() * b * tau
        t_bnd = cts["boundary_per_chip"].max() * b * tau
        row_bytes = s_l * dt_bytes
        comm_bytes = 2 * row_bytes * max(
            cts["halo_send_rows"].max(), cts["halo_recv_rows"].max())
        halo_mb += comm_bytes / 1e6
        t_step += max(t_int, comm_bytes / egress) + t_bnd
    return t1 / (p * t_step), halo_mb


def _factorizations(d: int):
    return [(f, d // f) for f in range(1, d + 1) if d % f == 0]


def _square_grids(p: int):
    """(pr, pc) grids of the 2-D scheme, closest to square first."""
    outs = []
    for pr in range(2, p):
        if p % pr == 0 and p // pr >= 2:
            outs.append((pr, p // pr))
    outs.sort(key=lambda rc: abs(rc[0] - rc[1]))
    return outs


def plan_mesh(
    n_devices: int,
    src: np.ndarray,
    dst: np.ndarray,
    n_real: int,
    *,
    total_jobs: int = 100,
    agg_dtype: str = "bfloat16",
    part: str = "h100-sxm",
    include_2d: bool = False,
    b_candidates: Sequence[int] = (10, 16, 20, 24, 30),
    anchors_path: Optional[str] = None,
    hbm_node_folds: Optional[int] = None,
) -> MeshPlan:
    """Score every (fold, graph) factorization of ``n_devices`` and pick the
    best.  ``total_jobs`` is the run's fold-job count (rounds x folds); the
    slots a last chunk cannot fill count against a candidate.  ``part``
    names the link (``LINK_EGRESS``).  ``hbm_node_folds`` bounds nodes per
    card x local fold batch (default: the anchors' ceiling x 24,041).
    ``include_2d`` adds 2-D grid candidates at the pure-graph
    factorizations (model only: never chosen)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    e_tot = len(src)
    anc = load_anchors(anchors_path)
    rates, tax = anc["rates"], anc["tax"]
    budget = hbm_node_folds or anc["hbm_ceiling"] * HBM_REF_NODES
    b_hbm_1 = max(int(budget / n_real), 1)
    best_single = max(
        rate_single_chip(min(b, b_hbm_1), rates) for b in b_candidates)

    table: List[Candidate] = []
    for f, p in _factorizations(n_devices):
        # the HBM bound per card; no rate past the largest measured b
        b_max = min(max(b_hbm_1 * p, 1), anc["max_b"])
        schemes = [("1d", None)]
        if include_2d and f == 1:
            schemes += [(f"2d:{pr}x{pc}", (pr, pc))
                        for pr, pc in _square_grids(p)]
        for scheme, grid in schemes:
            if grid is None:
                cts = counts_1d(src, dst, n_real, p, balanced=True)
            else:
                cts = counts_2d(src, dst, n_real, *grid, balanced=True)

            def t_epoch(b):
                """(seconds per epoch at local fold batch b, eff_graph, halo
                MB): the group runs at P x eff_graph x the single-card rate,
                less the structure tax where the graph is sharded."""
                eff_g, halo_mb = _graph_axis_model(
                    cts, e_tot, b, agg_dtype=agg_dtype, part=part,
                    rates=rates)
                t = tax if p > 1 else 1.0
                return (t * e_tot * b / (p * eff_g * rate_single_chip(b, rates)),
                        eff_g, halo_mb)

            for b in sorted({min(b, b_max) for b in b_candidates}):
                t_b, eff_g, halo_mb = t_epoch(b)
                # the engine's chunks: full chunks of F x b jobs at width b,
                # a last partial chunk padded to a multiple of F at its own
                # width
                slots = f * b
                n_full, r = divmod(total_jobs, slots)
                t_total = n_full * t_b
                computed = n_full * slots
                if r:
                    b_tail = -(-r // f)
                    t_total += t_epoch(b_tail)[0]
                    computed += f * b_tail
                util = total_jobs / computed
                rate = total_jobs * e_tot / t_total
                eff = rate / (n_devices * best_single)
                table.append(Candidate(
                    mesh_fold=f, mesh_graph=p, b_local=b,
                    fold_batch=f * b, scheme=scheme,
                    eff_graph=round(eff_g, 4), utilization=round(util, 4),
                    efficiency=round(eff, 4),
                    eff_vs_plateau=round(rate / (
                        n_devices * rate_single_chip(anc["max_b"], rates)), 4),
                    edge_folds_per_s=rate, halo_mb_per_step=round(halo_mb, 1),
                ))
    # deterministic pick: efficiency, then fewer graph ranks, then larger b
    impl = [c for c in table if c.scheme == "1d"]
    chosen = max(impl, key=lambda c: (c.efficiency, -c.mesh_graph, c.b_local))
    return MeshPlan(n_devices=n_devices, chosen=chosen, table=table,
                    b_single=min(b_hbm_1, anc["max_b"]),
                    b_min_measured=min(rates),
                    anchors_source=anc["source"])
