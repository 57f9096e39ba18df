"""How ``correct`` is decided: the program's first training steps against the
plain reference's, from the same inputs.

Set-up drives the program's training object through a round's first steps,
one ``run`` call each, and keeps what they produced (``program.Snapshot``);
the window then goes on with that same object.  Once the window has closed
and the program is freed, the reference makes the inputs again from the seed
and follows the same steps.  The numbers compared, each against its limit in
``limits/<cell>.json``:

* ``probs_gap``: the largest absolute gap of a probability (every fold, real
  row and class) of the forward before each step's update: the dense layers
  and the aggregations.
* ``loss_gap``: the largest gap of a step's training loss, relative to the
  reference's.
* ``grad_gap``: the first gradient as Adam holds it after step 1
  (``exp_avg / (1 - beta1)``), by the worst fold: ``| |g_prog| - |g_ref| |``
  over ``|g_ref|``, each the norm of every leaf of the fold in one vector.
* ``delta_gap``: the same measure of the fold's change over the steps,
  ``theta_last - theta_0``, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (round-off moves them under Adam).

  Both are taken over the whole fold, not by the worst leaf: by the worst
  leaf, one small leaf's noise set the reading (a bias element whose first
  gradient is cancellation noise; the last layer's weight gradient, a
  330,000-row float32 contraction), up to 10x the other seeds' (PERF.md).
* ``metrics_gap``: the largest absolute gap of the per-epoch metric row
  (AIM/COV/mlACC and loss of both splits, F1, AUC), the reference's row
  worked out from the program's own probabilities of that epoch.

Beside them, with the fixed limit 0 and no reference: ``agg_dtype_off``,
whether the window ran the max aggregations in the configuration's
``agg_dtype`` (``dtype_off``).  A float32 max in place of the bfloat16 one
differs from the bfloat16 reference by about the rounding flips that sound
runs read, so the gaps alone would not see it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .program import Snapshot

NUMBERS = ("probs_gap", "loss_gap", "grad_gap", "delta_gap", "metrics_gap")
QUIET_LEAF = 1e-3
# Numbers with a limit of their own, not read from ``limits/<cell>.json``.
FIXED_LIMITS = {"agg_dtype_off": 0.0}
DTYPE_TAGS = {"float32": "f32", "bfloat16": "bf16"}


def worst(values) -> float:
    """The largest of ``values``, a NaN counting as infinite."""
    return max(v if v == v else float("inf") for v in values)


def fold_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             ref_grad: Optional[Dict[str, torch.Tensor]] = None) -> float:
    """The worst fold's gap of norms over its leaves (see the module
    docstring); with ``ref_grad``, over the leaves that it does not leave
    quiet."""
    keep = {k: torch.ones(v.shape[0], dtype=torch.bool) for k, v in ref.items()}
    if ref_grad is not None:
        norms = {k: v.double().flatten(1).norm(dim=1) for k, v in ref_grad.items()}
        median = float(torch.cat(list(norms.values())).median())
        keep = {k: v >= QUIET_LEAF * median for k, v in norms.items()}

    def fold_norms(tree):
        sq = sum(torch.where(keep[k], v.double().flatten(1).pow(2).sum(1), 0.0)
                 for k, v in tree.items())
        return sq.sqrt()

    p, r = fold_norms(prog), fold_norms(ref)
    return worst(((p - r).abs() / r).tolist())


def readings(snap: Snapshot, ref, ref_rows: List[Dict[str, torch.Tensor]],
             theta0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of one run: ``ref`` the reference's
    ``model.Steps`` over the same steps, ``ref_rows`` the reference's metric
    rows from the program's probabilities, ``theta0`` the initial leaves."""
    probs = worst(float((p - q).abs().max()) for p, q in zip(snap.probs, ref.probs))
    loss = worst(float(((row["train.loss"] - lo.double()).abs() / lo.double().abs()).max())
               for row, lo in zip(snap.rows, ref.loss))
    grad = fold_gap(snap.grad1, ref.grad1)
    delta = fold_gap({k: snap.theta[k] - theta0[k] for k in theta0},
                     {k: ref.theta[k] - theta0[k] for k in theta0}, ref.grad1)
    metrics = worst(float((row[c] - want[c]).abs().max())
                  for row, want in zip(snap.rows, ref_rows) for c in want)
    return {"probs_gap": probs, "loss_gap": loss, "grad_gap": grad, "delta_gap": delta,
            "metrics_gap": metrics}


def dtype_off(stated: str, port: str, launches: Optional[Dict[str, int]]) -> float:
    """``agg_dtype_off``: the share of the window's max-aggregation launches
    (``launches``, the port's counters over the window) whose messages are
    not in the configuration's dtype ``stated``; 1 where the port's
    aggregation dtype at the window's close (``port``) is another, or where a
    configuration that states another dtype than float32 launched no max in
    it.  ``launches`` is None on the CPU, where the port counts nothing."""
    if port != stated:
        return 1.0
    if launches is None:
        return 0.0
    maxes = {k: v for k, v in launches.items() if k.startswith("spmm_max_")}
    total = sum(maxes.values())
    own = sum(v for k, v in maxes.items() if k.endswith("_" + DTYPE_TAGS[stated]))
    if stated != "float32" and own == 0:
        return 1.0
    return (total - own) / total if total else 0.0


def check_limits(limits: Dict[str, dict], cell: str) -> None:
    """Refuse a limits file that lacks a number, that compares none, or whose
    null limit does not come with the lower reading, a null upper reading
    and why: a null limit is only for a number that sound runs read and no
    control or fault reading bounds from above."""
    missing = [n for n in NUMBERS if n not in limits]
    if missing:
        raise ValueError(f"limits/{cell}.json lacks {missing}")
    for name in NUMBERS:
        entry = limits[name]
        if entry["limit"] is None and not (
                isinstance(entry.get("lower"), (int, float)) and "upper" in entry
                and entry["upper"] is None and entry.get("why")):
            raise ValueError(f"limits/{cell}.json: {name}'s null limit needs a numeric "
                             "'lower', an 'upper' of null and a 'why'")
    if all(limits[n]["limit"] is None for n in NUMBERS):
        raise ValueError(f"limits/{cell}.json compares none of {list(NUMBERS)}")


def judge(values: Dict[str, float], limits: Dict[str, dict]) -> Tuple[bool, Dict[str, dict]]:
    """(every compared number within its limit, {name: {"value", "limit"}}).
    A number that is not finite fails.  A number whose limit is null is not
    compared (``check_limits`` says when that may be); ``FIXED_LIMITS``'
    numbers always are."""
    checks = {name: {"value": values[name], "limit": limits[name]["limit"]}
              for name in NUMBERS if limits[name]["limit"] is not None}
    checks.update({name: {"value": values[name], "limit": limit}
                   for name, limit in FIXED_LIMITS.items()})
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
