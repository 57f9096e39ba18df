"""What the port recorded about itself in this process: the epoch phases and
the host spans of ``plagnn_tpu_torch/utils/profiling.py`` (``PHASES``,
``SPANS``), which stay after the program is freed.  A port that records
neither gives None."""
from typing import Dict, List, Optional

# A phase row has to add up to its epoch's epoch_ms within this many ms.
ROW_TOLERANCE_MS = 0.01


def _registry(name: str):
    from plagnn_tpu_torch.utils import profiling

    return getattr(profiling, name, None)


def window_phase_rows(ctx) -> Optional[List[Dict[str, float]]]:
    """The phase rows of the untraced window's epochs: the ``len(ctx.epoch_ms)``
    rows before the last ``ctx.traced_epochs``.  None unless each adds up to
    its epoch's ``ctx.epoch_ms``."""
    rows = _registry("PHASES")
    n, traced = len(ctx.epoch_ms), ctx.traced_epochs
    if not rows or n == 0 or len(rows) < n + traced:
        return None
    end = len(rows) - traced
    window = rows[end - n:end]
    if any(abs(sum(row.values()) - ms) > ROW_TOLERANCE_MS
           for row, ms in zip(window, ctx.epoch_ms)):
        return None
    return window


def phase_mean_ms(ctx, phase: str) -> Optional[float]:
    """The mean of ``phase`` over the window's epochs, 0 where an epoch had
    none of it (the AUC off its cadence)."""
    rows = window_phase_rows(ctx)
    if rows is None or any(phase not in row for row in rows):
        return None
    return sum(row[phase] for row in rows) / len(rows)


def span_seconds(name: str, first: bool = False) -> Optional[float]:
    """The host seconds of every call of the span ``name`` in the process, or
    of its first call; None where it never ran."""
    spans = _registry("SPANS")
    stats = spans.get(name) if spans else None
    if stats is None:
        return None
    return stats.first_s if first else stats.total_s
