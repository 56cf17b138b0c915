"""The numbers that decide ``correct``, each held against its limit.

Every number is a gap between what the program produced and what the
reference works out again from the same inputs (the benchmark's weights, the
trajectory the environment produced, the raw audio). ``with_limits`` pairs
each with the limit its cell's traffic file states; ``correct`` is that
every number is finite and within its limit. Which numbers a cell
compares is its driver's choice (``drivers/savi_train.savi_numbers``).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def peak_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def still_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    med = statistics.median(norms.values()) if norms else 0.0
    return [n for n, v in norms.items() if v < STILL_LEAF * med]


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], skip=()) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's (over
    the leaves the reference moves)."""
    names = [n for n in want if n not in skip]
    ref = {n: float(want[n].double().norm()) for n in names}
    moved = [v for v in ref.values() if v > 0]
    med = statistics.median(moved) if moved else 0.0
    return [abs((float(got[n].double().norm()) if n in got else 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in names]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def with_limits(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    return [{"name": n, "value": v, "limit": float(limits[n])} for n, v in numbers.items()]


def correct(compared: List[Dict]) -> bool:
    return bool(compared) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared)

