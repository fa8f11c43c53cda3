"""The numbers a check compares, and the verdict.

A training check compares by the worst leaf: for each parameter leaf the
gap between the program's norm and the reference's (not the norm of their
difference), measured against the reference's norm of that leaf or of the
median leaf, whichever is larger.  Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone under
Adam and are left out of the change.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch

STILL_LEAF = 1e-3          # a leaf's first gradient under this share of the median leaf's


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               keep: Optional[Iterable[str]] = None) -> float:
    """max over leaves of |‖p‖ − ‖r‖| / max(‖r‖, median leaf ‖r‖)."""
    names = sorted(reference if keep is None else keep)
    med = statistics.median(reference[n] for n in names)
    return max(abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names)


def worst_leaf_difference(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]
                          ) -> float:
    """max over leaves of ‖p − r‖ / max(‖r‖, median leaf ‖r‖): sees a
    gradient that points elsewhere with the same norm (a step over part of
    its batch), which the gap of norms does not."""
    norms = leaf_norms(reference)
    med = statistics.median(norms.values())
    return max(float((program[n].double() - reference[n].double()).norm()) / max(norms[n], med, 1e-30)
               for n in reference)


def moving_leaves(first_grad_norms: Dict[str, float]) -> list:
    med = statistics.median(first_grad_norms.values())
    return [n for n, v in first_grad_norms.items() if v >= STILL_LEAF * med]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers that have a
    limit; a number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        rows.append((name, value, limit))
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, rows
