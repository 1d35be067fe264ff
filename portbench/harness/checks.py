"""The comparison that decides ``correct``: the first training steps of the
program against the plain reference's.

* ``loss_gap_first``: ``|loss_program - loss_reference|`` of the first
  step over the reference's mean magnitude of the loss's per-row terms
  (the loss itself where every term is positive, as a cross-entropy
  against one-hot targets is; against soft targets the loss can come near
  0, and its rounding cannot).  The first step alone: AdamW moves every
  weight by about its rate whatever the gradient's size, so a gradient
  element within rounding of 0 steps either way, and the later steps'
  losses and changes swing with that on some seeds.
* ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment after one step over ``1 - beta1``), by the worst leaf: the
  gap between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf.
* ``change_gap``: each parameter's change after the steps, by the worst
  leaf in the same way, over the leaves whose first reference gradient is
  at least a thousandth of the median leaf's (a leaf the loss does not
  reach moves by weight decay and round-off alone).
* ``change_gap_matrices``: the same over the leaves of at least
  ``MATRIX`` elements.  A small leaf's norm gap is first order in its
  rounding errors, of either sign; a large leaf's is first order only in
  their projection on the change and second order (``|e|^2 / 2|g|``, of
  one sign) in the rest, so it grows as the square of the precision's
  step and swings little from seed to seed.

A cell's ``cells/<cell>.json`` names the numbers it compares and their
limits.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NAMES = ("loss_gap_first", "grad_gap", "change_gap", "change_gap_matrices")
MOVED = 1e-3
MATRIX = 1 << 16


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names
               ) -> List[Tuple[float, str]]:
    floor = statistics.median(ref[k] for k in names)
    gaps = [(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30), k)
            for k in names]
    return [(g if math.isfinite(g) else math.inf, k) for g, k in gaps]


def gaps(prog, ref) -> Dict[str, Tuple[float, str]]:
    """``{name: (value, where)}`` for the numbers; ``prog`` and ``ref`` are
    ``reference.gn.Readings``."""
    loss = abs(prog.losses[0] - ref.losses[0]) / max(ref.loss_scales[0],
                                                     1e-30)
    names = list(prog.grad_norms)
    g_floor = statistics.median(ref.grad_norms[k] for k in names)
    moved = [k for k in names if ref.grad_norms[k] >= MOVED * g_floor]
    change = _leaf_gaps(prog.change_norms, ref.change_norms, moved)
    large = [c for c in change if ref.sizes[c[1]] >= MATRIX]
    return {"loss_gap_first": (loss if math.isfinite(loss) else math.inf,
                               "step 1"),
            "grad_gap": max(_leaf_gaps(prog.grad_norms, ref.grad_norms,
                                       names)),
            "change_gap": max(change),
            "change_gap_matrices": max(large or [(0.0, "none")])}


def judge(found: Dict[str, Tuple[float, str]], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Whether every number that ``limits`` names is within its limit,
    and those numbers with their limits, as the result line carries
    them."""
    checks = {k: {"value": found[k][0], "limit": limits[k]} for k in NAMES
              if k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
