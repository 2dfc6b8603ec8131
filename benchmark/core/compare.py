"""The numbers that decide ``correct``, each from the program's readings and
the reference's.

Training (three steps from the same weights, rows and dropout draws):

- ``loss1_gap``: |first step's loss - the reference's| / the reference's.
- ``grad_gap``: |norm of the program's first gradient (as AdamW holds it
  after one step) - the reference's| / the reference's, over all leaves.
- ``change_gap``: the same for the change of all leaves after the third
  step.
- ``grad_leaf_gap``: over the leaves, the largest gap between the
  program's and the reference's norms of a leaf's first gradient, over the
  larger of the reference's norm of that leaf and of the median leaf.
- ``change_leaf_gap``: the same for each leaf's change after the third
  step, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (their change is Adam's round-off
  alone).
- ``grad_median_gap``, ``change_median_gap``: the median of the same
  per-leaf gaps over the leaves that move (a reference gradient above
  nought and at least a thousandth of the median of those), each over the
  larger of the leaf's reference norm and the median of those leaves':
  steady where one leaf's gap is not.
- ``loss_gap``: the largest relative loss gap over the three steps.
- ``top1_gap``: over the rows of the first step, serving's ``top1_gap``
  (below) of the program's top beam (``top1``, or the argmax of
  ``logits1``) against the reference's first-step logits.

A cell's limits file names the numbers it compares; the rest are printed
beside them (PERF.md gives their readings and why).

Serving (requests sampled from the window, rows judged one by one):

- ``top1_gap``: the largest gap by which the reference's logit of the
  served top beam lies below the reference's best, over the standard
  deviation of that row's reference logits.
- ``conf_gap``: the largest |served confidence - the reference's
  probability of the served top beam|.
"""

from __future__ import annotations

import math
import statistics

GRAD_FLOOR = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and of the median leaf."""
    med = statistics.median(ref[k] for k in ref)
    out = []
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def worst_leaves(prog: dict, ref: dict, keys, n: int = 3):
    """The ``n`` leaves with the largest norm gaps: (name, program's norm,
    reference's norm), for the run's diagnostics."""
    med = statistics.median(ref[k] for k in ref)
    rank = sorted(keys, key=lambda k: -abs(prog[k] - ref[k])
                  / max(ref[k], med, 1e-30))
    return [(k, prog[k], ref[k]) for k in rank[:n]]


def _total(norms: dict) -> float:
    return math.sqrt(sum(v * v for v in norms.values()))


def _rel(a: float, b: float) -> float:
    gap = abs(a - b) / abs(b) if b else math.inf
    return gap if math.isfinite(gap) else math.inf


def moving_leaves(grad_norms: dict) -> list:
    """The leaves whose reference gradient is above nought and at least
    ``GRAD_FLOOR`` times the median of those: the others move under AdamW
    by weight decay or round-off alone."""
    nonzero = [k for k, v in grad_norms.items() if v > 0]
    if not nonzero:
        return []
    med = statistics.median(grad_norms[k] for k in nonzero)
    return [k for k in nonzero if grad_norms[k] >= GRAD_FLOOR * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses``, ``grad_norms`` and
    ``change_norms`` (by leaf name); ``top1`` or ``logits1`` of ``prog``
    and ``logits1`` of ``ref`` for ``top1_gap``.  Returns the compared
    numbers and the printed ones."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's")
    gaps = [_rel(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    loss = max(gaps) if len(prog["losses"]) == len(ref["losses"]) \
        else math.inf
    g = ref["grad_norms"]
    moved = moving_leaves(g)
    grad = _leaf_gaps(prog["grad_norms"], g, g)
    change = _leaf_gaps(prog["change_norms"],
                        {k: ref["change_norms"][k] for k in moved}, moved)
    grad_moved = _leaf_gaps(prog["grad_norms"], {k: g[k] for k in moved},
                            moved)
    out = {"loss1_gap": gaps[0] if gaps else math.inf,
           "grad_gap": _rel(_total(prog["grad_norms"]), _total(g)),
           "change_gap": _rel(_total(prog["change_norms"]),
                              _total(ref["change_norms"])),
           "loss_gap": loss,
           "grad_leaf_gap": max(grad),
           "change_leaf_gap": max(change),
           "grad_median_gap": statistics.median(grad_moved),
           "change_median_gap": statistics.median(change)}
    if "logits1" in ref:
        top1 = prog["top1"] if "top1" in prog else \
            [max(range(len(r)), key=r.__getitem__) for r in prog["logits1"]]
        out["top1_gap"] = top1_gap(top1, ref["logits1"][:len(top1)])
    return out


def top1_gap(top1, ref_logits) -> float:
    """The largest gap by which the reference's logit of ``top1`` (rows,
    0-indexed beams) lies below the reference's best, over the standard
    deviation of that row's reference logits."""
    import numpy as np
    r = np.asarray(ref_logits, np.float64)
    gap = (r.max(axis=1) - r[np.arange(len(r)), np.asarray(top1)]) \
        / np.maximum(r.std(axis=1), 1e-30)
    return float(gap.max())


def serve_numbers(served_top1, served_conf, ref_logits) -> dict:
    """``served_top1`` (rows,) 0-indexed beams, ``served_conf`` (rows,),
    ``ref_logits`` (rows, beams) float64 numpy."""
    import numpy as np
    r = np.asarray(ref_logits, np.float64)
    top = np.asarray(served_top1)
    p = np.exp(r - r.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    conf = np.abs(np.asarray(served_conf, np.float64)
                  - p[np.arange(len(top)), top])
    return {"top1_gap": top1_gap(top, r), "conf_gap": float(conf.max())}
