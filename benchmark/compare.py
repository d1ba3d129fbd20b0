"""The numbers that decide ``correct`` for a training cell, from the
program's readings and the reference's over the same first updates:

- ``loss``: the widest relative gap of a micro-step's loss;
- ``grad1``: the first update's gradient, leaf by leaf, as the optimizer got
  it; the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  the worst leaf;
- ``change``: the same for each adapter leaf's change after the updates
  followed.

Leaves whose reference gradient is under a thousandth of the median leaf's
are nought to rounding (``lora_a`` in the first update, while every
``lora_b`` is still zero) and are left out by that rule, never by name.
"""

from __future__ import annotations

import statistics

NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's is rounding


def _worst(prog: dict, ref: dict, names) -> float:
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med) for n in names)


def counted(grads: dict) -> list:
    """The leaves whose gradient norm is at least :data:`NOUGHT` of the
    median leaf's."""
    med = statistics.median(grads.values())
    return [n for n, g in grads.items() if g > 0 and g >= NOUGHT * med]


def readings(prog: dict, ref: dict) -> dict:
    """``loss``, ``grad1`` and ``change`` (module docstring). ``prog`` holds
    ``losses`` (a list), ``grad1`` and ``change`` (name → norm); ``ref`` is
    ``reference.train_lm.follow``'s result."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program losses against {len(ref['losses'])} of the reference")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    first = ref["grads"][0]
    moved = set().union(*(counted(g) for g in ref["grads"]))
    return {"loss": loss, "grad1": _worst(prog["grad1"], first, counted(first)),
            "change": _worst(prog["change"], ref["change"], sorted(moved))}


def checks(values: dict, limits: dict) -> list:
    """[{name, value, limit}] in the limits' order; NaN counts as over."""
    out = []
    for name, limit in limits.items():
        v = values[name]
        out.append({"name": name, "value": v if v == v else float("inf"), "limit": limit})
    return out
