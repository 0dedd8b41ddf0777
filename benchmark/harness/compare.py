"""The check that decides ``correct``: the program's outputs against the plain
reference (:mod:`reference`), recomputed from the same inputs.

A configuration names its check (``"check"``): the module
``harness/checks/<check>.py``, whose ``check(cell, program, seed, device,
nums)`` fills ``nums`` with gaps between the program and the reference.
Each number has its limit in the cell's settings (``workloads/<cell>.json``);
a limit whose number the check could not read (the program stopped before
producing it) reads NaN and is not met. This module holds what every check
shares: the gaps, the covariance scaling and the verdict.
"""

import importlib
import math

from reference import prior


def relative(a, b):
    return float((a - b).abs().max() / b.abs().max())


def mean_gaps(mean, ref):
    """``(u gap, worst derivative's gap)``, each over its own largest entry."""
    gaps = [relative(mean[i], ref[i]) for i in range(ref.shape[0])]
    return gaps[0], max(gaps)


def gram_gap(sketch, ref, n, d):
    return max(float((sketch[i * d:(i + 1) * d] - ref[i * d:(i + 1) * d]).norm()
                     / ref[i * d:(i + 1) * d].norm()) for i in range(n))


class Numbers(dict):
    def worst(self, name, value):
        value = float(value)
        old = self.get(name, 0.0)
        self[name] = value if (math.isnan(value) or value > old) else old


def scaling(nu, dt, d, device):
    """The inverse Nordsieck scales of step ``dt``, one a state row (D,):
    the scaling ``S`` under which the covariances are compared."""
    return (1.0 / prior.nordsieck(nu, dt)).repeat_interleave(d).to(device)


def check(cell, program, seed, device):
    """The numbers of one run: ``{name: value}``, by the configuration's
    check. ``program`` holds the program's outputs on the host (see
    :func:`harness.runner.run`)."""
    nums = Numbers()
    module = importlib.import_module(f"harness.checks.{cell.config['check']}")
    module.check(cell, program, seed, device, nums)
    for name in cell.settings.get("limits", {}):
        nums.setdefault(name, math.nan)
    return nums


def verdict(nums, limits):
    """``(correct, {name: {"value", "limit"}})``: correct where every number
    has a limit and none is above it."""
    table, ok = {}, True
    for name, value in nums.items():
        limit = limits.get(name)
        passed = limit is not None and not math.isnan(value) and value <= limit
        ok = ok and passed
        table[name] = {"value": value, "limit": limit}
    return ok, table
