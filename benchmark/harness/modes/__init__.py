"""The traffic mixes' modes, one module each, found by a mix's ``mode``.

A mode's ``drive(run)`` takes a :class:`harness.runner._Run` (the cell, the
solver, the discretized problem, the seed and the summaries the check
compares) and does the set-up that its traffic needs, then the window,
inside ``with run.window() as t0:``, until ``run.seconds`` have passed. It
marks each accepted step's completion (``run.marks.mark()``), sets
``run.steps``, ``run.attempts``, ``run.inits`` (initializations inside the
window) and ``run.finite``, and leaves in ``run.program`` the outputs that
the configuration's check (:mod:`harness.checks`) compares: ``init``,
``chain``, ``window`` or ``solves``.
"""
