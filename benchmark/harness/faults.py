"""Faults planted in the timed path, to show that the check catches them:
the program's step function is wrapped where the solvers look it up, before
the solver binds it at ``initialize``.

* ``state_unchanged``: each step returns the state it was given (its error
  estimate and diffusion still computed, so a controller keeps working);
* ``answer_altered``: each step's new solution is moved at one point by
  ``ALTERATION`` times its largest value.
"""

import contextlib

ALTERATION = 1e-4


def _state_unchanged(step):
    def broken(cache, mean, cov_sqrtm, t_next, dt, **kwargs):
        _, _, error, reference, diffusion = step(cache, mean, cov_sqrtm, t_next, dt, **kwargs)
        return mean, cov_sqrtm, error, reference, diffusion
    return broken


def _answer_altered(step):
    def broken(cache, mean, cov_sqrtm, t_next, dt, **kwargs):
        new_mean, *rest = step(cache, mean, cov_sqrtm, t_next, dt, **kwargs)
        new_mean = new_mean.clone()
        new_mean[0, new_mean.shape[1] // 2] += ALTERATION * new_mean[0].abs().max()
        return (new_mean, *rest)
    return broken


FAULTS = {"state_unchanged": _state_unchanged, "answer_altered": _answer_altered}


@contextlib.contextmanager
def planted(name):
    """The fault ``name`` in the program's white-noise step while the block
    runs; nothing when ``name`` is None."""
    if name is None:
        yield
        return
    from pnmol_tpu_torch.solvers import white

    original = white.white_attempt_step
    white.white_attempt_step = FAULTS[name](original)
    try:
        yield
    finally:
        white.white_attempt_step = original
