"""Faults planted in the timed path, to show that the check catches them.

While a fault is planted, every solver class of the program (each
``PDEFilter`` subclass that defines ``_step_function``) hands the solve loop
its bound step wrapped: the ``(mean, cov, t_next, dt) -> (mean, cov, error,
reference, diffusion_sq)`` that ``initialize`` bound, whichever it is (the
graphed attempt, the op-by-op step, the steady mean-only step, a latent
step). The wrapper passes on what the loop reads of the step it wraps
(``failed``, ``unread``, ``raise_failure``), so that a faulted run makes the
host reads of a sound one. Without a fault nothing is wrapped.

* ``state_unchanged``: each step returns the state it was given (its error
  estimate and diffusion still computed, so a controller keeps working);
* ``answer_altered``: each step's new solution is moved at the problem's
  middle grid point by ``ALTERATION`` times its largest value.
"""

import contextlib

ALTERATION = 1e-4


def _state_unchanged(step, d):
    def broken(mean, cov, t_next, dt):
        _, _, error, reference, diffusion = step(mean, cov, t_next, dt)
        return mean, cov, error, reference, diffusion
    return broken


def _answer_altered(step, d):
    def broken(mean, cov, t_next, dt):
        new_mean, *rest = step(mean, cov, t_next, dt)
        new_mean = new_mean.clone()
        new_mean[0, d // 2] += ALTERATION * new_mean[0, :d].abs().max()
        return (new_mean, *rest)
    return broken


FAULTS = {"state_unchanged": _state_unchanged, "answer_altered": _answer_altered}


class _Faulted:
    """A bound step with a fault in its path; every other attribute is the
    wrapped step's."""

    def __init__(self, step, fault, d):
        self._step = step
        self._broken = fault(step, d)

    def __call__(self, mean, cov, t_next, dt):
        return self._broken(mean, cov, t_next, dt)

    def __getattr__(self, name):
        return getattr(self._step, name)


def _solver_classes(base):
    """``base`` and its subclasses, at any depth, each once."""
    classes, todo = {}, [base]
    while todo:
        cls = todo.pop()
        classes[cls] = None
        todo.extend(cls.__subclasses__())
    return list(classes)


@contextlib.contextmanager
def planted(name):
    """The fault ``name`` in the step each solver binds, while the block
    runs; nothing when ``name`` is None."""
    if name is None:
        yield
        return
    fault = FAULTS[name]
    from pnmol_tpu_torch.solvers import pdefilter

    def wrap(original):
        def step_function(self, pde):
            return _Faulted(original(self, pde), fault, pde.L.shape[0])
        return step_function

    patched = [(cls, vars(cls)["_step_function"])
               for cls in _solver_classes(pdefilter.PDEFilter)
               if "_step_function" in vars(cls)
               and not getattr(vars(cls)["_step_function"], "__isabstractmethod__", False)]
    for cls, original in patched:
        cls._step_function = wrap(original)
    try:
        yield
    finally:
        for cls, original in patched:
            cls._step_function = original
