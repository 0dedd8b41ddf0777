"""Step-size rules (counterpart of :mod:`pnmol_tpu.odetools.step`).

Only ``Constant`` is ported; the adaptive controller is ROADMAP queue 1,
item 9.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Constant:
    """Fixed step size."""

    dt: float

    def first_dt(self, discretized_pde):
        return self.dt


class Adaptive:
    """Placeholder for the adaptive controller, which is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Adaptive steps are not ported yet (ROADMAP queue 1, item 9)"
        )
