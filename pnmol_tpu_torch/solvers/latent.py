"""Latent-force EK1 solvers: not ported yet (ROADMAP queue 1, item 11)."""


class LinearLatentForceEK1:
    """Not ported yet (ROADMAP queue 1, item 11)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet: the latent-force "
            "solvers are ROADMAP queue 1, item 11"
        )


class SemiLinearLatentForceEK1(LinearLatentForceEK1):
    """Not ported yet (ROADMAP queue 1, item 11)."""
