"""PDE problem layer: base class, mixins and the problem recipes."""

from pnmol_tpu_torch.models import examples, mixins, problems

__all__ = ["examples", "mixins", "problems"]
