"""PDE problem layer: base class, mixins and the heat-equation recipe."""

from pnmol_tpu_torch.models import examples, mixins, problems

__all__ = ["examples", "mixins", "problems"]
