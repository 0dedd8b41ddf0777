"""Time-integration layer: PDE-filter solve loops and the white-noise EK1."""

from pnmol_tpu_torch.solvers import latent, pdefilter, white

__all__ = ["latent", "pdefilter", "white"]
