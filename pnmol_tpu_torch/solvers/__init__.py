"""Time-integration layer: the PDE-filter solve loop and step controller,
the white-noise and the latent-force EK1/EK0 solvers."""

from pnmol_tpu_torch.solvers import latent, pdefilter, white

__all__ = ["latent", "pdefilter", "white"]
