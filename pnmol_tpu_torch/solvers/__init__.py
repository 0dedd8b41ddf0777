"""Time-integration layer: the PDE-filter solve loop and step controller,
the white-noise and the latent-force EK1/EK0 solvers, and RTS smoothing of
their trajectories."""

from pnmol_tpu_torch.solvers import latent, pdefilter, smoothing, white

__all__ = ["latent", "pdefilter", "smoothing", "white"]
