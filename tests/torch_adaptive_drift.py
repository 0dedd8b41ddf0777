"""How far the distributed factorization's CholeskyQR3 panels drift from a
Householder QR along an adaptive trajectory, in the JAX package and in the
port, on the CPU.

The configuration is ``chip_smoke.py``'s adaptive phase: heat 1-D at N=512
(``SquareExponential(0.1 / dx)``), nu=2, the Matern52 + WhiteNoise prior,
``Adaptive()`` to t=0.1, f64. Each package runs ``simulate_final_state`` on
its default (Householder) path and with ``make_distributed_factorization``
on a one-device mesh, and prints the second's final mean, covariance Gram
and diffusion relative to the first. ``chip_smoke.py`` phase K holds the
two-rank run to the one-rank run of the same factorization, which this
script shows the JAX package shares. Run from the repository root (about
four minutes)::

    JAX_PLATFORMS=cpu python tests/torch_adaptive_drift.py
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

N, TMAX = 512, 0.1


def _report(name, base, alt):
    """Relative drift of ``alt`` from ``base``: dicts of numpy arrays."""

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    gram = [c @ c.T for c in (alt["cov"], base["cov"])]
    print(f"{name}: distributed factorization vs Householder QR after "
          f"{alt['n_steps']} steps of {alt['n_attempts']} attempts "
          f"({base['n_steps']} of {base['n_attempts']}): mean rel "
          f"{rel(alt['mean'], base['mean']):.3e}, Gram rel {rel(*gram):.3e}, diffusion rel "
          f"{abs(alt['diff'] / base['diff'] - 1):.3e}", flush=True)


def _final(final, info, to_numpy=np.asarray):
    return dict(mean=to_numpy(final.y.mean), cov=to_numpy(final.y.cov_sqrtm),
                diff=float(final.diffusion_squared_local), n_steps=info["num_steps"],
                n_attempts=info["num_attempted_steps"])


def jax_drift():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pnmol_tpu
    from pnmol_tpu import kernels
    from pnmol_tpu.parallel import meshes, sharded_filter

    dx = 1.0 / (N - 1)
    heat = pnmol_tpu.pde.examples.heat_1d_discretized(
        dx=dx, tmax=TMAX, kernel=kernels.SquareExponential(input_scale=0.1 / dx))

    def run(factorization):
        solver = pnmol_tpu.white.LinearWhiteNoiseEK1(
            steprule=pnmol_tpu.odetools.step.Adaptive(), num_derivatives=2,
            spatial_kernel=kernels.Matern52() + kernels.WhiteNoise(),
            factorization=factorization)
        return _final(*solver.simulate_final_state(heat))

    base = run(None)
    alt = run(sharded_filter.make_distributed_factorization(mesh=meshes.make_mesh(1, batch=1)))
    _report("JAX package", base, alt)


def port_drift():
    import torch

    import pnmol_tpu_torch as pt
    from pnmol_tpu_torch.parallel import meshes, sharded_filter

    dx = 1.0 / (N - 1)
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=TMAX, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device="cpu")

    def run(factorization):
        solver = pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Adaptive(), num_derivatives=2,
            spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
            factorization=factorization)
        return _final(*solver.simulate_final_state(heat), to_numpy=lambda x: x.numpy())

    torch.set_num_threads(4)
    base = run(None)
    alt = run(sharded_filter.make_distributed_factorization(mesh=meshes.make_mesh()))
    _report("port", base, alt)


if __name__ == "__main__":
    jax_drift()
    port_drift()
