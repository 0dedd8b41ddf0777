"""How far the sharded steady tier's frozen blocks sit from the single-device
steady mode's at phase E's point, in the JAX package and in the port, on
the CPU.

The configuration is ``chip_smoke.py``'s phases E and E2: heat 1-D at
N=512 (``SquareExponential(0.1 / dx)``), nu=2, the Matern52 + WhiteNoise
prior, ``Constant(1e-2)``, f64, the doubling seed and 4 polish iterations.
Each package converges the single-device steady mode and the sharded one on
two ranks (JAX: a 2-device mesh; the port: two gloo ranks), and prints the
sharded blocks against the single-device ones: the Gram of ``cov_inf``, the
cross covariance ``S_xz = L21 Sl^T``, the gain ``K = L21 Sl^-1`` (with its
excess over the tolerances of ``tests/test_parallel.py``'s seeded test,
rtol 5e-3 and atol 1e-4), and the mean after 512 frozen steps from the
initial state. ``chip_smoke.py`` holds the sharded caches of phases E2 and
N to the single-device ones through the Gram and the frozen trajectory, and
prints the gain. Run from the repository root (about five minutes)::

    JAX_PLATFORMS=cpu python tests/torch_steady_gain_spread.py
"""

import os
import pathlib
import sys

import numpy as np

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

N, NU, DT, STEPS = 512, 2, 1e-2, 512
RTOL, ATOL = 5e-3, 1e-4


def _report(name, base, alt, trajectory):
    """``base`` and ``alt``: dicts of numpy blocks; ``trajectory(blocks)``
    the mean after STEPS frozen steps."""

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    gram = [b["cov_inf"] @ b["cov_inf"].T for b in (alt, base)]
    sxz = [b["L21"] @ b["Sl"].T for b in (alt, base)]
    gain = [b["L21"] @ b["Sl_inv"] for b in (alt, base)]
    excess = float((np.abs(gain[0] - gain[1]) - ATOL - RTOL * np.abs(gain[1])).max())
    print(f"{name}: sharded (2 ranks) vs single device: cov_inf Gram rel {rel(*gram):.3e}, "
          f"S_xz rel {rel(*sxz):.3e}, gain rel {rel(*gain):.3e} (max |K| "
          f"{np.abs(gain[1]).max():.4e}; excess over rtol {RTOL:g}, atol {ATOL:g}: "
          f"{excess:.4e}); mean after {STEPS} frozen steps rel "
          f"{rel(trajectory(alt), trajectory(base)):.3e}", flush=True)


def _blocks(steady, to_numpy=np.asarray):
    return {name: to_numpy(getattr(steady, name))
            for name in ("cov_inf", "L21", "Sl", "Sl_inv", "err_vec")}


def jax_spread():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import pnmol_tpu
    from pnmol_tpu import kernels
    from pnmol_tpu.parallel import meshes, sharded_filter
    from pnmol_tpu.solvers import white

    dx = 1.0 / (N - 1)
    heat = pnmol_tpu.pde.examples.heat_1d_discretized(
        dx=dx, tmax=1.0, kernel=kernels.SquareExponential(input_scale=0.1 / dx))

    def solver(**kw):
        return white.LinearWhiteNoiseEK1(
            steprule=pnmol_tpu.odetools.step.Constant(DT), num_derivatives=NU,
            spatial_kernel=kernels.Matern52() + kernels.WhiteNoise(), **kw)

    steady = solver(steady_state=True)
    steady.initialize(heat)
    plain = solver()
    state = plain.initialize(heat)
    mesh = meshes.make_mesh(2, batch=1)
    sharded = sharded_filter.converge_space_sharded_steady_state(
        cache=sharded_filter.shard_cache(plain._cache, mesh, distributed_qr=True),
        cov0=state.y.cov_sqrtm, dt=DT, num_derivatives=NU, mesh=mesh, max_iters=4)

    def trajectory(blocks):
        frozen = steady.steady_cache._replace(**{k: jnp.asarray(v) for k, v in blocks.items()})
        step = white.make_steady_state_white_step(cache=plain._cache, steady=frozen,
                                                  num_derivatives=NU)
        mean = state.y.mean
        for k in range(1, STEPS + 1):
            mean = step(mean, None, k * DT, jnp.asarray(DT))[0]
        return np.asarray(mean)

    _report("JAX package", _blocks(steady.steady_cache), _blocks(sharded), trajectory)


def port_spread():
    import torch

    import pnmol_tpu_torch as pt
    import torch_parallel_ranks
    from pnmol_tpu_torch.parallel import distributed

    torch.set_num_threads(4)
    dx = 1.0 / (N - 1)
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=1.0, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device="cpu")
    steady = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(DT), num_derivatives=NU,
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(), steady_state=True)
    state = steady.initialize(heat)
    (alt, _), _ = distributed.spawn_ranks(torch_parallel_ranks.steady_spread_rank, 2,
                                          backend="gloo", device="cpu",
                                          payload=dict(N=N, nu=NU, dt=DT), timeout=3000)

    def trajectory(blocks):
        frozen = steady.steady_cache._replace(**{k: torch.tensor(v) for k, v in blocks.items()})
        step = pt.white.make_steady_state_white_step(cache=steady._cache, steady=frozen,
                                                     num_derivatives=NU)
        mean = state.y.mean
        for k in range(1, STEPS + 1):
            mean = step(mean, None, k * DT, DT)[0]
        return mean.numpy()

    _report("port", _blocks(steady.steady_cache, lambda x: x.numpy()), alt, trajectory)


if __name__ == "__main__":
    jax_spread()
    port_spread()
