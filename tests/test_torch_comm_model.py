"""The port's counted collectives against its communication model.

Every collective of the mesh records its kind and per-rank payload
(:class:`pnmol_tpu_torch.parallel.meshes.Mesh`, region ``"schedule"``): the
port's counterpart of the HLO walk of ``tests/test_comm_model.py``. On 4
gloo CPU ranks (spawned once for the file,
``torch_parallel_ranks.comm_cases``) each primitive's count must equal
:mod:`pnmol_tpu_torch.utils.comm_model`'s exactly, and so must the two-QR
memory-bounded step's (the sum of its parts) and the distributed
initialization's. The step's layout collectives (gathers and reshards,
GSPMD's part in the JAX tier) are counted apart and stay bounded.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pnmol_tpu  # noqa: E402
from pnmol_tpu import kernels  # noqa: E402
from pnmol_tpu.utils import comm_model as jax_model  # noqa: E402
from pnmol_tpu_torch.parallel import distributed  # noqa: E402
from pnmol_tpu_torch.utils import comm_model  # noqa: E402

import torch_parallel_ranks  # noqa: E402

PRIMITIVES = ("ring_matmul", "gram_rowsharded", "blocked_qr_r_sharded",
              "blocked_qr_r_sharded_ragged", "blocked_qr_r", "blocked_cholesky",
              "blocked_tri_solve", "blocked_cho_solve")


@pytest.fixture(scope="module")
def counted():
    n_points, nu = 32, 1
    dx = 1.0 / (n_points - 1)
    heat = pnmol_tpu.pde.examples.heat_1d_discretized(
        dx=dx, tmax=1.0, kernel=kernels.SquareExponential(input_scale=0.1 / dx))
    solver = pnmol_tpu.white.LinearWhiteNoiseEK1(
        steprule=pnmol_tpu.odetools.step.Constant(dt=1e-3), num_derivatives=nu,
        spatial_kernel=kernels.Matern52() + kernels.WhiteNoise())
    state = solver.initialize(heat)
    arrays = {k: np.asarray(v) for k, v in solver._cache._asdict().items()}
    arrays.update(mean=np.asarray(state.y.mean), cov=np.asarray(state.y.cov_sqrtm), d=n_points,
                  nu=nu)
    problem = dict(L=np.asarray(heat.L), E_sqrtm=np.asarray(heat.E_sqrtm), B=np.asarray(heat.B),
                   R_sqrtm=np.asarray(heat.R_sqrtm), y0=np.asarray(heat.y0),
                   points=np.asarray(heat.mesh_spatial.points), t0=0.0, tmax=1.0)
    runs = distributed.spawn_ranks(torch_parallel_ranks.comm_cases, 4, backend="gloo",
                                   device="cpu", payload=dict(two_qr=arrays,
                                                              two_qr_problem=problem),
                                   timeout=600)
    return [result for result, _ in runs]


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_collectives_match_model(counted, name):
    for ranks in counted:  # every rank issues the same schedule
        got, model = ranks[name]
        assert got == model, (name, got, model)


def test_two_qr_step_collectives_match_model(counted):
    got, model, layout = counted[0]["two_qr_step"]
    assert got == model, (got, model)
    # the layout collectives (z's operator rows, the gathered L21/L1 rows,
    # the posterior's reshard, diag(S)) stay below the schedule's payload
    assert 0 < sum(layout.values()) <= 0.6 * sum(model.values()), (layout, model)


def test_two_qr_step_is_the_sum_of_its_parts(counted):
    got, _, _ = counted[0]["two_qr_step"]
    parts = {}
    for name in ("ring_matmul", "gram_rowsharded", "blocked_cholesky", "blocked_cho_solve",
                 "blocked_qr_r_sharded"):
        parts[name] = counted[0][name]
    d, nu, n_bc, P, panel = 32, 1, 2, 4, 8
    step = comm_model.two_qr_step_cost(d, nu, n_bc, P, panel=panel)
    assert [p.name.split("(")[0] for p in step] == [
        "ring_matmul", "ring_matmul", "gram_rowsharded", "blocked_cholesky",
        "blocked_cho_solve", "blocked_qr_r_sharded", "ring_matmul", "ring_matmul",
        "blocked_qr_r_sharded"]
    total = {}
    for part in step:
        for coll in part.collectives:
            total[coll.kind] = total.get(coll.kind, 0) + coll.total_payload
    assert got == total


def test_distributed_init_collectives_match_model(counted):
    got, model = counted[0]["init"]
    assert got == model, (got, model)


def test_model_is_the_jax_model_for_the_unrolled_sweep():
    """The port's copy counts what the JAX package's model counts."""
    for port_cost, jax_cost in (
        (comm_model.two_qr_step_cost(64, 1, 2, 8, panel=8),
         jax_model.two_qr_step_cost(64, 1, 2, 8, panel=8, qr_loop="unrolled")),
        (comm_model.distributed_init_cost(64, 2, 2, 8, panel=8, sharded_r=False),
         jax_model.distributed_init_cost(64, 2, 2, 8, panel=8, sharded_r=False)),
    ):
        for a, b in zip(port_cost, jax_cost):
            assert a.name == b.name and a.flops == b.flops
            assert [(c.kind, c.payload_elements, c.count) for c in a.collectives] == \
                [(c.kind, c.payload_elements, c.count) for c in b.collectives]


def test_crossover_table_shape():
    rows = comm_model.crossover_table(d_values=(2000, 110592))
    assert rows[0]["sharded_speedup"] > 0
    assert rows[-1]["state_dim"] == 2 * 110592
    # compute alone: P ranks share the FLOPs, so the sharded step wins
    assert rows[-1]["sharded_speedup"] > 1
    assert not any(np.isnan(r["comm_fraction"]) for r in rows)
    chip = comm_model.ChipSpec(link_bytes_per_s=1e11, collective_launch_s=1e-5)
    linked = comm_model.crossover_table(d_values=(2000,), chip=chip)
    assert linked[0]["t_sharded_s"] > rows[0]["t_sharded_s"]
    assert 0 < linked[0]["comm_fraction"] < 1
