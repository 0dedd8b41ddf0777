"""The port's problem layer against the JAX package (mirror of
tests/test_problems.py; the method-of-lines conversion is held against JAX
in tests/test_torch_ivp.py): Neumann
boundaries, the SIR and Lotka-Volterra systems, spruce budworm with both
boundary conditions, boundary padding, and the ``duplicate`` prior."""

import functools

import numpy as np
import pytest
import torch

from pnmol_tpu import kernels as jkernels
from pnmol_tpu.models import examples as jexamples
import pnmol_tpu_torch as pt

torch.set_num_threads(1)

CPU = "cpu"
# tolerances of tests/test_torch_discretize.py: the FD weights agree to
# 1e-11 relative; E_sqrtm = llk - w . lk cancels, so it is pinned to 1e-11
# of the cancelling term llk (times the operator's scale)
FD_RTOL = 1e-11
E_RTOL_OF_LLK = 1e-11


def _llk(diffop, kernel=None):
    """|(L x L) k|(x, x) at coincident points: the cancelling term of E."""
    _, LL_k = pt.discretize._differentiate_kernel(
        diffop, kernel or pt.kernels.SquareExponential())
    x0 = torch.zeros(1, dtype=torch.float64)
    return abs(float(LL_k(x0, x0)))


LAPLACE_LLK = _llk(pt.diffops.laplace())
GRADIENT_LLK = _llk(pt.diffops.gradient())

PROBLEMS = {
    "heat-dirichlet": (lambda: jexamples.heat_1d_discretized(dx=0.2, bcond="dirichlet"),
                       lambda: pt.examples.heat_1d_discretized(dx=0.2, bcond="dirichlet",
                                                               device=CPU)),
    "heat-neumann": (lambda: jexamples.heat_1d_discretized(dx=0.2, bcond="neumann"),
                     lambda: pt.examples.heat_1d_discretized(dx=0.2, bcond="neumann",
                                                             device=CPU)),
    "spruce-dirichlet": (
        lambda: jexamples.spruce_budworm_1d_discretized(dx=0.25, bcond="dirichlet"),
        lambda: pt.examples.spruce_budworm_1d_discretized(dx=0.25, bcond="dirichlet",
                                                          device=CPU)),
    "spruce-neumann": (
        lambda: jexamples.spruce_budworm_1d_discretized(dx=0.25, bcond="neumann"),
        lambda: pt.examples.spruce_budworm_1d_discretized(dx=0.25, bcond="neumann",
                                                          device=CPU)),
    "sir": (lambda: jexamples.sir_1d_discretized(dx=0.25),
            lambda: pt.examples.sir_1d_discretized(dx=0.25, device=CPU)),
    "lotka-volterra": (lambda: jexamples.lotka_volterra_1d_discretized(dx=0.1),
                       lambda: pt.examples.lotka_volterra_1d_discretized(dx=0.1, device=CPU)),
}


@functools.lru_cache(maxsize=None)
def _built(name):
    """(JAX problem, port problem), discretized once per test process."""
    jmake, tmake = PROBLEMS[name]
    return jmake(), tmake()


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def problems(request):
    return (request.param, *_built(request.param))


def test_discretization_products_match_jax(problems):
    _, jpde, tpde = problems
    N = len(tpde.mesh_spatial)
    species = len(tpde.diffop) if isinstance(tpde.diffop, tuple) else 1
    d = species * N
    assert tpde.is_discretized and tpde.dimension == 1
    assert tpde.L.shape == tpde.E_sqrtm.shape == (d, d)
    assert tpde.B.shape == (2 * species, d) and tpde.R_sqrtm.shape == (2 * species,) * 2
    assert tpde.y0.shape == (d,)

    np.testing.assert_allclose(tpde.L.numpy(), np.asarray(jpde.L), rtol=FD_RTOL, atol=0)
    scale = max(np.atleast_1d(tpde.diffop_scale))
    np.testing.assert_allclose(tpde.E_sqrtm.numpy(), np.asarray(jpde.E_sqrtm), rtol=0,
                               atol=E_RTOL_OF_LLK * scale * LAPLACE_LLK)
    # Neumann: one-sided two-point gradient weights (+-1/dx-like, rtol of the
    # FD weights) and their errors (cancelling against the gradient's llk)
    np.testing.assert_allclose(tpde.B.numpy(), np.asarray(jpde.B), rtol=FD_RTOL, atol=0)
    np.testing.assert_allclose(tpde.R_sqrtm.numpy(), np.asarray(jpde.R_sqrtm), rtol=0,
                               atol=E_RTOL_OF_LLK * GRADIENT_LLK)
    # closed-form initial values on the same points
    np.testing.assert_allclose(tpde.y0.numpy(), np.asarray(jpde.y0), rtol=1e-14, atol=1e-15)


def test_neumann_and_dirichlet_boundary_operators():
    neumann = pt.examples.heat_1d_discretized(dx=0.2, bcond="neumann", device=CPU)
    N = len(neumann.mesh_spatial)
    B = neumann.B.numpy()
    # outward normal derivative: left weights negated, two points per side
    assert np.count_nonzero(B[0]) == np.count_nonzero(B[1]) == 2
    assert B[0, 0] > 0 > B[0, 1] and B[1, N - 1] > 0 > B[1, N - 2]
    # mirror images: the outward derivative at either end of a uniform mesh
    np.testing.assert_allclose(B[0, :2], B[1, ::-1][:2], rtol=1e-12)
    assert abs(B[0, 1]) == pytest.approx(1.0 / 0.2, rel=0.05)  # ~ 1/dx
    assert np.all(np.diag(neumann.R_sqrtm.numpy()) > 0)
    dirichlet = pt.examples.heat_1d_discretized(dx=0.2, device=CPU)
    np.testing.assert_array_equal(dirichlet.B.numpy(), np.eye(N)[[0, N - 1]])
    assert not dirichlet.R_sqrtm.any()


def test_system_discretization_is_blockdiag():
    sir = _built("sir")[1]
    N = len(sir.mesh_spatial)
    block = sir.L[:N, :N]
    torch.testing.assert_close(sir.L[N:2 * N, N:2 * N], block, rtol=0, atol=0)
    assert not sir.L[:N, N:].any()
    assert sir.B.shape == (6, 3 * N)
    lv = pt.examples.lotka_volterra_1d_discretized(dx=0.25, device=CPU)
    assert lv.L.shape == (2 * len(lv.mesh_spatial),) * 2


@pytest.mark.parametrize("name", ["spruce-dirichlet", "spruce-neumann", "sir",
                                  "lotka-volterra"])
def test_nonlinearity_and_jacobian_match_jax(name):
    jpde, tpde = _built(name)
    rng = np.random.default_rng(3)
    y = np.asarray(jpde.y0) * (1.0 + 0.1 * rng.standard_normal(tpde.y0.shape[0]))
    fx = tpde.f(0.3, torch.from_numpy(y))
    np.testing.assert_allclose(fx.numpy(), np.asarray(jpde.f(0.3, y)), rtol=1e-13,
                               atol=1e-13 * np.abs(y).max())
    J = tpde.df(0.3, torch.from_numpy(y))
    assert J.shape == (y.shape[0],) * 2
    np.testing.assert_allclose(J.numpy(), np.asarray(jpde.df(0.3, y)), rtol=1e-13,
                               atol=1e-15)


def test_bc_padding_roundtrip():
    x = torch.arange(1.0, 4.0, dtype=torch.float64)
    dirichlet = pt.examples.heat_1d(bcond="dirichlet")
    padded = dirichlet.bc_pad(x)
    np.testing.assert_array_equal(padded.numpy(), [0.0, 1.0, 2.0, 3.0, 0.0])
    torch.testing.assert_close(dirichlet.bc_remove_pad(padded), x)

    neumann = pt.examples.heat_1d(bcond="neumann")
    padded = neumann.bc_pad(x)
    np.testing.assert_array_equal(padded.numpy(), [1.0, 1.0, 2.0, 3.0, 3.0])
    torch.testing.assert_close(neumann.bc_remove_pad(padded), x)


def test_system_bc_padding_matches_jax():
    jsir, sir = _built("sir")
    N = len(sir.mesh_spatial)
    x = np.arange(float(3 * (N - 2)))
    padded = sir.bc_pad(torch.from_numpy(x))
    assert padded.shape == (3 * N,)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jsir.bc_pad(x)))
    np.testing.assert_array_equal(sir.bc_remove_pad(padded).numpy(), x)


def test_duplicate_gram_matches_jax():
    X = np.linspace(0.0, 1.0, 7)[:, None]
    prior = pt.duplicate(pt.kernels.Matern52() + pt.kernels.WhiteNoise(), 3)
    jprior = jkernels.duplicate(jkernels.Matern52() + jkernels.WhiteNoise(), 3)
    Xt = torch.from_numpy(X)
    gram = prior(Xt, Xt.T)
    assert gram.shape == (21, 21)
    np.testing.assert_allclose(gram.numpy(), np.asarray(jprior(X, X.T)), rtol=1e-12, atol=0)
    assert not gram[:7, 7:].any()  # block-diagonal
    diag = prior(Xt, Xt)  # equal shapes: the concatenated diagonals
    np.testing.assert_allclose(diag.numpy(), np.asarray(jprior(X, X)), rtol=1e-15)
    assert diag.shape == (21,)


def test_out_of_slice_problem_parts_raise():
    # the n-D Neumann operator is ported: on a 1-D mesh it is the outward
    # derivative at both ends, as in the JAX package (to 1e-11 of its
    # largest weight)
    from pnmol_tpu import discretize as jdiscretize
    from pnmol_tpu import mesh as jmesh

    mesh = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=0.25, device=CPU)
    B, R = pt.discretize.fd_probabilistic_neumann(mesh)
    jB, jR = jdiscretize.fd_probabilistic_neumann(
        jmesh.RectangularMesh.from_bbox_1d([0.0, 1.0], step=0.25))
    assert B.shape == (2, 5) and R.shape == (2, 2)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0,
                               atol=1e-11 * np.abs(np.asarray(jB)).max())
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0,
                               atol=1e-11 * np.abs(np.asarray(jR)).max())
    # the method-of-lines conversion is ported: it needs a discretized problem
    assert pt.examples.heat_1d_discretized(dx=0.25, device=CPU).to_ivp().y0.shape == (3,)
    with pytest.raises(AttributeError, match="prior discretization"):
        pt.examples.heat_1d().to_ivp()
    with pytest.raises(ValueError, match="Unknown boundary condition"):
        pt.examples.spruce_budworm_1d(bcond="periodic")
