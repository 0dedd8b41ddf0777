"""The port's native k-NN (its own copy of the KD-tree, built with g++ at
first use) against the JAX package's, and the meshes above the brute-force
cutover that it serves: neighbours and the FD discretization at 4097 points
against the JAX package."""

import numpy as np
import pytest
import torch

from pnmol_tpu import discretize as jdiscretize
from pnmol_tpu import diffops as jdiffops
from pnmol_tpu import kernels as jkernels
from pnmol_tpu import mesh as jmesh
from pnmol_tpu import native as jnative
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import native

torch.set_num_threads(1)

GRID = 4097  # above the 2048-point cutover


@pytest.mark.parametrize("k", [1, 3, 7])
def test_knn_matches_jax_on_random_2d_points(k):
    points = np.random.default_rng(0).uniform(size=(3000, 2))
    queries = np.random.default_rng(1).uniform(size=(500, 2))
    idx, dist = native.knn(points, queries, k)
    jidx, jdist = jnative.knn(points, queries, k)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(dist, jdist)
    # exact: the brute-force distances of the same neighbours, nearest first
    brute = np.sqrt(((queries[:, None, :] - points[idx]) ** 2).sum(-1))
    np.testing.assert_allclose(dist, brute, rtol=1e-15, atol=0)
    assert np.all(np.diff(dist, axis=1) >= 0)


def test_knn_matches_jax_on_a_uniform_grid():
    """Equidistant neighbours tie on a grid: both trees break ties alike."""
    points = np.linspace(0.0, 1.0, GRID)[:, None]
    idx, _ = native.knn(points, points, 3)
    jidx, _ = jnative.knn(points, points, 3)
    np.testing.assert_array_equal(idx, jidx)
    assert np.all(idx[:, 0] == np.arange(GRID))


def _grid(side, dim):
    axes = [np.linspace(0.0, 1.0, side)] * dim
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dim)


@pytest.mark.parametrize("side,dim,k", [(48, 2, 5), (48, 2, 9), (14, 3, 7)])
def test_knn_matches_jax_on_nd_grids(side, dim, k):
    """2-D and 3-D tensor grids above the cutover (2304 and 2744 points):
    equal indices, order included. A grid point's neighbours tie in whole
    shells, and another tie-break would change the FD operator."""
    points = _grid(side, dim)
    assert points.shape[0] > pt.mesh._TREE_CUTOVER
    idx, dist = native.knn(points, points, k)
    jidx, jdist = jnative.knn(points, points, k)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(dist, jdist)
    assert np.all(idx[:, 0] == np.arange(points.shape[0]))
    tm = pt.mesh.RectangularMesh(points, device="cpu")
    jm = jmesh.RectangularMesh(points)
    _, tnb = tm.neighbours(point=tm.boundary[0], num=k)
    _, jnb = jm.neighbours(point=jm.boundary[0], num=k)
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))


def test_mesh_neighbours_above_the_cutover_match_jax():
    tm = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=GRID, device="cpu")
    jm = jmesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=GRID)
    _, tnb = tm.neighbours(point=tm.points[:50], num=3)
    _, jnb = jm.neighbours(point=jm.points[:50], num=3)
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    assert tm.fill_distance == jm.fill_distance


def test_fd_probabilistic_above_the_cutover_matches_jax():
    """The 4097-point heat operator (dx-adapted FD kernel), to the
    tolerances of test_torch_discretize.py: L to 1e-11 relative, E to 1e-11
    of the kernel's (L x L) k at zero."""
    dx = 1.0 / (GRID - 1)
    scale = 0.1 / dx
    tm = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=GRID, device="cpu")
    jm = jmesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=GRID)
    tk = pt.kernels.SquareExponential(input_scale=scale)
    L, E = pt.discretize.fd_probabilistic(pt.diffops.laplace(), tm, kernel=tk)
    jL, jE = jdiscretize.fd_probabilistic(jdiffops.laplace(), jm,
                                          kernel=jkernels.SquareExponential(input_scale=scale))
    jL, jE = np.asarray(jL), np.asarray(jE)
    np.testing.assert_allclose(L.numpy(), jL, rtol=1e-11, atol=0)
    llk = 3 * scale**4  # (L x L) k at zero for the squared exponential
    np.testing.assert_allclose(E.numpy(), jE, rtol=0, atol=1e-11 * llk)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No NumPy fallback: without a compiler the k-NN raises."""
    monkeypatch.setattr(native.cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_COMPILER", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


def test_knn_rejects_mismatched_queries():
    with pytest.raises(ValueError, match="queries"):
        native.knn(np.zeros((5, 2)), np.zeros((3, 1)), 2)
