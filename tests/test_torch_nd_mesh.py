"""The port's n-D rectangular meshes against the JAX package: tensor grids
in 2-D and 3-D, the boundary/interior classification, the outward normals,
``sort()``, ``read_bbox``, and the bounding box a problem carried across by
``interop`` keeps. The grids are built in f64 on the host by both packages
from the same calls, so points and normals are held equal, not close."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnmol_tpu import mesh as jmesh
import pnmol_tpu_torch as pt
from pnmol_tpu_torch import interop

torch.set_num_threads(1)

CPU = "cpu"
BOX_3D = [[0.0, 1.0], [0.0, 2.0], [0.0, 1.0]]
# a face at 0.3, which no binary float represents exactly: the
# classification compares the f64 host points with the f64 host bbox
BOX_THIN = [[0.0, 1.0], [0.0, 0.3]]

GRIDS = {
    "3d-nums": lambda m, dev: m.RectangularMesh.from_bbox_3d(BOX_3D, nums=(4, 5, 3), **dev),
    "2d-thin": lambda m, dev: m.RectangularMesh.from_bbox_2d(BOX_THIN, nums=(5, 5), **dev),
    "2d-steps": lambda m, dev: m.RectangularMesh.from_bbox_2d(
        [[0.0, 1.0], [0.0, 0.5]], steps=(0.25, 0.125), **dev),
    "2d-unit": lambda m, dev: m.RectangularMesh.from_bbox_nd(
        [[0.0, 1.0], [0.0, 1.0]], nums=(5, 5), **dev),
}


def both(name):
    return GRIDS[name](pt.mesh, {"device": CPU}), GRIDS[name](jmesh, {})


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_classification_and_normals_equal_jax(name):
    tm, jm = both(name)
    np.testing.assert_array_equal(tm.points.numpy(), np.asarray(jm.points))
    assert tm.points.dtype == torch.float64 and tm.points.device.type == CPU
    assert tm.dimension == jm.dimension and tuple(tm.shape) == tuple(jm.shape)
    assert len(tm) == len(jm)
    np.testing.assert_array_equal(tm._bbox_host, jm._bbox_host)
    for part in ("boundary", "interior"):
        for got, want in zip(getattr(tm, part), getattr(jm, part)):
            np.testing.assert_array_equal(np_(got), np.asarray(want))
    np.testing.assert_array_equal(tm.boundary_normals.numpy(),
                                  np.asarray(jm.boundary_normals))
    np.testing.assert_array_equal(tm.boundary_projection_matrix.numpy(),
                                  np.asarray(jm.boundary_projection_matrix))
    np.testing.assert_array_equal(tm[3].numpy(), np.asarray(jm[3]))


def test_3d_grid_counts():
    tm, _ = both("3d-nums")
    assert tm.points.shape == (60, 3) and tm.dimension == 3
    # interior of a 4 x 5 x 3 grid: 2 * 3 * 1 points
    assert int((~tm.boundary[1]).sum()) == 6
    # a tensor grid's nearest neighbour of a point is the point itself
    _, idx = tm.neighbours(tm.points[31], num=7)
    assert int(idx[0]) == 31


def test_thin_face_keeps_its_boundary_points():
    tm, _ = both("2d-thin")
    assert int(tm.boundary[1].sum()) == 16
    normals = tm.boundary_normals
    np.testing.assert_allclose(torch.linalg.norm(normals, dim=1).numpy(), 1.0, rtol=1e-15)


def test_normals_of_faces_and_corners():
    tm, _ = both("2d-unit")
    pts, normals = tm.boundary[0].numpy(), tm.boundary_normals.numpy()
    face = np.nonzero((pts[:, 0] == 0.0) & (pts[:, 1] == 0.5))[0][0]
    np.testing.assert_array_equal(normals[face], [-1.0, 0.0])
    corner = np.nonzero((pts[:, 0] == 1.0) & (pts[:, 1] == 1.0))[0][0]
    np.testing.assert_allclose(normals[corner], [1 / np.sqrt(2)] * 2, rtol=1e-15)


@pytest.mark.parametrize("name", ["3d-nums", "2d-thin"])
def test_sort_matches_jax(name):
    tm, jm = both(name)
    # classify first: sort must drop the cached classifications
    _ = tm.boundary_normals, tm.boundary_projection_matrix
    _ = jm.boundary_normals, jm.boundary_projection_matrix
    tm.sort()
    jm.sort()
    np.testing.assert_array_equal(tm.points.numpy(), np.asarray(jm.points))
    np.testing.assert_array_equal(tm._points_host, jm._points_host)
    n_int = int(tm.interior[1].sum())
    np.testing.assert_array_equal(tm.interior[2].numpy(), np.arange(n_int))
    np.testing.assert_array_equal(tm.boundary[2].numpy(), np.asarray(jm.boundary[2]))
    np.testing.assert_array_equal(tm.boundary_normals.numpy(),
                                  np.asarray(jm.boundary_normals))
    np.testing.assert_array_equal(tm.boundary_projection_matrix.numpy(),
                                  np.asarray(jm.boundary_projection_matrix))


def test_exactly_one_of_steps_or_nums():
    with pytest.raises(ValueError):
        pt.mesh.RectangularMesh.from_bbox_nd(BOX_3D, device=CPU)
    with pytest.raises(ValueError):
        pt.mesh.RectangularMesh.from_bbox_nd(BOX_3D, device=CPU, steps=(1, 1, 1),
                                             nums=(2, 2, 2))


def test_read_bbox_matches_jax():
    points = np.random.default_rng(0).uniform(size=(40, 3))
    want = np.asarray(jmesh.read_bbox(jnp.asarray(points)))
    for cloud in (points, torch.tensor(points)):
        got = pt.mesh.read_bbox(cloud)
        assert got.dtype == np.float64 and got.shape == (3, 2)
        np.testing.assert_array_equal(got, want)


def test_explicit_bbox_sets_the_faces():
    points = np.array([[0.1, 0.1], [0.5, 0.5], [0.9, 0.2]])
    tm = pt.mesh.RectangularMesh(points, device=CPU, bbox=[[0.0, 1.0], [0.0, 1.0]])
    jm = jmesh.RectangularMesh(points, bbox=jnp.asarray([[0.0, 1.0], [0.0, 1.0]]))
    assert int(tm.boundary[1].sum()) == int(np.asarray(jm.boundary[1]).sum()) == 0
    assert int(pt.mesh.RectangularMesh(points, device=CPU).boundary[1].sum()) == 3


@pytest.mark.parametrize("points,dimension", [
    (np.linspace(0.0, 1.0, 5)[:, None], 1),
    (np.stack(np.meshgrid(np.linspace(0, 1, 3), np.linspace(0, 1, 4),
                          indexing="ij"), -1).reshape(-1, 2), 2),
])
def test_a_problem_carried_across_keeps_its_dimension(points, dimension):
    """interop gives the problem the points' bbox: n-D problems report
    dimension 2, as the n-D recipes do (JAX: ``bbox.ndim``), 1-D ones 1."""
    d = points.shape[0]
    pde = interop.discretized_problem(
        L=np.eye(d), E_sqrtm=np.eye(d), B=np.eye(d)[:1], R_sqrtm=np.zeros((1, 1)),
        y0=np.zeros(d), points=points, t0=0.0, tmax=1.0, device=CPU)
    assert pde.dimension == dimension
    np.testing.assert_array_equal(pde.mesh_spatial._bbox_host, pt.mesh.read_bbox(points))
    if dimension > 1:
        with pytest.raises(NotImplementedError, match="one spatial dimension"):
            pde.to_ivp()
