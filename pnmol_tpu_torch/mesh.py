"""Rectangular meshes in any spatial dimension with neighbour queries and
boundary normals (counterpart of :mod:`pnmol_tpu.mesh`).

Neighbour search runs once at problem setup, on the host, over the float64
host copy of the points: an exact NumPy brute-force k-NN up to
``_TREE_CUTOVER`` points, the native KD-tree (:mod:`pnmol_tpu_torch.native`)
above. Boundary classification and normals compare the host points with a
float64 host copy of the bounding box. Results become tensors on the mesh's
device.
"""

import abc
from functools import cached_property

import numpy as np
import torch

from pnmol_tpu_torch import config, native

_TREE_CUTOVER = 2048

# cached classifications that depend on the order of the points
_CACHED = ("boundary", "interior", "_boundary_mask_host", "boundary_projection_matrix",
           "boundary_normals")


def _knn_host(points: np.ndarray, queries: np.ndarray, k: int):
    """Indices of the k nearest neighbours for each query point (host)."""
    n = points.shape[0]
    k = min(k, n)
    if n > _TREE_CUTOVER:
        return native.knn(points, queries, k)[0].astype(np.int64)
    d2 = ((queries[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    idx = np.argpartition(d2, kth=k - 1, axis=1)[:, :k]
    order = np.take_along_axis(d2, idx, axis=1).argsort(axis=1)
    return np.take_along_axis(idx, order, axis=1)


def _host_bbox(points_host):
    return np.stack((points_host.min(axis=0), points_host.max(axis=0)), axis=-1)


class Mesh(abc.ABC):
    """Scattered points: ``points`` (N, dim) on ``device``, in ``dtype``
    (the policy's, :func:`pnmol_tpu_torch.config.default_dtype`, unless
    given), and a float64 host copy taken BEFORE that cast, which serves the
    setup geometry (neighbour search, stencil offsets, fill distance): f32
    differences of nearby coordinates would lose most of their digits."""

    def __init__(self, points, *, device, dtype=None):
        pts_np = np.asarray(points, dtype=np.float64)
        self._points_host = pts_np
        self.device = torch.device(device)
        self.points = torch.tensor(pts_np, dtype=dtype or config.default_dtype(),
                                   device=self.device)

    @abc.abstractmethod
    def neighbours(self, point, num):
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def boundary(self):
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def interior(self):
        raise NotImplementedError

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, key):
        return self.points[key]

    @property
    def shape(self):
        return self.points.shape

    @property
    def dimension(self):
        """Spatial dimension of the mesh."""
        return self.points.shape[-1]

    def sort(self):
        """Reorder the points as [interior; boundary] in place, dropping the
        cached classifications."""
        _, _, interior_idx = self.interior
        _, _, boundary_idx = self.boundary
        perm = torch.cat((interior_idx, boundary_idx))
        self.points = self.points[perm]
        self._points_host = self._points_host[perm.cpu().numpy()]
        for attr in _CACHED:
            self.__dict__.pop(attr, None)

    @property
    def fill_distance(self):
        """Largest distance from any point to its nearest distinct neighbour."""
        pts = self._points_host
        if pts.shape[0] > _TREE_CUTOVER:  # no (N, N) distance matrix
            nn = pts[_knn_host(pts, pts, 2)[:, 1]]
            return float(np.sqrt(((pts - nn) ** 2).sum(-1).max()))
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        return float(np.sqrt(d2.min(axis=1).max()))


class RectangularMesh(Mesh):
    """Tensor-product grid over an axis-aligned bounding box.

    A float64 host copy of ``bbox`` (dim, 2) serves boundary classification
    and normals, which compare the host points with it exactly: a bbox in
    the policy dtype (f32) would drop every face whose bound f32 does not
    represent (0.1, 0.3), and with it the face's boundary condition.
    Without ``bbox`` the points' own bounding box is taken.
    """

    def __init__(self, points, *, device, bbox=None, dtype=None):
        super().__init__(points, device=device, dtype=dtype)
        self._bbox_host = (_host_bbox(self._points_host) if bbox is None
                           else np.asarray(bbox, dtype=np.float64).reshape(-1, 2))

    @classmethod
    def from_bbox_1d(cls, bbox, *, device, step=None, num=None):
        bbox = np.asarray(bbox, dtype=np.float64)
        if (step is None) == (num is None):
            raise ValueError("Provide exactly one of step or num.")
        if step is not None:
            num = int((bbox[1] - bbox[0]) / step) + 1
        grid = np.linspace(bbox[0], bbox[1], num=num, endpoint=True)
        return cls(grid.reshape(-1, 1), device=device)

    @classmethod
    def from_bbox_nd(cls, bbox, *, device, steps=None, nums=None):
        """Tensor-product grid over an n-dimensional bounding box (dim, 2),
        built in float64 on the host (``meshgrid`` in "ij" order)."""
        bbox = np.asarray(bbox, dtype=np.float64).reshape(-1, 2)
        dim = bbox.shape[0]
        if (steps is None) == (nums is None):
            raise ValueError("Provide exactly one of steps or nums.")
        if steps is not None:
            nums = tuple(int((bbox[d, 1] - bbox[d, 0]) / steps[d]) + 1 for d in range(dim))
        axes = [np.linspace(bbox[d, 0], bbox[d, 1], num=nums[d], endpoint=True)
                for d in range(dim)]
        grids = np.meshgrid(*axes, indexing="ij")
        return cls(np.stack([g.reshape(-1) for g in grids], axis=-1), device=device)

    @classmethod
    def from_bbox_2d(cls, bbox, *, device, steps=None, nums=None):
        return cls.from_bbox_nd(bbox, device=device, steps=steps, nums=nums)

    @classmethod
    def from_bbox_3d(cls, bbox, *, device, steps=None, nums=None):
        return cls.from_bbox_nd(bbox, device=device, steps=steps, nums=nums)

    def neighbours(self, point, num):
        """k nearest mesh points for each query point (host-side, setup only).

        Returns ``(points (q, num, dim), indices (q, num))``.
        """
        if num <= 0:
            raise ValueError("num >= 1 required!")
        point = torch.as_tensor(point)
        queries = np.atleast_2d(point.cpu().numpy())
        indices = _knn_host(self._points_host, queries, num)
        if point.ndim == 1:
            indices = indices[0]
        indices = torch.as_tensor(indices, device=self.device)
        return self.points[indices], indices

    @cached_property
    def _boundary_mask_host(self):
        bbox = self._bbox_host
        on_face = (self._points_host == bbox[None, :, 0]) | (
            self._points_host == bbox[None, :, 1]
        )
        return on_face.any(axis=1)

    def _classified(self, mask_host):
        mask = torch.as_tensor(mask_host, device=self.device)
        return self.points[mask], mask, torch.nonzero(mask).reshape(-1)

    @cached_property
    def boundary(self):
        """(boundary points, mask, indices)."""
        return self._classified(self._boundary_mask_host)

    @cached_property
    def interior(self):
        """(interior points, mask, indices)."""
        return self._classified(~self._boundary_mask_host)

    @cached_property
    def boundary_projection_matrix(self):
        """Rows of the identity at the boundary indices."""
        _, _, indices = self.boundary
        eye = torch.eye(len(self), dtype=self.points.dtype, device=self.device)
        return eye[indices, :]

    @cached_property
    def boundary_normals(self):
        """Unit outward normals at the boundary points, (b, dim) on the
        device: a face point takes its face's axis normal, an edge or corner
        point (on several faces) the normalized sum of its faces' normals."""
        bbox = self._bbox_host
        pts = self._points_host[self._boundary_mask_host]
        normals = (pts == bbox[None, :, 1]).astype(np.float64) - (
            pts == bbox[None, :, 0]
        ).astype(np.float64)
        norms = np.linalg.norm(normals, axis=1, keepdims=True)
        return torch.tensor(normals / np.maximum(norms, 1e-300),
                            dtype=self.points.dtype, device=self.device)


def read_bbox(points):
    """Per-dimension (min, max) of a point cloud (N, dim): a float64 host
    array (dim, 2), as the meshes keep their bounding box."""
    if isinstance(points, torch.Tensor):
        points = points.cpu().numpy()
    return _host_bbox(np.asarray(points, dtype=np.float64))
