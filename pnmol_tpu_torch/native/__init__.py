"""Native (C++) host code of the port, bound through ctypes (counterpart of
:mod:`pnmol_tpu.native`).

The k-NN stencil search of meshes above 2048 points (``knn.cpp``, a
KD-tree). It is compiled with ``g++`` at first use into
``pnmol_tpu_torch/_build/knn-<hash>/``, keyed by the hash of the source and
the flags (``ops.cuda_build.compile_library``), with OpenMP where the
compiler has it and single-threaded queries where it does not. Unlike the
JAX package this module has no NumPy fallback: a failed build raises.
"""

import ctypes
import functools
import pathlib

import numpy as np

from pnmol_tpu_torch.ops import cuda_build

_SOURCE = pathlib.Path(__file__).resolve().parent / "knn.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_COMPILER = "g++"


def build() -> pathlib.Path:
    """Compile ``knn.cpp`` (once per source), with ``-fopenmp`` or, where
    that fails, without it; return the library's path. Raises if the
    compiler is missing or both builds fail."""
    variants = ((*_FLAGS, "-fopenmp"), _FLAGS)
    for flags in variants:  # a build without OpenMP is not retried with it
        lib = cuda_build.library_path("knn", _SOURCE, flags)
        if lib.exists():
            return lib
    try:
        return cuda_build.compile_library(_COMPILER, "knn", _SOURCE, variants[0])
    except RuntimeError:
        return cuda_build.compile_library(_COMPILER, "knn", _SOURCE, variants[1])


def available() -> bool:
    """Whether the k-NN library builds here (the compiler's failure is what
    :func:`knn` raises)."""
    try:
        build()
    except (RuntimeError, OSError):
        return False
    return True


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.pnmol_knn_query.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]
    lib.pnmol_knn_query.restype = None
    return lib


def knn(points, queries, k: int):
    """k nearest neighbours of each query among ``points`` (both (n, dim),
    float64 on the host): ``(indices (q, k) int32, distances (q, k))``,
    nearest first; ``k`` is capped at the number of points."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    queries = np.ascontiguousarray(queries, dtype=np.float64)
    n, dim = points.shape
    if queries.ndim != 2 or queries.shape[1] != dim:
        raise ValueError(f"knn: queries of shape {queries.shape} for {dim}-D points")
    q = queries.shape[0]
    k = min(int(k), n)
    if k < 1:
        raise ValueError("knn: need k >= 1 and at least one point")
    indices = np.empty((q, k), dtype=np.int32)
    distances = np.empty((q, k), dtype=np.float64)
    _library().pnmol_knn_query(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, dim,
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), q, k,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        distances.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return indices, distances
