"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

Every source ``csrc/<name>.cu`` exports pairs of plain C functions,
``<symbol>_f64`` and ``<symbol>_f32`` (``panel_lq.cu`` exports ``panel_lq``
and ``leaf_qr``, ``gram_radial.cu`` exports ``gram_radial``), that take
device pointers and integer sizes, then the device index and the stream,
launch on that stream without synchronizing, and return the launch's
``cudaError_t`` (0 = success). Each source is compiled with ``nvcc`` for
``sm_90a`` at first use into ``_build/<name>-<hash>/``, keyed by the hash
of the source and the flags, so an edited source builds anew and an
unchanged one is reused. Nothing here falls back: a missing ``nvcc``, a
failed build or a failed launch raises.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

import torch

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE / "csrc"
_BUILD_DIR = _PACKAGE / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_DTYPE_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = pathlib.Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
        )
    return str(nvcc)


def library_path(name: str, source: pathlib.Path, flags: tuple) -> pathlib.Path:
    """Where :func:`compile_library` puts ``lib<name>.so`` built from
    ``source`` with ``flags``: ``_build/<name>-<hash>/``."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    return _BUILD_DIR / f"{name}-{digest[:16]}" / f"lib{name}.so"


def compile_library(compiler: str, name: str, source: pathlib.Path, flags: tuple) -> pathlib.Path:
    """Compile ``source`` with ``compiler`` and ``flags`` into
    :func:`library_path` unless it is there already (the CUDA kernels here,
    the host C++ of :mod:`pnmol_tpu_torch.native` too). Returns the path;
    raises if the compiler is missing or fails."""
    lib = library_path(name, source, flags)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                                  capture_output=True, text=True, timeout=600)
        except FileNotFoundError as err:
            raise RuntimeError(f"{name}: {compiler} not found; it cannot be built") from err
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: {compiler} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def build(name: str, defines: tuple = ()) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` into a shared library (once per source and
    ``defines``, macros passed to ``nvcc`` as ``-D<define>``).

    Returns the library's path. Raises if ``nvcc`` is missing or the compile
    fails.
    """
    flags = (*_NVCC_FLAGS, *(f"-D{define}" for define in defines))
    source = _CSRC / f"{name}.cu"
    lib = library_path(name, source, flags)
    return lib if lib.exists() else compile_library(_nvcc(), name, source, flags)


@functools.lru_cache(maxsize=None)
def _library(name: str):
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def entry_points(name: str, symbol: str, argtypes: tuple):
    """``{dtype: C function}`` of the entry points ``<symbol>_f64`` and
    ``<symbol>_f32`` of ``csrc/<name>.cu``, built and bound once.

    ``argtypes`` are the ctypes types of the kernel's own arguments; the
    device index and the stream are appended.
    """
    lib = _library(name)
    functions = {}
    for dtype, suffix in _DTYPE_SUFFIX.items():
        fn = getattr(lib, f"{symbol}_{suffix}")
        fn.argtypes = [*argtypes, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        functions[dtype] = fn
    return functions


def check_input(name: str, tensor, ndim: int = 2) -> None:
    """Raise unless ``tensor`` is a contiguous CUDA float64/float32 tensor of
    ``ndim`` dimensions (what every kernel of ``csrc/`` takes)."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensor.device}")
    if tensor.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"{name}: dtype must be float64 or float32, got {tensor.dtype}")
    if tensor.ndim != ndim or not tensor.is_contiguous():
        raise ValueError(f"{name}: input must be a contiguous {ndim}-D tensor")


def launch(name: str, symbol: str, argtypes: tuple, like, *args) -> None:
    """Launch the entry point ``symbol`` of ``csrc/<name>.cu`` for ``like``'s
    dtype on the current stream of ``like``'s device; raise if the launch
    failed."""
    fn = entry_points(name, symbol, argtypes)[like.dtype]
    err = fn(*args, like.device.index, torch.cuda.current_stream(like.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: kernel launch failed (cudaError {err})")
