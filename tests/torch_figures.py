"""What the driver tests share: the committed JAX arrays of
``experiments/results/`` (read as data) and the digests of the JAX
package's committed records, which a test takes before and after a
driver's command line runs."""

import hashlib
import pathlib

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
RESULTS = REPO / "experiments" / "results"


def committed(figure, name):
    return np.load(RESULTS / figure / f"{name}.npy")


def committed_names(figure):
    return {p.stem for p in (RESULTS / figure).glob("*.npy")}


def results_digests():
    """sha256 of every file under experiments/results/."""
    return {str(p.relative_to(RESULTS)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(RESULTS.rglob("*")) if p.is_file()}


def committed_digests():
    """sha256 of every file under the JAX package's committed records
    (``bench_artifacts/``, ``experiments/``, ``docs/``), bytecode caches
    aside (an import in another test process may write one)."""
    return {str(p.relative_to(REPO)): hashlib.sha256(p.read_bytes()).hexdigest()
            for root in ("bench_artifacts", "experiments", "docs")
            for p in sorted((REPO / root).rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def relative_gap(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())
