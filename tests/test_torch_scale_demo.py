"""The scale demo on the port (``pnmol_tpu_torch.experiments.scale_demo``,
the CPU and its plain QRs) against the JAX package's ``demo_step`` (from
``experiments/scale_demo.py``, its ``"xla"`` factorization; the record it
prints is read from stdout) at small sizes: the 1-D heat on 33 points
through the white and the latent solver at nu = 1, the 2-D heat on 8 x 8
through the two-QR banded pipeline, and the 1-D heat in steady state
through both solvers; and the plain radial Gram against JAX's
``pallas_gram.gram_fast_jnp`` on 256 seeded points.

Tolerances (set from a CPU run of both packages): ``N``, ``state_dim``,
``grid`` and the Riccati iterations equal; the decay ratio within 1e-6
absolute (JAX's record rounds it to 6 digits; the unrounded ratios agree to
~1e-12). The closed-loop radius within 1e-3 relative: both estimate it by
256 power iterations, from start vectors drawn by different generators
(``jax.random`` key 0, ``torch.Generator`` seed 0), whose transients leave
the two geometric means 2.1e-4 (white) and 2.2e-4 (latent) apart. The Gram
within 1e-14 absolute (unit output scale; measured 2.2e-16).
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
import torch_figures

from pnmol_tpu.ops import pallas_gram
from pnmol_tpu_torch.experiments import scale_demo
from pnmol_tpu_torch.ops import gram as tgram

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# the JAX driver, loaded from its file under a name of its own (it has no
# import-time side effects; experiments/ is not a package)
_spec = importlib.util.spec_from_file_location("jax_scale_demo",
                                               REPO / "experiments" / "scale_demo.py")
jax_scale_demo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_scale_demo)

CASES = {
    "1d-white": dict(dim=1, n=33, nu=1, solver_name="white"),
    "1d-latent": dict(dim=1, n=33, nu=1, solver_name="latent"),
    "2d-two-qr-banded": dict(dim=2, n=8, nu=1, propagate_band="banded"),
    "1d-steady-white": dict(dim=1, n=33, nu=1, steady_state=True, dt=1e-2),
    "1d-steady-latent": dict(dim=1, n=33, nu=1, steady_state=True, dt=1e-2,
                             solver_name="latent"),
}
STEPS = 4


def jax_record(case):
    kwargs = dict(case)
    kwargs["n_side"] = kwargs.pop("n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_scale_demo.demo_step(num_steps=STEPS, fused=False, **kwargs)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jaxs_demo_step(name):
    case = CASES[name]
    got = scale_demo.step("cpu", steps=STEPS, **case)
    want = jax_record(case)
    for key in ("demo", "solver", "grid", "N", "state_dim", "nu", "dtype", "fused_qr",
                "propagate_band", "steady_state", "steady_riccati_iterations", "dt",
                "nan_free", "heat_decays"):
        assert got[key] == want[key], key
    assert abs(got["decay_ratio"] - want["decay_ratio"]) <= 1e-6
    if case.get("steady_state"):
        np.testing.assert_allclose(got["steady_diagnostics"]["closed_loop_rho"],
                                   want["steady_diagnostics"]["closed_loop_rho"], rtol=1e-3)
        assert set(got["steady_diagnostics"]) == set(want["steady_diagnostics"])
    assert got["device"] == "cpu" and got["peak_memory_gib"] is None
    assert got["steps_per_sec"] > 0 and got["first_call_seconds"] > 0


def test_steady_options_follow_the_command_line():
    assert scale_demo.steady_options(False, 3) is False
    assert scale_demo.steady_options(True) is True
    assert scale_demo.steady_options(True, 7, 1e-9, 2, seed=False) == {
        "max_iters": 7, "tol": 1e-9, "chunk_iters": 2, "seed": False}


def test_plain_gram_matches_jaxs_gram_fast_jnp():
    points = np.random.default_rng(0).uniform(size=(256, 2))
    want = np.asarray(pallas_gram.gram_fast_jnp(points, points, 5.0, 1.0, phi_name="matern52"))
    x = torch.as_tensor(points)
    got = tgram.gram_radial_reference(x, x, 5.0, 1.0, phi_name="matern52").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_gram_record_on_the_cpu_times_the_plain_version_only():
    record = scale_demo.gram("cpu", n=256)
    assert (record["demo"], record["N"], record["device"]) == ("gram_assembly", 256, "cpu")
    for dtype, size in (("float64", 8), ("float32", 4)):
        assert set(record[dtype]) == {"plain_seconds", "gbytes_out"}
        assert record[dtype]["gbytes_out"] == 256 * 256 * size / 1e9


def test_the_command_line_writes_only_under_its_output_root(tmp_path, capsys):
    before = torch_figures.committed_digests()
    record = scale_demo.main(["step", "--dim", "1", "--n", "17", "--steps", "2",
                              "--device", "cpu", "--out", str(tmp_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    assert json.loads((tmp_path / "scale_demo" / "scale_demo.json").read_text()) == record
    assert torch_figures.committed_digests() == before


@pytest.mark.parametrize("mode", ["step", "gram"])
def test_the_card_is_refused_without_a_card(mode):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(scale_demo, mode)("cuda")
