"""The port's radial Gram (its plain version; the CUDA kernel is in
test_torch_cuda.py) and the radial kernels' full-Gram dispatch, against the
JAX package's Pallas Gram kernel run in interpret mode and its jnp twin."""

import jax
import numpy as np
import pytest
import torch

from pnmol_tpu import kernels as jkernels
from pnmol_tpu.ops import pallas_gram
import pnmol_tpu_torch as pt
from pnmol_tpu_torch.ops import cuda_build
from pnmol_tpu_torch.ops import gram as tgram

torch.set_num_threads(1)

# Both packages evaluate the same distance-trick formula on the same
# centred points; they differ only in the summation order of x . y (dim 2)
# and in exp/sqrt rounding. Measured: <= 5.5e-16 of output_scale^2; the bound
# leaves two digits of margin.
GRAM_TOL = 1e-13

PROFILES = [
    ("squared_exponential", jkernels.SquareExponential, pt.kernels.SquareExponential),
    ("matern52", jkernels.Matern52, pt.kernels.Matern52),
]


@pytest.fixture(params=[1, 2], ids=["1d", "2d"])
def points(request):
    rng = np.random.default_rng(request.param)
    return rng.uniform(size=(37, request.param)), rng.uniform(size=(53, request.param))


@pytest.mark.parametrize("phi_name", [p[0] for p in PROFILES])
def test_reference_matches_pallas_kernel_and_jnp(points, phi_name):
    x, y = points
    got = tgram.gram_radial_reference(
        torch.from_numpy(x), torch.from_numpy(y), 1.3, 1.1, phi_name=phi_name
    ).numpy()
    via_pallas = pallas_gram.gram_radial(x, y, 1.3, 1.1, phi_name=phi_name, interpret=True)
    via_jnp = pallas_gram.gram_fast_jnp(x, y, 1.3, 1.1, phi_name=phi_name)
    assert got.shape == (37, 53)
    np.testing.assert_allclose(got, np.asarray(via_pallas), rtol=0, atol=GRAM_TOL * 1.1**2)
    np.testing.assert_allclose(got, np.asarray(via_jnp), rtol=0, atol=GRAM_TOL * 1.1**2)


@pytest.mark.parametrize("phi_name, jcls, tcls", PROFILES, ids=[p[0] for p in PROFILES])
def test_radial_kernel_full_gram_matches_jax(points, phi_name, jcls, tcls):
    x, y = points
    jk, tk = jcls(input_scale=1.7, output_scale=0.9), tcls(input_scale=1.7, output_scale=0.9)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = tk(xt, yt.T).numpy()
    np.testing.assert_allclose(got, np.asarray(jk(x, y.T)), rtol=0, atol=GRAM_TOL * 0.9**2)
    # and the pairwise oracle (the autodiff surface), with the bound of
    # tests/test_ops/test_pallas_gram.py (measured 3.3e-16)
    oracle = jax.vmap(jax.vmap(jk.pairwise, (None, 0)), (0, None))(x, y)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=0, atol=1e-10)
    assert got.dtype == np.float64


def test_diagonal_and_scalar_dispatch_unchanged(points):
    x, _ = points
    tk = pt.kernels.SquareExponential(input_scale=2.0, output_scale=1.5)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tk(xt, xt).numpy(), np.full(37, 1.5**2), rtol=1e-15)
    jk = jkernels.SquareExponential(input_scale=2.0, output_scale=1.5)
    np.testing.assert_allclose(float(tk(xt[0], xt[1])), float(jk(x[0], x[1])), rtol=1e-14)


def test_matern_gram_no_nan_at_zero_distance():
    pts = torch.tensor([[0.5], [0.5], [0.7]], dtype=torch.float64)  # duplicate points
    k = pt.kernels.Matern52()
    gram = k(pts, pts.T)
    assert not torch.isnan(gram).any()
    assert gram[0, 1].item() == pytest.approx(k.output_scale**2, abs=1e-15)


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.uniform(size=(n, 2))) for n in (600, 500))
    before = tgram.gram_radial.launches
    got = tgram.gram_radial(x, y, 2.0, 1.0, phi_name="matern52")
    want = tgram.gram_radial_reference(x, y, 2.0, 1.0, phi_name="matern52")
    assert tgram.gram_radial.launches == before == 0
    assert torch.equal(got, want)
    # a CPU Gram above the kernel's size threshold takes the plain version too
    k = pt.kernels.SquareExponential(input_scale=3.0)
    assert k._PALLAS_MIN_ELEMS == 512 * 512 and 600 * 500 >= k._PALLAS_MIN_ELEMS
    torch.testing.assert_close(
        k(x, y.T), tgram.gram_radial_reference(x, y, 3.0, 1.0, phi_name="squared_exponential"),
        rtol=0, atol=0)
    assert tgram.gram_radial.launches == 0


def test_wrapper_rejects_other_devices():
    meta = torch.zeros((4, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgram.gram_radial(meta, meta, 1.0, 1.0, phi_name="matern52")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the Gram kernel's build raises."""
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("gram_radial")
