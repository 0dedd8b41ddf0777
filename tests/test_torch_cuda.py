"""The CUDA kernels (panel LQ, radial Gram, and leaf QR: the panel kernel on
the tall layout) on the card, against their plain PyTorch versions, and the
latent-force golden through the panel kernel and the R-form hook.

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (skip the JAX-pinning conftest there)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Without a GPU every test skips.
"""

import pathlib

import numpy as np
import pytest
import torch

import pnmol_tpu_torch as pt
from pnmol_tpu_torch.ops import gram as tgram
from pnmol_tpu_torch.ops import qr_householder as tq

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "rows, cols, off, zero_rows",
    [(128, 3586, 0, ()), (128, 600, 40, ()), (32, 3586, 0, ()),
     (128, 1538, 0, range(2, 128)), (2, 1538, 0, ()), (128, 6658, 0, ()), (2, 6658, 0, ()),
     (2, 3074, 0, ()), (128, 6658, 40, ()), (128, 1538, 0, range(128)), (128, 40000, 0, ()),
     (128, 20000, 3, ()), (136, 3586, 5, ())],
    ids=["step-panel", "offset", "leaf-form", "ragged-zero-rows", "two-rows",
         "latent-step-panel", "latent-two-rows", "latent-last-panel", "latent-step-offset",
         "zero-panel", "chunk-in-global-memory", "chunk-in-global-memory-offset",
         "rows-above-128"],
)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_the_plain_version(cuda, rows, cols, off, zero_rows, dtype):
    rng = np.random.default_rng(rows + cols + off)
    slab = rng.standard_normal((rows, cols))
    slab[list(zero_rows)] = 0.0
    x = torch.tensor(slab, dtype=dtype, device=cuda)
    before = tq.panel_lq.launches
    lv, tT = tq.panel_lq(x, off)
    torch.cuda.synchronize()
    assert tq.panel_lq.launches == before + 1
    lv_ref, tT_ref = tq.panel_lq_reference(x, off)
    # rounding of one panel: ~1e-14 (f64) / ~1e-6 (f32) of the slab's scale
    tol = (1e-12 if dtype == torch.float64 else 1e-4) * np.abs(slab).max()
    assert (lv - lv_ref).abs().max().item() <= tol
    assert (tT - tT_ref).abs().max().item() <= tol


def test_two_launches_give_the_same_bits(cuda):
    """The cross-CTA sums run in a fixed order, without float atomics."""
    x = torch.tensor(np.random.default_rng(5).standard_normal((128, 6658)), device=cuda)
    lv, tT = tq.panel_lq(x, 0)
    lv2, tT2 = tq.panel_lq(x, 0)
    assert torch.equal(lv, lv2) and torch.equal(tT, tT2)


def _rule_cta_counts():
    """One panel (the widest) for each CTA count the launch rule picks on the
    N = 512 white, latent and Lotka-Volterra sweeps of a 132-SM card."""
    by_ctas = {}
    for rows, cols in ((1538, 1538), (2050, 3586), (2562, 2562), (3586, 6658),
                       (1540, 1540), (2052, 3588)):
        for i in range(0, rows, 128):
            panel = (min(128, rows - i), cols - i)
            ctas = tq.panel_lq_launch(*panel, 8, 132).ctas
            by_ctas[ctas] = max(by_ctas.get(ctas, panel), panel, key=lambda p: p[1])
    return sorted(by_ctas.items())


@pytest.mark.parametrize("ctas, panel", _rule_cta_counts(), ids=lambda v: str(v))
def test_kernel_at_each_cta_count_of_the_rule(cuda, ctas, panel):
    rows, cols = panel
    x = torch.tensor(np.random.default_rng(ctas).standard_normal(panel), device=cuda)
    assert tq.panel_lq_launch(rows, cols, 8, 132).ctas == ctas
    lv, tT = tq.panel_lq(x, 0)
    lv_ref, tT_ref = tq.panel_lq_reference(x, 0)
    tol = 1e-12 * x.abs().max().item()
    assert (lv - lv_ref).abs().max().item() <= tol
    assert (tT - tT_ref).abs().max().item() <= tol


def test_panel_too_tall_for_the_tt_cta_raises(cuda):
    """T^T of 200 rows (320 KB in f64) does not fit one CTA's shared memory."""
    x = torch.zeros((200, 600), dtype=torch.float64, device=cuda)
    before = tq.panel_lq.launches
    with pytest.raises(ValueError, match="bytes of shared memory per CTA"):
        tq.panel_lq(x, 0)
    assert tq.panel_lq.launches == before


def test_blocked_sweep_matches_the_gram(cuda):
    W = torch.tensor(np.random.default_rng(1).standard_normal((300, 520)), device=cuda)
    L = tq.blocked_lq_l(W, block=64)
    G = W @ W.T
    assert ((L @ L.T - G).abs().max() / G.abs().max()).item() <= 1e-12


def test_blocked_sweep_of_the_latent_step_pre_array_matches_the_gram(cuda):
    """3586 x 6658: the latent step's shape at N = 512, 29 panels, the last
    of 2 rows."""
    W = torch.tensor(np.random.default_rng(6).standard_normal((3586, 6658)), device=cuda)
    before = tq.panel_lq.launches
    L = tq.blocked_lq_l(W)
    assert tq.panel_lq.launches == before + 29
    G = W @ W.T
    assert ((L @ L.T - G).abs().max() / G.abs().max()).item() <= 1e-13
    assert torch.all(torch.triu(L, 1) == 0).item()


@pytest.mark.parametrize("leaf", [32, 64])
def test_256_row_blocks_take_the_leaf_route(cuda, leaf):
    """The blocks that the panel kernel cannot take in one launch (256 rows,
    from 4096 points on) run the leaf route: ceil(b / leaf) leaf_lq launches
    a block and no panel_lq launch, equal to the plain version entry by
    entry (the same reflectors)."""
    W = np.random.default_rng(leaf).standard_normal((300, 700))
    W[7] = 0.0
    before = (tq.leaf_lq.launches, tq.panel_lq.launches)
    L = tq.blocked_lq_l(torch.tensor(W, device=cuda), leaf=leaf, block=256)
    torch.cuda.synchronize()
    leaves = -(-256 // leaf) + -(-44 // leaf)
    assert (tq.leaf_lq.launches, tq.panel_lq.launches) == (before[0] + leaves, before[1])
    L_plain = tq.blocked_lq_l(torch.from_numpy(W), leaf=leaf, block=256)
    scale = np.abs(W @ W.T).max()
    assert (L.cpu() - L_plain).abs().max().item() <= 1e-12 * np.sqrt(scale)


@pytest.mark.parametrize("rows, cols, off", [(64, 20257, 0), (64, 20257, 192), (32, 26626, 224)],
                         ids=["n1e4-window", "n1e4-window-last-leaf", "latent-d2048-leaf"])
def test_leaf_lq_matches_the_plain_version_at_large_n_shapes(cuda, rows, cols, off):
    x = torch.tensor(np.random.default_rng(cols + off).standard_normal((rows, cols)),
                     device=cuda)
    before = (tq.leaf_lq.launches, tq.panel_lq.launches)
    lv, tT = tq.leaf_lq(x, off)
    torch.cuda.synchronize()
    assert (tq.leaf_lq.launches, tq.panel_lq.launches) == (before[0] + 1, before[1])
    assert not tq.panel_lq_launch(rows, cols, 8, 132).registers  # the global-memory tier
    lv_ref, tT_ref = tq.panel_lq_reference(x, off)
    tol = 1e-12 * x.abs().max().item()
    assert (lv - lv_ref).abs().max().item() <= tol
    assert (tT - tT_ref).abs().max().item() <= tol


def test_two_leaf_lq_launches_give_the_same_bits(cuda):
    x = torch.tensor(np.random.default_rng(8).standard_normal((64, 20257)), device=cuda)
    lv, tT = tq.leaf_lq(x, 0)
    lv2, tT2 = tq.leaf_lq(x, 0)
    assert torch.equal(lv, lv2) and torch.equal(tT, tT2)


GOLDEN = pathlib.Path(__file__).parent / "golden" / "heat_trajectories.npz"


@pytest.mark.parametrize("factorization", ["householder", "r-form"])
def test_latent_golden_through_the_kernels(cuda, factorization):
    """The dx = 0.2 latent golden (thresholds of tests/test_golden.py) on the
    card: one panel per LQ (the init and 5 steps), or two leaves per step in
    the R form."""
    hook = "householder" if factorization == "householder" else tq.make_householder_factorization()
    wrapper, launches = (tq.panel_lq, 6) if factorization == "householder" else (tq.leaf_qr, 10)
    heat = pt.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=cuda)
    solver = pt.latent.LinearLatentForceEK1(
        steprule=pt.odetools.step.Constant(0.1),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(), factorization=hook)
    before = wrapper.launches
    sol = solver.solve(heat)
    assert wrapper.launches == before + launches
    with np.load(GOLDEN) as golden:
        np.testing.assert_allclose(sol.mean.cpu().numpy(), golden["latent_mean"],
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(float(sol.diffusion_squared_calibrated),
                                   golden["latent_diffusion"], rtol=1e-10)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tq.panel_lq(x.to(torch.float16), 0)
    with pytest.raises(ValueError):
        tq.panel_lq(x.T, 0)  # not contiguous
    with pytest.raises(ValueError):
        tq.panel_lq(x, 5)  # rows > cols - off


# --- radial Gram (K3) -------------------------------------------------------

# the kernel's tiles are 32 rows x 128 columns; the ragged shapes divide
# neither, and an odd or non-multiple-of-4 m leaves row starts that a
# 16-byte store cannot take
GRAM_SHAPES = [((512, 1), (512, 1)), ((1000, 2), (777, 2)), ((37, 3), (53, 3)),
               ((70, 1), (300, 1)), ((33, 2), (131, 2)), ((100, 3), (258, 3)),
               ((50, 5), (130, 5))]


@pytest.mark.parametrize("shapes", GRAM_SHAPES,
                         ids=["512x1", "ragged-1000x777x2", "dim3", "ragged-dim1",
                              "ragged-odd-m-dim2", "ragged-dim3", "dim5-two-chunks"])
@pytest.mark.parametrize("phi_name", ["squared_exponential", "matern52"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gram_kernel_matches_the_plain_version(cuda, shapes, phi_name, dtype):
    rng = np.random.default_rng(sum(shapes[0]) + sum(shapes[1]))
    x, y = (torch.tensor(rng.uniform(size=s), dtype=dtype, device=cuda) for s in shapes)
    before = tgram.gram_radial.launches
    got = tgram.gram_radial(x, y, 5.0, 1.3, phi_name=phi_name)
    torch.cuda.synchronize()
    assert tgram.gram_radial.launches == before + 1
    want = tgram.gram_radial_reference(x, y, 5.0, 1.3, phi_name=phi_name)
    # the same distance-trick formula, d2 rounded as in the plain version:
    # exp/sqrt rounding only, relative to output_scale^2
    tol = (1e-12 if dtype == torch.float64 else 1e-5) * 1.3**2
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol


def test_radial_kernel_dispatches_large_cuda_grams_to_the_kernel(cuda):
    X = torch.linspace(0.0, 1.0, 512, dtype=torch.float64, device=cuda)[:, None]
    k = pt.kernels.SquareExponential(input_scale=5.0)
    before = tgram.gram_radial.launches
    gram = k(X, X.T)  # 512^2 elements: the kernel
    assert tgram.gram_radial.launches == before + 1
    k(X[:511], X.T)  # below the threshold: the plain version
    assert tgram.gram_radial.launches == before + 1
    torch.testing.assert_close(
        gram, tgram.gram_radial_reference(X, X, 5.0, 1.0, phi_name="squared_exponential"),
        rtol=0, atol=1e-12)


def test_gram_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((8, 2), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tgram.gram_radial(x.to(torch.float16), x.to(torch.float16), 1.0, 1.0, phi_name="matern52")
    with pytest.raises(ValueError):
        tgram.gram_radial(x.T, x.T, 1.0, 1.0, phi_name="matern52")  # not contiguous
    with pytest.raises(ValueError):
        tgram.gram_radial(x, x[:, :1].contiguous(), 1.0, 1.0, phi_name="matern52")
    with pytest.raises(ValueError):
        tgram.gram_radial(x, x, 1.0, 1.0, phi_name="polynomial")


# --- leaf QR (K4) -----------------------------------------------------------


@pytest.mark.parametrize(
    "rows, cols, zero_cols",
    [(3586, 32, ()), (2050, 32, ()), (40, 32, ()), (2050, 32, (3, 17)), (300, 2, ()),
     (32, 32, ()), (6658, 32, ()), (3586, 128, ()), (20000, 32, ()), (6658, 128, (0, 77))],
    ids=["step-top", "step-bottom", "short", "zero-columns", "narrow-last-leaf", "square",
         "latent-step-top", "leaf-128", "chunk-in-global-memory", "latent-leaf-128-zero-columns"],
)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_leaf_kernel_matches_the_plain_version(cuda, rows, cols, zero_cols, dtype):
    rng = np.random.default_rng(rows + cols + len(zero_cols))
    slab = rng.standard_normal((rows, cols))
    slab[:, list(zero_cols)] = 0.0
    x = torch.tensor(slab, dtype=dtype, device=cuda)
    before = tq.leaf_qr.launches
    vr, t = tq.leaf_qr(x)
    torch.cuda.synchronize()
    assert tq.leaf_qr.launches == before + 1
    vr_ref, t_ref = tq.leaf_qr_reference(x)
    # rounding of one Householder QR: ~1e-15 (f64) / ~1e-6 (f32) of R's scale
    scale = vr_ref.abs().max().item()
    tol = (1e-12 if dtype == torch.float64 else 1e-4) * scale
    assert (vr - vr_ref).abs().max().item() <= tol
    assert (t - t_ref).abs().max().item() <= tol
    for k in zero_cols:
        assert t[k, k].item() == 0.0  # the identity reflector


def test_two_leaf_launches_give_the_same_bits(cuda):
    """The tall layout shares the panel kernel's fixed-order exchange."""
    for rows in (3586, 20000):  # chunks in registers, and in global memory
        x = torch.tensor(np.random.default_rng(rows).standard_normal((rows, 32)), device=cuda)
        vr, t = tq.leaf_qr(x)
        vr2, t2 = tq.leaf_qr(x)
        assert torch.equal(vr, vr2) and torch.equal(t, t2)


def test_leaf_launch_is_the_panel_launch_of_the_transpose(cuda):
    """The same reflectors from the same arithmetic on the same launch shape:
    the tall launch gives the panel launch's bits, transposed, and counts
    as a leaf launch only."""
    x = torch.tensor(np.random.default_rng(7).standard_normal((3586, 32)), device=cuda)
    panel_before, leaf_before = tq.panel_lq.launches, tq.leaf_qr.launches
    vr, t = tq.leaf_qr(x)
    assert (tq.panel_lq.launches, tq.leaf_qr.launches) == (panel_before, leaf_before + 1)
    lv, tT = tq.panel_lq(x.T.contiguous(), 0)
    assert torch.equal(vr, lv.T) and torch.equal(t, tT.T)


def test_blocked_qr_r_of_the_step_pre_array_matches_the_gram(cuda):
    A = torch.tensor(np.random.default_rng(2).standard_normal((3586, 2050)), device=cuda)
    before = tq.leaf_qr.launches
    R = tq.blocked_qr_r(A)
    assert tq.leaf_qr.launches == before + 65  # ceil(2050 / 32) leaves
    G = A.T @ A
    assert ((R.T @ R - G).abs().max() / G.abs().max()).item() <= 1e-12
    assert torch.all(torch.tril(R, -1) == 0).item()


def test_blocked_qr_r_with_leaf_128_makes_one_launch_per_block(cuda):
    A = torch.tensor(np.random.default_rng(3).standard_normal((3586, 2050)), device=cuda)
    before = tq.leaf_qr.launches
    R = tq.blocked_qr_r(A, leaf=128)
    assert tq.leaf_qr.launches == before + 17  # 16 blocks of 128 columns, then 2
    G = A.T @ A
    assert ((R.T @ R - G).abs().max() / G.abs().max()).item() <= 1e-12
    assert torch.all(torch.tril(R, -1) == 0).item()


def test_leaf_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((40, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tq.leaf_qr(x.to(torch.float16))
    with pytest.raises(ValueError):
        tq.leaf_qr(x.T)  # not contiguous
    with pytest.raises(ValueError):
        tq.leaf_qr(torch.zeros((200, 129), dtype=torch.float64, device=cuda))  # > 128 columns
    with pytest.raises(ValueError):
        tq.leaf_qr(torch.zeros((4, 8), dtype=torch.float64, device=cuda))  # rows < cols


# --- the MOL baseline, the smoother and the calibration ---------------------


def test_mol_ek1_and_smoother_keep_their_outputs_on_the_card(cuda):
    """The MOL EK1 (both entry points) on heat.to_ivp() and the RTS smoother of a
    white solve: every output is a CUDA tensor, and none is NaN."""
    heat = pt.examples.heat_1d_discretized(dx=0.1, tmax=0.5, device=cuda)
    ivp = heat.to_ivp()
    assert ivp.y0.device == ivp.f(0.0, ivp.y0).device == ivp.df(0.0, ivp.y0).device == cuda
    mol = pt.odetools.ek1.ReferenceEK1ConstantDiffusion(
        num_derivatives=2, steprule=pt.odetools.step.Constant(0.1),
        initialization=pt.odetools.init.TaylorMode())
    sol, sigma_sq = mol.solve(ivp)
    final, _ = mol.simulate_final_state(ivp)
    adaptive, _ = pt.odetools.ek1.ReferenceEK1ConstantDiffusion(
        num_derivatives=2, initialization=pt.odetools.init.Stack()).solve(ivp)
    ref = pt.odetools.reference_solver.solve_ivp_dopri5(ivp.f, ivp.t_span, ivp.y0, [0.5])
    solver = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.1))
    smoothed = pt.solvers.smoothing.smooth_solution(solver, solver.solve(heat))
    outputs = [sol.t, sol.mean, sol.cov_sqrtm, sigma_sq, final.y.mean, final.y.cov_sqrtm,
               adaptive.mean, ref.y, smoothed.mean, smoothed.cov_sqrtm]
    for out in outputs:
        assert out.device == cuda and not torch.isnan(out).any()
    torch.testing.assert_close(sol.mean[-1, 0], ref.y[-1], rtol=1e-3, atol=1e-6)


def test_mle_grid_launches_the_gram_kernel_once_per_trial(cuda):
    """Figure 2's target on 512 points: each trial's 512 x 512 Gram takes the
    kernel (Python-float scales); the chosen trial is the plain route's."""
    X = torch.linspace(0.0, 1.0, 512, dtype=torch.float64, device=cuda)[:, None]
    y = torch.sin(X[:, 0] ** 2)
    trials = torch.logspace(-3, 3, 20, dtype=torch.float64)
    before = tgram.gram_radial.launches
    best = pt.kernels.mle_input_scale(mesh_points=X, data=y,
                                      kernel_type=pt.kernels.SquareExponential,
                                      input_scale_trials=trials)
    assert tgram.gram_radial.launches == before + 20
    plain = torch.stack([pt.kernels.log_likelihood(tgram.gram_radial_reference(
        X, X, float(s), 1.0, phi_name="squared_exponential"), y, 512) for s in trials])
    plain = torch.where(torch.isnan(plain), -float("inf"), plain)
    assert float(best) == float(trials[int(torch.argmax(plain))])


def test_log_likelihood_masks_a_singular_gram(cuda):
    """cholesky_ex's info marks the failed factorization: NaN, where
    torch.linalg.cholesky would raise, on the card as on the CPU."""
    ones = torch.ones((64, 64), dtype=torch.float64, device=cuda)
    y = torch.linspace(0.0, 1.0, 64, dtype=torch.float64, device=cuda)
    value = pt.kernels.log_likelihood(ones, y, 64)
    assert value.device == cuda and torch.isnan(value)
    finite = pt.kernels.log_likelihood(ones + 63.0 * torch.eye(64, dtype=torch.float64,
                                                              device=cuda), y, 64)
    assert torch.isfinite(finite)


# --- steady-state mode ------------------------------------------------------


@pytest.mark.parametrize("kind", ["white", "latent"])
def test_steady_state_through_the_panel_kernel_matches_the_plain_path(cuda, kind):
    """Steady state at dx = 0.05 (one 128-row panel per sweep) through
    "householder" and through the plain path: the same polish iterations,
    cov_inf Grams and gains within 1e-8, the white seed's SDA iterations
    equal, and the panel kernel launched by the kernel path only."""
    heat = pt.examples.heat_1d_discretized(dx=0.05, tmax=0.2, device=cuda)
    cls = pt.white.LinearWhiteNoiseEK1 if kind == "white" else pt.latent.LinearLatentForceEK1
    runs = {}
    for factorization in ("householder", None):
        solver = cls(steprule=pt.odetools.step.Constant(0.01), steady_state=True,
                     factorization=factorization)
        before = tq.panel_lq.launches
        sol = solver.solve(heat)
        torch.cuda.synchronize()
        runs[factorization] = (solver, sol, tq.panel_lq.launches - before)
    (hh, hh_sol, hh_launches), (plain, plain_sol, plain_launches) = runs["householder"], runs[None]
    assert hh_launches > 0 and plain_launches == 0
    a, b = hh.steady_cache, plain.steady_cache
    assert a.iterations == b.iterations and a.cov_inf.device == cuda
    if kind == "white":
        assert hh.steady_diagnostics["sda_iterations"] == plain.steady_diagnostics["sda_iterations"]
        assert hh.steady_diagnostics["dare_residual"] < 1e-6

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max()).item()

    assert rel(a.cov_inf @ a.cov_inf.T, b.cov_inf @ b.cov_inf.T) <= 1e-8
    assert rel(a.L21 @ a.Sl_inv, b.L21 @ b.Sl_inv) <= 1e-8
    assert torch.isfinite(hh_sol.mean).all() and hh_sol.mean.device == cuda
    assert rel(hh_sol.mean[..., :21], plain_sol.mean[..., :21]) <= 1e-8


@pytest.mark.parametrize("solver", ["qr", "chol"])
def test_sda_on_the_card_matches_the_cpu(cuda, solver):
    """The doubling on CUDA tensors against the same doubling on the CPU:
    equal iterations, sigma within rel 1e-10, the certificate below 1e-10."""
    rng = np.random.default_rng(7)
    D = 48
    M = rng.standard_normal((D, D))
    A = 0.9 * M / np.abs(np.linalg.eigvals(M)).max()
    Gh, Qh = rng.standard_normal((D, D)), rng.standard_normal((D, D))
    G, Q = Gh @ Gh.T / D + 0.1 * np.eye(D), Qh @ Qh.T / D + 0.1 * np.eye(D)
    cpu = pt.ops.dare.sda(*(torch.tensor(x) for x in (A, G, Q)), tol=1e-13, solver=solver)
    gpu_inputs = [torch.tensor(x, device=cuda) for x in (A, G, Q)]
    gpu = pt.ops.dare.sda(*gpu_inputs, tol=1e-13, solver=solver)
    assert gpu.sigma.device == cuda and gpu.iterations == cpu.iterations
    rel = ((gpu.sigma.cpu() - cpu.sigma).abs().max() / cpu.sigma.abs().max()).item()
    assert rel <= 1e-10
    assert pt.ops.dare.dare_residual(gpu.sigma, *gpu_inputs).item() < 1e-10


ND_RECIPES = {  # dx-adapted kernels: well-conditioned stencil Grams
    "heat-2d-neumann": lambda dev: pt.examples.heat_2d_discretized(
        num_points=(12, 12), bcond="neumann", stencil_size_interior=9,
        stencil_size_boundary=9, kernel=pt.kernels.SquareExponential(input_scale=0.5 * 11),
        tmax=0.5, device=dev),
    "advection-3d": lambda dev: pt.examples.advection_diffusion_discretized(
        dim=3, num_points=(6, 6, 6), stencil_size_interior=7, stencil_size_boundary=7,
        kernel=pt.kernels.SquareExponential(input_scale=0.5 * 5), velocity=[1.0, 0.5, 0.25],
        device=dev),
    "fisher-kpp-neumann": lambda dev: pt.examples.fisher_kpp_2d_discretized(
        num_points=(8, 8), bcond="neumann",
        kernel=pt.kernels.SquareExponential(input_scale=0.5 * 7), device=dev),
}


@pytest.mark.parametrize("name", sorted(ND_RECIPES))
def test_nd_recipes_on_the_card_match_the_cpu(cuda, name):
    """The n-D discretizations (k-NN, FD, the n-D Neumann operator) on CUDA
    tensors against the same recipe on the CPU: each product within 1e-10
    of its largest entry."""
    gpu, cpu = ND_RECIPES[name](cuda), ND_RECIPES[name]("cpu")
    assert gpu.dimension == 2
    for attr in ("L", "E_sqrtm", "B", "R_sqrtm", "y0"):
        got, want = getattr(gpu, attr), getattr(cpu, attr)
        assert got.device == cuda and got.shape == want.shape
        assert (got.cpu() - want).abs().max().item() <= 1e-10 * want.abs().max().item()


def test_nd_neumann_heat_through_the_panel_kernel_matches_the_plain_path(cuda):
    """The 12 x 12 no-flux heat (d = 144, m = 188, nu = 2: init 476 rows, 4
    panels; steps 620 rows, 5 panels) through "householder" and the plain
    path: 4 + 5 x 10 launches, means and Grams within 1e-10."""
    heat = ND_RECIPES["heat-2d-neumann"](cuda)
    sols = {}
    for factorization in ("householder", None):
        before = tq.panel_lq.launches
        sols[factorization] = pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(0.05), factorization=factorization).solve(heat)
        torch.cuda.synchronize()
        assert tq.panel_lq.launches - before == (54 if factorization else 0)
    (a, b) = sols["householder"], sols[None]
    assert torch.isfinite(a.mean).all() and a.mean.device == cuda

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max()).item()

    assert rel(a.mean, b.mean) <= 1e-10
    assert rel(a.cov_sqrtm[-1] @ a.cov_sqrtm[-1].T, b.cov_sqrtm[-1] @ b.cov_sqrtm[-1].T) <= 1e-10


def test_radial_kernel_dispatches_2d_and_3d_grams_to_the_kernel(cuda):
    for dim in (2, 3):
        X = torch.rand((600, dim), dtype=torch.float64, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(dim))
        k = pt.kernels.Matern52(input_scale=4.0)
        before = tgram.gram_radial.launches
        gram = k(X, X.T)
        assert tgram.gram_radial.launches == before + 1
        torch.testing.assert_close(
            gram, tgram.gram_radial_reference(X, X, 4.0, 1.0, phi_name="matern52"),
            rtol=0, atol=1e-12)


def _sharded_step_rank(payload, device):
    """One rank of the sharded-step checks: the distributed-QR white step
    (fused, or the two-QR split) at N=512 on the card against the plain
    fused step on the same state."""
    from pnmol_tpu_torch.parallel import distributed, sharded_filter

    torch.set_num_threads(1)
    mesh = distributed.global_mesh(batch=1)
    heat = pt.pde.examples.heat_1d_discretized(dx=1.0 / 511, tmax=1.0, device=device)
    solver = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(1e-3))
    state = solver.initialize(heat)
    plain = solver._step_fn(state.y.mean, state.y.cov_sqrtm, 1e-3, 1e-3)
    two_qr = payload["two_qr"]
    cache = sharded_filter.shard_cache(solver._cache, mesh, distributed_qr=True,
                                       shard_operands=two_qr)
    step = sharded_filter.make_space_sharded_white_step(
        cache=cache, num_derivatives=2, mesh=mesh, distributed_qr=True, two_qr=two_qr,
        panel_size=256)
    mesh.reset_counts()
    got = step(state.y.mean, mesh.shard(state.y.cov_sqrtm, sharded_filter.cov_layout(True)),
               1e-3, 1e-3)
    D = state.y.cov_sqrtm.shape[0]
    sizes = [D // mesh.shape["space"]] * mesh.shape["space"]
    cov = mesh.gather_rows(got[1].T, sizes).T
    return dict(
        device=str(got[0].device),
        mean=(got[0] - plain[0]).abs().max().item() / plain[0].abs().max().item(),
        gram=((cov @ cov.T - plain[1] @ plain[1].T).abs().max()
              / (plain[1] @ plain[1].T).abs().max()).item(),
        diff=abs(got[4].item() - plain[4].item()) / plain[4].item(),
        staged=mesh.staged_bytes, schedule=mesh.totals(),
    )


@pytest.mark.parametrize("backend, ranks, two_qr", [("nccl", 1, False), ("nccl", 1, True),
                                                    ("gloo", 2, False)],
                         ids=["nccl-fused", "nccl-two-qr", "gloo-two-ranks"])
def test_sharded_step_on_the_card_matches_the_plain_step(cuda, backend, ranks, two_qr):
    from pnmol_tpu_torch.parallel import distributed

    runs = distributed.spawn_ranks(_sharded_step_rank, ranks, backend=backend, device="cuda:0",
                                   payload={"two_qr": two_qr}, timeout=600)
    for got, _ in runs:
        assert got["device"] == "cuda:0"
        assert got["mean"] < 1e-10 and got["diff"] < 1e-8
        assert got["gram"] < 1e-6
        # gloo stages every collective's CUDA operand through host memory
        assert (got["staged"] > 0) == (backend == "gloo")
        assert got["schedule"]["all-reduce"] > 0


@pytest.mark.parametrize("route", ["panel_lq", "leaf_lq", "leaf_qr"])
def test_kernel_routes_raise_under_autograd_on_the_card(cuda, route):
    """The kernel has no backward: a slab that autograd records through
    raises before any launch, naming the plain factorization."""
    slab = torch.tensor(np.random.default_rng(2).standard_normal((32, 600)), device=cuda,
                        requires_grad=True)
    calls = {"panel_lq": lambda x: tq.panel_lq(x, 0), "leaf_lq": lambda x: tq.leaf_lq(x, 0),
             "leaf_qr": lambda x: tq.leaf_qr(x.T.contiguous())}
    wrapper = getattr(tq, route)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="no backward.*factorization=None"):
        calls[route](slab)
    assert wrapper.launches == before
    with torch.no_grad():
        calls[route](slab)
    assert wrapper.launches == before + 1


def _gradient(device, factorization=None):
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=device)
    solver = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(0.1),
                                          spatial_kernel=pt.kernels.Matern52()
                                          + pt.kernels.WhiteNoise())
    state = solver.initialize(heat)
    base = heat.L / heat.diffop_scale
    scale = torch.tensor(0.035, dtype=torch.float64, device=device, requires_grad=True)
    cache = solver._cache._replace(L=scale * base)
    mean, cov = state.y.mean, state.y.cov_sqrtm
    for k in range(1, 6):
        mean, cov, *_ = pt.white.white_attempt_step(cache, mean, cov, 0.1 * k, 0.1,
                                                    num_derivatives=2,
                                                    factorization=factorization)
    return torch.autograd.grad((mean[0] ** 2).sum(), scale)[0].item()


def test_gradient_through_plain_steps_on_the_card_matches_the_cpu(cuda):
    """Gradients through 5 plain white steps on the card equal the CPU's;
    through the Householder panel route they raise."""
    g = _gradient(cuda)
    assert abs(g - _gradient("cpu")) <= 1e-10 * abs(g)
    with pytest.raises(RuntimeError, match="no backward"):
        _gradient(cuda, tq.make_householder_lq_factorization())


def test_checkpoint_round_trip_keeps_the_card(cuda, tmp_path):
    from pnmol_tpu_torch.utils import checkpoint

    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.3, device=cuda)
    final, _ = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1)).simulate_final_state(heat)
    checkpoint.save_state(tmp_path / "state", final)
    restored, _ = checkpoint.load_state(tmp_path / "state", device=cuda)
    assert restored.y.mean.device == final.y.mean.device
    assert torch.equal(restored.y.mean, final.y.mean)
    assert torch.equal(restored.y.cov_sqrtm, final.y.cov_sqrtm)


def _sharded_steady_rank(payload, device):
    """One NCCL rank: the seeded sharded steady state at N = 128 and 8
    sharded mean-only steps, against the single-GPU steady mode."""
    from pnmol_tpu_torch.parallel import distributed, sharded_filter

    mesh = distributed.global_mesh(batch=1)
    dx = 1.0 / 127
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=0.08, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device=device)
    solver = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(1e-2),
                                          steady_state=True)
    state = solver.initialize(heat)
    cache = sharded_filter.shard_cache(solver._cache, mesh, distributed_qr=True)
    steady = sharded_filter.converge_space_sharded_steady_state(
        cache=cache, cov0=state.y.cov_sqrtm, dt=1e-2, num_derivatives=2, mesh=mesh, max_iters=4)
    placed = sharded_filter.shard_steady_cache(steady, mesh)
    mean, _ = sharded_filter.make_space_sharded_steady_solve(
        cache=cache, steady=placed, num_derivatives=2, mesh=mesh, dt=1e-2, num_steps=8)(
        state.y.mean, 0.0)
    step = pt.white.make_steady_state_white_step(cache=solver._cache, steady=placed.local,
                                                 num_derivatives=2)
    ref, got = solver.steady_cache, steady.local
    frozen, full, cov = state.y.mean, state.y.mean, ref.cov_inf
    for k in range(1, 9):
        frozen = step(frozen, None, k * 1e-2, 1e-2)[0]
        full, cov, *_ = pt.white.white_attempt_step(solver._cache, full, cov, k * 1e-2, 1e-2,
                                                    num_derivatives=2)
    final, _ = solver.simulate_final_state(heat)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    G, G_ref = got.cov_inf @ got.cov_inf.T, ref.cov_inf @ ref.cov_inf.T
    return dict(device=str(mean.device), solve=rel(mean, frozen), trajectory=rel(mean, final.y.mean),
                frozen_gap=rel(final.y.mean, full),
                gram_excess=((G - G_ref).abs() - 1e-4 - 5e-3 * G_ref.abs()).max().item())


def test_sharded_steady_state_on_the_card_matches_the_single_gpu(cuda):
    """The sharded solve is the frozen recursion of its own blocks; against
    the single-GPU steady mode, the Gram of cov_inf holds the JAX package's
    tolerances (rtol 5e-3, atol 1e-4), and the frozen trajectory stays
    closer than the single-GPU frozen gain's own gap to full steps seeded at
    its cov_inf (the gain is not held: tests/torch_steady_gain_spread.py)."""
    from pnmol_tpu_torch.parallel import distributed

    (got, _), = distributed.spawn_ranks(_sharded_steady_rank, 1, backend="nccl",
                                        device="cuda:0", timeout=600)
    assert got["device"] == "cuda:0"
    assert got["solve"] <= 1e-12
    assert got["gram_excess"] <= 0.0
    assert got["trajectory"] <= got["frozen_gap"]


def test_figure4_corner_on_the_card_matches_the_committed_results(cuda):
    """Figure 4's driver at dx = 0.2 and the four largest step sizes on the
    card through the panel kernel: the committed JAX arrays (read as data)
    at the CPU test's tolerances (step counts equal, RMSE and chi2 1e-6),
    and one panel launch for the initialization and for each step of the
    two PNMOL solvers (every pre-array fits one 128-row panel)."""
    from pnmol_tpu_torch.experiments import figure4

    results = pathlib.Path(__file__).resolve().parent.parent / "experiments" / "results"
    before = tq.panel_lq.launches
    arrays = figure4.run(cuda, dxs=[0.2], dts=figure4.default_dts(False)[:4])
    launches = tq.panel_lq.launches - before
    steps = 0
    for method in figure4.METHODS:
        for metric in ("rmse", "chi2", "nsteps"):
            want = np.load(results / "figure4" / f"dx_0.2_{method}_{metric}.npy")[:4]
            got = arrays[f"dx_0.2_{method}_{metric}"]
            if metric == "nsteps":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        if method != "mol":
            steps += int(arrays[f"dx_0.2_{method}_nsteps"].sum())
    assert launches == 2 * 4 + steps


def test_work_precision_lv_row_on_the_card_matches_the_cpu(cuda):
    """The work-precision driver's Lotka-Volterra row at dt 0.316 on the
    card (the panel kernel: 5 panels for the initialization and 7 for each
    of the 4 steps) against the same row on the CPU (plain QRs), both
    against the committed reference: the step counts equal, the relative
    RMSE within 1e-6 and the chi2 within 2e-4 relative, the CPU test's
    tolerances against the committed rows. Each device assembles the
    default SquareExponential() stencils on dx = 0.01, whose Grams are near
    singular, with its own rounding: on an NVIDIA H100 80GB HBM3 the two
    RMSEs read 5.0e-8 apart."""
    from pnmol_tpu_torch.experiments import common, work_precision

    rows = {}
    for device in (torch.device("cpu"), cuda):
        problem = work_precision.Problem("lv", None, device)
        u_ref, _ = work_precision.reference(problem)
        rows[device.type] = work_precision.solve_row(
            problem, 0.316, u_ref, common.default_factorization(device), device.type)
    got, want = rows["cuda"], rows["cpu"]
    assert got["launches"] == {"panel_lq": 5 + 7 * 4, "leaf_lq": 0}
    assert got["num_steps"] == want["num_steps"] == 4
    for key, rtol in (("rmse_rel", 1e-6), ("chi2", 2e-4)):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0, err_msg=key)


def test_f32_bench_configuration_on_the_card_matches_the_cpu(cuda):
    """The bench configuration under the f32 policy (built, initialized and
    stepped in f32; 64 points, 20 steps) through the panel kernel's f32
    instantiation on the card against the plain path on the CPU: every state
    tensor f32, the solution u 1e-4 apart (the two f32 assemblies of L part
    by their rounding; the port and the JAX package on the CPU: 9e-6)."""
    previous = pt.config.enable_x64(False)
    try:
        finals = {}
        for device, factorization in ((cuda, "householder"), ("cpu", None)):
            dx = 1.0 / 63
            heat = pt.pde.examples.heat_1d_discretized(
                dx=dx, tmax=0.02, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
                device=device)
            before = tq.panel_lq.launches
            final, _ = pt.white.LinearWhiteNoiseEK1(
                steprule=pt.odetools.step.Constant(1e-3), num_derivatives=2,
                spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
                factorization=factorization).simulate_final_state(heat)
            assert (tq.panel_lq.launches > before) == (device == cuda)
            assert {final.y.mean.dtype, final.y.cov_sqrtm.dtype} == {torch.float32}
            finals[device] = final.y.mean.cpu()
    finally:
        pt.config.enable_x64(previous)
    u_card, u_cpu = finals[cuda][0], finals["cpu"][0]
    assert ((u_card - u_cpu).abs().max() / u_cpu.abs().max()).item() < 1e-4
