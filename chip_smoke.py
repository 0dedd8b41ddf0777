"""Smoke run of the PyTorch/CUDA port (pnmol_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the panel-LQ kernel from ``pnmol_tpu_torch/csrc``;
3. kernel: the CUDA panel kernel against its plain PyTorch version on the
   card (f64, random slabs at the solver's shapes), a full blocked LQ of the
   2050 x 3586 step pre-array, and both versions' times;
4. golden: the dx = 0.2 heat solve through the kernel against
   ``tests/golden/heat_trajectories.npz``;
5. full width: the bench configuration (N = 512, nu = 2, f64): initialize
   and 20 steps through the kernel path, counting its launches, then the
   same run on the plain ``torch.linalg.qr`` path, and the two compared.

The last lines are the kernels' JSON record, the card, and
``{"ok": true, "device": {...}}``. Imports neither JAX nor pnmol_tpu.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "heat_trajectories.npz"
N_POINTS, NU, DT, NUM_STEPS = 512, 2, 1e-3, 20
# panel launches of the kernel path at N = 512 with 128-row panels: the
# init LQ is 1538 x 1538 (13 panels), each step's is 2050 x 3586 (17)
EXPECTED_LAUNCHES = 13 + 17 * NUM_STEPS


def fail(message):
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(condition, message):
    if not condition:
        fail(message)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(tq, dev):
    rng = np.random.default_rng(0)
    cases = [
        ("rows 128, cols 3586, off 0 (step panel)", 128, 3586, 0, ()),
        ("rows 128, cols 3586, off 40", 128, 3586, 40, ()),
        ("rows 32, cols 3586, off 0 (leaf form)", 32, 3586, 0, ()),
        ("rows 128, cols 1538, rows 2.. zero (ragged)", 128, 1538, 0, range(2, 128)),
    ]
    worst = 0.0
    for name, rows, cols, off, zero_rows in cases:
        slab = rng.standard_normal((rows, cols))
        slab[list(zero_rows)] = 0.0
        x = torch.tensor(slab, device=dev)
        lv, tT = tq.panel_lq(x, off)
        torch.cuda.synchronize()
        lv_ref, tT_ref = tq.panel_lq_reference(x, off)
        err_lv = (lv - lv_ref).abs().max().item()
        err_t = (tT - tT_ref).abs().max().item()
        tol = 1e-12 * np.abs(slab).max()  # f64 rounding of one panel, with margin
        print(f"kernel vs plain, {name}: max|dLV| {err_lv:.3e}, max|dT^T| {err_t:.3e}"
              f" (tol {tol:.3e})", flush=True)
        check(np.isfinite(err_lv) and np.isfinite(err_t), f"{name}: non-finite output")
        check(err_lv <= tol and err_t <= tol, f"{name}: kernel disagrees with plain version")
        worst = max(worst, err_lv, err_t)

    W = torch.tensor(rng.standard_normal((2050, 3586)), device=dev)
    L = tq.blocked_lq_l(W)
    G = W @ W.T
    rel = ((L @ L.T - G).abs().max() / G.abs().max()).item()
    print(f"blocked_lq_l 2050 x 3586: max|L L^T - W W^T| / max|W W^T| = {rel:.3e}", flush=True)
    check(rel <= 1e-12, "blocked LQ Gram mismatch")
    check(torch.all(torch.triu(L, 1) == 0).item(), "blocked LQ factor not lower triangular")

    # times at the step's panel shape, in turns: plain, kernel, kernel, plain
    x = torch.tensor(rng.standard_normal((128, 3586)), device=dev)
    plain = [cuda_ms(lambda: tq.panel_lq_reference(x, 0), 3)]
    kernel = [cuda_ms(lambda: tq.panel_lq(x, 0), 20) for _ in range(2)]
    plain.append(cuda_ms(lambda: tq.panel_lq_reference(x, 0), 3))
    ms, plain_ms = sum(kernel) / 2, sum(plain) / 2
    print(f"panel 128 x 3586 f64: kernel {kernel} ms, plain {plain} ms", flush=True)
    leaf = torch.tensor(rng.standard_normal((32, 3586)), device=dev)
    print(f"panel 32 x 3586 f64 (leaf form): kernel "
          f"{cuda_ms(lambda: tq.panel_lq(leaf, 0), 20)} ms, plain "
          f"{cuda_ms(lambda: tq.panel_lq_reference(leaf, 0), 3)} ms", flush=True)
    return worst, ms, plain_ms


def phase_golden(pt, tq, dev):
    with np.load(GOLDEN) as data:
        golden = dict(data)
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=dev)
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.1),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
        factorization="householder",
    )
    before = tq.panel_lq.launches
    sol = solver.solve(heat)
    torch.cuda.synchronize()
    check(tq.panel_lq.launches - before == 6, "golden run did not go through the kernel")
    mean = sol.mean.cpu().numpy()
    diffusion = float(sol.diffusion_squared_calibrated)
    std = torch.sqrt(torch.einsum("ij,ij->i", sol.cov_sqrtm[-1], sol.cov_sqrtm[-1])).cpu().numpy()
    # thresholds of tests/test_golden.py
    ok_mean = np.allclose(mean, golden["white_mean"], rtol=1e-10, atol=1e-13)
    ok_diff = np.allclose(diffusion, golden["white_diffusion"], rtol=1e-10)
    ok_std = np.allclose(std, golden["white_final_std"], rtol=1e-8, atol=1e-12)
    print(f"golden dx=0.2 through the kernel: max|dmean| "
          f"{np.abs(mean - golden['white_mean']).max():.3e}, diffusion rel "
          f"{abs(diffusion / float(golden['white_diffusion']) - 1):.3e}, max|dstd| "
          f"{np.abs(std - golden['white_final_std']).max():.3e}", flush=True)
    check(ok_mean and ok_diff and ok_std, "golden trajectory mismatch")


def run_full_width(pt, heat, factorization):
    """initialize + NUM_STEPS steps through the user-facing generator."""
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(DT),
        num_derivatives=NU,
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
        factorization=factorization,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diffusions = []
    for state, info in solver.solution_generator(heat):
        torch.cuda.synchronize()
        if info["num_steps"] == 0:
            t_init = time.perf_counter()
            y0_mean = state.y.mean
        elif info["num_steps"] == 1:
            t_first = time.perf_counter()
        if info["num_steps"]:
            diffusions.append(state.diffusion_squared_local)
    t_end = time.perf_counter()
    check(info["num_steps"] == NUM_STEPS, f"ran {info['num_steps']} steps")
    return dict(
        state=state,
        y0_mean=y0_mean,
        diffusion=torch.stack(diffusions).mean(),
        init_s=t_init - t0,
        steps_per_s=NUM_STEPS / (t_end - t_init),
        steady_steps_per_s=(NUM_STEPS - 1) / (t_end - t_first),
    )


def phase_full_width(pt, tq, dev, card_line):
    dx = 1.0 / (N_POINTS - 1)
    heat = pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=NUM_STEPS * DT,
        kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx), device=dev,
    )
    tq.panel_lq.launches = 0
    hh = run_full_width(pt, heat, "householder")
    launches = tq.panel_lq.launches
    plain = run_full_width(pt, heat, None)
    check(tq.panel_lq.launches == launches, "the plain path launched the kernel")
    print(f"N={N_POINTS} kernel path: panel launches {launches} (expected {EXPECTED_LAUNCHES})",
          flush=True)
    check(launches == EXPECTED_LAUNCHES, "kernel launch count")

    for name, run in (("householder kernel", hh), ("plain torch.linalg.qr", plain)):
        mean, cov = run["state"].y.mean, run["state"].y.cov_sqrtm
        check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all()
                   and torch.isfinite(run["diffusion"])), f"{name}: NaN or inf")
        check(mean[0].abs().max() < run["y0_mean"][0].abs().max(), f"{name}: heat did not decay")
        print(f"N={N_POINTS} {name}: init {run['init_s']:.3f} s, {run['steps_per_s']:.2f} steps/s "
              f"over {NUM_STEPS} steps ({run['steady_steps_per_s']:.2f} after the first), "
              f"max|u| {run['y0_mean'][0].abs().max().item():.6f} -> "
              f"{mean[0].abs().max().item():.6f} [{card_line}]", flush=True)

    m1, m2 = hh["state"].y.mean, plain["state"].y.mean
    C1, C2 = hh["state"].y.cov_sqrtm, plain["state"].y.cov_sqrtm
    G1, G2 = C1 @ C1.T, C2 @ C2.T
    mean_rel = ((m1 - m2).abs().max() / m2.abs().max()).item()
    gram_rel = ((G1 - G2).abs().max() / G2.abs().max()).item()
    diff_rel = abs(hh["diffusion"].item() / plain["diffusion"].item() - 1)
    print(f"kernel path vs plain path after {NUM_STEPS} steps: mean rel {mean_rel:.3e}, "
          f"cov Gram rel {gram_rel:.3e}, diffusion rel {diff_rel:.3e}", flush=True)
    check(mean_rel <= 1e-8 and gram_rel <= 1e-8, "kernel path disagrees with the plain path")
    # looser: the diffusion whitens through the near-singular innovation
    # directions of the noise-free Dirichlet rows, which amplify rounding
    check(diff_rel <= 1e-6, "diffusion disagrees with the plain path")
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    card_line = card()
    print(f"card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    import pnmol_tpu_torch as pt
    from pnmol_tpu_torch.ops import qr_householder as tq

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = tq.build_panel_lq()
    tq._library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    worst, ms, plain_ms = phase_kernel(tq, dev)
    phase_golden(pt, tq, dev)
    launches = phase_full_width(pt, tq, dev, card_line)
    check("jax" not in sys.modules and "pnmol_tpu" not in sys.modules, "JAX was imported")

    print(json.dumps({"kernels": [{
        "name": "panel_lq",
        "route": "cuda",
        "source": "pnmol_tpu_torch/csrc/panel_lq.cu",
        "replaces": "pnmol_tpu/ops/qr_householder.py:535",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
