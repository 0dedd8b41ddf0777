"""Smoke run of the PyTorch/CUDA port (pnmol_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --figures    # phase P's drivers at full size: every
                                       # row of figures 3 (both routes) and 4
    python3 chip_smoke.py --drivers    # phase S's drivers at full size: every
                                       # work-precision dt, both latent rungs,
                                       # the seeded N = 1e4 decay, the 2-D and
                                       # 3-D scale_demo step points; phase X's
                                       # f32 work-precision legs and f32 decay

Phases (any failure exits non-zero; nothing is swallowed):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the two sources of ``pnmol_tpu_torch/csrc`` (one
   ``nvcc`` each, both started together), printing each build's time; they
   hold the three kernels (``panel_lq.cu`` the panel kernel, launched on the
   wide layout as ``panel_lq`` and on the tall one as ``leaf_qr``;
   ``gram_radial.cu`` the radial Gram);
3. kernel: the CUDA panel kernel against its plain PyTorch version on the
   card (f64, random slabs at the solvers' shapes, up to the latent step's
   128 x 6658 panel and its ragged 2-row last panel, and an all-zero panel),
   each launched twice with bitwise-equal results; full blocked LQs of the
   2050 x 3586 white and the 3586 x 6658 latent step pre-arrays against
   their Grams and cuSOLVER's QR; the panel's time by CTA count (the rule's
   choice, about 32, 66 and 131), each launch shape checked against the
   plain version first; and at 128 x 3586, 128 x 6658,
   32 x 3586 and 128 x 1538 the kernel's, plain version's and
   ``torch.geqrf``'s times beside the bound. Then the radial Gram kernel
   against its plain version (f64 and f32, ragged tiles, dim 1-3) and its
   times; the leaf launch against its plain version (f64 and f32, from the
   narrow last leaf to 6658 x 32, 3586 x 128 and the global-memory tier at
   20000 x 32), each launched twice with bitwise-equal results, and against
   the panel launch of the transpose; its time by CTA count at 3586 x 32;
   full blocked QRs of the 3586 x 2050 white and 6658 x 3586 latent R-form
   pre-arrays at leaf 32 and 128 against their Grams and cuSOLVER's QR;
   and the kernels', plain versions' and library's times beside their
   bounds. Then the leaf launch of the LQ leaf route (the panel kernel on
   a leaf, counted as ``leaf_lq``) against its plain version at the large-N
   shapes (64 x 20257 and 64 x 30002 in the global-memory tier, 32 x 26626),
   twice each with bitwise-equal results; full 256-row-block sweeps at leaf
   32 and 64 against their Grams and their launch counts; and the 64 x 20257
   and 64 x 30002 leaves' times beside the plain version's,
   ``torch.geqrf``'s and the bound;
4. golden: the dx = 0.2 heat solve against
   ``tests/golden/heat_trajectories.npz``, through the panel kernel and
   through the R-form hook (leaf kernel);
5. full width: the bench configuration (N = 512, nu = 2, f64): initialize
   and 20 steps through the panel-kernel path, counting its launches, then
   the same run on the plain ``torch.linalg.qr`` path, and the two compared;
6. collocation: the same heat problem at N = 512 with ``L`` and ``E_sqrtm``
   from global collocation (one radial-Gram kernel launch in the setup),
   initialize and 20 steps on the panel-kernel path and on the plain path;
7. R form: the phase-5 problem through the R-form Householder hook (leaf
   kernel), initialize and 20 steps at leaf 32 (1300 leaf launches: 65 per
   step, the init plain) and at leaf 128 (340: 17 per step), each against
   phase 5's plain run;
8. latent golden: the dx = 0.2 heat solve through ``LinearLatentForceEK1``
   against the golden's ``latent_mean``/``latent_diffusion``, through the
   panel kernel and through the R-form hook;
9. latent at full width: the phase-5 problem through
   ``LinearLatentForceEK1``, initialize and 20 steps on the panel-kernel
   path (601 launches: the 2562-row init LQ in 21 panels, each 3586 x 6658
   step pre-array in 29) and on the plain path, compared;
10. semilinear at full width: Lotka-Volterra on 256 points (d = 512, four
    Neumann rows) through ``SemiLinearWhiteNoiseEK1`` with a ``duplicate``
    prior, initialize and 20 steps on the panel-kernel path (353 launches)
    and on the plain path, compared;
11. adaptive: the phase-5 problem with ``Adaptive()`` defaults to tmax =
    0.1, on the panel-kernel path (13 + 17 x attempts launches) and on the
    plain path: equal step and attempt counts, landing on tmax, compared;
12. semilinear latent: Lotka-Volterra at dx = 0.1 through
    ``SemiLinearLatentForceEK1`` on the panel-kernel path and the plain
    path, compared;
13. latent R form: the phase-9 problem through the R-form hook, initialize
    and 20 steps (2260 leaf launches: each 6658 x 3586 step pre-array in
    28 x 4 + 1 = 113 leaves, the init plain), against phase 9's plain run;
14. latent d=2048: heat on 2048 points through ``LinearLatentForceEK1`` with
    ``"householder"`` (hooks sized for 4096 points: 256-row blocks on the
    leaf route, 32-row leaves), initialize and 2 steps, fused (1219 leaf
    launches) and two-QR banded (1987), no panel launch, against the plain
    path;
15. N=1e4 two-QR: ``bench.py``'s large-N point in f64 (N = 10000, nu = 1,
    ``Constant(1e-3)``): initialize and 5 steps through ``"householder"``,
    ``fused=False``, ``propagate_band="banded"`` (256-row blocks of 64-row
    leaves: 4379 leaf launches, no panel launch) and ``"interleaved"``
    (4379 + 313 for the initial factor's re-triangularization), against
    the plain two-QR path (``torch.linalg.qr`` of each pre-array); init
    seconds, steps/s, the sweeps of each path, and the peak memory;
16. (A) MOL baseline: the phase-5 problem's ``to_ivp()`` (d = 510) through
    ``odetools.ek1.ReferenceEK1ConstantDiffusion`` (``Stack``, 20 steps,
    plain QRs, no kernel launch), its init seconds and steps/s, against DP5
    on the card and phase 5's PNMOL mean; ``TaylorMode`` on the same IVP;
17. (B) smoothing: phase 5's panel-kernel run through ``solve`` (353
    launches), then ``solvers.smoothing.smooth_solution`` against a dense
    RTS oracle;
18. (P) the paper's figures through the port's drivers
    (``pnmol_tpu_torch/experiments``, each ``run`` on the card, whose PNMOL
    solvers take ``factorization="householder"``), every output held to
    the JAX package's committed arrays in ``experiments/results/`` at the
    tolerances of ``tests/test_torch_figure{1,2,3,4}.py``, with its
    seconds, steps and ``panel_lq`` launches: P1 figure 1 in full (heat d = 6, white, latent,
    MOL and DP5; 122 ``panel_lq``); P2 figure 2 in full (25 points, the
    150-point grid, the samples from JAX's noise, no kernel); P3 (was C)
    figure 4's dx = 0.01 row in full (Lotka-Volterra d = 202, 12 dts,
    tmax 6, latent, white and MOL; LSODA on d = 1398); P4 (was L) figure
    3's dx = 1/64 row in full (SIR d = 195, 18 dts, white and MOL; LSODA on
    d = 1917), the white solver sequentially (panel kernel) and as one
    batched sweep (plain QRs), held to each other as a kernel path is held to
    its plain path;
19. (D) calibration: ``kernels.mle_input_scale`` on a 512-point mesh (one
    radial-Gram launch per trial, 20) against the same grid through the
    plain Gram, then 100 Adam steps of ``mle_input_scale_gradient``;
20. (E) steady state at N = 512 (bench.py's steady configuration: nu = 2,
    ``Constant(1e-2)``, f64): the seeded white solver through
    ``"householder"`` and the plain path (the SDA seed on D = 1536, 4
    polish iterations, 512 mean-only steps: max|u| against the JAX
    package's 0.0405580823), the seconds of each initialization stage;
    the unseeded white solver to tol 1e-10 on the kernel path, held to its
    fixed point and to full steps seeded at it; the latent solver on both
    paths; mean-only steps/s through ``solution_generator`` and a bare loop
    beside the bytes bound;
21. (F) steady state at the N = 1e4 point (nu = 1, ``Constant(1e-2)``,
    ``"householder"``, ``fused=False``, ``propagate_band="banded"``, f64):
    the SDA seed's Cholesky body on D = 2e4, the polish and harvest on the
    leaf route, the stage seconds and the peak memory, the harvest against
    the plain two-QR path, 512 mean-only steps beside the 0.96 ms bound,
    and 3 full banded steps beside 3 frozen ones;
22. (G) heat 2-D at N = 1e4, the JAX package's 2-D scale point
    (``experiments/scale_demo.py:48-56``, f64): ``heat_2d_discretized`` on
    100 x 100 points (``SquareExponential(0.15/dx)``, 5-point stencils,
    nugget 1e-10; 396 boundary points, so m = 10396 and D = 2e4 at nu = 1),
    the discretization's seconds (k-NN and FD), then initialize and 3 steps
    of ``Constant(1e-3)`` on the banded leaf route (475 + 788 x 3 = 2839
    ``leaf_lq``) against the plain two-QR path: init seconds, steps/s, peak
    memory, one propagate and one update sweep by CUDA events, max|u| held
    to the direction of ``(L u0)``; then ``kernels.Matern52`` on the 1e4
    mesh points, one ``gram_radial`` launch, against its plain version
    (1e-12) and timed beside its 0.239 ms bound;
23. (H) advection-diffusion 3-D at 21^3 (``scale_demo.py:58-70``: velocity
    (1, 0.5, 0.25), kappa 0.05, 7-point stencils; 2402 boundary points, m =
    11663, D = 18522), as G: 472 + 762 x 3 = 2758 ``leaf_lq``, each path's
    peak under 80 GB;
24. (I) the 2-D problems below 4096 points on the block route: Fisher-KPP
    on 48 x 48 (d = 2304, m = 2492; diffusion 0.01, growth 3) through
    ``SemiLinearWhiteNoiseEK1``, nu = 2, 10 steps of 1e-3 (56 + 74 x 10 =
    796 ``panel_lq``; max u grows toward 1), and the no-flux heat of
    ``tests/test_neumann_nd.py`` on 24 x 24 through the n-D Neumann operator
    (9-point stencils, ``SquareExponential(0.05/dx)``; m = 668, D = 1728:
    15 + 19 x 10 = 205 panels; the spatial mean held to 20% while the spread
    falls), each against the plain path;
25. (J) the space-sharded tier on ONE NCCL rank (NCCL takes one rank per
    GPU), spawned by ``parallel.distributed.spawn_ranks``, at phase 15's
    N = 1e4 point (nu = 1): ``sharded_white_initialize`` and 3 steps of
    ``make_space_sharded_constant_solve(two_qr=True)`` on the cache placed
    by ``shard_cache(shard_operands=True)``, the counted collectives equal
    to ``comm_model``'s at P = 1, init seconds, steps/s and peak memory,
    against the plain single-GPU two-QR run of the same problem (1e-4);
26. (K) TWO gloo ranks sharing the card, every collective staged through
    host memory (the bytes printed), at the bench width: the distributed
    init and 20 fused distributed-QR steps, the same two-QR (collectives
    equal to the comm model at P = 2), the latent init and 2 steps, the
    adaptive solve to ADAPTIVE_TMAX (20 steps of 41 attempts, as phase 11),
    each against its single-GPU run (phases 5, 9 and 11; the adaptive one
    also against phase 11's solver with the distributed factorization on a
    one-rank mesh); then ``sharded_collocation_global`` at N = 1e4
    (``SquareExponential(1/dx)``, figure 2's nuggets), each rank's 5000 x
    1e4 Gram block on the Gram kernel (2 ``gram_radial``, counted in the
    ranks), against the single-GPU ``collocation_global`` within 10x the
    rounding floor of its distance-trick Grams;
27. (M, after phase 4) gradients: ``torch.autograd.grad`` through 5 plain
    white steps of the dx = 0.2 heat on the card against central
    differences (1e-4) and the CPU (1e-10); the Householder panel route
    must raise (no backward), before any launch;
28. (O, after phase 5) the utilities on phase 5's panel-kernel path:
    ``solve_resilient`` with a NaN injected at step 10 (one restart from the
    step-5 checkpoint at dt / 2: 40 attempts, 693 ``panel_lq``), a
    checkpoint round trip of the card's state (bitwise, device kept), the
    ``init_profile`` of ``initialize`` under ``PNMOL_INIT_PROFILE=1`` and
    ``time_blocked`` of one step (115 ``panel_lq``);
29. (E2, after E) the steady sharded tier on two gloo ranks at phase E's
    point: the seeded sharded steady state (its cov_inf Gram held to E's at
    the JAX test's rtol 5e-3, atol 1e-4; the mean after 512 frozen steps to
    E's at 1e-5; the gain printed), the sharded mean-only solve against the
    frozen recursion of its blocks, and the frozen-gain sweep of 3 dts over
    the batch axis against sequential steady solves (1e-10);
30. (N, after F) the steady sharded tier on one NCCL rank of this process
    at phase F's point: the distributed init, the row-sharded doubling seed
    (each doubling's collectives against ``comm_model``), 4 polish
    iterations, 20 mean-only steps; held to phase F's cache, moved to the
    host before N starts (the Gram within 10 polish deltas, the 20-step
    frozen mean at 1e-3; the gain printed). F and N print the live CUDA
    storages before their seeds and doublings; J prints its steps' split;
31. (S1) the work-precision driver (``experiments/work_precision.py``) on
    the card: ``lv`` (Lotka-Volterra d = 202, six dts) held to the
    committed CPU f64 rows of ``bench_artifacts/tpu_work_precision.json``
    (to the gap of the card's near-singular FD stencils),
    ``heat_512`` on the card's seven dts and ``heat_2048`` at dt 0.1 and
    0.05, their dt 0.1 rows held to JAX's; each row's relative RMSE, chi2,
    seconds, steps/s and ``panel_lq`` launches; each reference recomputed
    by the port's LSODA on the card and held to the committed one;
32. (S2) the steady probes: the decay at N = 512 (2048 mean-only steps)
    held to ``bench_artifacts/steady_decay_probe_f64_n512.json``; the decay
    at N = 1e4 through ``measure`` on phase F's solver (run inside F,
    printed, no PDE decay held at this mesh); the error probe at the
    committed configuration held to every row of
    ``bench_artifacts/steady_error_probe.json``;
33. (S3) the scale demo: the latent N-ladder's rung N = 4096 at nu = 1
    (4097 points, stacked state 16388; two-QR banded on the leaf route,
    two calls of 3 steps: init seconds, steps/s, peak memory),
    its first step held to the plain two-QR path's (phase 14's
    tolerances); ``gram --n 10000``, K3 against its plain version in f64
    (1e-12) and f32 (1e-5);
34. (X) the f32 precision policy (``PNMOL_TPU_X32``'s, switched at run
    time by ``config.enable_x64`` around each run): X0 the f32 launches of
    K1, K2 and K4 against their plain versions at the f32 solver shapes,
    bitwise repeatable, and their times beside the f32 bound and
    ``torch.geqrf``'s; X1 the JAX bench's configuration in f32 end to end
    (N = 512: mesh, FD, init and 20 steps on K1, 353 launches, and on the
    plain path), held to each other and to phase 5's f64 run, the f32
    steps on phase 5's f64 init with its cache cast to f32 (the JAX f32
    test's pattern) held to its f64 steps, and TF32 trailing updates
    (``precision="default"``), with steps/s and init seconds beside phase
    5's; X2 the latent solver in f32 on K1 (601) and plain, and its f32
    steps on a cast cache (the covariance held to the f64 steps'); X3 the
    R form at leaf 128 on K4 in f32 (340); X4 the N = 1e4 point in f32
    (two-QR banded on K2), init and 3 steps, steps/s and peak memory beside
    phase 15's, the first step against the plain f32 path; X5 the seeded
    steady state at N = 512 in f32 (the f32 recursion's seed raises, as the
    JAX package's is NaN) and promoted to f64, on the f32 problem (held to
    the CPU's run on the same operators) and on phase E's problem cast to
    f32 (max|u| held to phase E's), mean-only steps/s.
    ``--drivers`` adds the f32 work-precision legs (each row beside the
    card's f64 row) and the f32 decay at N = 1e4 (the recursion in f64).

At the meshes of phases 14 and 15 the heat does not decay: the FD
operator's row sum at the initial peak is positive, so ``(L u0)`` points up
there, and the FD error covariance (the filter's measurement noise) dwarfs
it, so the filter's initial derivative is that value shrunk about 1700-fold
at 2048 points and max|u| rises by about ``dt`` times it a step, as in the
JAX package (``tests/test_torch_fine_mesh.py``). There, and in phases G
and H, max|u| is held to the direction both point in.

Every path's launch counts are set to 0 just before it and read just after;
the kernels' ``launches`` are the sums over the paths, with the launches
that spawned ranks count in their own processes and report. Each group of
phases prints its seconds ("time: phases ..."). The last lines are the
kernels' JSON record, the card, and ``{"ok": true, "device": {...}}``.
Imports neither JAX nor pnmol_tpu, and reads the JAX package's committed
figure arrays and ``bench_artifacts/`` records only as data.
"""
import concurrent.futures
import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import types

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "heat_trajectories.npz"
N_POINTS, NU, DT, NUM_STEPS = 512, 2, 1e-3, 20
# panel launches of the kernel path at N = 512 with 128-row panels: the
# init LQ is 1538 x 1538 (13 panels), each step's is 2050 x 3586 (17)
EXPECTED_LAUNCHES = 13 + 17 * NUM_STEPS
# leaf launches of the R-form path at N = 512: the initialization stays on
# the plain update; each step's pre-array is 3586 x 2050, swept in 32-column
# leaves (16 blocks of 4 leaves, then one leaf of the last 2 columns), or in
# 128-column leaves (one per block: 16, then 1)
EXPECTED_LEAF_LAUNCHES = -(-2050 // 32) * NUM_STEPS
EXPECTED_LEAF128_LAUNCHES = -(-2050 // 128) * NUM_STEPS
# the latent R form: each step's 6658 x 3586 pre-array in 28 blocks of 4
# leaves, then one leaf of the last 2 columns
EXPECTED_LATENT_LEAF_LAUNCHES = (28 * 4 + 1) * NUM_STEPS
# the latent solver at N = 512 (m = 514 measurement rows): the init LQ has
# m + 4N = 2562 rows (21 panels), each step's m + 6N = 3586 (29 panels)
EXPECTED_LATENT_LAUNCHES = 21 + 29 * NUM_STEPS
# Lotka-Volterra on 256 points: d = 512, m = 516; init 1540 rows (13
# panels), steps 2052 (17)
LV_POINTS = 256
EXPECTED_LV_LAUNCHES = 13 + 17 * NUM_STEPS
# the adaptive run: 20 accepted steps of 41 attempts on the CPU (JAX and the
# port alike); every attempt factorizes the white step's pre-array
ADAPTIVE_TMAX = 0.1
# the large-N phases: 256-row blocks on the leaf route. Latent heat on 2048
# points (m = 2050; the hooks sized for the stacked 4096 points: 32-row
# leaves), 2 steps; the white heat at N = 1e4, nu = 1 (m = 10002, D = 2e4:
# 64-row leaves), 5 steps
LATENT_LARGE_POINTS, LATENT_LARGE_STEPS = 2048, 2
LARGE_N, LARGE_NU, LARGE_STEPS = 10000, 1, 5
# the calibration: figure 2's grid search on a 512-point mesh
MLE_POINTS, MLE_TRIALS = 512, 20
# steady state: bench.py's steady configuration (dt 1e-2) at N = 512 and at
# the N = 1e4 point, 512 mean-only steps each; the JAX package's values at
# N = 512 on the CPU (f64): 14 SDA iterations, 4 polish iterations, max|u|
# 0.0999994 -> 0.0405580823 after 512 steps
STEADY_DT, STEADY_STEPS = 1e-2, 512
JAX_STEADY_SDA_ITERATIONS, JAX_STEADY_MAX_U = 14, 0.0405580823
STEADY_UNSEEDED = {"seed": False, "tol": 1e-10, "max_iters": 3000}
# the n-D problems: the 2-D heat at the JAX package's 2-D scale point
# (100 x 100, N = 1e4) and the 3-D advection-diffusion at its largest
# single-chip rung (21^3), 3 steps each at nu = 1; Fisher-KPP on 48 x 48
# and the Neumann heat on 24 x 24 at nu = 2, 10 steps each
HEAT2D_SIDE, ADVECTION_SIDE, ND_STEPS = 100, 21, 3
FKPP_SIDE, FKPP_STEPS = 48, 10
NEUMANN_SIDE, NEUMANN_STEPS, NEUMANN_DT = 24, 10, 0.05
# the source of each kernel: the leaf QR is the panel kernel on the tall
# layout, the LQ leaf the panel kernel on a leaf of a block
SOURCES = {"panel_lq": "panel_lq", "leaf_lq": "panel_lq", "gram_radial": "gram_radial",
           "leaf_qr": "panel_lq"}


def leaf_launches(rows, block, leaf):
    """Leaf launches of one LQ sweep of ``rows`` rows on the leaf route:
    ``ceil(rows / block)`` blocks of ``ceil(b / leaf)`` leaves."""
    return sum(-(-min(block, rows - i) // leaf) for i in range(0, rows, block))


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


def issue_ms(fn, reps):
    """The host's time to issue one call (no synchronization inside it), the
    least of ``reps`` calls each started on an idle card: about the call's
    device time where the host is what holds it back."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return min(times)


# the card's peaks for the bounds (NVIDIA's H100 SXM data sheet, dense, at
# 700 W): HBM bandwidth; FP64 on the tensor cores (full FP64 precision,
# twice the 34 TFLOP/s outside them) and FP32 outside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}


def bound(ops, nbytes, dtype):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory rate
    and the operations over the peak rate of ``dtype``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def panel_bound(rows, cols, off, dtype):
    """Bound of one Householder LQ panel: reflector k's norm and scaling
    (3 t flops on its tail of t lanes), its dot with every other row and the
    update of the rows below (2 (t + 1) each), and row k of T^T (k (k + 1));
    the slab read once, LV and T^T written once."""
    ops = 0
    for k in range(rows):
        t = cols - off - k - 1
        ops += 3 * t + (2 * rows - 2 - k) * 2 * (t + 1) + k * (k + 1)
    item = torch.finfo(dtype).bits // 8
    return bound(ops, (2 * rows * cols + rows * rows) * item, dtype)


def leaf_bound(rows, cols, dtype):
    """Bound of one tall Householder QR slab (the panel's count, transposed)."""
    ops = 0
    for k in range(cols):
        t = rows - k - 1
        ops += 3 * t + (2 * cols - 2 - k) * 2 * (t + 1) + k * (k + 1)
    item = torch.finfo(dtype).bits // 8
    return bound(ops, (2 * rows * cols + cols * cols) * item, dtype)


def gram_bound(n, m, dim, dtype):
    """Bound of one radial Gram: the points read once, n m entries written;
    2 dim + 3 flops for each squared distance and about 8 for the profile."""
    item = torch.finfo(dtype).bits // 8
    return bound(n * m * (2 * dim + 11), (n * dim + m * dim + n * m) * item, dtype)


def phase_kernel(tq, dev):
    rng = np.random.default_rng(0)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [
        ("rows 128, cols 3586, off 0 (step panel)", 128, 3586, 0, ()),
        ("rows 128, cols 3586, off 40", 128, 3586, 40, ()),
        ("rows 32, cols 3586, off 0 (leaf form)", 32, 3586, 0, ()),
        ("rows 128, cols 1538, rows 2.. zero (ragged)", 128, 1538, 0, range(2, 128)),
        ("rows 128, cols 1538, all rows zero", 128, 1538, 0, range(128)),
        ("rows 128, cols 6658, off 0 (latent step panel)", 128, 6658, 0, ()),
        ("rows 128, cols 6658, off 40", 128, 6658, 40, ()),
        ("rows 2, cols 6658, off 0 (2-row panel)", 2, 6658, 0, ()),
        ("rows 2, cols 3074, off 0 (latent last panel)", 2, 3074, 0, ()),
    ]
    worst = 0.0
    for name, rows, cols, off, zero_rows in cases:
        slab = rng.standard_normal((rows, cols))
        slab[list(zero_rows)] = 0.0
        x = torch.tensor(slab, device=dev)
        lv, tT = tq.panel_lq(x, off)
        lv2, tT2 = tq.panel_lq(x, off)
        torch.cuda.synchronize()
        same = torch.equal(lv, lv2) and torch.equal(tT, tT2)
        lv_ref, tT_ref = tq.panel_lq_reference(x, off)
        err_lv = (lv - lv_ref).abs().max().item()
        err_t = (tT - tT_ref).abs().max().item()
        # f64 rounding of one panel, with margin (an all-zero panel: exact)
        tol = 1e-12 * np.abs(slab).max()
        launch = tq.panel_lq_launch(rows, cols, 8, num_sms)
        print(f"kernel vs plain, {name}: max|dLV| {err_lv:.3e}, max|dT^T| {err_t:.3e}"
              f" (tol {tol:.3e}); {launch.ctas} CTAs of {launch.width} columns in"
              f" {'registers' if launch.registers else 'global memory'};"
              f" two launches bitwise equal: {same}", flush=True)
        check(np.isfinite(err_lv) and np.isfinite(err_t), f"{name}: non-finite output")
        check(err_lv <= tol and err_t <= tol, f"{name}: kernel disagrees with plain version")
        check(same, f"{name}: two launches on the same input differ")
        worst = max(worst, err_lv, err_t)

    # the white step's pre-array, and the latent step's (29 panels, the last
    # of 2 rows), against their Grams and against cuSOLVER's QR's time
    for rows, cols, tol in ((2050, 3586, 1e-12), (3586, 6658, 1e-13)):
        W = torch.tensor(rng.standard_normal((rows, cols)), device=dev)
        L = tq.blocked_lq_l(W)
        G = W @ W.T
        rel = ((L @ L.T - G).abs().max() / G.abs().max()).item()
        print(f"blocked_lq_l {rows} x {cols}: max|L L^T - W W^T| / max|W W^T| = {rel:.3e}"
              f" (tol {tol:.0e})", flush=True)
        check(rel <= tol, f"blocked LQ {rows} x {cols}: Gram mismatch")
        check(torch.all(torch.triu(L, 1) == 0).item(), "blocked LQ factor not lower triangular")
        Wt = W.T.contiguous()
        qr = [cuda_ms(lambda: torch.linalg.qr(Wt, mode="r"), 3)]
        sweep = [cuda_ms(lambda: tq.blocked_lq_l(W), 3) for _ in range(2)]
        qr.append(cuda_ms(lambda: torch.linalg.qr(Wt, mode="r"), 3))
        print(f"LQ sweep {rows} x {cols} f64: blocked_lq_l {sweep} ms, "
              f"torch.linalg.qr(W^T, mode='r') {qr} ms", flush=True)

    # the CTA count: the rule's choice against about 32, 66 and 131 CTAs,
    # each launch shape held against the plain version before it is timed
    for rows, cols in ((128, 3586), (128, 6658), (128, 1538)):
        x = torch.tensor(rng.standard_normal((rows, cols)), device=dev)
        lv_ref, tT_ref = tq.panel_lq_reference(x, 0)
        tol = 1e-12 * x.abs().max().item()
        rule = tq.panel_lq_launch(rows, cols, 8, num_sms)
        times = []
        for ctas in (rule.ctas, 32, 66, num_sms - 1):
            launch = tq.panel_lq_geometry(rows, cols, ctas, 8)
            lv, tT = tq._launch_panel_lq(x, 0, launch)
            err = max((lv - lv_ref).abs().max().item(), (tT - tT_ref).abs().max().item())
            check(err <= tol, f"panel {rows} x {cols} on {launch.ctas} CTAs: kernel disagrees "
                  f"with plain version ({err:.3e} > {tol:.3e})")
            ms = cuda_ms(lambda: tq._launch_panel_lq(x, 0, launch), 20)
            times.append(f"{launch.ctas} CTAs {ms:.4f} ms (max err {err:.1e})")
        print(f"panel {rows} x {cols} f64 by CTA count (the rule's first): {', '.join(times)}",
              flush=True)

    timed = {(rows, cols): time_wide(tq, tq.panel_lq, "panel", rng, dev, rows, cols, label,
                                     num_sms)
             for rows, cols, label in ((128, 3586, "step panel"), (128, 6658, "latent step"),
                                       (32, 3586, "leaf form"), (128, 1538, "white init panel"))}
    return dict(max_abs_err=worst, **timed[(128, 3586)])


DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32"}


def time_wide(tq, wrapper, name, rng, dev, rows, cols, label, num_sms, dtype=torch.float64):
    """Times of the panel kernel's launch through ``wrapper`` on a random
    ``(rows, cols)`` slab of ``dtype``, in turns: plain, kernel, kernel,
    plain; torch.geqrf of the transposed slab (the same reflectors, no T)
    as the library yardstick; and the bound."""
    x = torch.tensor(rng.standard_normal((rows, cols)), dtype=dtype, device=dev)
    xt = x.T.contiguous()
    plain = [cuda_ms(lambda: tq.panel_lq_reference(x, 0), 3)]
    kernel = [cuda_ms(lambda: wrapper(x, 0), 20) for _ in range(2)]
    plain.append(cuda_ms(lambda: tq.panel_lq_reference(x, 0), 3))
    library = cuda_ms(lambda: torch.geqrf(xt), 20)
    ms = sum(kernel) / 2
    bound_ms, bound_by = panel_bound(rows, cols, 0, dtype)
    launch = tq.panel_lq_launch(rows, cols, x.element_size(), num_sms)
    print(f"{name} {rows} x {cols} {DTYPE_NAMES[dtype]} ({label}): kernel {kernel} ms, "
          f"plain {plain} ms, "
          f"torch.geqrf {library:.4f} ms; bound {bound_ms * 1e3:.2f} us ({bound_by}), "
          f"kernel at {bound_ms / ms:.2%} of it; {launch.ctas} CTAs of {launch.width} columns",
          flush=True)
    return dict(ms=ms, plain_ms=sum(plain) / 2, library_ms=library, bound_ms=bound_ms,
                bound_by=bound_by)


def time_tall(tq, rng, dev, rows, cols, label, num_sms, dtype):
    """Times of the tall launch (``leaf_qr``) on a random ``(rows, cols)``
    slab of ``dtype`` in turns (plain, kernel, kernel, plain), torch.geqrf's
    and the bound."""
    x = torch.tensor(rng.standard_normal((rows, cols)), dtype=dtype, device=dev)
    plain = [cuda_ms(lambda: tq.leaf_qr_reference(x), 3)]
    kernel = [cuda_ms(lambda: tq.leaf_qr(x), 20) for _ in range(2)]
    plain.append(cuda_ms(lambda: tq.leaf_qr_reference(x), 3))
    library = cuda_ms(lambda: torch.geqrf(x), 20)
    ms = sum(kernel) / 2
    bound_ms, bound_by = leaf_bound(rows, cols, dtype)
    launch = tq.leaf_qr_launch(rows, cols, x.element_size(), num_sms)
    print(f"leaf_qr {rows} x {cols} {DTYPE_NAMES[dtype]} ({label}): kernel {kernel} ms, plain "
          f"{plain} ms, torch.geqrf {library:.4f} ms; bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}), kernel at {bound_ms / ms:.2%} of it; {launch.ctas} CTAs of "
          f"{launch.width} rows", flush=True)
    return dict(ms=ms, plain_ms=sum(plain) / 2, library_ms=library, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_gram(tgram, cuda_build, dev):
    """The radial Gram kernel against its plain version, and both times."""
    rng = np.random.default_rng(1)
    worst = 0.0
    # ragged tiles (32 x 128), an odd m (no 16-byte row starts) and dim 3
    for n, m, dim in ((512, 512, 1), (1000, 777, 2), (33, 131, 2), (100, 258, 3)):
        for dtype in (torch.float64, torch.float32):
            x = torch.tensor(rng.uniform(size=(n, dim)), dtype=dtype, device=dev)
            y = torch.tensor(rng.uniform(size=(m, dim)), dtype=dtype, device=dev)
            for phi in ("squared_exponential", "matern52"):
                got = tgram.gram_radial(x, y, 5.0, 1.3, phi_name=phi)
                torch.cuda.synchronize()
                want = tgram.gram_radial_reference(x, y, 5.0, 1.3, phi_name=phi)
                err = (got - want).abs().max().item()
                # exp/sqrt rounding only, relative to output_scale^2
                tol = (1e-12 if dtype == torch.float64 else 1e-5) * 1.3**2
                print(f"gram kernel vs plain, ({n}, {dim}) x ({m}, {dim}) {phi} {dtype}: "
                      f"max|dK| {err:.3e} (tol {tol:.3e})", flush=True)
                check(np.isfinite(err) and err <= tol, f"gram {phi} {n}x{m}: kernel disagrees")
                if dtype == torch.float64:
                    worst = max(worst, err)

    # times, dim 1, f64, in turns: plain, kernel, kernel, plain
    times = {}
    for n in (512, 4096):
        x = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=dev)[:, None]
        kernel = lambda: tgram.gram_radial(x, x, 5.0, 1.0, phi_name="squared_exponential")  # noqa: E731
        plain = lambda: tgram.gram_radial_reference(x, x, 5.0, 1.0, phi_name="squared_exponential")  # noqa: E731
        p = [cuda_ms(plain, 20)]
        k = [cuda_ms(kernel, 50) for _ in range(2)]
        p.append(cuda_ms(plain, 20))
        # the launch alone, on clouds the wrapper has centred
        xc = x - x.mean(dim=0, keepdim=True)
        out = torch.empty((n, n), dtype=x.dtype, device=dev)
        launch_only = cuda_ms(lambda: cuda_build.launch(
            "gram_radial", "gram_radial", tgram._GRAM_ARGS, xc, xc.data_ptr(), xc.data_ptr(),
            out.data_ptr(), n, n, 1, 0, 5.0, 1.0), 50)
        bound_ms, bound_by = gram_bound(n, n, 1, torch.float64)
        print(f"gram {n} x {n} f64: kernel {k} ms (the launch alone {launch_only:.4f} ms), "
              f"plain {p} ms; bound {bound_ms * 1e3:.2f} us ({bound_by}), kernel at "
              f"{bound_ms / (sum(k) / 2):.2%} of it (the launch alone at "
              f"{bound_ms / launch_only:.2%}); no single PyTorch call computes it", flush=True)
        times[n] = dict(ms=sum(k) / 2, plain_ms=sum(p) / 2, library_ms=None,
                        bound_ms=bound_ms, bound_by=bound_by)
    return dict(max_abs_err=worst, **times[512])


def phase_leaf(tq, dev):
    """The leaf launch (the panel kernel on the tall layout) against its
    plain version, the full R-form sweeps, and their times against the
    plain version and cuSOLVER."""
    rng = np.random.default_rng(2)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [("3586 x 32 (first leaf of a step)", 3586, 32, ()),
             ("2050 x 32 (last full leaf)", 2050, 32, ()),
             ("40 x 32", 40, 32, ()),
             ("2050 x 32, columns 3 and 17 zero", 2050, 32, (3, 17)),
             ("6658 x 32 (first leaf of a latent step)", 6658, 32, ()),
             ("3586 x 128 (leaf 128)", 3586, 128, ()),
             ("20000 x 32 (chunks in global memory)", 20000, 32, ()),
             ("300 x 2 (narrow last leaf)", 300, 2, ())]
    worst = 0.0
    for name, rows, cols, zero_cols in cases:
        slab = rng.standard_normal((rows, cols))
        slab[:, list(zero_cols)] = 0.0
        launch = tq.leaf_qr_launch(rows, cols, 8, num_sms)
        for dtype in (torch.float64, torch.float32):
            x = torch.tensor(slab, dtype=dtype, device=dev)
            vr, t = tq.leaf_qr(x)
            vr2, t2 = tq.leaf_qr(x)
            torch.cuda.synchronize()
            same = torch.equal(vr, vr2) and torch.equal(t, t2)
            vr_ref, t_ref = tq.leaf_qr_reference(x)
            err = max((vr - vr_ref).abs().max().item(), (t - t_ref).abs().max().item())
            # f64: rounding of one QR, against the slab's scale; f32: against R's
            tol = (1e-12 * np.abs(slab).max() if dtype == torch.float64
                   else 1e-4 * vr_ref.abs().max().item())
            print(f"leaf kernel vs plain, {name} {dtype}: max|dVR|, |dT| {err:.3e} "
                  f"(tol {tol:.3e}); {launch.ctas} CTAs of {launch.width} rows in "
                  f"{'registers' if launch.registers else 'global memory'}; two launches "
                  f"bitwise equal: {same}", flush=True)
            check(np.isfinite(err) and err <= tol, f"leaf {name}: kernel disagrees")
            check(same, f"leaf {name}: two launches on the same input differ")
            check(all(t[k, k].item() == 0.0 for k in zero_cols), f"leaf {name}: tau != 0")
            if dtype == torch.float64:
                worst = max(worst, err)

    # the tall launch against the panel launch of the transpose (the same
    # launch shape and arithmetic)
    x = torch.tensor(rng.standard_normal((3586, 32)), device=dev)
    vr, t = tq.leaf_qr(x)
    lv, tT = tq.panel_lq(x.T.contiguous(), 0)
    torch.cuda.synchronize()
    same = torch.equal(vr, lv.T) and torch.equal(t, tT.T)
    print(f"leaf 3586 x 32 against the panel launch of its transpose: bitwise equal {same}, "
          f"max diff {max((vr - lv.T).abs().max().item(), (t - tT.T).abs().max().item()):.3e}",
          flush=True)
    check(same, "the tall launch differs from the panel launch of the transpose")

    # the CTA count at 3586 x 32: the rule's against about 32, 66 and 131,
    # each launch shape held against the plain version before it is timed
    vr_ref, t_ref = tq.leaf_qr_reference(x)
    tol = 1e-12 * x.abs().max().item()
    times = []
    for ctas in (tq.leaf_qr_launch(3586, 32, 8, num_sms).ctas, 32, 66, num_sms - 1):
        launch = tq.panel_lq_geometry(32, 3586, ctas, 8)
        vr, t = tq._launch_leaf_qr(x, launch)
        err = max((vr - vr_ref).abs().max().item(), (t - t_ref).abs().max().item())
        check(err <= tol, f"leaf 3586 x 32 on {launch.ctas} CTAs: kernel disagrees with plain "
              f"version ({err:.3e} > {tol:.3e})")
        ms = cuda_ms(lambda: tq._launch_leaf_qr(x, launch), 20)
        times.append(f"{launch.ctas} CTAs {ms:.4f} ms (max err {err:.1e})")
    print(f"leaf 3586 x 32 f64 by CTA count (the rule's first): {', '.join(times)}", flush=True)

    # the full sweeps of the white and latent R-form pre-arrays, at leaf 32
    # (the default) and 128, against their Grams and cuSOLVER's QR
    for rows, cols in ((3586, 2050), (6658, 3586)):
        A = torch.tensor(rng.standard_normal((rows, cols)), device=dev)
        G = A.T @ A
        for leaf in (32, 128):
            before = tq.leaf_qr.launches
            R = tq.blocked_qr_r(A, leaf=leaf)
            torch.cuda.synchronize()
            leaves = tq.leaf_qr.launches - before
            rel = ((R.T @ R - G).abs().max() / G.abs().max()).item()
            print(f"blocked_qr_r {rows} x {cols} at leaf {leaf}: {leaves} leaf launches, "
                  f"max|R^T R - A^T A| / max|A^T A| = {rel:.3e} (tol 1e-12)", flush=True)
            expected = sum(-(-min(128, cols - b) // leaf) for b in range(0, cols, 128))
            check(leaves == expected, f"blocked QR {rows} x {cols} at leaf {leaf}: {leaves} "
                  f"leaf launches, not {expected}")
            check(rel <= 1e-12, f"blocked QR {rows} x {cols} at leaf {leaf}: Gram mismatch")
            check(torch.all(torch.tril(R, -1) == 0).item(),
                  "blocked QR factor not upper triangular")
        qr = [cuda_ms(lambda: torch.linalg.qr(A, mode="r"), 3)]
        sweeps = {leaf: [cuda_ms(lambda: tq.blocked_qr_r(A, leaf=leaf), 3) for _ in range(2)]
                  for leaf in (32, 128)}
        qr.append(cuda_ms(lambda: torch.linalg.qr(A, mode="r"), 3))
        issue = {leaf: issue_ms(lambda: tq.blocked_qr_r(A, leaf=leaf), 3) for leaf in (32, 128)}
        print(f"R-form sweep {rows} x {cols} f64: blocked_qr_r leaf 32 {sweeps[32]} ms "
              f"(the host issues it in {issue[32]:.2f} ms), leaf 128 {sweeps[128]} ms "
              f"({issue[128]:.2f} ms), torch.linalg.qr(mode='r') {qr} ms", flush=True)

    # times, f64, in turns: plain, kernel, kernel, plain; torch.geqrf of the
    # slab (the same reflectors, no T) as the library yardstick
    timed = {rows: time_tall(tq, rng, dev, rows, 32, label, num_sms, torch.float64)
             for rows, label in ((3586, "first leaf of a white step"),
                                 (6658, "of a latent step"), (20000, "chunks in global memory"))}
    return dict(max_abs_err=worst, **timed[3586])


def phase_leaf_lq(tq, dev):
    """The LQ leaf route's launch (the panel kernel on one leaf of a 256-row
    block, counted as leaf_lq) against its plain version at the large-N
    shapes, the 256-row-block sweeps, and the leaves' times."""
    rng = np.random.default_rng(3)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [("64 x 20257 (banded window of the N=1e4 sweeps)", 64, 20257, 0, ()),
             ("64 x 20257 at off 192 (last leaf of a block)", 64, 20257, 192, ()),
             ("64 x 30002 (first leaf of the N=1e4 update)", 64, 30002, 0, ()),
             ("32 x 26626 (first leaf of a latent d=2048 step)", 32, 26626, 0, ()),
             ("32 x 26626 at off 224, rows 3 and 17 zero", 32, 26626, 224, (3, 17)),
             ("2 x 12290 (a 2-row last leaf)", 2, 12290, 0, ())]
    worst = 0.0
    for name, rows, cols, off, zero_rows in cases:
        slab = rng.standard_normal((rows, cols))
        slab[list(zero_rows)] = 0.0
        x = torch.tensor(slab, device=dev)
        before = tq.panel_lq.launches
        lv, tT = tq.leaf_lq(x, off)
        lv2, tT2 = tq.leaf_lq(x, off)
        torch.cuda.synchronize()
        check(tq.panel_lq.launches == before, f"leaf_lq {name}: counted as panel_lq")
        same = torch.equal(lv, lv2) and torch.equal(tT, tT2)
        lv_ref, tT_ref = tq.panel_lq_reference(x, off)
        err = max((lv - lv_ref).abs().max().item(), (tT - tT_ref).abs().max().item())
        tol = 1e-12 * np.abs(slab).max()
        launch = tq.panel_lq_launch(rows, cols, 8, num_sms)
        print(f"leaf_lq vs plain, {name}: max|dLV|, |dT^T| {err:.3e} (tol {tol:.3e}); "
              f"{launch.ctas} CTAs of {launch.width} columns in "
              f"{'registers' if launch.registers else 'global memory'}; two launches bitwise "
              f"equal: {same}", flush=True)
        check(np.isfinite(err) and err <= tol, f"leaf_lq {name}: kernel disagrees")
        check(same, f"leaf_lq {name}: two launches on the same input differ")
        worst = max(worst, err)

    # whole 256-row-block sweeps on the leaf route, at both leaf sizes
    W = torch.tensor(rng.standard_normal((2050, 4100)), device=dev)
    G = W @ W.T
    for leaf in (32, 64):
        before = (tq.leaf_lq.launches, tq.panel_lq.launches)
        L = tq.blocked_lq_l(W, leaf=leaf, block=256)
        torch.cuda.synchronize()
        counts = (tq.leaf_lq.launches - before[0], tq.panel_lq.launches - before[1])
        rel = ((L @ L.T - G).abs().max() / G.abs().max()).item()
        expected = (leaf_launches(2050, 256, leaf), 0)
        print(f"blocked_lq_l 2050 x 4100 at block 256, leaf {leaf}: (leaf_lq, panel_lq) "
              f"launches {counts} (expected {expected}), max|L L^T - W W^T| / max|W W^T| = "
              f"{rel:.3e} (tol 1e-12)", flush=True)
        check(counts == expected, f"leaf route at leaf {leaf}: launch counts")
        check(rel <= 1e-12 and torch.all(torch.triu(L, 1) == 0).item(),
              f"leaf route at leaf {leaf}: Gram mismatch")

    timed = {cols: time_wide(tq, tq.leaf_lq, "leaf_lq", rng, dev, 64, cols, label, num_sms)
             for cols, label in ((20257, "banded window"), (30002, "update's first leaf"))}
    return dict(max_abs_err=worst, **timed[20257])


class Launches:
    """Per-path kernel launch counts: set to 0 just before a path, read just
    after it, and summed over the paths for the kernels' record."""

    def __init__(self, wrappers):
        self.wrappers = wrappers
        self.totals = dict.fromkeys(wrappers, 0)

    def reset(self):
        for wrapper in self.wrappers.values():
            wrapper.launches = 0

    def read(self, label, expected, *, add=True):
        """Check the counts since the last reset against ``expected`` (the
        kernels it leaves out must be 0)."""
        counts = {name: wrapper.launches for name, wrapper in self.wrappers.items()}
        expected = {name: expected.get(name, 0) for name in self.wrappers}
        print(f"{label}: launches {counts} (expected {expected})", flush=True)
        check(counts == expected, f"{label}: kernel launch counts")
        if add:
            for name, count in counts.items():
                self.totals[name] += count
        return counts


def prior(pt, species=1):
    kernel = pt.kernels.Matern52() + pt.kernels.WhiteNoise()
    return kernel if species == 1 else pt.duplicate(kernel, species)


def phase_golden(pt, dev, launches, solver_cls, prefix, factorization, expected, label):
    """The dx = 0.2 heat solve against the golden ``{prefix}_*`` arrays."""
    with np.load(GOLDEN) as data:
        golden = dict(data)
    heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=dev)
    solver = solver_cls(steprule=pt.odetools.step.Constant(0.1), spatial_kernel=prior(pt),
                        factorization=factorization)
    launches.reset()
    sol = solver.solve(heat)
    torch.cuda.synchronize()
    launches.read(f"{prefix} golden through {label}", expected)
    mean = sol.mean.cpu().numpy()
    diffusion = float(sol.diffusion_squared_calibrated)
    # thresholds of tests/test_golden.py
    ok = (np.allclose(mean, golden[f"{prefix}_mean"], rtol=1e-10, atol=1e-13)
          and np.allclose(diffusion, golden[f"{prefix}_diffusion"], rtol=1e-10))
    line = (f"{prefix} golden dx=0.2 through {label}: max|dmean| "
            f"{np.abs(mean - golden[f'{prefix}_mean']).max():.3e}, diffusion rel "
            f"{abs(diffusion / float(golden[f'{prefix}_diffusion']) - 1):.3e}")
    if f"{prefix}_final_std" in golden:
        std = torch.sqrt(torch.einsum("ij,ij->i", sol.cov_sqrtm[-1], sol.cov_sqrtm[-1]))
        std = std.cpu().numpy()
        ok = ok and np.allclose(std, golden[f"{prefix}_final_std"], rtol=1e-8, atol=1e-12)
        line += f", max|dstd| {np.abs(std - golden[f'{prefix}_final_std']).max():.3e}"
    print(line, flush=True)
    check(ok, f"{prefix} golden trajectory mismatch")


def heat_solver(pt, factorization, cls=None, steprule=None):
    """The bench configuration's solver: nu = 2, prior Matern52 + WhiteNoise,
    Constant(DT) unless another rule is given (None: the Adaptive default)."""
    cls = cls or pt.white.LinearWhiteNoiseEK1
    return cls(steprule=steprule, num_derivatives=NU, spatial_kernel=prior(pt),
               factorization=factorization)


def run_solver(solver, pde, num_steps=NUM_STEPS):
    """initialize + steps through the user-facing generator, synchronized
    after each; ``num_steps=None`` takes whatever an adaptive rule takes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diffusions = []
    for state, info in solver.solution_generator(pde):
        torch.cuda.synchronize()
        if info["num_steps"] == 0:
            t_init = time.perf_counter()
            y0_mean = state.y.mean
        elif info["num_steps"] == 1:
            t_first = time.perf_counter()
        if info["num_steps"]:
            diffusions.append(state.diffusion_squared_local)
    t_end = time.perf_counter()
    steps = info["num_steps"]
    if num_steps is not None:
        check(steps == num_steps, f"ran {steps} steps, not {num_steps}")
    return dict(
        state=state,
        info=dict(info),
        y0_mean=y0_mean,
        diffusion=torch.stack(diffusions).mean(),
        init_s=t_init - t0,
        steps_per_s=steps / (t_end - t_init),
        steady_steps_per_s=(steps - 1) / (t_end - t_first),
    )


def report_run(name, run, card_line, d=None, decays=True, heat=None):
    """Prints init seconds and steps/s; then no NaN and (for heat) decay of
    the solution ``mean[0, :d]``. Given a fine-mesh ``heat`` problem, max|u|
    must instead move the way ``(L u0)`` and the filter's initial
    derivative both point at the initial peak (the module docstring)."""
    mean, cov = run["state"].y.mean, run["state"].y.cov_sqrtm
    u0_vec = run["y0_mean"][0, :d]
    u0, u = u0_vec.abs().max(), mean[0, :d].abs().max()
    info = run["info"]
    print(f"{name}: init {run['init_s']:.3f} s, {run['steps_per_s']:.2f} steps/s over "
          f"{info['num_steps']} steps of {info['num_attempted_steps']} attempts "
          f"({run['steady_steps_per_s']:.2f} after the first), max|u| {u0.item():.10f} -> "
          f"{u.item():.10f} [{card_line}]", flush=True)
    check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all()
               and torch.isfinite(run["diffusion"])), f"{name}: NaN or inf")
    if heat is not None:
        peak = u0_vec.abs().argmax()
        sign = u0_vec[peak].sign()
        slope = (heat.L[peak] @ u0_vec * sign).item()
        du0 = (run["y0_mean"][1, peak] * sign).item()
        print(f"{name}: at the initial peak (L u0) = {slope:.6e} (row sum of L "
              f"{heat.L[peak].sum().item():.6e}, |E_sqrtm row| "
              f"{heat.E_sqrtm[peak].norm().item():.6e}), the filter's initial derivative "
              f"{du0:.6e}, max|u| moved {(u - u0).item():.6e}", flush=True)
        check((slope > 0) == (du0 > 0) and (u > u0).item() == (du0 > 0),
              f"{name}: max|u| against the direction of (L u0) and the initial derivative")
    elif decays:
        check(u < u0, f"{name}: heat did not decay")


def compare_runs(label, run, plain, d=None):
    """Mean and covariance Gram <= 1e-8 relative, diffusion <= 1e-6. For the
    latent solvers (``d`` = the state half) the 1e-8 holds on the solution
    half of the mean, and the whole stacked mean is held to 1e-6: the
    highest derivative of the latent force is fixed only through noise-free
    measurements, and two f64 Householder QRs of the same pre-arrays
    (LAPACK and XLA, on a CPU) already give stacked means 8.4e-8 apart
    after the 20 N = 512 latent steps, the state halves 8.5e-9."""
    m1, m2 = run["state"].y.mean, plain["state"].y.mean
    C1, C2 = run["state"].y.cov_sqrtm, plain["state"].y.cov_sqrtm
    G1, G2 = C1 @ C1.T, C2 @ C2.T

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    mean_rel, stacked_rel = rel(m1[:, :d], m2[:, :d]), rel(m1, m2)
    gram_rel = rel(G1, G2)
    diff_rel = abs(run["diffusion"].item() / plain["diffusion"].item() - 1)
    stacked = "" if d is None else f" (stacked with the latent half {stacked_rel:.3e})"
    print(f"{label} after {run['info']['num_steps']} steps: mean rel {mean_rel:.3e}{stacked}, "
          f"cov Gram rel {gram_rel:.3e}, diffusion rel {diff_rel:.3e}", flush=True)
    check(mean_rel <= 1e-8 and gram_rel <= 1e-8 and stacked_rel <= 1e-6,
          f"{label}: paths disagree")
    # looser: the diffusion whitens through the near-singular innovation
    # directions of the noise-free Dirichlet rows, which amplify rounding
    check(diff_rel <= 1e-6, f"{label}: diffusions disagree")


def full_width_heat(pt, dev, tmax=NUM_STEPS * DT):
    dx = 1.0 / (N_POINTS - 1)
    return pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=tmax, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device=dev,
    )


def phase_full_width(pt, dev, launches, card_line):
    heat = full_width_heat(pt, dev)
    launches.reset()
    hh = run_solver(heat_solver(pt, "householder", steprule=pt.odetools.step.Constant(DT)), heat)
    plain = run_solver(heat_solver(pt, None, steprule=pt.odetools.step.Constant(DT)), heat)
    launches.read(f"N={N_POINTS} FD path", {"panel_lq": EXPECTED_LAUNCHES})
    report_run(f"N={N_POINTS} householder kernel", hh, card_line)
    report_run(f"N={N_POINTS} plain torch.linalg.qr", plain, card_line)
    compare_runs("kernel path vs plain path", hh, plain)
    return heat, plain, hh


def phase_collocation(pt, dev, launches, card_line):
    """heat_1d on the 512-point mesh with L and E_sqrtm from global
    collocation (SquareExponential(input_scale=5), nuggets 1e-12 on K and
    1e-6 on E); B, R_sqrtm and y0 as the mixin sets them."""
    launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heat = full_width_heat(pt, dev)
    D, E_sqrtm = pt.discretize.collocation_global(
        pt.diffops.laplace(), heat.mesh_spatial,
        kernel=pt.kernels.SquareExponential(input_scale=5.0),
        nugget_gram_matrix=1e-12, nugget_cholesky_E=1e-6, symmetrize_cholesky_E=True,
    )
    heat.L = heat.diffop_scale * D
    heat.E_sqrtm = heat.diffop_scale * E_sqrtm
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(bool(torch.isfinite(heat.L).all() and torch.isfinite(heat.E_sqrtm).all()),
          "collocation: NaN or inf in L or E_sqrtm")
    launches.read(f"N={N_POINTS} collocation setup ({setup_s:.3f} s)", {"gram_radial": 1},
                  add=False)
    constant = pt.odetools.step.Constant(DT)
    hh = run_solver(heat_solver(pt, "householder", steprule=constant), heat)
    plain = run_solver(heat_solver(pt, None, steprule=constant), heat)
    launches.read(f"N={N_POINTS} collocation path",
                  {"panel_lq": EXPECTED_LAUNCHES, "gram_radial": 1})
    report_run(f"N={N_POINTS} collocation, householder kernel", hh, card_line)
    report_run(f"N={N_POINTS} collocation, plain torch.linalg.qr", plain, card_line)
    compare_runs("collocation: kernel path vs plain path", hh, plain)


def phase_r_form(pt, tq, launches, heat, plain, card_line):
    """The phase-5 problem through the R-form hook at leaf 32 (the default)
    and at leaf 128, each against phase 5's plain run."""
    for leaf, expected in ((32, EXPECTED_LEAF_LAUNCHES), (128, EXPECTED_LEAF128_LAUNCHES)):
        launches.reset()
        rf = run_solver(heat_solver(pt, tq.make_householder_factorization(leaf=leaf),
                                    steprule=pt.odetools.step.Constant(DT)), heat)
        launches.read(f"N={N_POINTS} R-form path at leaf {leaf}", {"leaf_qr": expected})
        report_run(f"N={N_POINTS} R-form hook at leaf {leaf}, leaf kernel", rf, card_line)
        compare_runs(f"R-form path at leaf {leaf} vs plain path", rf, plain)


def phase_latent(pt, launches, heat, card_line):
    """The phase-5 problem through LinearLatentForceEK1: the stacked state
    has 2N = 1024 points and the step's pre-array is 3586 x 6658."""
    launches.reset()
    runs = {
        fac: run_solver(heat_solver(pt, fac, cls=pt.latent.LinearLatentForceEK1,
                                    steprule=pt.odetools.step.Constant(DT)), heat)
        for fac in ("householder", None)
    }
    launches.read(f"N={N_POINTS} latent path", {"panel_lq": EXPECTED_LATENT_LAUNCHES})
    report_run(f"N={N_POINTS} latent, householder kernel", runs["householder"], card_line,
               d=N_POINTS)
    report_run(f"N={N_POINTS} latent, plain torch.linalg.qr", runs[None], card_line, d=N_POINTS)
    compare_runs("latent: kernel path vs plain path", runs["householder"], runs[None],
                 d=N_POINTS)
    return runs[None]


def phase_latent_r_form(pt, tq, launches, heat, plain, card_line):
    """The phase-9 problem through the R-form hook (the tall pre-array is
    6658 x 3586), against phase 9's plain run."""
    launches.reset()
    rf = run_solver(heat_solver(pt, tq.make_householder_factorization(),
                                cls=pt.latent.LinearLatentForceEK1,
                                steprule=pt.odetools.step.Constant(DT)), heat)
    launches.read(f"N={N_POINTS} latent R-form path", {"leaf_qr": EXPECTED_LATENT_LEAF_LAUNCHES})
    report_run(f"N={N_POINTS} latent, R-form hook, leaf kernel", rf, card_line, d=N_POINTS)
    compare_runs("latent: R-form path vs plain path", rf, plain, d=N_POINTS)


def phase_lotka_volterra(pt, dev, launches, card_line):
    """SemiLinearWhiteNoiseEK1 on Lotka-Volterra at d = 512 (256 points, two
    species, four Neumann rows) with the dx-adapted FD kernel."""
    dx = 1.0 / (LV_POINTS - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv = pt.examples.lotka_volterra_1d_discretized(
        dx=dx, tmax=NUM_STEPS * DT, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device=dev,
    )
    torch.cuda.synchronize()
    check(lv.L.shape == (2 * LV_POINTS,) * 2 and lv.B.shape == (4, 2 * LV_POINTS),
          f"Lotka-Volterra shapes {tuple(lv.L.shape)}, {tuple(lv.B.shape)}")
    print(f"Lotka-Volterra d={2 * LV_POINTS} discretized in {time.perf_counter() - t0:.3f} s",
          flush=True)
    launches.reset()
    runs = {
        fac: run_solver(pt.white.SemiLinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(DT), num_derivatives=NU,
            spatial_kernel=prior(pt, 2), factorization=fac), lv)
        for fac in ("householder", None)
    }
    launches.read(f"d={2 * LV_POINTS} Lotka-Volterra path", {"panel_lq": EXPECTED_LV_LAUNCHES})
    for fac, name in (("householder", "householder kernel"), (None, "plain torch.linalg.qr")):
        report_run(f"d={2 * LV_POINTS} Lotka-Volterra, {name}", runs[fac], card_line,
                   decays=False)
    compare_runs("Lotka-Volterra: kernel path vs plain path", runs["householder"], runs[None])


def phase_adaptive(pt, dev, launches, card_line):
    """The phase-5 problem to ADAPTIVE_TMAX with the Adaptive() defaults
    (``steprule=None``)."""
    heat = full_width_heat(pt, dev, tmax=ADAPTIVE_TMAX)
    print(f"adaptive: first dt {float(pt.odetools.step.Adaptive().first_dt(heat)):.6g}",
          flush=True)
    launches.reset()
    runs = {fac: run_solver(heat_solver(pt, fac), heat, num_steps=None)
            for fac in ("householder", None)}
    hh, plain = runs["householder"], runs[None]
    attempts = hh["info"]["num_attempted_steps"]
    launches.read(f"N={N_POINTS} adaptive path ({attempts} attempts)",
                  {"panel_lq": 13 + 17 * attempts})
    for key in ("num_steps", "num_attempted_steps"):
        check(hh["info"][key] == plain["info"][key],
              f"adaptive: {key} {hh['info'][key]} (kernel) != {plain['info'][key]} (plain)")
    for run in runs.values():
        check(abs(run["state"].t - ADAPTIVE_TMAX) <= 1e-12, f"adaptive: ended at {run['state'].t}")
    report_run(f"N={N_POINTS} adaptive, householder kernel", hh, card_line)
    report_run(f"N={N_POINTS} adaptive, plain torch.linalg.qr", plain, card_line)
    compare_runs("adaptive: kernel path vs plain path", hh, plain)
    return plain


def phase_semilinear_latent(pt, dev, launches, card_line):
    """SemiLinearLatentForceEK1 on Lotka-Volterra at dx = 0.1 (d = 22): the
    init LQ has 114 rows (1 panel), each step's 158 (2 panels)."""
    lv = pt.examples.lotka_volterra_1d_discretized(dx=0.1, tmax=0.2, device=dev)
    launches.reset()
    runs = {
        fac: run_solver(pt.latent.SemiLinearLatentForceEK1(
            steprule=pt.odetools.step.Constant(0.05), spatial_kernel=prior(pt, 2),
            factorization=fac), lv, num_steps=4)
        for fac in ("householder", None)
    }
    launches.read("d=22 semilinear latent path", {"panel_lq": 1 + 2 * 4})
    report_run("d=22 semilinear latent, householder kernel", runs["householder"], card_line,
               d=22, decays=False)
    compare_runs("semilinear latent: kernel path vs plain path", runs["householder"],
                 runs[None], d=22)


def dx_adapted_heat(pt, dev, points, num_steps, dt=DT):
    """heat_1d on ``points`` mesh points with the dx-adapted FD kernel, to
    ``num_steps`` steps of ``dt``."""
    dx = 1.0 / (points - 1)
    return pt.pde.examples.heat_1d_discretized(
        dx=dx, tmax=num_steps * dt, kernel=pt.kernels.SquareExponential(input_scale=0.1 / dx),
        device=dev,
    )


def phase_latent_large(pt, dev, launches, card_line):
    """LinearLatentForceEK1 with "householder" at d = 2048: the hooks sized
    for 4096 points take 256-row blocks, so every block runs the leaf route
    (32-row leaves). The init LQ has m + 4d = 10242 rows; each fused step's
    m + 6d = 14338, each two-QR step's propagate 6d and update m + 6d. The
    fused and the two-QR banded runs against the plain fused run."""
    d = LATENT_LARGE_POINTS
    heat = dx_adapted_heat(pt, dev, d, LATENT_LARGE_STEPS)
    m = heat.L.shape[0] + heat.B.shape[0]
    init = leaf_launches(m + 4 * d, 256, 32)
    fused_step = leaf_launches(m + 6 * d, 256, 32)
    two_qr_step = leaf_launches(6 * d, 256, 32) + fused_step
    configs = {  # each with its leaf_lq launches
        "householder (leaf route)": (
            dict(factorization="householder"), init + LATENT_LARGE_STEPS * fused_step),
        "householder two-QR banded (leaf route)": (
            dict(factorization="householder", fused=False, propagate_band="banded"),
            init + LATENT_LARGE_STEPS * two_qr_step),
        "plain torch.linalg.qr": (dict(factorization=None), 0),
    }
    runs = {}
    for name, (kwargs, expected) in configs.items():
        launches.reset()
        runs[name] = run_solver(pt.latent.LinearLatentForceEK1(
            steprule=pt.odetools.step.Constant(DT), num_derivatives=NU,
            spatial_kernel=prior(pt), **kwargs), heat, num_steps=LATENT_LARGE_STEPS)
        launches.read(f"d={d} latent, {name}", {"leaf_lq": expected})
    # at this mesh the heat rises (the module docstring)
    for name, run in runs.items():
        report_run(f"d={d} latent, {name}", run, card_line, d=d, heat=heat)
    plain = runs.pop("plain torch.linalg.qr")
    for name, run in runs.items():
        compare_runs(f"d={d} latent: {name} vs plain path", run, plain, d=d)


def two_qr_point(pt, dev, launches, card_line, label, make_problem, num_steps,
                 interleaved=False):
    """A large-N point through the two-QR pipeline on the leaf route (nu =
    1, ``Constant(DT)``): ``make_problem()`` discretized on the card, then
    initialize and ``num_steps`` steps ``"banded"`` (and ``"interleaved"``)
    against the plain two-QR path, each path's ``leaf_lq`` count read on its
    own. With m measurement rows and D = 2d, the init update LQ has m + 2d
    rows, each step's propagate D and update m + D; every 256-row block runs
    64-row leaves. Prints the discretization seconds, each path's init
    seconds, steps/s and peak memory, and one propagate and one update sweep
    of each path by CUDA events. Returns ``(problem, m, D, leaf_lq count
    of the banded path, the banded path's init s, steps/s and peak GiB)``."""
    n = LARGE_NU + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heat = make_problem()
    torch.cuda.synchronize()
    d = heat.L.shape[0]
    m, D = d + heat.B.shape[0], n * d
    print(f"{label} discretized in {time.perf_counter() - t0:.3f} s (k-NN and FD; d = {d}, "
          f"m = {m}, D = {D})", flush=True)
    per_run = leaf_launches(m + 2 * d, 256, 64) + num_steps * (
        leaf_launches(D, 256, 64) + leaf_launches(m + D, 256, 64))
    banded, plain = ("householder two-QR banded (leaf route)", "plain two-QR torch.linalg.qr")
    configs = {  # each with its leaf_lq launches
        banded: (dict(factorization="householder", fused=False, propagate_band="banded"),
                 per_run)}
    if interleaved:
        # the interleaved run re-triangularizes its (D, D) initial factor once
        configs["householder two-QR interleaved (leaf route)"] = (
            dict(factorization="householder", fused=False, propagate_band="interleaved"),
            per_run + leaf_launches(D, 256, 64))
    configs[plain] = (dict(factorization=None, fused=False), 0)
    solvers = {name: pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(DT), num_derivatives=LARGE_NU,
        spatial_kernel=prior(pt), **kwargs) for name, (kwargs, _) in configs.items()}
    runs, peaks = {}, {}
    for name, solver in solvers.items():
        held = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        launches.reset()
        runs[name] = run_solver(solver, heat, num_steps=num_steps)
        launches.read(f"{label} {name}", {"leaf_lq": configs[name][1]})
        peaks[name] = (torch.cuda.max_memory_allocated(dev) / 2**30, held)
    for name, run in runs.items():
        report_run(f"{label} {name}", run, card_line, heat=heat)  # as at d = 2048
        peak, held = peaks[name]
        print(f"{label} {name}: peak memory {peak:.2f} GiB, of which {held:.2f} GiB held "
              f"before the run (the problem and the earlier runs) [{card_line}]", flush=True)
        check(peak < 80.0, f"{label} {name}: peak memory above the card's 80 GB")
    for name in list(configs)[:-1]:
        compare_runs(f"{label}: {name} vs plain two-QR path", runs[name], runs[plain])

    # one propagate and one update sweep of each path, from the final states
    # (the interleaved propagate needs the triangular factor of its own run)
    cache, hook = solvers[banded]._cache, solvers[banded].factorization
    p, p_inv = pt.ops.iwp.nordsieck_scales_1d(LARGE_NU, DT, dtype=torch.float64, device=dev)

    def predicted(name):
        return pt.ops.iwp.apply_stack_matrix(
            cache.A1d, pt.ops.iwp.scale_stack(p_inv, runs[name]["state"].y.cov_sqrtm))

    ACl = predicted(banded)
    apply_H = pt.white._measurement_operator(cache, cache.L, p, n)
    Clp = hook.propagate.banded(ACl, cache.Ql)
    HClp = apply_H(Clp)
    sweeps = {"propagate, banded leaf route": lambda: hook.propagate.banded(ACl, cache.Ql)}
    if interleaved:
        name = list(configs)[1]
        ACl_tri = predicted(name)
        sweeps["propagate, interleaved leaf route"] = lambda: (
            solvers[name].factorization.propagate.interleaved(ACl_tri, cache.Ql, n))
    sweeps.update({
        "update, banded leaf route": lambda: hook.update_from_products.blocks_banded(
            HClp, Clp, cache.E_bc_sqrtm),
        "propagate, torch.linalg.qr": lambda: pt.ops.sqrt.propagate_cholesky_factor(
            ACl, cache.Ql),
        "update, torch.linalg.qr": lambda: pt.ops.sqrt.update_sqrt_from_products_blocks(
            HClp, Clp, cache.E_bc_sqrtm),
    })
    times = {name: cuda_ms(fn, 1) for name, fn in sweeps.items()}
    print(f"{label} sweeps (ms, CUDA events, one call after one warm-up): "
          + ", ".join(f"{name} {ms:.1f}" for name, ms in times.items()) + f" [{card_line}]",
          flush=True)
    summary = dict(init_s=runs[banded]["init_s"], steps_per_s=runs[banded]["steps_per_s"],
                   peak_gib=peaks[banded][0])
    return heat, m, D, per_run, summary


def phase_large_n(pt, dev, launches, card_line):
    """bench.py's large-N point in f64 through the two-QR pipeline on the
    leaf route, banded and interleaved, against the plain two-QR path:
    N = 1e4, nu = 1, so D = 2e4 and m = 10002. Returns the banded path's
    init s, steps/s and peak GiB (phase X4 prints its f32 run beside them)."""
    return two_qr_point(pt, dev, launches, card_line, f"N={LARGE_N}",
                        lambda: dx_adapted_heat(pt, dev, LARGE_N, LARGE_STEPS), LARGE_STEPS,
                        interleaved=True)[-1]


def phase_heat_2d(pt, tgram, dev, launches, card_line):
    """G. The JAX package's 2-D scale point (experiments/scale_demo.py:48-56)
    in f64: heat on a 100 x 100 grid (N = 1e4, nu = 1, 396 boundary points:
    m = 10396, D = 2e4), initialize and 3 steps on the banded leaf route
    (475 + 788 x 3 = 2839 ``leaf_lq``) against the plain two-QR path; then
    the Matern52 Gram of the 1e4 mesh points through the kernel dispatch,
    one ``gram_radial`` launch, against its plain version and its bound."""
    side = HEAT2D_SIDE
    dx = 1.0 / (side - 1)

    def problem():
        return pt.pde.examples.heat_2d_discretized(
            num_points=(side, side), kernel=pt.kernels.SquareExponential(input_scale=0.15 / dx),
            stencil_size_interior=5, stencil_size_boundary=5, nugget_gram_matrix_fd=1e-10,
            tmax=ND_STEPS * DT, device=dev)

    heat, m, D, leaves, _ = two_qr_point(pt, dev, launches, card_line,
                                         f"heat 2-D {side}x{side}", problem, ND_STEPS)
    check((m, D, leaves) == (10396, 20000, 2839), "heat 2-D: m, D or the leaf count")

    points = heat.mesh_spatial.points
    kernel = pt.kernels.Matern52(input_scale=0.15 / dx)
    launches.reset()
    got = kernel(points, points.T)
    torch.cuda.synchronize()
    launches.read(f"heat 2-D Gram {len(points)} x {len(points)}", {"gram_radial": 1})
    want = tgram.gram_radial_reference(points, points, 0.15 / dx, 1.0, phi_name="matern52")
    err = (got - want).abs().max().item()
    del got, want
    torch.cuda.empty_cache()
    n = len(points)
    ms = cuda_ms(lambda: kernel(points, points.T), 5)
    plain_ms = cuda_ms(lambda: tgram.gram_radial_reference(
        points, points, 0.15 / dx, 1.0, phi_name="matern52"), 5)
    bound_ms, bound_by = gram_bound(n, n, 2, torch.float64)
    torch.cuda.empty_cache()
    print(f"heat 2-D Gram {n} x {n} Matern52 f64: max|dK| {err:.3e} (tol 1e-12); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
          f"kernel at {bound_ms / ms:.2%} of it [{card_line}]", flush=True)
    check(np.isfinite(err) and err <= 1e-12, "heat 2-D Gram: kernel disagrees")


def phase_advection_3d(pt, dev, launches, card_line):
    """H. The JAX package's largest 3-D single-chip rung
    (experiments/scale_demo.py:58-70) in f64: advection-diffusion on 21^3
    points (velocity (1, 0.5, 0.25), kappa 0.05, 7-point stencils; 2402
    boundary points: m = 11663, D = 18522), initialize and 3 steps on the
    banded leaf route (472 + 762 x 3 = 2758 ``leaf_lq``) against the plain
    two-QR path, each under the card's 80 GB."""
    side = ADVECTION_SIDE
    dx = 1.0 / (side - 1)

    def problem():
        return pt.pde.examples.advection_diffusion_discretized(
            dim=3, num_points=(side,) * 3,
            kernel=pt.kernels.SquareExponential(input_scale=0.15 / dx),
            stencil_size_interior=7, stencil_size_boundary=7, nugget_gram_matrix_fd=1e-10,
            tmax=ND_STEPS * DT, velocity=[1.0, 0.5, 0.25], diffusion_rate=0.05, device=dev)

    _, m, D, leaves, _ = two_qr_point(pt, dev, launches, card_line,
                                      f"advection 3-D {side}^3", problem, ND_STEPS)
    check((m, D, leaves) == (11663, 18522, 2758), "advection 3-D: m, D or the leaf count")


def block_panels(rows):
    """Panel launches of one LQ sweep of ``rows`` rows on the block route."""
    return -(-rows // 128)


def phase_nd_small(pt, dev, launches, card_line):
    """I. The 2-D problems below 4096 points on the block route (128-row
    panels): Fisher-KPP on 48 x 48 (d = 2304, 188 boundary points, m = 2492)
    through ``SemiLinearWhiteNoiseEK1`` (nu = 2, 10 steps of DT; init 7100
    rows in 56 panels, steps 9404 rows in 74: 796 ``panel_lq``), and the
    no-flux heat of tests/test_neumann_nd.py on 24 x 24 (9-point stencils,
    ``SquareExponential(0.05/dx)``) through the n-D Neumann operator, nu =
    2, 10 steps of 0.05; each against the plain path."""
    side = FKPP_SIDE
    dx = 1.0 / (side - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pde = pt.pde.examples.fisher_kpp_2d_discretized(
        num_points=(side, side), kernel=pt.kernels.SquareExponential(input_scale=0.15 / dx),
        stencil_size_interior=5, stencil_size_boundary=5, nugget_gram_matrix_fd=1e-10,
        tmax=FKPP_STEPS * DT, diffusion_rate=0.01, growth_rate=3.0, device=dev)
    torch.cuda.synchronize()
    d = pde.L.shape[0]
    m, D = d + pde.B.shape[0], (NU + 1) * d
    expected = block_panels(m + 2 * d) + FKPP_STEPS * block_panels(m + D)
    print(f"Fisher-KPP 2-D {side}x{side} discretized in {time.perf_counter() - t0:.3f} s "
          f"(d = {d}, m = {m}, D = {D})", flush=True)
    check((d, m, expected) == (2304, 2492, 796), "Fisher-KPP 2-D: d, m or the panel count")
    runs = {}
    for name, factorization in (("householder kernel", "householder"), ("plain", None)):
        launches.reset()
        runs[name] = run_solver(pt.white.SemiLinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(DT), num_derivatives=NU,
            spatial_kernel=prior(pt), factorization=factorization), pde, num_steps=FKPP_STEPS)
        launches.read(f"Fisher-KPP 2-D {name}",
                      {"panel_lq": expected if factorization else 0})
    for name, run in runs.items():
        report_run(f"Fisher-KPP 2-D {name}", run, card_line, decays=False)
        u0, u = run["y0_mean"][0].max().item(), run["state"].y.mean[0].max().item()
        # the logistic growth (rate 3) outruns the diffusion (0.01), as in
        # tests/test_fisher_kpp_2d.py, and stays below the carrying capacity
        check(u0 < u <= 1.05, f"Fisher-KPP 2-D {name}: max u did not grow toward 1")
    compare_runs("Fisher-KPP 2-D: kernel path vs plain path", runs["householder kernel"],
                 runs["plain"])

    side = NEUMANN_SIDE
    dx = 1.0 / (side - 1)
    heat = pt.pde.examples.heat_2d_discretized(
        num_points=(side, side), tmax=NEUMANN_STEPS * NEUMANN_DT, bcond="neumann",
        kernel=pt.kernels.SquareExponential(input_scale=0.05 / dx),
        stencil_size_interior=9, stencil_size_boundary=9, device=dev)
    d = heat.L.shape[0]
    m, D = d + heat.B.shape[0], (NU + 1) * d
    expected = block_panels(m + 2 * d) + NEUMANN_STEPS * block_panels(m + D)
    print(f"Neumann heat 2-D {side}x{side}: d = {d}, m = {m} ({heat.B.shape[0]} Neumann "
          f"rows), D = {D}: {expected} panels expected", flush=True)
    runs = {}
    for name, factorization in (("householder kernel", "householder"), ("plain", None)):
        launches.reset()
        runs[name] = run_solver(pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(NEUMANN_DT), num_derivatives=NU,
            spatial_kernel=prior(pt), factorization=factorization), heat,
            num_steps=NEUMANN_STEPS)
        launches.read(f"Neumann heat 2-D {name}",
                      {"panel_lq": expected if factorization else 0})
    for name, run in runs.items():
        report_run(f"Neumann heat 2-D {name}", run, card_line, decays=False)
        u0, u = run["y0_mean"][0, :d], run["state"].y.mean[0, :d]
        mean0, meanT = u0.mean().item(), u.mean().item()
        print(f"Neumann heat 2-D {name}: spatial mean {mean0:.6f} -> {meanT:.6f}, spread "
              f"{u0.std().item():.6f} -> {u.std().item():.6f}", flush=True)
        # no-flux boundaries hold the mean (to tests/test_neumann_nd.py's
        # 20%) while the profile flattens
        check(abs(meanT - mean0) <= 0.2 * abs(mean0) and u.std() < u0.std(),
              f"Neumann heat 2-D {name}: mean not held or spread not falling")
    compare_runs("Neumann heat 2-D: kernel path vs plain path", runs["householder kernel"],
                 runs["plain"])


def timed_sync(fn):
    """``(result, seconds)`` by the host clock, synchronized on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def phase_mol(pt, dev, launches, card_line, pnmol):
    """A. The MOL baseline at the bench point: ``heat.to_ivp()`` of the
    phase-5 problem (d = 510 interior points, D = 1530 at nu = 2) through
    ``ReferenceEK1ConstantDiffusion`` with ``Stack(use_df=False)``, 20 steps
    of DT through ``solve`` and ``simulate_final_state``; each step is two
    ``torch.linalg.qr`` (3060 x 1530 and 2040 x 2040), no kernel. Against
    DP5 on the card and phase 5's PNMOL white panel-kernel mean."""
    heat = full_width_heat(pt, dev)
    ivp = heat.to_ivp()
    d = ivp.y0.shape[0]
    mol = pt.odetools.ek1.ReferenceEK1ConstantDiffusion(
        num_derivatives=NU, steprule=pt.odetools.step.Constant(DT),
        initialization=pt.odetools.init.Stack(use_df=False))
    launches.reset()
    (sol, sigma_sq), solve_s = timed_sync(lambda: mol.solve(ivp))
    _, init_s = timed_sync(lambda: mol.initialize(ivp))
    (final, info), final_s = timed_sync(lambda: mol.simulate_final_state(ivp))
    f0 = ivp.f(ivp.t0, ivp.y0)
    rows = (ivp.y0, f0, ivp.df(ivp.t0, ivp.y0) @ f0)
    taylor, taylor_s = timed_sync(lambda: pt.odetools.init.TaylorMode.taylor_mode(
        ivp.f, ivp.y0, ivp.t0, NU))
    ref, dp5_s = timed_sync(lambda: pt.odetools.reference_solver.solve_ivp_dopri5(
        ivp.f, ivp.t_span, ivp.y0, [ivp.tmax], rtol=1e-10, atol=1e-12))
    launches.read(f"N={N_POINTS} MOL path (d={d}, D={d * (NU + 1)})", {})

    steps = info["num_steps"]
    u, u_ref, u0 = sol.mean[-1, 0], ref.y[-1], sol.mean[0, 0]
    print(f"N={N_POINTS} MOL EK1 (Stack, plain torch.linalg.qr): init {init_s:.3f} s, "
          f"{steps / (solve_s - init_s):.2f} steps/s over {steps} steps (solve {solve_s:.3f} s, "
          f"simulate_final_state {final_s:.3f} s), sigma^2 {sigma_sq.item():.6e}, max|u| "
          f"{u0.abs().max().item():.10f} -> {u.abs().max().item():.10f} [{card_line}]", flush=True)
    dp5_err = ((u - u_ref).abs().max() / u_ref.abs().max()).item()
    pnmol_u = pnmol["state"].y.mean[0, 1:-1]
    pnmol_diff = ((u - pnmol_u).abs().max() / pnmol_u.abs().max()).item()
    print(f"N={N_POINTS} MOL final mean against DP5 (rtol 1e-10, atol 1e-12, {ref.num_steps} "
          f"attempts, {dp5_s:.3f} s): max rel {dp5_err:.3e}; against phase 5's PNMOL white "
          f"panel-kernel interior mean: max rel {pnmol_diff:.3e}", flush=True)
    factor = sol.cov_sqrtm[-1] * torch.sqrt(sigma_sq)
    factor_rel = ((final.y.cov_sqrtm - factor).abs().max() / factor.abs().max()).item()
    taylor_rel = max(((taylor[k] - row).abs().max() / row.abs().max()).item()
                     for k, row in enumerate(rows))
    print(f"N={N_POINTS} MOL simulate_final_state factor vs solve's x sqrt(sigma^2): rel "
          f"{factor_rel:.3e}; TaylorMode(nu={NU}) vs y0, f(y0), df(y0) f(y0): rel "
          f"{taylor_rel:.3e} ({taylor_s:.3f} s)", flush=True)
    check(all(bool(torch.isfinite(x).all()) for x in (sol.mean, sol.cov_sqrtm, sigma_sq,
                                                       final.y.mean, final.y.cov_sqrtm, u_ref)),
          "MOL: NaN or inf")
    check(steps == NUM_STEPS and bool(u.abs().max() < u0.abs().max()), "MOL: heat did not decay")
    check(factor_rel <= 1e-10, "MOL: simulate_final_state's factor differs from solve's")
    check(taylor_rel <= 1e-10, "MOL: TaylorMode differs from the Stack rows")


def rts_oracle(solver, sol, raw=False):
    """The dense full-covariance RTS smoother of
    tests/test_solvers/test_smoothing.py, run in each step's preconditioned
    coordinates (the same recursion under the similarity transform P), or
    with ``raw`` in raw coordinates as that test runs it. At dt = 1e-3 the
    raw scales span dt^2.5 / 2 = 1.6e-8 to dt^0.5 = 0.03, and the raw dense
    gain solve loses digits that the comparison needs (phase B prints both).
    Returns the smoothed ``(flat mean, covariance)`` of every state."""
    A_pre, LQ_pre = solver.iwp.preconditioned_discretize
    Q_pre = LQ_pre @ LQ_pre.T
    dts = torch.diff(sol.t)
    flat = sol.mean.transpose(1, 2).reshape(sol.mean.shape[0], -1)  # point-major
    m_next, C_next = flat[-1], sol.cov_sqrtm[-1] @ sol.cov_sqrtm[-1].T
    out = [(m_next, C_next)]
    for k in range(len(dts) - 1, -1, -1):
        p, p_inv = solver.iwp.nordsieck_preconditioner_1d_raw(dts[k])
        P, P_inv = p.repeat(sol.mean.shape[2]), p_inv.repeat(sol.mean.shape[2])
        if raw:
            P, P_inv = torch.ones_like(P), torch.ones_like(P_inv)
            A_pre, LQ_pre = solver.iwp.non_preconditioned_discretize(dts[k].item())
            Q_pre = LQ_pre @ LQ_pre.T
        m_k = P_inv * flat[k]
        C_k = P_inv[:, None] * (sol.cov_sqrtm[k] @ sol.cov_sqrtm[k].T) * P_inv[None, :]
        m_n, C_n = P_inv * m_next, P_inv[:, None] * C_next * P_inv[None, :]
        mp = A_pre @ m_k
        Pp = A_pre @ C_k @ A_pre.T + Q_pre
        gain = torch.linalg.solve(Pp.T, (C_k @ A_pre.T).T).T
        m_s = m_k + gain @ (m_n - mp)
        C_s = C_k + gain @ (C_n - Pp) @ gain.T
        m_next, C_next = P * m_s, P[:, None] * C_s * P[None, :]
        out.append((m_next, C_next))
    return out[::-1]


def phase_smoothing(pt, dev, launches, card_line):
    """B. RTS smoothing at N = 512: phase 5's configuration (white, panel
    kernel, 20 steps, D = 1536) through ``solve``, all 21 states kept, then
    ``smooth_solution`` (plain QRs and Cholesky solves), against the dense
    oracle in f64 on the card."""
    heat = full_width_heat(pt, dev)
    solver = heat_solver(pt, "householder", steprule=pt.odetools.step.Constant(DT))
    launches.reset()
    sol, solve_s = timed_sync(lambda: solver.solve(heat))
    smoothed, smooth_s = timed_sync(lambda: pt.solvers.smoothing.smooth_solution(solver, sol))
    launches.read(f"N={N_POINTS} smoothing path (the solve's panel launches)",
                  {"panel_lq": EXPECTED_LAUNCHES})
    oracle, oracle_s = timed_sync(lambda: rts_oracle(solver, sol))

    def distance(oracle):
        """The largest distance of the smoother's means and covariances from
        the oracle's, each relative to the state's largest entry."""
        mean_rel = gram_rel = 0.0
        for k, (m_o, C_o) in enumerate(oracle):
            m = smoothed.mean[k].T.reshape(-1)
            G = smoothed.cov_sqrtm[k] @ smoothed.cov_sqrtm[k].T
            mean_rel = max(mean_rel, ((m - m_o).abs().max() / m_o.abs().max()).item())
            gram_rel = max(gram_rel, ((G - C_o).abs().max() / C_o.abs().max()).item())
        return mean_rel, gram_rel

    mean_rel, gram_rel = distance(oracle)
    raw_mean_rel, raw_gram_rel = distance(rts_oracle(solver, sol, raw=True))
    var_f = torch.einsum("tij,tij->ti", sol.cov_sqrtm, sol.cov_sqrtm)
    var_s = torch.einsum("tij,tij->ti", smoothed.cov_sqrtm, smoothed.cov_sqrtm)
    excess = (var_s - var_f).max().item()
    print(f"N={N_POINTS} RTS smoother over {sol.t.shape[0]} states (D={sol.cov_sqrtm.shape[1]}): "
          f"{smooth_s:.3f} s (the solve {solve_s:.3f} s, the dense oracle {oracle_s:.3f} s); "
          f"against the dense oracle, of each state's largest entry: mean {mean_rel:.3e}, "
          f"covariance {gram_rel:.3e} (the raw-coordinate oracle: {raw_mean_rel:.3e} and "
          f"{raw_gram_rel:.3e}); smoothed minus filtered variance at most {excess:.3e} "
          f"[{card_line}]", flush=True)
    check(bool(torch.isfinite(smoothed.mean).all() and torch.isfinite(smoothed.cov_sqrtm).all()),
          "smoothing: NaN or inf")
    check(mean_rel <= 1e-7 and gram_rel <= 1e-6, "smoothing: the dense oracle disagrees")
    check(excess <= 1e-10, "smoothing: a smoothed variance exceeds the filtered one")
    check(torch.equal(smoothed.mean[-1], sol.mean[-1])
          and torch.equal(smoothed.cov_sqrtm[-1], sol.cov_sqrtm[-1]),
          "smoothing: the last state changed")


# phase P: the paper's figures through the port's drivers
# (pnmol_tpu_torch/experiments), each output held to the JAX package's
# committed arrays in experiments/results/ (read as data) at the tolerances
# of tests/test_torch_figure{1,2,3,4}.py; u is the f64 unit roundoff
RESULTS = REPO / "experiments" / "results"
FIGURE2_NOISE = REPO / "tests" / "golden" / "figure2_jax_noise.npz"
U = float(np.finfo(np.float64).eps)
# experiments/figure1.py's printout of the calibrated gammas
FIG1_JAX_GAMMAS = {"pnmol_white": 0.008719248204530036, "pnmol_latent": 0.002750894030713232}
FIG3_DX, FIG4_DX = 1.0 / 64, 0.01
# the finest rows of figures 3 and 4, at the tolerances of
# tests/test_torch_figure{3,4}.py: there the default SquareExponential()
# stencils are near singular (figure 3's 5-point boundary stencils at dx =
# 1/64: u cond = 0.07; the references' meshes worse), so the two packages'
# FD rows part and so do their LSODA references (~2e-6 and ~6e-7 of the
# reference, relative rms). Each relative RMSE is held to the GAP
# absolute (the absolute RMSE to GAP times the reference's rms), each chi2
# to 2 GAP / RMSE relative (e^T C^-1 e moves by about 2 |delta| / |e| when
# the reference moves by delta); figure 3's stds to 1e-3 and its white
# chi2, which also carries the calibration of the parted E, to 0.2; the
# step counts and the axes equal
FIG3_GAP, FIG3_STD_RTOL, FIG3_WHITE_CHI2_RTOL = 1e-4, 1e-3, 0.2
FIG4_GAP = 1e-5
ROUTES_GAP = 1e-8


def committed(figure, name):
    return np.load(RESULTS / figure / f"{name}.npy")


def relative_gap(got, want):
    """max |got - want| / max |want|."""
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def hold_to_gap(label, rmse, want_rmse, chi2, want_chi2, gap, worst, chi2_rtol=None):
    """Relative RMSEs within ``gap`` absolute of JAX's; chi2 within
    ``chi2_rtol`` relative, by default 2 gap / RMSE; keep the largest
    deviations under ``label``."""
    rmse_gap = float(np.abs(rmse - want_rmse).max())
    chi2_rel = np.abs(chi2 / want_chi2 - 1)
    limit = 2 * gap / want_rmse if chi2_rtol is None else chi2_rtol
    worst[f"{label} rmse (abs)"] = max(worst.get(f"{label} rmse (abs)", 0.0), rmse_gap)
    worst[f"{label} chi2 (rel)"] = max(worst.get(f"{label} chi2 (rel)", 0.0),
                                       float(chi2_rel.max()))
    check(rmse_gap <= gap and bool((chi2_rel <= limit).all()),
          f"{label}: RMSE {rmse_gap:.3e} (abs, held to {gap:g}) or chi2 {chi2_rel.max():.3e} "
          f"(rel) beyond the references' gap")


def gram_condition(torch_kernel, points, nugget=0.0):
    pts = torch.tensor(points, dtype=torch.float64)
    gram = torch_kernel(pts, pts.T) + nugget * torch.eye(len(points), dtype=torch.float64)
    return float(torch.linalg.cond(gram))


def phase_figure1(pt, dev, launches, card_line):
    """P1. Figure 1 in full (heat 1-D, d = 6, tmax 3; 60 steps of 0.05 a
    solver; the DP5 reference on the 61-point mesh), the PNMOL solvers
    through the panel kernel."""
    from pnmol_tpu_torch.experiments import figure1

    launches.reset()
    arrays, seconds = timed_sync(lambda: figure1.run(dev))
    # one 128-row panel for the initialization and each of 60 steps, twice
    launches.read("P figure 1", {"panel_lq": 2 * 61})
    worst = {}
    for prefix in ("pnmol_white", "pnmol_latent", "tornadox", "reference"):
        means = relative_gap(arrays[f"{prefix}_means"], committed("figure1", f"{prefix}_means"))
        worst[f"{prefix} means"] = means
        check(means <= (1e-10 if prefix == "reference" else 1e-12),
              f"figure 1 {prefix}: means {means:.3e} from JAX's")
        want = committed("figure1", f"{prefix}_stds")
        stds = float(np.abs(arrays[f"{prefix}_stds"] - want).max())
        worst[f"{prefix} stds (abs)"] = stds
        check(stds <= 1e-11 * np.abs(want).max(), f"figure 1 {prefix}: stds {stds:.3e} off")
        for name in ("ts", "xs"):
            want = committed("figure1", f"{prefix}_{name}")
            check(arrays[f"{prefix}_{name}"].shape == want.shape
                  and float(np.abs(arrays[f"{prefix}_{name}"] - want).max()) <= 1e-14,
                  f"figure 1 {prefix}: {name}")
    for prefix, gamma in FIG1_JAX_GAMMAS.items():
        dev_gamma = abs(float(arrays[f"{prefix}_gamma"]) / gamma - 1)
        worst[f"{prefix} gamma"] = dev_gamma
        check(dev_gamma <= 1e-12, f"figure 1 {prefix}: gamma {dev_gamma:.3e} from JAX's")
    print(f"P figure 1 (heat d=6, 60 steps a solver, DP5 on 61 points): {seconds:.3f} s; "
          f"largest deviations from the committed arrays: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" [{card_line}]", flush=True)


def phase_figure2(pt, dev, launches, card_line):
    """P2. Figure 2 in full (25 points, the 150-point grid): every Gram is
    below the Gram kernel's dispatch, so no kernel runs; the samples drawn
    from JAX's own noise (tests/golden/figure2_jax_noise.npz)."""
    from pnmol_tpu_torch.experiments import figure2

    golden = np.load(FIGURE2_NOISE)
    noises = [golden[f"noise{i}"] for i in (1, 2, 3)]
    launches.reset()
    arrays, seconds = timed_sync(lambda: figure2.run(dev, noises=noises))
    launches.read("P figure 2 (no kernel: 25- and 150-point Grams)", {})
    SE = pt.kernels.SquareExponential
    worst = {}
    check(float(arrays["fig2_scale_mle"]) == float(committed("figure2", "fig2_scale_mle")),
          "figure 2: the MLE scale is not JAX's")
    got, want = arrays["fig2_rmse_all"], committed("figure2", "fig2_rmse_all")
    mesh = np.linspace(0, 1, figure2.NUM_MESH_POINTS)[:, None]
    parted, rmse_dev = [], 0.0
    for i, size in enumerate(committed("figure2", "fig2_stencil_sizes")):
        for j, scale in enumerate(committed("figure2", "fig2_input_scales")):
            rtol = 10 * U * gram_condition(SE(input_scale=float(scale)), mesh[:size] - mesh[0])
            if rtol <= 1.0:
                dev_ij = abs(got[i, j] / want[i, j] - 1)
                rmse_dev = max(rmse_dev, dev_ij)
                check(dev_ij <= rtol, f"figure 2 RMSE at stencil {size}, scale {scale}: "
                      f"{dev_ij:.3e} from JAX's (held to 10 u cond = {rtol:.3e})")
            elif (got[i, j] == figure2.FAILED_RMSE) != (want[i, j] == figure2.FAILED_RMSE):
                parted.append((int(size), float(scale)))
    worst["RMSE grid (where 10 u cond <= 1)"] = rmse_dev
    for name in ("fig2_L_sparse", "fig2_E_sparse"):
        worst[name] = relative_gap(arrays[name], committed("figure2", name))
        check(worst[name] <= 1e-10, f"figure 2 {name}: {worst[name]:.3e} from JAX's")
    bound = U * gram_condition(SE(input_scale=float(arrays["fig2_scale_mle"])), mesh, 1e-12)
    for name, limit in (("fig2_L_dense", bound), ("fig2_E_dense", 10 * bound)):
        worst[name] = relative_gap(arrays[name], committed("figure2", name))
        check(worst[name] <= limit, f"figure 2 {name}: {worst[name]:.3e} from JAX's")
    for name in ("fig2_xgrid", "fig2_fx", "fig2_dfx"):
        worst[name] = relative_gap(arrays[name], committed("figure2", name))
        check(worst[name] <= 1e-14, f"figure 2 {name}: {worst[name]:.3e} from JAX's")
    xgrid = committed("figure2", "fig2_xgrid")
    for k, scale in enumerate(committed("figure2", "fig2_input_scales"), start=1):
        name = f"fig2_s{k}"
        worst[name] = relative_gap(arrays[name], committed("figure2", name))
        limit = U * gram_condition(SE(input_scale=float(scale)), xgrid, 1e-12)
        check(worst[name] <= limit, f"figure 2 {name}: {worst[name]:.3e} from JAX's "
              f"(held to u cond = {limit:.3e})")
    print(f"P figure 2: {seconds:.3f} s; MLE scale {float(arrays['fig2_scale_mle'])!r} (JAX's); "
          f"RMSE entries where one package's Cholesky fails and the other's does not "
          f"(singular stencil Grams, u cond > 0.1): {parted}; largest deviations from the "
          f"committed arrays: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" [{card_line}]", flush=True)


def phase_figure4(pt, dev, launches, card_line, dx=FIG4_DX):
    """C / P3. Figure 4's finest row in full: Lotka-Volterra at dx = 0.01
    (d = 202, stencils 3 and 4), the 12 dts of logspace(0, -2.5), tmax 6,
    through the latent and white semilinear EK1 (panel kernel) and the MOL
    EK1, against LSODA on the dx/7 mesh (d = 1398); or another row's dx."""
    from pnmol_tpu_torch.experiments import figure4

    pde = figure4.make_lv(dx, device=dev, stencil_size_interior=3,
                          stencil_size_boundary=4)
    d, dts = pde.L.shape[0], figure4.default_dts(False)
    m = d + pde.B.shape[0]
    del pde
    steps = [len(pt.pdefilter.constant_step_schedule(0.0, figure4.tmax(False), dt)[1])
             for dt in dts.tolist()]
    # panel launches of one simulate_final_state: init LQ and per-step LQ
    # rows, latent m + 4d and m + 6d, white m + 2d and m + 3d (MOL none)
    expected = sum(block_panels(m + 4 * d) + n * block_panels(m + 6 * d)
                   + block_panels(m + 2 * d) + n * block_panels(m + 3 * d) for n in steps)
    launches.reset()
    arrays, seconds = timed_sync(lambda: figure4.run(dev, dxs=[dx]))
    counts = launches.read(f"P figure 4 dx={dx} (12 dts x 3 methods)",
                           {"panel_lq": expected})
    prefix = f"dx_{dx}"
    worst, diverged = {}, []
    for method in figure4.METHODS:
        got_steps = arrays[f"{prefix}_{method}_nsteps"]
        check(np.array_equal(got_steps, committed("figure4", f"{prefix}_{method}_nsteps"))
              and list(got_steps) == steps, f"figure 4 {method}: step counts")
        rmse, chi2 = (arrays[f"{prefix}_{method}_{k}"] for k in ("rmse", "chi2"))
        want_rmse, want_chi2 = (committed("figure4", f"{prefix}_{method}_{k}")
                                for k in ("rmse", "chi2"))
        # divergence compounds rounding: there both packages must diverge
        # (RMSE > 1), and the ratio is printed
        gone = want_rmse > 1.0
        for i in np.nonzero(gone)[0]:
            diverged.append(f"{method} dt={dts[i]:.4f}: RMSE {rmse[i]:.3e} (JAX {want_rmse[i]:.3e},"
                            f" ratio {rmse[i] / want_rmse[i]:.3f}), chi2 {chi2[i]:.3e} (JAX "
                            f"{want_chi2[i]:.3e})")
            check(rmse[i] > 1.0, f"figure 4 {method} dt={dts[i]}: diverged in JAX, not here")
        hold_to_gap(method, rmse[~gone], want_rmse[~gone], chi2[~gone], want_chi2[~gone],
                    FIG4_GAP, worst)
        times = arrays[f"{prefix}_{method}_time"]
        print(f"P figure 4 dx={dx} {method}: {int(got_steps.sum())} steps in "
              f"{times.sum():.3f} s ({got_steps.sum() / times.sum():.1f} steps/s); per dt "
              f"seconds {np.array2string(times, precision=3)}; RMSE "
              f"{np.array2string(rmse, precision=3)} [{card_line}]", flush=True)
    print(f"P figure 4 dx={dx}: {seconds:.3f} s, {counts['panel_lq']} panel_lq; LSODA "
          f"reference {float(arrays[prefix + '_reference_time']):.3f} s, "
          f"{int(arrays[prefix + '_reference_jac_calls'])} Jacobians (with their copies "
          f"to the host {float(arrays[prefix + '_reference_jac_time']):.3f} s); diverged "
          f"as in JAX: {diverged}; largest deviations from the committed arrays: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" [{card_line}]", flush=True)


def phase_mle(pt, tgram, dev, launches, card_line):
    """D. Input-scale calibration: figure 2's target sin(x . x) on a 512-point
    mesh of [0, 1], 20 trials in logspace(-3, 3): ``mle_input_scale`` on CUDA
    tensors (each 512 x 512 Gram through the Gram kernel), then again through
    the plain Gram on purpose; then 100 Adam steps of the gradient MLE (a
    tensor scale: the plain Gram, which autograd follows)."""
    SE = pt.kernels.SquareExponential

    class PlainSE(SE):
        def __call__(self, X, Y):
            return tgram.gram_radial_reference(X, Y.T, self.input_scale, self.output_scale,
                                               phi_name=self._PHI_NAME)

    X = torch.linspace(0.0, 1.0, MLE_POINTS, dtype=torch.float64, device=dev)[:, None]
    y = torch.sin((X**2).sum(dim=1))
    trials = torch.logspace(-3, 3, MLE_TRIALS, dtype=torch.float64)

    def grid(kernel_type):
        return pt.kernels.mle_input_scale(mesh_points=X, data=y, kernel_type=kernel_type,
                                          input_scale_trials=trials)

    launches.reset()
    best, kernel_s = timed_sync(lambda: grid(SE))
    launches.read(f"N={MLE_POINTS} mle_input_scale grid", {"gram_radial": MLE_TRIALS})
    launches.reset()
    best_plain, plain_s = timed_sync(lambda: grid(PlainSE))
    launches.read(f"N={MLE_POINTS} mle_input_scale grid, plain Gram", {})

    def values(kernel_type):
        return np.array([pt.kernels.input_scale_to_log_likelihood(
            s, X, y, kernel_type).item() for s in trials.tolist()])

    v_kernel, v_plain = values(SE), values(PlainSE)  # comparison launches: not counted
    masked_kernel, masked_plain = np.isnan(v_kernel), np.isnan(v_plain)
    print(f"N={MLE_POINTS} input-scale MLE: chosen {float(best):.6g} (Gram kernel, {kernel_s:.3f} s)"
          f", {float(best_plain):.6g} (plain Gram, {plain_s:.3f} s); masked trials "
          f"{np.nonzero(masked_kernel)[0].tolist()} and {np.nonzero(masked_plain)[0].tolist()} "
          f"of {MLE_TRIALS} (indices into logspace(-3, 3)) [{card_line}]", flush=True)
    for i in np.nonzero(masked_kernel != masked_plain)[0]:
        for label, kernel_type in (("kernel", SE), ("plain", PlainSE)):
            chol, info = torch.linalg.cholesky_ex(kernel_type(input_scale=trials[i].item())(X, X.T))
            # a failed factorization's leading info - 1 pivots are valid
            valid = int(info) - 1 if int(info) > 0 else MLE_POINTS
            smallest = torch.diagonal(chol)[:valid].abs().min().item() if valid else float("nan")
            print(f"  trial {trials[i].item():.6g} masked on one route only: {label} Gram "
                  f"info {int(info)}, smallest pivot {smallest:.3e}", flush=True)
    both = ~masked_kernel & ~masked_plain
    conds = np.array([torch.linalg.cond(PlainSE(input_scale=s)(X, X.T)).item()
                      for s in trials.tolist()])
    rel = np.abs(v_kernel - v_plain) / np.abs(v_plain)
    tame = both & (conds < 1e12)
    for i in np.nonzero(both & ~tame)[0]:
        print(f"  trial {trials[i].item():.6g}: Gram condition {conds[i]:.3e}, log likelihoods "
              f"{v_kernel[i]:.10g} (kernel) and {v_plain[i]:.10g} (plain), rel {rel[i]:.3e}",
              flush=True)
    worst = rel[tame].max() if tame.any() else 0.0
    print(f"N={MLE_POINTS} log likelihoods finite on both routes: {int(both.sum())}, of which "
          f"{int(tame.sum())} with Gram condition below 1e12 agree to {worst:.3e} rel", flush=True)
    check(float(best) == float(best_plain), "MLE: the routes choose different scales")
    if (masked_kernel == masked_plain).all():
        check(worst <= 1e-8, "MLE: the routes' log likelihoods disagree")

    launches.reset()
    scale, grad_s = timed_sync(lambda: pt.kernels.mle_input_scale_gradient(
        mesh_points=X, data=y, kernel_type=SE, initial_scale=float(best)))
    launches.read(f"N={MLE_POINTS} mle_input_scale_gradient", {})
    print(f"N={MLE_POINTS} gradient MLE (100 Adam steps from {float(best):.6g}): scale "
          f"{scale:.10g} in {grad_s:.3f} s [{card_line}]", flush=True)
    check(np.isfinite(scale) and scale > 0, "gradient MLE: not finite")

class StageTimer:
    """Seconds of a steady initialization's stages: inside the ``with``
    block the port's stage functions are wrapped, each call synchronized on
    both ends. Stages: the SDA seed (``seed``, which holds the doublings),
    each doubling (``doubling``; ``bodies`` lists the body each took), the
    polish chunks (``polish``) and the harvest (``harvest``)."""

    def __init__(self, pt):
        self.targets = ((pt.white, "steady_state_sda_seed", "seed"),
                        (pt.white, "converge_white_steady_state", None),
                        (pt.latent, "converge_latent_steady_state", None),
                        (pt.ops.dare, "_sda_step", "doubling"))
        self.seconds, self.bodies, self.saved = {}, [], []

    def __enter__(self):
        self.saved = [(module, name, getattr(module, name)) for module, name, _ in self.targets]
        for (module, name, stage), (_, _, fn) in zip(self.targets, self.saved):
            setattr(module, name, self._wrap(fn, stage))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)

    def _wrap(self, fn, stage):
        def wrapped(*args, **kwargs):
            if stage == "doubling":
                self.bodies.append(args[3])
            key = stage or ("harvest" if kwargs.get("harvest", True) else "polish")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    def line(self, init_s):
        """The stages, and the rest of the initialization (the normal init)."""
        sec = dict.fromkeys(("seed", "doubling", "polish", "harvest"), 0.0) | self.seconds
        rest = init_s - sec["seed"] - sec["polish"] - sec["harvest"]
        doublings = (f"{len(self.bodies)} doublings ({', '.join(sorted(set(self.bodies)))} body) "
                     f"{sec['doubling']:.3f} s" if self.bodies else "no doubling")
        return (f"init {init_s:.3f} s: normal init {rest:.3f} s, SDA seed {sec['seed']:.3f} s "
                f"({doublings}), polish {sec['polish']:.3f} s, harvest {sec['harvest']:.3f} s")


class SplitTimer:
    """Seconds spent in some functions of a module while the ``with`` block
    runs: each is wrapped, its calls synchronized on both ends and summed
    (the ``PhaseTimer`` of ``utils.profiling`` for functions that a path
    calls many times)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.seconds, self.calls, self.saved = {}, {}, {}

    def __enter__(self):
        for name in self.names:
            fn = self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            self.calls[name] = self.calls.get(name, 0) + 1
            return out
        return wrapped

    def line(self, total_s):
        rest = total_s - sum(self.seconds.values())
        return ", ".join(f"{name} {self.seconds[name]:.3f} s ({self.calls[name]} calls)"
                         for name in self.seconds) + f", the rest {rest:.3f} s of {total_s:.3f} s"


def rel_max(a, b):
    """max|a - b| / max|b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def steady_step_bound(solver):
    """Bytes bound of one mean-only step: L21, Sl^{-1}, L and B read once,
    the mean read and written, err_vec read, the error and reference
    written; ``(bytes, ms)``."""
    steady, cache = solver.steady_cache, solver._cache
    mats = (steady.L21, steady.Sl_inv, cache.L, cache.B)
    values = (sum(x.numel() for x in mats) + 2 * steady.L21.shape[0]
              + 3 * steady.err_vec.numel())
    nbytes = values * steady.L21.element_size()
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def bare_steps_per_s(solver, state, pde, num_steps):
    """Mean-only steps through ``attempt_step`` with one synchronization at
    the end; ``(steps/s, final state)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(num_steps):
        state, _ = solver.attempt_step(state, STEADY_DT, pde)
    torch.cuda.synchronize()
    return num_steps / (time.perf_counter() - t0), state


def report_steady(name, solver, init_line, card_line):
    sc, info = solver.steady_cache, solver.steady_diagnostics
    radius = pt_module(solver).steady_closed_loop_radius(
        solver._cache, sc, STEADY_DT, num_derivatives=solver.num_derivatives).item()
    seed = (f"SDA {info['sda_iterations']} iterations (last delta {info['sda_delta']:.3e}), "
            f"dare_residual {info['dare_residual']:.3e}; " if info else "unseeded; ")
    print(f"{name}: {init_line}; {seed}polish {sc.iterations} iterations, delta "
          f"{sc.delta:.6e}; closed-loop radius {radius:.6f} [{card_line}]", flush=True)
    check(all(bool(torch.isfinite(x).all()) for x in (sc.cov_inf, sc.L21, sc.Sl_inv, sc.err_vec)),
          f"{name}: NaN or inf in the steady cache")
    return radius


def pt_module(solver):
    """The solver family's module (white or latent)."""
    return sys.modules[type(solver).__module__]


def phase_steady(pt, dev, launches, card_line):
    """E. Steady state at N = 512, bench.py's steady configuration (nu = 2,
    Constant(1e-2), f64): the seeded white solver through "householder"
    (init LQ 1538 rows: 13 panels; seed update and each polish step 2050
    rows: 17) and the plain path, 512 mean-only steps each; the unseeded
    white solver on the kernel path; the latent solver on both paths (init
    21 panels, each polish step 29)."""
    heat = dx_adapted_heat(pt, dev, N_POINTS, STEADY_STEPS, dt=STEADY_DT)
    m, D = heat.L.shape[0] + heat.B.shape[0], (NU + 1) * N_POINTS
    constant = pt.odetools.step.Constant(STEADY_DT)

    def panels(rows):
        return -(-rows // 128)

    def white(factorization, opts=True):
        return pt.white.LinearWhiteNoiseEK1(
            steprule=constant, num_derivatives=NU, spatial_kernel=prior(pt),
            factorization=factorization, steady_state=opts)

    seeded, final_means, bare_rates = {}, {}, {}
    for fac, label in (("householder", "householder kernel"), (None, "plain torch.linalg.qr")):
        solver = white(fac)
        launches.reset()
        with StageTimer(pt) as stages:
            run = run_solver(solver, heat, num_steps=STEADY_STEPS)
        sc, info = solver.steady_cache, solver.steady_diagnostics
        per_step = panels(m + D)
        launches.read(f"N={N_POINTS} steady white, {label}", {"panel_lq": (
            panels(m + 2 * N_POINTS) + per_step + per_step * (sc.iterations + 1))} if fac else {})
        name = f"N={N_POINTS} steady white, {label}"
        report_steady(name, solver, stages.line(run["init_s"]), card_line)
        report_run(name, run, card_line)
        u = run["state"].y.mean[0].abs().max().item()
        bare, _ = bare_steps_per_s(solver, run["state"], heat, STEADY_STEPS)
        nbytes, bound_ms = steady_step_bound(solver)
        print(f"{name}: max|u| after {STEADY_STEPS} mean-only steps {u:.10f} (the JAX package: "
              f"{JAX_STEADY_MAX_U}, rel {abs(u / JAX_STEADY_MAX_U - 1):.3e}); "
              f"{run['steady_steps_per_s']:.1f} steps/s through solution_generator (a sync a "
              f"step), {bare:.1f} in a bare attempt_step loop; bytes bound {nbytes / 1e6:.2f} MB, "
              f"{bound_ms * 1e3:.2f} us a step, the bare loop at {bound_ms * bare / 1e3:.2%} of "
              f"it [{card_line}]", flush=True)
        check(sc.iterations == 4, f"{name}: {sc.iterations} polish iterations, not 4")
        check(abs(info["sda_iterations"] - JAX_STEADY_SDA_ITERATIONS) <= 1,
              f"{name}: {info['sda_iterations']} SDA iterations")
        check(info["dare_residual"] < 1e-6, f"{name}: dare_residual {info['dare_residual']:.3e}")
        check(abs(u / JAX_STEADY_MAX_U - 1) <= 1e-5, f"{name}: max|u| {u} after the steps")
        seeded[fac] = solver
        final_means[fac] = run["state"].y.mean
        bare_rates[fac] = bare
    a, b = seeded["householder"].steady_cache, seeded[None].steady_cache
    errs = (rel_max(a.cov_inf @ a.cov_inf.T, b.cov_inf @ b.cov_inf.T),
            rel_max(a.L21 @ a.Sl_inv, b.L21 @ b.Sl_inv), rel_max(a.err_vec, b.err_vec))
    print(f"N={N_POINTS} steady white, kernel path vs plain path: cov_inf Gram rel {errs[0]:.3e}, "
          f"gain rel {errs[1]:.3e}, err_vec rel {errs[2]:.3e} [{card_line}]", flush=True)
    check(errs[0] <= 1e-8 and errs[1] <= 1e-6 and errs[2] <= 1e-8,
          "steady white: the kernel path's cache disagrees with the plain path's")

    # unseeded, to tol 1e-10, on the kernel path
    solver = white("householder", STEADY_UNSEEDED)
    launches.reset()
    with StageTimer(pt) as stages:
        state, init_s = timed_sync(lambda: solver.initialize(heat))
    sc = solver.steady_cache
    launches.read(f"N={N_POINTS} steady white unseeded, householder kernel",
                  {"panel_lq": panels(m + 2 * N_POINTS) + panels(m + D) * (sc.iterations + 1)})
    name = f"N={N_POINTS} steady white unseeded (tol 1e-10, max_iters 3000), householder kernel"
    report_steady(name, solver, stages.line(init_s), card_line)
    again = pt.white.converge_white_steady_state(
        solver._cache, sc.cov_inf, STEADY_DT, num_derivatives=NU,
        factorization=solver.factorization, max_iters=1)
    fixed = rel_max(again.cov_inf @ again.cov_inf.T, sc.cov_inf @ sc.cov_inf.T)
    mean_full, cov, frozen, worst = state.y.mean, sc.cov_inf, state, 0.0
    for k in range(1, 9):
        mean_full, cov, *_ = pt.white.white_attempt_step(
            solver._cache, mean_full, cov, k * STEADY_DT, STEADY_DT, num_derivatives=NU,
            factorization=solver.factorization)
        frozen, _ = solver.attempt_step(frozen, STEADY_DT, heat)
        worst = max(worst, rel_max(frozen.y.mean, mean_full))
    s = seeded["householder"].steady_cache
    gaps = (rel_max(s.cov_inf @ s.cov_inf.T, sc.cov_inf @ sc.cov_inf.T),
            rel_max(s.L21 @ s.Sl_inv, sc.L21 @ sc.Sl_inv))
    print(f"{name}: one more cov_step moves the cov_inf Gram {fixed:.3e} (rel); 8 frozen steps "
          f"against 8 full steps seeded at cov_inf: mean rel {worst:.3e}; the default (seeded) "
          f"cache against it: cov_inf Gram rel {gaps[0]:.3e}, gain rel {gaps[1]:.3e} "
          f"[{card_line}]", flush=True)
    check(fixed <= 1e-8, f"{name}: cov_inf is not a fixed point")
    check(worst <= 1e-5, f"{name}: frozen steps leave the full steps")
    check(bool(frozen.y.mean[0].abs().max() < state.y.mean[0].abs().max()),
          f"{name}: heat did not decay")

    # the latent solver (no seed), both paths
    runs = {}
    for fac, label in (("householder", "householder kernel"), (None, "plain torch.linalg.qr")):
        solver = pt.latent.LinearLatentForceEK1(
            steprule=constant, num_derivatives=NU, spatial_kernel=prior(pt),
            factorization=fac, steady_state=True)
        launches.reset()
        with StageTimer(pt) as stages:
            run = run_solver(solver, heat, num_steps=STEADY_STEPS)
        it = solver.steady_cache.iterations
        launches.read(f"N={N_POINTS} steady latent, {label}",
                      {"panel_lq": 21 + 29 * (it + 1)} if fac else {})
        name = f"N={N_POINTS} steady latent, {label}"
        report_steady(name, solver, stages.line(run["init_s"]), card_line)
        report_run(name, run, card_line, d=N_POINTS)
        runs[fac] = run
    compare_runs("steady latent: kernel path vs plain path", runs["householder"], runs[None],
                 d=N_POINTS)
    return dict(solver=seeded["householder"], mean=final_means["householder"], heat=heat,
                bare=bare_rates["householder"])


def phase_steady_large(pt, dev, launches, card_line):
    """F. Steady state at the N = 1e4 point (nu = 1: D = 2e4, m = 10002;
    Constant(1e-2), f64) through "householder", fused=False,
    propagate_band="banded": the init update and the seed update are 30002
    rows (469 leaves each), each polish step a 2e4-row propagate (313) and
    a 30002-row update (469); the SDA on D = 2e4 takes the Cholesky body."""
    d, n = LARGE_N, LARGE_NU + 1
    heat = dx_adapted_heat(pt, dev, d, STEADY_STEPS, dt=STEADY_DT)
    m, D = d + heat.B.shape[0], n * d
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(STEADY_DT), num_derivatives=LARGE_NU,
        spatial_kernel=prior(pt), factorization="householder", fused=False,
        propagate_band="banded", steady_state=True)
    name = f"N={d} steady white, two-QR banded leaf route"
    held = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    launches.reset()
    # what is resident before the seed and before the doubling (the
    # dumps of utils.debug, on for this initialization)
    with StageTimer(pt) as stages, environ(PNMOL_DEBUG_LIVE="1"):
        state0, init_s = timed_sync(lambda: solver.initialize(heat))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    sc, info = solver.steady_cache, solver.steady_diagnostics
    rate, final = bare_steps_per_s(solver, state0, heat, STEADY_STEPS)
    per_step = leaf_launches(D, 256, 64) + leaf_launches(m + D, 256, 64)
    launches.read(name, {"leaf_lq": leaf_launches(m + 2 * d, 256, 64)
                         + leaf_launches(m + D, 256, 64) + per_step * (sc.iterations + 1)})
    report_steady(name, solver, stages.line(init_s), card_line)
    nbytes, bound_ms = steady_step_bound(solver)
    u0, u = state0.y.mean[0].abs().max().item(), final.y.mean[0].abs().max().item()
    print(f"{name}: peak memory {peak:.2f} GiB, of which {held:.2f} GiB held before; "
          f"{STEADY_STEPS} mean-only steps at {rate:.1f} steps/s ({1e3 / rate:.3f} ms a step) "
          f"against a bytes bound of {nbytes / 1e9:.3f} GB, {bound_ms:.3f} ms a step "
          f"({bound_ms * rate / 1e3:.2%} of it); max|u| {u0:.10f} -> {u:.10f} [{card_line}]",
          flush=True)
    check(stages.bodies and set(stages.bodies) == {"chol"}, f"{name}: SDA bodies {stages.bodies}")
    # the certificate's rounding floor grows with cond(sigma): on the CPU it
    # reads 1.5e-9 at 512 points and 1e-7 at 1024 (nu = 1, either body), and
    # 2.6e-5 here on an H100, with the doubling's last delta 4e-22
    check(info["dare_residual"] < 1e-4, f"{name}: dare_residual {info['dare_residual']:.3e}")
    check(bool(torch.isfinite(final.y.mean).all()), f"{name}: NaN or inf in the mean")

    # the harvest from the same factor through the hook and the plain two-QR
    # path (comparison launches: not counted)
    cache = solver._cache
    hook = pt.white.converge_white_steady_state(
        cache, sc.cov_inf, STEADY_DT, num_derivatives=LARGE_NU, fused=False,
        factorization=solver.factorization, propagate_band="banded", max_iters=0)
    grams = (hook.cov_inf @ hook.cov_inf.T, hook.Sl @ hook.Sl.T, hook.L21 @ hook.Sl_inv)
    del hook
    plain = pt.white.converge_white_steady_state(
        cache, sc.cov_inf, STEADY_DT, num_derivatives=LARGE_NU, fused=False, max_iters=0)
    errs = (rel_max(grams[0], plain.cov_inf @ plain.cov_inf.T),
            rel_max(grams[1], plain.Sl @ plain.Sl.T), rel_max(grams[2], plain.L21 @ plain.Sl_inv))
    del grams, plain
    print(f"{name}: harvest through the hook vs the plain two-QR path from the same factor: "
          f"cov_inf Gram rel {errs[0]:.3e}, Sl Gram rel {errs[1]:.3e}, gain rel {errs[2]:.3e} "
          f"[{card_line}]", flush=True)
    check(max(errs[:2]) <= 1e-8, f"{name}: the harvests disagree")

    # 3 full banded steps from the initial state seeded at cov_inf, beside 3
    # frozen steps. From the initial covariance (phase 15) max|u| rises with
    # (L u0) and the filter's initial derivative; from the stationary one it
    # falls (on an H100: 0.1 -> 0.0990 in 3 steps). The two paths
    # move it the same way and stay within the seeded gain's gap (the
    # polish's last delta, 3.5e-4, moves the gain by about as much)
    peak_i = state0.y.mean[0].abs().argmax()
    sign = state0.y.mean[0, peak_i].sign()
    slope = (heat.L[peak_i] @ state0.y.mean[0] * sign).item()
    du0 = (state0.y.mean[1, peak_i] * sign).item()
    mean_full, cov, frozen = state0.y.mean, sc.cov_inf, state0
    for k in range(1, 4):
        mean_full, cov, *_ = pt.white.white_attempt_step(
            cache, mean_full, cov, k * STEADY_DT, STEADY_DT, num_derivatives=LARGE_NU,
            factorization=solver.factorization, fused=False, propagate_band="banded")
        frozen, _ = solver.attempt_step(frozen, STEADY_DT, heat)
    del cov
    u_full, u_frozen = mean_full[0].abs().max().item(), frozen.y.mean[0].abs().max().item()
    print(f"{name}: 3 full banded steps from the initial state at cov_inf against 3 frozen "
          f"steps: mean rel {rel_max(frozen.y.mean, mean_full):.3e}; max|u| {u0:.10f} -> "
          f"{u_full:.10f} (full), {u_frozen:.10f} (frozen); at the initial peak (L u0) = "
          f"{slope:.6e}, the initial derivative {du0:.6e} [{card_line}]", flush=True)
    check((u_full > u0) == (u_frozen > u0), f"{name}: full and frozen steps move max|u| apart")
    check(rel_max(frozen.y.mean, mean_full) <= 1e-3, f"{name}: frozen steps leave the full steps")
    del mean_full, frozen
    # S2: the decay probe's measure on this solver (its configuration: nu =
    # 1, dt 1e-2, the dx-adapted kernel), 2048 mean-only steps. No PDE decay
    # is held at this mesh (the module docstring); the frozen mean is held
    # to the full steps just above
    from pnmol_tpu_torch.experiments import steady_decay_probe

    launches.reset()
    record, seconds = timed_sync(lambda: steady_decay_probe.measure(
        solver, state0, DECAY_STEPS, STEADY_DT))
    launches.read(f"S2 decay N={d} on F's solver", {})
    decay_line(f"S2 decay N={d} (F's solver)", record, card_line, seconds)
    check(np.isfinite(record["ratio"]) and record["n"] == d, f"S2 decay N={d}: not finite")
    # phase N's reference, on the host: the device tensors go with this frame
    frozen = state0
    for _ in range(SHARDED_STEADY_STEPS):
        frozen, _ = solver.attempt_step(frozen, STEADY_DT, heat)
    return dict(cov_inf=sc.cov_inf.cpu(), gain=(sc.L21 @ sc.Sl_inv).cpu(),
                sxz=(sc.L21 @ sc.Sl.T).cpu(), mean=frozen.y.mean.cpu(), delta=sc.delta,
                sda_iterations=info["sda_iterations"], steps_per_s=rate)


# the space-sharded tier: J, one NCCL rank at the N = 1e4 point (nu = 1,
# Constant(DT)), 3 two-QR steps; K, two gloo ranks sharing the card at the
# bench width (N = 512, nu = 2), with global collocation at N = 1e4 (figure
# 2's nuggets, SquareExponential(1/dx): the figure's own MLE scale, 6.16,
# leaves neither K nor E a Cholesky factor from 1024 points on)
SHARDED_STEPS, SHARDED_LATENT_STEPS, COLLOCATION_N = 3, 2, 10000
# stated before the first run on the card: CholeskyQR3 panels against
# Householder QRs drift by eps*cond per step (the JAX package's own sharded
# trajectories: ~4e-6 absolute after 5 f64 steps, tests/test_parallel.py)
SHARDED_RTOL = 1e-4
# stated before K's run against the explicit-difference reference: the
# distance trick's first-order error of a Gram entry, 3 eps s^2 R^2 / 2 with
# s = 9999 and R^2 = |x - c|^2 + |y - c|^2 <= 0.625 on a rank's rows, is
# 2.1e-8; the actions are held to 50 times that
COLLOCATION_RTOL = 1e-6


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def full_white_cache(pt, heat, chol_gram, mesh, nu):
    """The white step cache of the distributed init's ``chol_gram`` (rows
    gathered), for ``shard_cache`` to place."""
    from pnmol_tpu_torch.parallel import meshes

    d = heat.L.shape[0]
    trans = pt.ops.iwp.IntegratedWienerTransition(
        num_derivatives=nu, wiener_process_dimension=d,
        wp_diffusion_sqrtm=mesh.gather_rows(chol_gram, meshes.block_sizes(d, mesh.shape["space"])))
    return pt.white.WhiteSolverCache(
        A1d=trans.preconditioned_discretize_1d[0], Ql=trans.process_noise_factor, L=heat.L,
        B=heat.B, E_bc_sqrtm=torch.block_diag(heat.E_sqrtm, heat.R_sqrtm))


def model_totals(parts, times=1):
    totals = {}
    for part in parts:
        for coll in part.collectives:
            totals[coll.kind] = totals.get(coll.kind, 0) + coll.total_payload * times
    return totals


def counted_against_model(label, mesh, parts, times=1):
    """The mesh's schedule counts since its last reset against the comm
    model's; returns the line's text."""
    got, model = mesh.totals("schedule"), model_totals(parts, times)
    calls = mesh.calls("schedule")
    check(got == model, f"{label}: counted collectives {got} != comm model {model}")
    return (f"{label}: collectives (kind: calls, elements) "
            + ", ".join(f"{k}: {calls[k]}, {got[k]}" for k in sorted(got))
            + f" = comm model; layout {mesh.totals('layout')}, staged "
            f"{mesh.staged_bytes / 2**20:.1f} MiB")


def gathered_cols(mesh, x, n):
    from pnmol_tpu_torch.parallel import meshes

    return mesh.gather_rows(x.T.contiguous(), meshes.block_sizes(n, mesh.shape["space"])).T


def rank_wrappers():
    """The four kernel wrappers in a spawned rank, their counts set to 0:
    a rank has its own counters, which it returns to the parent."""
    from pnmol_tpu_torch.ops import gram as tgram
    from pnmol_tpu_torch.ops import qr_householder as tq

    wrappers = {"panel_lq": tq.panel_lq, "leaf_lq": tq.leaf_lq,
                "gram_radial": tgram.gram_radial, "leaf_qr": tq.leaf_qr}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    return wrappers


def add_rank_launches(label, launches, ranks, expected):
    """The spawned ranks' kernel launches, summed, against ``expected``, and
    added to the run's totals; returns the sum."""
    counts = {}
    for got in ranks:
        for name, count in got["launches"].items():
            counts[name] = counts.get(name, 0) + count
    print(f"{label}: the ranks' launches {counts} (expected {expected})", flush=True)
    check(counts == expected, f"{label}: the ranks' kernel launches")
    for name, count in counts.items():
        launches.totals[name] += count
    return counts


def sharded_large_rank(payload, device):
    """J, on its one NCCL rank: the distributed init and 3 two-QR steps at
    the N = 1e4 point, then the plain single-GPU two-QR run of the same
    problem in the same process; returns the lines to print and the
    comparison."""
    import pnmol_tpu_torch as pt
    from pnmol_tpu_torch.parallel import distributed, sharded_filter, sharded_init, sharded_linalg
    from pnmol_tpu_torch.utils import comm_model

    torch.set_num_threads(4)
    dev = torch.device(device)
    mesh = distributed.global_mesh(batch=1)
    P = mesh.shape["space"]
    wrappers = rank_wrappers()
    heat = dx_adapted_heat(pt, dev, LARGE_N, SHARDED_STEPS)
    d, n_bc = heat.L.shape[0], heat.B.shape[0]
    lines = [f"J: backend {mesh.backend}, {P} rank, {dev}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_counts()
    t0 = time.perf_counter()
    mean0, C0, chol_gram = sharded_init.sharded_white_initialize(
        heat, mesh, num_derivatives=LARGE_NU, spatial_kernel=prior(pt))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lines.append(counted_against_model("J distributed init", mesh, comm_model.distributed_init_cost(
        d, LARGE_NU, n_bc, P, sharded_r=False)))
    cache = sharded_filter.shard_cache(full_white_cache(pt, heat, chol_gram, mesh, LARGE_NU),
                                       mesh, distributed_qr=True, shard_operands=True)
    del chol_gram
    solve = sharded_filter.make_space_sharded_constant_solve(
        cache=cache, num_derivatives=LARGE_NU, mesh=mesh, dt=DT, num_steps=SHARDED_STEPS,
        distributed_qr=True, two_qr=True)
    mesh.reset_counts()
    t1 = time.perf_counter()
    with SplitTimer(sharded_linalg, ("blocked_qr_r_sharded", "ring_matmul", "gram_rowsharded",
                                     "blocked_cholesky", "blocked_cho_solve")) as split:
        mean, cov, diff = solve(mean0, C0, float(heat.t0))
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    steps_per_s = SHARDED_STEPS / step_s
    lines.append(counted_against_model(
        f"J {SHARDED_STEPS} two-QR steps", mesh,
        comm_model.two_qr_step_cost(d, LARGE_NU, n_bc, P), SHARDED_STEPS))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    model = comm_model.step_time_model(comm_model.two_qr_step_cost(d, LARGE_NU, n_bc, P), P)
    lines.append(f"J the steps' split (synchronized): {split.line(step_s)}")
    lines.append(f"J sharded two-QR (N={LARGE_N}, D={(LARGE_NU + 1) * d}, m={d + n_bc}): init "
                 f"{init_s:.3f} s, {steps_per_s:.3f} steps/s over {SHARDED_STEPS} steps, peak "
                 f"{peak:.2f} GiB; the comm model's FP64-peak bound of a step "
                 f"{model['t_step_s']:.3f} s ({model['flops_per_device']:.3e} FLOP)")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(cov).all()), "J: NaN or inf")
    counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
    cov = gathered_cols(mesh, cov, cov.shape[0])
    del cache, C0, mean0
    torch.cuda.empty_cache()

    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(DT), num_derivatives=LARGE_NU,
        spatial_kernel=prior(pt), factorization=None, fused=False)
    t2 = time.perf_counter()
    final, info = solver.simulate_final_state(heat)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t2
    check(info["num_steps"] == SHARDED_STEPS, f"J plain: {info['num_steps']} steps")
    C = final.y.cov_sqrtm
    out = dict(mean=rel(mean, final.y.mean), gram=rel(cov @ cov.T, C @ C.T),
               diff=abs(diff.item() / final.diffusion_squared_local.item() - 1))
    lines.append(f"J plain two-QR torch.linalg.qr, init + {SHARDED_STEPS} steps in "
                 f"{plain_s:.3f} s; sharded vs plain: mean rel {out['mean']:.3e}, Gram rel "
                 f"{out['gram']:.3e}, diffusion rel {out['diff']:.3e}")
    return dict(lines=lines, launches=counts, **out)


def _heat_run(mean, cov, diff, mesh):
    return dict(mean=mean.cpu(), cov=gathered_cols(mesh, cov, cov.shape[0]).cpu(),
                diff=float(diff))


def sharded_gloo_rank(payload, device):
    """K, on each of two gloo ranks sharing the card: the distributed init
    and 20 fused distributed-QR steps at the bench width, the same with the
    two-QR split, the latent init and 2 steps, the adaptive solve, and
    global collocation at N = 1e4 with each rank's Gram block through the
    Gram kernel; returns the lines to print, the runs' final states, and
    the rank's kernel launches."""
    import pnmol_tpu_torch as pt
    from pnmol_tpu_torch.parallel import distributed, meshes, sharded_filter, sharded_init, \
        sharded_linalg
    from pnmol_tpu_torch.utils import comm_model

    torch.set_num_threads(2)
    dev = torch.device(device)
    mesh = distributed.global_mesh(batch=1)
    P = mesh.shape["space"]
    wrappers = rank_wrappers()
    heat = full_width_heat(pt, dev)
    d, n_bc = heat.L.shape[0], heat.B.shape[0]
    lines, runs = [f"K: backend {mesh.backend}, rank {mesh.rank} of {P}, {dev}"], {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    mesh.reset_counts()
    (mean0, C0, chol_gram), init_s = timed(lambda: sharded_init.sharded_white_initialize(
        heat, mesh, num_derivatives=NU, spatial_kernel=prior(pt)))
    lines.append(counted_against_model("K distributed init", mesh,
                                       comm_model.distributed_init_cost(d, NU, n_bc, P,
                                                                        sharded_r=False)))
    lines.append(f"K distributed init: {init_s:.3f} s")
    fused = sharded_init.sharded_white_cache(heat, chol_gram, mesh, num_derivatives=NU)
    for label, cache, two_qr in (
        ("fused distributed-QR", fused, False),
        ("two-QR", sharded_filter.shard_cache(full_white_cache(pt, heat, chol_gram, mesh, NU),
                                              mesh, distributed_qr=True, shard_operands=True),
         True),
    ):
        solve = sharded_filter.make_space_sharded_constant_solve(
            cache=cache, num_derivatives=NU, mesh=mesh, dt=DT, num_steps=NUM_STEPS,
            distributed_qr=True, two_qr=two_qr)
        mesh.reset_counts()
        (mean, cov, diff), seconds = timed(lambda: solve(mean0, C0, float(heat.t0)))
        line = f"K {label}: {NUM_STEPS / seconds:.2f} steps/s over {NUM_STEPS} steps"
        if two_qr:
            lines.append(counted_against_model(f"K {label} {NUM_STEPS} steps", mesh,
                                               comm_model.two_qr_step_cost(d, NU, n_bc, P),
                                               NUM_STEPS))
        else:
            line += (f"; collectives {mesh.calls('schedule')} calls, staged "
                     f"{mesh.staged_bytes / 2**20:.1f} MiB")
        lines.append(line)
        runs[label] = _heat_run(mean, cov, diff, mesh)

    rule = pt.odetools.step.Adaptive()
    heat_adaptive = full_width_heat(pt, dev, tmax=ADAPTIVE_TMAX)
    solve = sharded_filter.make_space_sharded_adaptive_solve(
        cache=fused, num_derivatives=NU, mesh=mesh, steprule=rule, t0=0.0, tmax=ADAPTIVE_TMAX)
    mesh.reset_counts()
    (t, mean, cov, diff, n_steps, n_attempts), seconds = timed(
        lambda: solve(mean0, C0, float(rule.first_dt(heat_adaptive))))
    lines.append(f"K adaptive to t = {t:.6g}: {n_steps} steps of {n_attempts} attempts in "
                 f"{seconds:.3f} s; staged {mesh.staged_bytes / 2**20:.1f} MiB")
    runs["adaptive"] = dict(_heat_run(mean, cov, diff, mesh), t=t, n_steps=n_steps,
                            n_attempts=n_attempts)
    del fused, C0

    mesh.reset_counts()
    (mean0, C0, chol_gram), init_s = timed(lambda: sharded_init.sharded_latent_initialize(
        heat, mesh, num_derivatives=NU, spatial_kernel=prior(pt)))
    cache = sharded_init.sharded_latent_cache(heat, chol_gram, mesh, num_derivatives=NU)
    solve = sharded_filter.make_space_sharded_constant_solve(
        cache=cache, num_derivatives=NU, mesh=mesh, dt=DT, num_steps=SHARDED_LATENT_STEPS,
        latent=True)
    (mean, cov, diff), seconds = timed(lambda: solve(mean0, C0, float(heat.t0)))
    lines.append(f"K latent: init {init_s:.3f} s, {SHARDED_LATENT_STEPS / seconds:.2f} steps/s "
                 f"over {SHARDED_LATENT_STEPS} steps; staged {mesh.staged_bytes / 2**20:.1f} MiB")
    runs["latent"] = _heat_run(mean, cov, diff, mesh)
    del cache, C0, chol_gram

    # global collocation at N = 1e4: each rank's 5000 x 1e4 Gram block runs
    # the Gram kernel; D's action on a smooth function and E E^T's on a
    # seeded vector come back for the comparison
    grid = pt.mesh.RectangularMesh.from_bbox_1d([0.0, 1.0], num=COLLOCATION_N, device=dev)
    kernel = pt.kernels.SquareExponential(input_scale=float(COLLOCATION_N - 1))
    mesh.reset_counts()
    before = wrappers["gram_radial"].launches
    (D, E), seconds = timed(lambda: sharded_linalg.sharded_collocation_global(
        pt.diffops.laplace(), grid, mesh, kernel=kernel, nugget_gram_matrix=1e-12,
        nugget_cholesky_E=1e-10, symmetrize_cholesky_E=True))
    check(wrappers["gram_radial"].launches == before + 1, "K collocation: the rank's Gram block "
          "did not run the Gram kernel")
    start, stop = mesh.bounds(COLLOCATION_N)
    f = torch.sin(3.0 * grid.points[:, 0])
    v = torch.tensor(np.random.default_rng(0).standard_normal(COLLOCATION_N), device=dev)
    EtV = mesh.psum(E.T @ v[start:stop], region="layout")
    sizes = meshes.block_sizes(COLLOCATION_N, P)
    runs["collocation"] = dict(Df=mesh.gather_rows(D @ f, sizes).cpu(),
                               EEv=mesh.gather_rows(E @ EtV, sizes).cpu())
    lines.append(f"K sharded collocation N={COLLOCATION_N}: {seconds:.3f} s, rank block "
                 f"{tuple(D.shape)}; staged {mesh.staged_bytes / 2**20:.1f} MiB, layout "
                 f"{mesh.totals('layout')}")
    counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
    return dict(lines=lines, runs=runs, launches=counts)


def compare_final(label, got, ref_mean, ref_cov, ref_diff, d=None):
    """A sharded run's final mean, covariance Gram and diffusion against a
    single-GPU run's, relative, held to SHARDED_RTOL."""
    mean, cov = got["mean"].to(ref_mean.device), got["cov"].to(ref_mean.device)
    out = dict(mean=rel(mean[:, :d], ref_mean[:, :d]), gram=rel(cov @ cov.T, ref_cov @ ref_cov.T),
               diff=abs(got["diff"] / float(ref_diff) - 1))
    print(f"{label}: mean rel {out['mean']:.3e}, Gram rel {out['gram']:.3e}, diffusion rel "
          f"{out['diff']:.3e} (held to {SHARDED_RTOL:g})", flush=True)
    check(max(out.values()) <= SHARDED_RTOL, f"{label}: sharded and single-GPU runs disagree")


def phase_sharded_large(pt, dev, launches, card_line):
    """J. One NCCL rank at the N = 1e4 point, spawned by the launcher (NCCL
    takes one rank per GPU): the distributed init, 3 two-QR memory-bounded
    steps with the cache placed by shard_cache(shard_operands=True), the
    counted collectives against the comm model at P = 1, and the plain
    single-GPU two-QR run of the same problem."""
    from pnmol_tpu_torch.parallel import distributed

    import chip_smoke

    launches.reset()
    t0 = time.perf_counter()
    (got, _), = distributed.spawn_ranks(chip_smoke.sharded_large_rank, 1, backend="nccl",
                                       device="cuda:0", timeout=900)
    launches.read("J one NCCL rank: this process", {})
    for line in got["lines"]:
        print(f"{line} [{card_line}]", flush=True)
    add_rank_launches("J one NCCL rank (no kernel on its path)", launches, [got],
                      dict.fromkeys(SOURCES, 0))
    print(f"J: {time.perf_counter() - t0:.1f} s with the rank's start", flush=True)
    check(max(got["mean"], got["gram"], got["diff"]) <= SHARDED_RTOL,
          f"J: sharded and plain runs disagree beyond {SHARDED_RTOL:g}")


def phase_sharded_gloo(pt, dev, launches, card_line, plain, latent_plain, adaptive_plain):
    """K. Two gloo ranks sharing the card (their collectives staged through
    host memory) at the bench width, each run against its single-GPU plain
    run (phases 5, 9 and 11); the collocation against the single-GPU
    ``collocation_global`` at N = 1e4. The ranks' Gram-kernel launches add
    to the record."""
    from pnmol_tpu_torch.parallel import distributed

    import chip_smoke

    launches.reset()
    t0 = time.perf_counter()
    ranks = distributed.spawn_ranks(chip_smoke.sharded_gloo_rank, 2, backend="gloo",
                                    device="cuda:0", timeout=900)
    elapsed = time.perf_counter() - t0
    launches.read("K two gloo ranks: this process", {})
    for got, _ in ranks:
        for line in got["lines"]:
            print(f"{line} [{card_line}]", flush=True)
    print(f"K: {elapsed:.1f} s with the ranks' start", flush=True)
    add_rank_launches("K two gloo ranks", launches, [got for got, _ in ranks],
                      {**dict.fromkeys(SOURCES, 0), "gram_radial": 2})
    runs = ranks[0][0]["runs"]
    check(all(np.array_equal(r["runs"]["adaptive"]["mean"].numpy(),
                             runs["adaptive"]["mean"].numpy()) for r, _ in ranks),
          "K: the ranks' adaptive means differ")

    ref_cov = plain["state"].y.cov_sqrtm * torch.sqrt(plain["diffusion"])
    for label in ("fused distributed-QR", "two-QR"):
        compare_final(f"K {label} vs phase 5's plain run", runs[label], plain["state"].y.mean,
                      ref_cov, plain["diffusion"])
    adaptive = runs["adaptive"]
    info = adaptive_plain["info"]
    print(f"K adaptive: {adaptive['n_steps']} steps of {adaptive['n_attempts']} attempts "
          f"(phase 11's plain run: {info['num_steps']} of {info['num_attempted_steps']})",
          flush=True)
    check(adaptive["n_steps"] == info["num_steps"]
          and adaptive["n_attempts"] == info["num_attempted_steps"]
          and abs(adaptive["t"] - ADAPTIVE_TMAX) <= 1e-12, "K adaptive: step counts")
    # along the adaptive trajectory (dt up to 0.03) the CholeskyQR3 panels
    # drift from a Householder QR by far more than roundoff, in the JAX
    # package as in the port (tests/torch_adaptive_drift.py: 4.1e-4 in the
    # mean and 9.8e-3 in the Gram on one device, both packages): the sharded
    # run is held to the single-GPU run of the same factorization (phase
    # 11's solver with the distributed factorization on a one-rank mesh),
    # and its drift from phase 11's plain run to 1.5x that run's
    from pnmol_tpu_torch.parallel import meshes, sharded_filter

    hook = run_solver(heat_solver(pt, sharded_filter.make_distributed_factorization(
        mesh=meshes.make_mesh())), full_width_heat(pt, dev, tmax=ADAPTIVE_TMAX), num_steps=None)
    check(hook["info"]["num_attempted_steps"] == info["num_attempted_steps"],
          "K adaptive: the one-rank run's attempts")
    scaled = {name: (run["state"].y.mean, run["state"].y.cov_sqrtm * torch.sqrt(run["diffusion"]),
                     run["diffusion"]) for name, run in (("hook", hook), ("plain", adaptive_plain))}
    compare_final("K adaptive vs the one-rank run of the same factorization", adaptive,
                  *scaled["hook"])
    drift = {}
    for name, got in (("two gloo ranks", adaptive), ("one rank", dict(
            mean=scaled["hook"][0], cov=scaled["hook"][1], diff=float(scaled["hook"][2])))):
        mean, cov = got["mean"].to(dev), got["cov"].to(dev)
        ref_mean, ref_cov, ref_diff = scaled["plain"]
        drift[name] = (rel(mean, ref_mean), rel(cov @ cov.T, ref_cov @ ref_cov.T),
                       abs(got["diff"] / float(ref_diff) - 1))
        print(f"K adaptive, {name} against phase 11's plain run: mean rel {drift[name][0]:.3e}, "
              f"Gram rel {drift[name][1]:.3e}, diffusion rel {drift[name][2]:.3e}", flush=True)
    check(all(a <= 1.5 * b for a, b in zip(drift["two gloo ranks"], drift["one rank"])),
          "K adaptive: the sharded run drifts beyond the one-rank run's drift")
    compare_final("K latent vs the plain latent run (phase 9's, 2 steps)", runs["latent"],
                  latent_plain["state"].y.mean,
                  latent_plain["state"].y.cov_sqrtm * torch.sqrt(latent_plain["diffusion"]),
                  latent_plain["diffusion"], d=N_POINTS)

    # the reference: the single-GPU collocation_global with K(X, X) from
    # explicit differences (x - y)^2 in f64, free of the distance trick whose
    # rounding (eps * input_scale^2 * |x - c|^2, about 2e-8 of an entry here)
    # both the sharded run and the single-GPU Gram-kernel run carry; both are
    # held to COLLOCATION_RTOL of it (comparison launches: not counted)
    col = runs["collocation"]
    Df, EEv = collocation_actions(pt, dev, COLLOCATION_N, exact=True)
    Df_trick, EEv_trick = collocation_actions(pt, dev, COLLOCATION_N)
    got = {"sharded": (rel(col["Df"].to(dev), Df), rel(col["EEv"].to(dev), EEv)),
           "single-GPU": (rel(Df_trick, Df), rel(EEv_trick, EEv))}
    print(f"K collocation N={COLLOCATION_N} against the single-GPU collocation_global with "
          f"explicit-difference K: " + "; ".join(
              f"{name}: D f rel {d:.3e}, E E^T v rel {e:.3e}" for name, (d, e) in got.items())
          + f" (held to {COLLOCATION_RTOL:g}); sharded against the single-GPU Gram-kernel run: "
          f"{rel(col['Df'].to(dev), Df_trick):.3e}, {rel(col['EEv'].to(dev), EEv_trick):.3e}",
          flush=True)
    check(max(max(pair) for pair in got.values()) <= COLLOCATION_RTOL,
          "K collocation: the sharded or single-GPU run disagrees with the reference")


def collocation_actions(pt, dev, n, exact=False):
    """``(D f, E E^T v)`` of the single-GPU ``collocation_global`` on n points
    of [0, 1] (``SquareExponential(1/dx)``, figure 2's nuggets), with
    f = sin(3 x) and v from seed 0. ``exact`` evaluates K(X, X) through the
    kernel's pairwise form (explicit differences) instead of the Gram
    kernel's distance trick."""
    x = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=dev)[:, None]
    f = torch.sin(3.0 * x[:, 0])
    v = torch.tensor(np.random.default_rng(0).standard_normal(n), device=dev)
    kernel = pt.kernels.SquareExponential(input_scale=float(n - 1))
    D, E = pt.discretize.collocation_global(
        pt.diffops.laplace(), pt.mesh.RectangularMesh(x.cpu().numpy(), device=dev),
        kernel=pt.kernels.Lambda(kernel.pairwise) if exact else kernel,
        nugget_gram_matrix=1e-12, nugget_cholesky_E=1e-10, symmetrize_cholesky_E=True)
    return D @ f, E @ (E.T @ v)


def latent_plain_short(pt, dev):
    """The phase-9 configuration cut to K's latent steps, on the plain path."""
    heat = full_width_heat(pt, dev, tmax=SHARDED_LATENT_STEPS * DT)
    solver = heat_solver(pt, None, cls=pt.latent.LinearLatentForceEK1,
                         steprule=pt.odetools.step.Constant(DT))
    return run_solver(solver, heat, num_steps=SHARDED_LATENT_STEPS)


def phase_figure3(pt, dev, launches, card_line, dx=FIG3_DX):
    """L / P4. Figure 3's finest row in full: SIR at dx = 1/64 (d = 195,
    nu = 1, stencils 3 and 5, the duplicate(Matern52 + WhiteNoise, 3) prior,
    tmax 6), the 18 dts 2^(2 .. -6.5), the white semilinear EK1 (panel
    kernel) and the MOL EK1 against LSODA on the dx/10 mesh (d = 1917);
    the white solver sequentially and as one batched sweep
    (``ensembles.dt_sweep_final_states``, the initialization on the
    kernel), each held to the committed row and the two to each other at
    the kernel path's tolerances against the plain one; or another row's
    dx."""
    from pnmol_tpu_torch.experiments import figure3

    pde = figure3.make_sir(dx, figure3.STENCIL_SIZE + 2, device=dev)
    d = pde.L.shape[0]
    m = d + pde.B.shape[0]
    del pde
    dts = sorted(figure3.DTS)
    steps = [len(pt.pdefilter.constant_step_schedule(0.0, figure3.tmax(False), dt)[1])
             for dt in dts]
    # nu = 1: the initialization's LQ and every step's have m + 2d rows
    panels = block_panels(m + 2 * d)
    row = int(np.nonzero(committed("figure3", "pnmol_white_dx")[:, 0] == dx)[0][0])
    runs, worst = {}, {}
    for route, ensemble, expected in (("sequential", False, sum(1 + n for n in steps) * panels),
                                      ("ensemble", True, panels)):
        launches.reset()
        arrays, seconds = timed_sync(lambda: figure3.run(dev, dxs=[dx], ensemble=ensemble))
        counts = launches.read(f"P figure 3 dx={dx:g} {route} (18 dts x 2 methods)",
                               {"panel_lq": expected})
        runs[route] = arrays
        for method in ("pnmol_white", "tornadox"):
            want = {k: committed("figure3", f"{method}_{k}")[row]
                    for k in ("error_abs", "error_rel", "std", "chi2", "dt", "dx")}
            got = {k: arrays[f"{method}_{k}"][0] for k in want}
            hold_to_gap(f"{method} {route}", got["error_rel"], want["error_rel"], got["chi2"],
                        want["chi2"], FIG3_GAP, worst,
                        FIG3_WHITE_CHI2_RTOL if method == "pnmol_white" else None)
            ref_rms = want["error_abs"] / want["error_rel"]
            check(bool((np.abs(got["error_abs"] - want["error_abs"]) <= FIG3_GAP * ref_rms).all()),
                  f"figure 3 {method} {route}: error_abs beyond the references' gap")
            std_rel = float(np.abs(got["std"] / want["std"] - 1).max())
            worst[f"{method} {route} std (rel)"] = std_rel
            check(std_rel <= FIG3_STD_RTOL, f"figure 3 {method} {route}: std {std_rel:.3e}")
            check(np.array_equal(got["dt"], want["dt"]) and np.array_equal(got["dx"], want["dx"]),
                  f"figure 3 {method}: the dt and dx axes")
        print(f"P figure 3 dx={dx:g} {route}: {seconds:.3f} s, {sum(steps)} steps a method, "
              f"{counts['panel_lq']} panel_lq; white {arrays['pnmol_white_runtime'].sum():.3f} s, "
              f"MOL {arrays['tornadox_runtime'].sum():.3f} s "
              f"({sum(steps) / arrays['tornadox_runtime'].sum():.1f} steps/s); LSODA reference "
              f"{float(arrays['reference_time'][0]):.3f} s, "
              f"{int(arrays['reference_jac_calls'][0])} Jacobians (with their copies to the "
              f"host {float(arrays['reference_jac_time'][0]):.3f} s) [{card_line}]", flush=True)
    # the two routes part as the kernel path parts from the plain one
    # (compare_runs: mean 1e-8, diffusion 1e-6): the sequential white steps
    # run the panel kernel, the batched sweep torch.linalg.qr. So the relative
    # RMSEs within ROUTES_GAP = 1e-8 absolute, the stds 1e-6 relative, the
    # chi2 1e-6 + 2 ROUTES_GAP / RMSE relative (MOL's route is the same)
    apart = {}
    for method in ("pnmol_white", "tornadox"):
        seq, ens = ({k: runs[r][f"{method}_{k}"][0] for k in ("error_rel", "std", "chi2")}
                    for r in ("sequential", "ensemble"))
        hold_to_gap(f"{method} routes", ens["error_rel"], seq["error_rel"], ens["chi2"],
                    seq["chi2"], ROUTES_GAP, apart, 1e-6 + 2 * ROUTES_GAP / seq["error_rel"])
        apart[f"{method} routes std (rel)"] = float(np.abs(ens["std"] / seq["std"] - 1).max())
        check(apart[f"{method} routes std (rel)"] <= 1e-6, f"figure 3 {method}: the routes' stds")
    print(f"P figure 3 dx={dx:g}: the batched sweep against the sequential solves: "
          + ", ".join(f"{k} {v:.3e}" for k, v in apart.items())
          + "; largest deviations from the committed row: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" [{card_line}]", flush=True)


# the steady half of the sharded tier and the utilities: M, gradients
# through 5 plain white steps of the dx = 0.2 heat (the JAX package's
# differentiability problem); N, the sharded steady state on one NCCL rank
# at phase F's point, then 20 mean-only steps; E2, two gloo ranks at phase
# E's point, 512 mean-only steps and a three-dt frozen-gain sweep; O, the
# utilities on phase 5's path
GRAD_STEPS, GRAD_DT, GRAD_SCALE = 5, 0.1, 0.035
SHARDED_STEADY_STEPS = 20
STEADY_SWEEP_DTS, STEADY_SWEEP_TMAX = (1e-2, 5e-3, 2.5e-3), 0.1
# the tolerances of tests/test_parallel.py's seeded sharded steady state
# (the JAX package's: both sides polish from different seeds), on the Gram
# of cov_inf. The gain K = L21 Sl^-1 is printed, not held: along the
# innovation directions of the exact Dirichlet rows it carries the
# distributed factorization's rounding times cond(S), and at phase E's point
# the JAX package's own sharded gain sits beyond these tolerances from its
# single-device one (tests/torch_steady_gain_spread.py). Its action is held
# instead: the mean after the frozen steps against the single-GPU run's, to
# the limit phases E and F already put on the frozen gain's own gap (frozen
# against full steps: 1e-5 at N = 512, 1e-3 at N = 1e4)
STEADY_RTOL, STEADY_ATOL = 5e-3, 1e-4
STEADY_TRAJECTORY_RTOL = {N_POINTS: 1e-5, LARGE_N: 1e-3}
# at N = 1e4 the Gram's entries outgrow the absolute atol; there it is held
# as tests/test_parallel.py's chunked test holds two stopped polishes: both
# inside the stopping delta's neighborhood, rtol = 10 x delta of max |G|
STEADY_GRAM_DELTAS = 10.0
RESILIENT_NAN_STEP, RESILIENT_CHECKPOINT_EVERY = 10, 5


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the ``with`` block, then restore them."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_gradients(pt, tq, dev, launches, card_line):
    """M. ``torch.autograd.grad`` of the final mean's squared norm after 5
    plain white steps with respect to the diffusion scale (at 0.035), on the
    card, against central differences (1e-4) and the same run on the CPU
    (1e-10); then the same loss through the Householder panel route, which
    must raise (the kernel has no backward)."""

    def make_loss(device):
        heat = pt.pde.examples.heat_1d_discretized(dx=0.2, tmax=0.5, device=device)
        solver = pt.white.LinearWhiteNoiseEK1(steprule=pt.odetools.step.Constant(GRAD_DT),
                                              spatial_kernel=prior(pt))
        state = solver.initialize(heat)
        base = heat.L / heat.diffop_scale

        def loss(scale, factorization=None):
            cache = solver._cache._replace(L=scale * base)
            mean, cov = state.y.mean, state.y.cov_sqrtm
            for k in range(1, GRAD_STEPS + 1):
                mean, cov, *_ = pt.white.white_attempt_step(
                    cache, mean, cov, k * GRAD_DT, GRAD_DT, num_derivatives=NU,
                    factorization=factorization)
            return (mean[0] ** 2).sum()

        return loss

    def grad(loss, device):
        x = torch.tensor(GRAD_SCALE, dtype=torch.float64, device=device, requires_grad=True)
        return torch.autograd.grad(loss(x), x)[0].item()

    launches.reset()
    loss = make_loss(dev)
    (g, g_s) = timed_sync(lambda: grad(loss, dev))
    g_cpu = grad(make_loss("cpu"), "cpu")
    eps = 1e-6
    with torch.no_grad():
        up, down = (loss(torch.tensor(GRAD_SCALE + s * eps, dtype=torch.float64, device=dev))
                    for s in (1, -1))
    fd = (up - down).item() / (2 * eps)
    launches.read("M gradients through the plain steps (no kernel on the path)", {})
    print(f"M gradient through {GRAD_STEPS} plain white steps (dx=0.2): {g:.16e} on the card in "
          f"{g_s:.3f} s, {g_cpu:.16e} on the CPU (rel {abs(g / g_cpu - 1):.3e}), central "
          f"differences {fd:.16e} (rel {abs(g / fd - 1):.3e}) [{card_line}]", flush=True)
    check(abs(g - g_cpu) <= 1e-10 * abs(g_cpu), "M: the card's gradient differs from the CPU's")
    check(abs(g - fd) <= 1e-4 * abs(fd), "M: the gradient differs from central differences")
    hook = tq.make_householder_lq_factorization()
    launches.reset()
    try:
        grad(lambda x: loss(x, hook), dev)
    except RuntimeError as err:
        raised = str(err)
    else:
        raised = None
    launches.read("M gradient through the panel route (raises before a launch)", {})
    print(f"M gradient through the Householder panel route raises: {raised}", flush=True)
    check(raised is not None and "no backward" in raised,
          "M: a gradient through the panel route did not raise")


def compare_blocks(got, ref, rtol=STEADY_RTOL, atol=STEADY_ATOL, chunk=2048):
    """``got`` against ``ref`` entrywise; a pair ``(X, Y)`` stands for ``X @
    Y``, formed on the card a chunk of rows at a time. Returns ``(max abs
    difference, its ratio to max |ref|, max |ref|, the excess of the
    difference over atol + rtol |ref|)``."""
    def rows(a, r):
        return a[0][r:r + chunk] @ a[1] if isinstance(a, tuple) else a[r:r + chunk]

    worst = excess = scale = 0.0
    n = (got[0] if isinstance(got, tuple) else got).shape[0]
    for r in range(0, n, chunk):
        a, b = rows(got, r), rows(ref, r)
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        excess = max(excess, (diff - atol - rtol * b.abs()).max().item())
        scale = max(scale, b.abs().max().item())
    return worst, worst / scale, scale, excess


def phase_sharded_steady_large(pt, dev, launches, card_line, reference):
    """N. The sharded steady tier on ONE NCCL rank (a process group of this
    process) at phase F's point (nu = 1, D = 2e4, m = 10002,
    Constant(1e-2), f64): the distributed init, the cache placed by
    ``shard_cache(distributed_qr=True)``, ``converge_space_sharded_steady_state``
    seeded by ``sharded_steady_seed`` (each doubling's collectives against
    the comm model) with 4 polish iterations (phase F's), then 20 steps of
    ``make_space_sharded_steady_solve`` against the single-GPU frozen
    recursion from the same blocks; held to phase F's (host) reference: the
    Gram of cov_inf within STEADY_GRAM_DELTAS polish deltas and the mean
    after the 20 frozen steps at STEADY_TRAJECTORY_RTOL (the gain and the
    Gram's excess over STEADY_RTOL/STEADY_ATOL printed)."""
    import torch.distributed as dist

    from pnmol_tpu_torch.parallel import distributed, sharded_dare, sharded_filter, sharded_init
    from pnmol_tpu_torch.utils import comm_model

    torch.cuda.empty_cache()
    distributed.init_distributed(backend="nccl", master_addr="127.0.0.1", master_port=free_port(),
                                 world_size=1, rank=0, device=dev)
    try:
        mesh = distributed.global_mesh(batch=1)
        P = mesh.shape["space"]
        d, n = LARGE_N, LARGE_NU + 1
        heat = dx_adapted_heat(pt, dev, d, STEADY_STEPS, dt=STEADY_DT)
        D = n * d
        name = f"N one NCCL rank, N={d} sharded steady state (D={D}, m={d + heat.B.shape[0]})"
        held = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        launches.reset()
        (mean0, C0, chol_gram), init_s = timed_sync(lambda: sharded_init.sharded_white_initialize(
            heat, mesh, num_derivatives=LARGE_NU, spatial_kernel=prior(pt)))
        cache = sharded_filter.shard_cache(full_white_cache(pt, heat, chol_gram, mesh, LARGE_NU),
                                           mesh, distributed_qr=True)
        del chol_gram
        real_sda, real_seed = sharded_dare.sda_sharded, sharded_dare.sharded_steady_seed
        stages = {}

        def counted_sda(*args, **kwargs):
            mesh.reset_counts()
            res, stages["sda_s"] = timed_sync(lambda: real_sda(*args, **kwargs))
            stages["sda_counts"] = (mesh.totals("schedule"), mesh.calls("schedule"),
                                    mesh.totals("layout"))
            return res

        def timed_seed(*args, **kwargs):
            out, stages["seed_s"] = timed_sync(lambda: real_seed(*args, **kwargs))
            mesh.reset_counts()  # the polish's collectives from here on
            return out

        diagnostics = {}
        sharded_dare.sda_sharded, sharded_dare.sharded_steady_seed = counted_sda, timed_seed
        try:
            with environ(PNMOL_DEBUG_LIVE="1"):
                steady, steady_s = timed_sync(
                    lambda: sharded_filter.converge_space_sharded_steady_state(
                        cache=cache, cov0=C0, dt=STEADY_DT, num_derivatives=LARGE_NU, mesh=mesh,
                        max_iters=4, diagnostics=diagnostics))
        finally:
            sharded_dare.sda_sharded, sharded_dare.sharded_steady_seed = real_sda, real_seed
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        polish = (mesh.calls("schedule"), mesh.totals("layout"))
        del C0
        launches.read(f"{name} (no kernel on the sharded path)", {})
        its = diagnostics["sda_iterations"]
        schedule, calls, layout = stages["sda_counts"]
        model = model_totals([comm_model.blocked_cholesky_cost(D, P)] * 2
                             + [comm_model.blocked_cho_solve_cost(D, D, P)] * 2, its)
        print(f"{name}: init {init_s:.3f} s; seed {stages['seed_s']:.3f} s, of which SDA "
              f"{its} doublings {stages['sda_s']:.3f} s ({stages['sda_s'] / its:.3f} s a doubling;"
              f" phase F's dense SDA {reference['sda_iterations']} doublings), last delta "
              f"{diagnostics['sda_delta']:.3e}, dare_residual {diagnostics['dare_residual']:.3e};"
              f" polish {steady.local.iterations} iterations in "
              f"{steady_s - stages['seed_s']:.3f} s, delta {steady.local.delta:.6e}; peak "
              f"{peak:.2f} GiB, of which {held:.2f} GiB held before [{card_line}]", flush=True)
        print(f"{name}: the doublings' collectives (kind: calls, elements) "
              + ", ".join(f"{k}: {calls[k]}, {schedule[k]}" for k in sorted(schedule))
              + f" = comm model ({its} x (2 blocked_cholesky + 2 blocked_cho_solve)); layout "
              f"{layout}; the polish's {polish[0]} calls, layout {polish[1]}", flush=True)
        check(schedule == model, f"N: the doublings' collectives {schedule} != comm model {model}")
        check(abs(its - reference["sda_iterations"]) <= 2, f"N: {its} SDA doublings")
        check(diagnostics["dare_residual"] < 1e-4,
              f"N: dare_residual {diagnostics['dare_residual']:.3e}")
        check(steady.local.iterations <= 4, f"N: {steady.local.iterations} polish iterations")

        placed = sharded_filter.shard_steady_cache(steady, mesh)
        solve = sharded_filter.make_space_sharded_steady_solve(
            cache=cache, steady=placed, num_derivatives=LARGE_NU, mesh=mesh, dt=STEADY_DT,
            num_steps=SHARDED_STEADY_STEPS)
        (mean, diff), solve_s = timed_sync(lambda: solve(mean0, float(heat.t0)))
        rate = SHARDED_STEADY_STEPS / solve_s
        step = pt.white.make_steady_state_white_step(cache=cache.local, steady=placed.local,
                                                     num_derivatives=LARGE_NU)
        m_ref, diff_sum = mean0, 0.0
        for k in range(1, SHARDED_STEADY_STEPS + 1):
            m_ref, _, _, _, dsq = step(m_ref, None, k * STEADY_DT, STEADY_DT)
            diff_sum += dsq.item()
        solve_rel = rel(mean, m_ref)
        print(f"{name}: {SHARDED_STEADY_STEPS} sharded mean-only steps at {rate:.1f} steps/s "
              f"(phase F's bare loop {reference['steps_per_s']:.1f}); against the single-GPU "
              f"frozen recursion from the same blocks: mean rel {solve_rel:.3e}, diffusion rel "
              f"{abs(diff.item() / (diff_sum / SHARDED_STEADY_STEPS) - 1):.3e} [{card_line}]",
              flush=True)
        check(bool(torch.isfinite(mean).all()), "N: NaN or inf in the mean")
        check(solve_rel <= 1e-12, "N: the sharded solve leaves the frozen recursion")
        trajectory = rel(mean, reference["mean"].to(dev))
        C, delta = steady.local.cov_inf, steady.local.delta
        K = steady.local.L21 @ steady.local.Sl_inv
        sxz = rel(steady.local.L21 @ steady.local.Sl.T, reference["sxz"].to(dev))
        del placed, solve, cache, steady, mean0, mean, m_ref
        torch.cuda.empty_cache()
        C_ref = reference["cov_inf"].to(dev)
        gram = compare_blocks((C, C.T), (C_ref, C_ref.T))
        del C, C_ref
        gain = compare_blocks(K, reference["gain"].to(dev))
        gram_rtol = STEADY_GRAM_DELTAS * max(delta, reference["delta"])
        print(f"{name} against phase F's single-GPU cache: cov_inf Gram max abs {gram[0]:.3e} "
              f"(rel {gram[1]:.3e}, held to {gram_rtol:.3e}; max {gram[2]:.4e}; excess over "
              f"rtol {STEADY_RTOL:g}, atol {STEADY_ATOL:g}: {gram[3]:.4e}); S_xz rel {sxz:.3e};"
              f" the mean after {SHARDED_STEADY_STEPS} frozen steps rel {trajectory:.3e} (held "
              f"to {STEADY_TRAJECTORY_RTOL[d]:g}); gain L21 Sl^-1 rel {gain[1]:.3e}, max |K| "
              f"{gain[2]:.4e}, excess over rtol {STEADY_RTOL:g}, atol {STEADY_ATOL:g}: "
              f"{gain[3]:.4e} (not held) [{card_line}]", flush=True)
        check(trajectory <= STEADY_TRAJECTORY_RTOL[d],
              "N: the frozen trajectory leaves phase F's")
        check(gram[1] <= gram_rtol, "N: the cov_inf Gram leaves phase F's")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def sharded_steady_gloo_rank(payload, device):
    """E2, on each of two gloo ranks sharing the card, at phase E's point:
    the distributed init, the seeded sharded steady state (4 polish
    iterations), 512 sharded mean-only steps, and the frozen-gain dt sweep
    of the parent's per-dt caches over the batch axis; returns the lines,
    the gathered blocks and results, and the rank's kernel launches."""
    import pnmol_tpu_torch as pt
    from pnmol_tpu_torch.parallel import distributed, ensembles, meshes, sharded_filter, \
        sharded_init

    torch.set_num_threads(2)
    dev = torch.device(device)
    mesh = distributed.global_mesh(batch=1)
    wrappers = rank_wrappers()
    heat = dx_adapted_heat(pt, dev, N_POINTS, STEADY_STEPS, dt=STEADY_DT)
    lines = [f"E2: backend {mesh.backend}, rank {mesh.rank} of {mesh.shape['space']}, {dev}"]
    (mean0, C0, chol_gram), init_s = timed_sync(lambda: sharded_init.sharded_white_initialize(
        heat, mesh, num_derivatives=NU, spatial_kernel=prior(pt)))
    cache = sharded_filter.shard_cache(full_white_cache(pt, heat, chol_gram, mesh, NU), mesh,
                                       distributed_qr=True)
    diagnostics = {}
    mesh.reset_counts()
    steady, steady_s = timed_sync(lambda: sharded_filter.converge_space_sharded_steady_state(
        cache=cache, cov0=C0, dt=STEADY_DT, num_derivatives=NU, mesh=mesh, max_iters=4,
        diagnostics=diagnostics))
    lines.append(f"E2 seeded sharded steady state: init {init_s:.3f} s, seed and polish "
                 f"{steady_s:.3f} s (SDA {diagnostics['sda_iterations']} doublings, "
                 f"dare_residual {diagnostics['dare_residual']:.3e}; polish "
                 f"{steady.local.iterations} iterations, delta {steady.local.delta:.3e}); "
                 f"staged {mesh.staged_bytes / 2**20:.1f} MiB")
    blocks = {name: sharded_filter._full(steady, name, mesh, "space").cpu()
              for name in ("cov_inf", "L21", "Sl", "Sl_inv")}
    blocks["err_vec"] = steady.local.err_vec.cpu()
    placed = sharded_filter.shard_steady_cache(steady, mesh)
    layouts = {name: placed.layouts[name].spec for name in ("cov_inf", "L21", "Sl_inv")}
    solve = sharded_filter.make_space_sharded_steady_solve(
        cache=cache, steady=placed, num_derivatives=NU, mesh=mesh, dt=STEADY_DT,
        num_steps=STEADY_STEPS)
    mesh.reset_counts()
    (mean, diff), solve_s = timed_sync(lambda: solve(mean0, float(heat.t0)))
    lines.append(f"E2 sharded mean-only solve: {STEADY_STEPS / solve_s:.1f} steps/s over "
                 f"{STEADY_STEPS} steps, layouts {layouts}, staged "
                 f"{mesh.staged_bytes / 2**20:.1f} MiB")
    del cache, steady, placed, C0

    sweep = payload["sweep"]
    batch = meshes.make_mesh(2, batch=2)
    caches = [pt.white.SteadyStateCache(**{k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                                           for k, v in c.items()}) for c in sweep["steadies"]]
    (means, _, diffs), sweep_s = timed_sync(lambda: ensembles.steady_dt_sweep_final_states(
        cache=pt.white.WhiteSolverCache(*(x.to(dev) for x in sweep["cache"])),
        num_derivatives=NU, mean0=sweep["mean0"].to(dev), t0=0.0, tmax=STEADY_SWEEP_TMAX,
        dts=STEADY_SWEEP_DTS, steady_caches=ensembles.stack_caches(caches), mesh=batch))
    lines.append(f"E2 frozen-gain dt sweep over the batch axis ({len(STEADY_SWEEP_DTS)} dts): "
                 f"{sweep_s:.3f} s")
    counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
    return dict(lines=lines, blocks=blocks, mean0=mean0.cpu(), mean=mean.cpu(),
                diff=float(diff), means=means.cpu(), diffs=diffs.cpu(), launches=counts)


def phase_sharded_steady_gloo(pt, dev, launches, card_line, steady_ref):
    """E2. Two gloo ranks sharing the card at phase E's point: the seeded
    sharded steady state held to phase E's cache (kernel path), the Gram of
    cov_inf at STEADY_RTOL/STEADY_ATOL and the mean after 512 frozen steps
    at STEADY_TRAJECTORY_RTOL (the gain printed), the 512-step sharded
    mean-only solve held to the single-GPU frozen recursion from the same
    blocks (1e-10), and the
    frozen-gain sweep over STEADY_SWEEP_DTS held to sequential single-GPU
    steady solves (1e-10 in the mean, 1e-9 in the diffusion). The gloo
    numbers are host-bound (PERF.md section 5): printed, not gated."""
    from pnmol_tpu_torch.parallel import distributed

    import chip_smoke

    heat = dx_adapted_heat(pt, dev, N_POINTS, STEADY_STEPS, dt=STEADY_DT)
    sweep_heat = dx_adapted_heat(pt, dev, N_POINTS, 1, dt=STEADY_SWEEP_TMAX)
    launches.reset()
    finals, steadies = [], []
    for dt in STEADY_SWEEP_DTS:
        solver = pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(dt), num_derivatives=NU, spatial_kernel=prior(pt),
            steady_state=True)
        finals.append(solver.simulate_final_state(sweep_heat)[0])
        steadies.append({k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                         for k, v in solver.steady_cache._asdict().items()})
    mean0 = solver.initialize(sweep_heat).y.mean
    launches.read("E2 sequential steady solves, plain path", {})
    payload = dict(sweep=dict(cache=[x.cpu() for x in solver._cache], mean0=mean0.cpu(),
                              steadies=steadies))
    t0 = time.perf_counter()
    ranks = distributed.spawn_ranks(chip_smoke.sharded_steady_gloo_rank, 2, backend="gloo",
                                    device="cuda:0", payload=payload, timeout=900)
    elapsed = time.perf_counter() - t0
    launches.read("E2 two gloo ranks: this process", {})
    for got, _ in ranks:
        for line in got["lines"]:
            print(f"{line} [{card_line}]", flush=True)
    print(f"E2: {elapsed:.1f} s with the ranks' start", flush=True)
    add_rank_launches("E2 two gloo ranks (no kernel on the sharded path)", launches,
                      [got for got, _ in ranks], dict.fromkeys(SOURCES, 0))
    got = ranks[0][0]
    b = {k: v.to(dev) for k, v in got["blocks"].items()}
    solver_ref = steady_ref["solver"]
    ref = solver_ref.steady_cache
    gram = compare_blocks((b["cov_inf"], b["cov_inf"].T), (ref.cov_inf, ref.cov_inf.T))
    gain = compare_blocks(b["L21"] @ b["Sl_inv"], ref.L21 @ ref.Sl_inv)
    sxz = rel(b["L21"] @ b["Sl"].T, ref.L21 @ ref.Sl.T)
    trajectory = rel(got["mean"].to(dev), steady_ref["mean"])
    frozen = pt.white.SteadyStateCache(cov_inf=b["cov_inf"], L21=b["L21"], Sl=b["Sl"],
                                       Sl_inv=b["Sl_inv"], err_vec=b["err_vec"], iterations=0,
                                       delta=0.0)
    step = pt.white.make_steady_state_white_step(cache=solver_ref._cache, steady=frozen,
                                                 num_derivatives=NU)
    m_ref, diff_sum = got["mean0"].to(dev), 0.0
    for k in range(1, STEADY_STEPS + 1):
        m_ref, _, _, _, dsq = step(m_ref, None, k * STEADY_DT, STEADY_DT)
        diff_sum += dsq.item()
    solve_rel = rel(got["mean"].to(dev), m_ref)
    diff_rel = abs(got["diff"] / (diff_sum / STEADY_STEPS) - 1)
    worst = dict(mean=0.0, diff=0.0)
    for i, final in enumerate(finals):
        worst["mean"] = max(worst["mean"], (got["means"][i].to(dev) - final.y.mean).abs().max()
                            .item())
        worst["diff"] = max(worst["diff"], abs(got["diffs"][i].item()
                                               / final.diffusion_squared_local.item() - 1))
    print(f"E2 against phase E's cache: cov_inf Gram max abs {gram[0]:.3e} (rel {gram[1]:.3e}, "
          f"max {gram[2]:.4e}; excess over rtol {STEADY_RTOL:g}, atol {STEADY_ATOL:g}: "
          f"{gram[3]:.4e}); S_xz rel {sxz:.3e}; the mean "
          f"after {STEADY_STEPS} frozen steps rel {trajectory:.3e} against phase E's (held to "
          f"{STEADY_TRAJECTORY_RTOL[N_POINTS]:g}); gain L21 Sl^-1 rel {gain[1]:.3e}, max |K| "
          f"{gain[2]:.4e}, excess over rtol {STEADY_RTOL:g}, atol {STEADY_ATOL:g}: "
          f"{gain[3]:.4e} (not held); the sharded solve against the single-GPU frozen "
          f"recursion from the same blocks: mean rel {solve_rel:.3e}, diffusion rel "
          f"{diff_rel:.3e}; the sweep against {len(finals)} sequential steady solves: mean max "
          f"abs {worst['mean']:.3e}, diffusion rel {worst['diff']:.3e} [{card_line}]", flush=True)
    check(trajectory <= STEADY_TRAJECTORY_RTOL[N_POINTS],
          "E2: the frozen trajectory leaves phase E's")
    check(gram[3] <= 0.0, "E2: the cov_inf Gram leaves phase E's")
    check(all(np.array_equal(r["mean"].numpy(), got["mean"].numpy()) for r, _ in ranks),
          "E2: the ranks' means differ")
    check(solve_rel <= 1e-10 and diff_rel <= 1e-10,
          "E2: the sharded solve leaves the frozen recursion")
    check(worst["mean"] <= 1e-10 and worst["diff"] <= 1e-9,
          "E2: the sweep and the sequential steady solves disagree")


def phase_utilities(pt, dev, launches, card_line, heat):
    """O. The utilities on phase 5's panel-kernel path: ``solve_resilient``
    with one NaN injected at step 10 (one restart from the step-5
    checkpoint at dt / 2, then a finite finish at tmax); a checkpoint round
    trip of the card's state (device kept, bitwise equal); the phase
    seconds of ``initialize`` under ``PNMOL_INIT_PROFILE=1``; and
    ``time_blocked`` of one step."""
    import tempfile

    from pnmol_tpu_torch.utils import checkpoint, profiling, resilience

    solver = heat_solver(pt, "householder", steprule=pt.odetools.step.Constant(DT))
    attempt = solver.attempt_step
    armed = {"on": True}

    def flaky(state, dt, pde, t_next=None):
        new_state, info = attempt(state, dt, pde, t_next)
        if armed["on"] and state.t >= (RESILIENT_NAN_STEP - 1.5) * DT:
            armed["on"] = False
            return new_state._replace(y=new_state.y._replace(
                mean=new_state.y.mean * float("nan"))), info
        return new_state, info

    solver.attempt_step = flaky
    with tempfile.TemporaryDirectory(prefix="pnmol_checkpoints_") as tmp:
        launches.reset()
        (final, report), seconds = timed_sync(lambda: resilience.solve_resilient(
            solver, heat, checkpoint_dir=tmp, checkpoint_every=RESILIENT_CHECKPOINT_EVERY))
        attempts = report.num_steps + report.num_failures
        launches.read(f"O resilient solve ({attempts} attempts)",
                      {"panel_lq": 13 + 17 * attempts})
        print(f"O solve_resilient, NaN at step {RESILIENT_NAN_STEP}: {report} in {seconds:.3f} s,"
              f" t = {final.t:.12g} [{card_line}]", flush=True)
        check(report.num_failures == 1 and report.num_restarts == 1, "O: not one restart")
        check(report.final_dt == DT / 2 and abs(final.t - heat.tmax) <= 1e-12,
              "O: the restart's dt or the final time")
        restart_steps = round((heat.tmax - RESILIENT_CHECKPOINT_EVERY * DT) / (DT / 2))
        check(report.num_steps == RESILIENT_NAN_STEP - 1 + restart_steps,
              f"O: {report.num_steps} accepted steps")
        check(bool(torch.isfinite(final.y.mean).all() and torch.isfinite(final.y.cov_sqrtm).all()),
              "O: the resilient trajectory is not finite")

        path = pathlib.Path(tmp) / "state"
        checkpoint.save_state(path, final, extra={"dt": torch.tensor(report.final_dt,
                                                                      dtype=torch.float64)})
        restored, extra = checkpoint.load_state(path, device=dev)
        same = (restored.t == final.t and all(
            a.device == b.device and torch.equal(a, b) for a, b in (
                (restored.y.mean, final.y.mean), (restored.y.cov_sqrtm, final.y.cov_sqrtm),
                (restored.diffusion_squared_local, final.diffusion_squared_local))))
        print(f"O checkpoint round trip of the card's state: device {restored.y.mean.device}, "
              f"bitwise equal {same}, extra dt {float(extra['dt'])}", flush=True)
        check(same, "O: the checkpoint round trip changed the state or its device")

    solver = heat_solver(pt, "householder", steprule=pt.odetools.step.Constant(DT))
    launches.reset()
    with environ(PNMOL_INIT_PROFILE="1"):
        state = solver.initialize(heat)
    out, step_s = profiling.time_blocked(solver._step_fn, state.y.mean, state.y.cov_sqrtm, DT,
                                         DT, repeats=5)
    launches.read("O init_profile and time_blocked (1 + 6 steps)", {"panel_lq": 13 + 17 * 6})
    print(f"O init_profile of phase 5's initialize: {solver.init_profile}; time_blocked of one "
          f"step: {step_s * 1e3:.3f} ms (best of 5) [{card_line}]", flush=True)
    check(set(solver.init_profile) == {"prior_gram_cholesky_y0", "measure_assembly",
                                       "init_update_qr", "aux_Ql_Ebc"},
          "O: init_profile's phases")
    check(bool(torch.isfinite(out[0]).all()), "O: NaN or inf in the timed step")


# the measurement drivers (phase S, pnmol_tpu_torch/experiments): the
# work-precision legs (S1), the steady probes (S2) and the scale demo's
# latent rung and Gram (S3); --drivers runs all of them at full size
BENCH = REPO / "bench_artifacts"
WP_HEAT_2048_DTS = (0.1, 0.05)
# the JAX package's heat rows at dt 0.1 (CPU, f64; its live solves built
# as experiments/tpu_work_precision.py builds them, against the committed
# references), held at the tolerance of tests/test_torch_work_precision.py,
# 1e-6 relative (the dx-adapted FD kernel). At 2048 points that kernel's
# Laplacian is unstable (the committed LSODA reference grows from 0.1 to
# 11.0 by t = 1; ROADMAP 3.4), and both packages' filters stay near 0.1:
# RMSE 0.99, chi2 8.7e6. The Lotka-Volterra rows take
# the default SquareExponential() on dx = 0.01, whose 3- and 4-point
# stencil Grams are near singular, so the card assembles L and E with its
# own rounding, and the rows part from the committed CPU rows as the
# figures' finest rows do (ROADMAP 3.3): the relative RMSE held to
# WP_LV_GAP absolute, the chi2 to 1e-3 relative, set from an H100 run
# (NVIDIA H100 80GB HBM3): the card's L and E 2.5e-5 and 6.9e-2 from the
# CPU's, the rows up to 3.9e-8 and 1.8e-4 apart; the CPU test's 1e-6
# relative RMSE does not hold from dt 0.00562 on, where the RMSE sits at
# the FD floor and carries L's gap
JAX_WP_HEAT = {512: {"rmse_rel": 0.01757362995399361, "chi2": 0.5164480067175954},
               2048: {"rmse_rel": 0.9916838747619726, "chi2": 8659820.132959297}}
WP_HEAT_RTOL, WP_LV_GAP, WP_LV_CHI2_RTOL = 1e-6, 1e-7, 1e-3
# stated before the first run on the card, ten times the CPU tests' (the
# kernel route's rounding against LAPACK's, over 2048 and 3001 steps): the
# decay's amplitudes 1e-5 relative (phase E's hold on the frozen mean); the
# error probe's deviations 1e-12 absolute unseeded, 1e-9 seeded (its gain
# sits at the polish's stopping delta), the unseeded deltas 1e-5 relative
DECAY_RTOL, ERR_ATOL_CARD, ERR_DELTA_RTOL = 1e-5, {"seeded": 1e-9, "unseeded": 1e-12}, 1e-5
ERROR_PROBE_LADDER = (1, 2, 3, 5, 10, 25, 100)
DECAY_STEPS = 2048
# the latent N-ladder's rungs, docs/SCALE.md's points: N = 4096 at nu = 1
# and 3072 at nu = 2 count the mesh's intervals, so 4097 and 3073 points
# (stacked states 16388 and 18438); 3 steps a call, two calls, two-QR
# banded on the leaf route
LATENT_RUNGS = ((4097, 1), (3073, 2))
RUNG_STEPS = 3


def sweep_launches(rows, points):
    """``{kernel: launches}`` of one LQ sweep of ``rows`` rows by the
    ``"householder"`` hooks sized for ``points`` points (the latent solver
    sizes them for its 2d): 128-row blocks in one ``panel_lq`` each below
    4096 points, else 256-row blocks on the leaf route (``leaf_lq``; leaves
    of 64 rows from 8192 points, else 32)."""
    if points < 4096:
        return {"panel_lq": block_panels(rows)}
    return {"leaf_lq": leaf_launches(rows, 256, 64 if points >= 8192 else 32)}


def add_counts(*counts):
    """The sum of launch counts by kernel."""
    total = {}
    for count in counts:
        for name, n in count.items():
            total[name] = total.get(name, 0) + n
    return total


def phase_work_precision(pt, dev, launches, card_line, full=False):
    """S1. The work-precision driver's three legs on the card against the
    committed references (``experiments/results/wp_ref_*.npy``, read as
    data, as the committed rows were): ``lv`` on its six dts, held to the
    committed CPU f64 rows of ``bench_artifacts/tpu_work_precision.json``;
    ``heat_512`` on the card's ladder and ``heat_2048`` at dt 0.1 and 0.05
    (``full``: the card's ladder), their dt 0.1 rows held to JAX's. Each
    leg's launches: one untimed solve at its first dt, then its rows. Then
    each reference recomputed by the port's LSODA on the card, which the
    driver holds to the committed one (``work_precision.REFERENCE_RTOL``).
    Returns the card's rows."""
    from pnmol_tpu_torch.experiments import work_precision as wp

    committed_rows = json.loads((BENCH / "tpu_work_precision.json").read_text())["rows"]
    # the card's Lotka-Volterra operators against the CPU's (the same code)
    cpu_pde, card_pde = (wp.lotka_volterra(wp.LV_DX, device) for device in ("cpu", dev))
    gaps = {k: relative_gap(getattr(card_pde, k).cpu().numpy(), getattr(cpu_pde, k).numpy())
            for k in ("L", "E_sqrtm")}
    print("S1 lv: the card's FD operators against the CPU's, max |diff| / max |CPU|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)
    del cpu_pde, card_pde
    worst, card_rows = {}, []
    for leg, dts in (("lv_cuda", None), ("heat_512_cuda", None),
                     ("heat_2048_cuda", None if full else WP_HEAT_2048_DTS)):
        name, n, _ = wp.parse_leg(leg)
        problem = wp.Problem(name, n, dev)
        d = problem.pde.L.shape[0]
        m, D = d + problem.pde.B.shape[0], (wp.NU + 1) * d
        ladder = wp.default_dts(name, n, "cuda") if dts is None else list(dts)

        def solve_launches(dt, d=d, m=m, D=D):
            steps = len(pt.pdefilter.constant_step_schedule(0.0, 1.0, dt)[1])
            return add_counts(sweep_launches(m + 2 * d, d), *[sweep_launches(m + D, d)] * steps)

        launches.reset()
        result, seconds = timed_sync(lambda: wp.run_leg(leg, dts=dts))
        card_rows.extend(result["rows"])
        ran = [row["dt"] for row in result["rows"]]
        check(ran == ladder, f"S1 {leg}: ran the dts {ran}, not {ladder}")
        launches.read(f"S1 {leg} ({len(ladder)} dts and the warm-up)",
                      add_counts(*[solve_launches(dt) for dt in [ladder[0]] + ladder]))
        print(f"S1 {leg}: {seconds:.3f} s, the warm-up solve {result['warmup_seconds']:.3f} s "
              f"[{card_line}]", flush=True)
        for row in result["rows"]:
            check(row["launches"] == {k: solve_launches(row["dt"]).get(k, 0)
                                      for k in row["launches"]}, f"S1 {leg}: a row's launches")
            print(f"S1 {leg} dt={row['dt']}: {row['num_steps']} steps, rmse_rel "
                  f"{row['rmse_rel']:.10e}, chi2 {row['chi2']:.10e}, {row['seconds']:.4f} s, "
                  f"{row['steps_per_s']:.2f} steps/s, launches {row['launches']} [{card_line}]",
                  flush=True)
            check(np.isfinite(row["rmse_rel"]) and np.isfinite(row["chi2"]),
                  f"S1 {leg} dt={row['dt']}: not finite")
            if name == "lv":
                (want,) = [r for r in committed_rows if r["problem"] == "lv"
                           and r["platform"] == "cpu" and r["dt"] == row["dt"]]
                limits = {"rmse_rel (abs)": WP_LV_GAP, "chi2 (rel)": WP_LV_CHI2_RTOL}
            elif row["dt"] == 0.1:
                want = dict(JAX_WP_HEAT[n], num_steps=10)
                limits = {"rmse_rel (rel)": WP_HEAT_RTOL, "chi2 (rel)": WP_HEAT_RTOL}
            else:
                continue
            gaps = {"rmse_rel (abs)": abs(row["rmse_rel"] - want["rmse_rel"]),
                    "rmse_rel (rel)": abs(row["rmse_rel"] / want["rmse_rel"] - 1),
                    "chi2 (rel)": abs(row["chi2"] / want["chi2"] - 1)}
            print(f"S1 {leg} dt={row['dt']}: against "
                  f"{'the committed CPU row' if name == 'lv' else 'JAX'}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)
            check(row["num_steps"] == want["num_steps"], f"S1 {leg} dt={row['dt']}: steps")
            for key, limit in limits.items():
                label = f"{name} {key} (held to {limit:g})"
                worst[label] = max(worst.get(label, 0.0), gaps[key])
                if gaps[key] > limit:
                    worst[f"FAILED {leg} dt={row['dt']} {key}"] = gaps[key]
        launches.reset()
        (_, ref), seconds = timed_sync(lambda: wp.reference(problem, recompute=True))
        launches.read(f"S1 {leg}: LSODA reference", {})
        print(f"S1 {leg}: reference recomputed by LSODA on {ref['d']} unknowns in "
              f"{ref['seconds']:.3f} s ({ref['jac_calls']} Jacobians, their copies to the host "
              f"{ref['jac_seconds']:.3f} s), {ref['gap_to_committed']:.3e} from the committed one "
              f"(held to {wp.REFERENCE_RTOL[name]:g}) [{card_line}]", flush=True)
        del problem
    print("S1 largest deviations: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()),
          flush=True)
    check(not any(k.startswith("FAILED") for k in worst), "S1: rows beyond their tolerances")
    return card_rows


def decay_line(label, record, card_line, seconds):
    print(f"{label}: ratio {record['ratio']:.10e}, per_step_factor "
          f"{record['per_step_factor']:.10f}, slowest_mode_ratio "
          f"{record['slowest_mode_ratio']:.6e}, max|u| {record['absmax0']:.10f} -> "
          f"{record['absmax_final']:.10e} after {record['steps']} mean-only steps in "
          f"{seconds:.3f} s, riccati_iters {record['riccati_iters']}, dare_residual "
          f"{record['dare_residual']:.3e} [{card_line}]", flush=True)


def phase_steady_probes(pt, dev, launches, card_line):
    """S2. The decay probe at N = 512 (nu = 1, its SDA seed and 4 polish
    steps on the panel kernel: 13 panels each for the init, the seed update
    and each polish step and harvest), 2048 mean-only steps, held to
    ``bench_artifacts/steady_decay_probe_f64_n512.json``; the error probe at
    the committed configuration (d = 51: every pre-array in 2 panels), held
    to every row of ``bench_artifacts/steady_error_probe.json``."""
    from pnmol_tpu_torch.experiments import steady_decay_probe, steady_error_probe

    want = json.loads((BENCH / "steady_decay_probe_f64_n512.json").read_text())
    launches.reset()
    (solver, state), build_s = timed_sync(lambda: steady_decay_probe.build(dev, N_POINTS))
    record, seconds = timed_sync(lambda: steady_decay_probe.measure(solver, state, DECAY_STEPS))
    launches.read("S2 decay N=512", {"panel_lq": 13 * (2 + solver.steady_cache.iterations + 1)})
    decay_line(f"S2 decay N={N_POINTS} (build {build_s:.3f} s)", record, card_line, seconds)
    gaps = {k: abs(record[k] / want[k] - 1) for k in ("absmax_final", "ratio", "per_step_factor")}
    print("S2 decay N=512 against the committed record: "
          + ", ".join(f"{k} rel {v:.3e}" for k, v in gaps.items()), flush=True)
    check(record["riccati_iters"] == want["riccati_iters"] and max(gaps.values()) <= DECAY_RTOL,
          "S2 decay N=512: off the committed record")
    del solver, state

    want = json.loads((BENCH / "steady_error_probe.json").read_text())
    cfg = want["config"]
    launches.reset()
    probe, seconds = timed_sync(lambda: steady_error_probe.run(
        dev, dx=cfg["dx"], dt=cfg["dt"], tmax=cfg["tmax"], iters_ladder=ERROR_PROBE_LADDER))
    steps = cfg["num_steps"] - 1
    expected = 2 + 2 * steps + sum(2 + 2 * (row["riccati_iterations"] + 1)
                                   + (2 if row["config"] == "sda_seeded" else 0)
                                   for row in probe["rows"])
    launches.read("S2 error probe (d=51: full solve, 7 capped, 1 seeded)", {"panel_lq": expected})
    print(f"S2 error probe at dx {cfg['dx']}, dt {cfg['dt']}, tmax {cfg['tmax']} (d = "
          f"{probe['config']['d']}, {steps} steps a solve, 9 solves): {seconds:.3f} s "
          f"[{card_line}]", flush=True)
    check([r["config"] for r in probe["rows"]] == [r["config"] for r in want["rows"]],
          "S2 error probe: rows")
    for got, ref in zip(probe["rows"], want["rows"]):
        kind = "seeded" if ref["config"] == "sda_seeded" else "unseeded"
        errs = {k: abs(got[k] - ref[k]) for k in ("rel_mean_err_tail", "rel_mean_err_full")}
        delta_rel = abs(got["delta"] / ref["delta"] - 1)
        print(f"S2 error probe {got['config']}: {got['riccati_iterations']} iterations (JAX "
              f"{ref['riccati_iterations']}), delta {got['delta']:.6e} (JAX {ref['delta']:.6e}), "
              f"err tail {got['rel_mean_err_tail']:.6e}, full {got['rel_mean_err_full']:.6e}; "
              f"from the committed row: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)
        check(got["riccati_iterations"] == ref["riccati_iterations"]
              and max(errs.values()) <= ERR_ATOL_CARD[kind]
              and (kind == "seeded" or delta_rel <= ERR_DELTA_RTOL),
              f"S2 error probe {got['config']}: off the committed row")


def step_once(solver, pde):
    """The run dict of ``compare_runs`` after initialize and one step."""
    state = solver.initialize(pde)
    state, _ = solver.attempt_step(state, solver.steprule.dt, pde)
    torch.cuda.synchronize()
    return dict(state=state, info={"num_steps": 1}, diffusion=state.diffusion_squared_local)


def phase_latent_rung(pt, dev, launches, card_line, n, nu):
    """S3. A rung of the scale demo's latent N-ladder: ``scale_demo.step``
    (``--dim 1 --solver latent``, two-QR banded, ``"householder"``: the
    hooks sized for 2n points take the leaf route) on two calls of 3 steps,
    its init seconds, steps/s and peak memory; then the first step of the
    same solver against the plain two-QR path's first step (phase 14's
    tolerances). The stacked state has D = 2 (nu + 1) n; the init update LQ
    m + 4n rows, each step's propagate D and update m + D."""
    from pnmol_tpu_torch.experiments import scale_demo

    options = dict(nu=nu, dt=DT, fused=False, propagate_band="banded")
    held = torch.cuda.memory_allocated(dev) / 2**30
    launches.reset()
    record, seconds = timed_sync(lambda: scale_demo.step(
        dev, n=n, dim=1, solver_name="latent", steps=RUNG_STEPS, factorization="householder",
        **options))
    m, D = record["N"] + 2, record["state_dim"]
    per_step = add_counts(sweep_launches(D, 2 * n), sweep_launches(m + D, 2 * n))
    launches.read(f"S3 latent rung N={n} nu={nu}", add_counts(
        sweep_launches(m + 4 * n, 2 * n), *[per_step] * (2 * RUNG_STEPS)))
    print(f"S3 latent rung N={n} nu={nu} (stacked state {D}, m = {m}): init "
          f"{record['init_seconds']:.3f} s, first call of {RUNG_STEPS} steps "
          f"{record['first_call_seconds']:.3f} s, {record['steps_per_sec']:.4f} steps/s, "
          f"max|u| ratio {record['decay_ratio']:.6f}, peak memory "
          f"{record['peak_memory_gib']:.2f} GiB ({held:.2f} GiB held before), {seconds:.3f} s "
          f"[{card_line}]", flush=True)
    check(record["nan_free"] and record["peak_memory_gib"] < 80.0, f"S3 latent rung N={n}: "
          "NaN or peak memory above the card's 80 GB")

    heat = scale_demo.make_problem(1, n, dev)
    runs = {}
    for fac in ("householder", "plain"):
        launches.reset()
        runs[fac] = step_once(scale_demo.make_solver("latent", factorization=fac, **options), heat)
        launches.read(f"S3 latent rung N={n}: one step, {fac}", add_counts(
            sweep_launches(m + 4 * n, 2 * n), per_step) if fac == "householder" else {})
    compare_runs(f"S3 latent rung N={n} nu={nu}: the first step, householder vs plain two-QR",
                 runs["householder"], runs["plain"], d=n)


def phase_scale_gram(pt, dev, launches, card_line, n=LARGE_N):
    """S3. ``scale_demo.gram`` on 1e4 seeded uniform 2-D points: K3 against
    its plain version in f64 (1e-12) and f32 (1e-5), each a warm-up and 3
    timed launches."""
    from pnmol_tpu_torch.experiments import scale_demo

    launches.reset()
    record = scale_demo.gram(dev, n=n)
    launches.read(f"S3 gram {n} x {n} (f64, f32)", {"gram_radial": 8})
    for dtype, tol in (("float64", 1e-12), ("float32", 1e-5)):
        entry = record[dtype]
        print(f"S3 gram {n} x {n} {dtype}: kernel {entry['kernel_seconds'] * 1e3:.4f} ms, plain "
              f"{entry['plain_seconds'] * 1e3:.4f} ms (best of 3, host clock), max|dK| "
              f"{entry['max_abs_diff']:.3e} (tol {tol:g}) [{card_line}]", flush=True)
        check(entry["max_abs_diff"] <= tol, f"S3 gram {dtype}: kernel disagrees")


def phase_scale_nd(pt, dev, launches, card_line):
    """``--drivers``: ``scale_demo.step`` at the 2-D 100 x 100 and 3-D 21^3
    points (phases G and H's problems, nu = 1, two-QR banded on the leaf
    route), two calls of 3 steps each."""
    from pnmol_tpu_torch.experiments import scale_demo

    for dim, side, (m, d) in ((2, HEAT2D_SIDE, (10396, 10000)),
                              (3, ADVECTION_SIDE, (11663, 9261))):
        D = 2 * d
        launches.reset()
        record = scale_demo.step(dev, n=side, dim=dim, nu=1, steps=RUNG_STEPS,
                                 factorization="householder", propagate_band="banded")
        launches.read(f"S scale_demo step {dim}-D {side}^{dim}", add_counts(
            sweep_launches(m + 2 * d, d),
            *[add_counts(sweep_launches(D, d), sweep_launches(m + D, d))] * (2 * RUNG_STEPS)))
        print(f"S scale_demo step {dim}-D {side}^{dim}: N {record['N']}, build "
              f"{record['build_seconds']:.3f} s, init {record['init_seconds']:.3f} s, first "
              f"call {record['first_call_seconds']:.3f} s, {record['steps_per_sec']:.4f} "
              f"steps/s, peak {record['peak_memory_gib']:.2f} GiB [{card_line}]", flush=True)
        check(record["N"] == d and record["nan_free"] and record["peak_memory_gib"] < 80.0,
              f"S scale_demo step {dim}-D: N, NaN or peak memory")


def phase_decay_large(pt, dev, launches, card_line):
    """``--drivers``: the decay probe at N = 1e4 with its own seed (two-QR
    banded on the leaf route, as phase F), 2048 mean-only steps."""
    from pnmol_tpu_torch.experiments import steady_decay_probe

    launches.reset()
    (solver, state), build_s = timed_sync(lambda: steady_decay_probe.build(dev, LARGE_N))
    record, seconds = timed_sync(lambda: steady_decay_probe.measure(solver, state, DECAY_STEPS))
    d, m = LARGE_N, LARGE_N + 2
    launches.read(f"S2 decay N={LARGE_N} (own seed)", add_counts(
        sweep_launches(m + 2 * d, d), sweep_launches(m + 2 * d, d),
        *[add_counts(sweep_launches(2 * d, d), sweep_launches(m + 2 * d, d))]
        * (solver.steady_cache.iterations + 1)))
    decay_line(f"S2 decay N={LARGE_N} (own seed, build {build_s:.3f} s)", record, card_line,
               seconds)
    check(np.isfinite(record["ratio"]), "S2 decay N=1e4: not finite")
    del solver, state
    torch.cuda.empty_cache()


def phase_drivers_full(pt, dev, launches, card_line, clock):
    """``--drivers``: the four measurement drivers at full size: every
    work-precision leg and dt on the card, the decay at N = 512 and at
    N = 1e4 (its own seed, two-QR banded), the error probe, both latent
    rungs, the Gram and the 2-D and 3-D step points."""
    f64_rows = phase_work_precision(pt, dev, launches, card_line, full=True)
    clock.lap("S1 (work precision, every dt)")
    phase_steady_probes(pt, dev, launches, card_line)
    phase_decay_large(pt, dev, launches, card_line)
    clock.lap("S2 (steady probes, decay N=1e4 seeded)")
    for n, nu in LATENT_RUNGS:
        phase_latent_rung(pt, dev, launches, card_line, n, nu)
        torch.cuda.empty_cache()
    phase_scale_gram(pt, dev, launches, card_line)
    phase_scale_nd(pt, dev, launches, card_line)
    clock.lap("S3 (scale demo)")
    phase_f32_drivers(pt, dev, launches, card_line, f64_rows)
    clock.lap("X (the f32 work-precision legs, the f32 decay at N=1e4)")


def phase_figures_full(pt, dev, launches, card_line, clock):
    """``--figures``: the four figure drivers at full size, every row of
    figures 3 (both routes) and 4, each held as phase P holds its rows."""
    from pnmol_tpu_torch.experiments import figure3, figure4

    phase_figure1(pt, dev, launches, card_line)
    clock.lap("figure 1")
    phase_figure2(pt, dev, launches, card_line)
    clock.lap("figure 2")
    for dx in figure4.DXS:
        phase_figure4(pt, dev, launches, card_line, dx)
        clock.lap(f"figure 4 dx={dx}")
    for dx in sorted(figure3.DXS):
        phase_figure3(pt, dev, launches, card_line, dx)
        clock.lap(f"figure 3 dx={dx:g}")


# phase X: the f32 precision policy (PNMOL_TPU_X32's, switched at run time by
# pnmol_tpu_torch.config.enable_x64 around each run). The JAX bench's
# metric of record runs f32 end to end (bench.py:135-141, 158-215): mesh, FD,
# prior, init and steps in f32. Assembled in f32, the 3-point stencil
# systems of SquareExponential(0.1/dx) (condition ~1e4) lose about four
# digits of L, so the solution u after phase 5's 20 steps sits 4.3e-3 from
# the f64 run's in JAX and in the port alike (on the CPU; ROADMAP 3.5), and
# the higher derivatives are not determined. So u is held to 1e-2 against
# phase 5 there, and the step loop's own f32 error is held on phase 5's f64
# init with its cache cast to f32 (JAX's test_float32.py pattern). There the
# JAX package's own f32 steps on the CPU read u 5.2e-6, the mean 6.5e-4
# (norm: the top derivative carries 6.0e-2) and the Gram 8.5e-6 from its
# f64 steps (the port on the CPU: 4.4e-6, 6.7e-4, 1.8e-5), so JAX's 1e-4
# on the whole mean (its test at dx = 0.1) holds on u here: u 1e-4, the
# mean 2e-3, the Gram 1e-4. The latent steps on a cast cache keep only
# their covariance (JAX: the Gram 5.1e-5 from f64, u 0.23; the port 7.4e-5,
# 0.32): the Gram 1e-3. Kernel against plain in f32 on the same problem:
# the mean 1e-4 (norm; CPU 5.1e-7), the Gram 1e-3 (CPU 4.4e-5)
F32_U_TOL_ASSEMBLED, F32_U_TOL_CAST, F32_MEAN_TOL_CAST, F32_GRAM_TOL_CAST = 1e-2, 1e-4, 2e-3, 1e-4
F32_LATENT_GRAM_TOL_CAST = 1e-3
F32_MEAN_TOL, F32_GRAM_TOL = 1e-4, 1e-3
# X4: bench.py's N = 1e4 point in f32 (nu = 1, two-QR banded on K2), 3 steps
X4_STEPS = 3
# X5: the JAX package's f32 steady state at N = 512 on the CPU (PNMOL_TPU_X32):
# the f32 recursion's seed has no Cholesky factor (NaN, 36 SDA iterations),
# the f64 recursion on the f32-assembled problem reads max|u| 0.019064756
# after 512 mean-only steps (the port on the CPU: 0.0238586). On phase E's
# f64 problem cast to f32 the promoted recursion reads 0.0406255 on the CPU,
# 1.7e-3 from phase E's value: held to 1e-2. The card's run on its f32
# problem is held to the port's CPU run on the same operators (copied to the
# host). On the CPU's own f32 operators the port and the JAX package agree
# to 3.1e-5 (max|u|) and 2.8e-6 (the frozen covariance's Gram); the card's
# f32 operators pose a harder DARE (17 SDA iterations to a residual of
# 2-4e-6, against 14 to 1e-8), and there the card and the CPU part by
# 3.3e-3 (max|u|, the mean) and 6.8e-3 (the Gram; 4.1e-3 the gain): max|u|
# and the mean held to 1e-2, the frozen blocks to 2e-2
JAX_STEADY_F32_PROMOTED_MAX_U = 0.019064756
F32_STEADY_TOL_CAST, F32_STEADY_TOL_HOST, F32_STEADY_BLOCKS_TOL_HOST = 1e-2, 1e-2, 2e-2


def cast_problem(pde64, make_problem):
    """``make_problem()`` under the f32 policy with the f64 problem's
    operators, initial value and points cast to f32: X5's frozen f32 steps
    on phase E's f64 assembly."""
    from pnmol_tpu_torch.experiments import common

    with common.precision_policy(torch.float32):
        pde = make_problem()
    for name in ("L", "E_sqrtm", "B", "R_sqrtm", "y0"):
        setattr(pde, name, getattr(pde64, name).float())
    return pde


def check_f32_bounded(label, run, d=None):
    """The f32-assembled problem's hold on max|u| (JAX's
    test_fine_dx_pipeline_under_x32_mode): at most 1.01 times its start.
    Its f32 L need not decay the peak: the stencils' row sums there carry
    f32 rounding (on the CPU the 20 steps move max|u| by -2e-6, on the
    card by +8e-7)."""
    u0 = run["y0_mean"][0, :d].abs().max().item()
    u = run["state"].y.mean[0, :d].abs().max().item()
    check(u <= 1.01 * u0, f"{label}: max|u| {u} above 1.01 times its start {u0}")


def check_f32_state(label, run):
    state = run["state"]
    dtypes = {x.dtype for x in (state.y.mean, state.y.cov_sqrtm, state.diffusion_squared_local,
                                run["diffusion"])}
    check(dtypes == {torch.float32}, f"{label}: state dtypes {dtypes}, not float32")


def f32_distances(run, ref, d=None):
    """``(u, mean, Gram)`` distances of ``run`` from ``ref`` (either dtype):
    u = derivative 0 of the solution half, max-relative; the mean, norm-
    relative; the covariance Gram, max-relative; in f64."""
    m1, m2 = run["state"].y.mean.double(), ref["state"].y.mean.double()
    C1, C2 = run["state"].y.cov_sqrtm.double(), ref["state"].y.cov_sqrtm.double()
    u = rel_max(m1[0, :d], m2[0, :d])
    mean = ((m1[:, :d] - m2[:, :d]).norm() / m2[:, :d].norm()).item()
    return u, mean, rel_max(C1 @ C1.T, C2 @ C2.T)


def cast_cache_steps(pt, cls, make_step_fn, heat64):
    """JAX's tests/test_solvers/test_float32.py pattern at the bench point:
    the f64 init of ``cls`` on the f64 problem (the K1 path), its cache and
    initial state cast to f32, then NUM_STEPS steps of the solver's f64 step
    and of the f32 step on the cast cache (``make_step_fn`` with the
    solver's factorization): ``{"f64": run, "f32": run}`` in the form
    :func:`f32_distances` reads, each with its steps/s."""
    solver = heat_solver(pt, "householder", cls=cls, steprule=pt.odetools.step.Constant(DT))
    state = solver.initialize(heat64)
    cache32 = type(solver._cache)(*(
        x.float() if torch.is_tensor(x) and x.is_floating_point() else x for x in solver._cache))
    step32 = make_step_fn(cache=cache32, num_derivatives=NU, factorization=solver.factorization)
    runs = {}
    for label, step, dtype in (("f64", solver._step_fn, torch.float64),
                               ("f32", step32, torch.float32)):
        mean, cov = state.y.mean.to(dtype), state.y.cov_sqrtm.to(dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(NUM_STEPS):
            mean, cov, *_ = step(mean, cov, DT * (k + 1), DT)
        torch.cuda.synchronize()
        runs[label] = dict(
            state=types.SimpleNamespace(y=types.SimpleNamespace(mean=mean, cov_sqrtm=cov)),
            steps_per_s=NUM_STEPS / (time.perf_counter() - t0))
    return runs


def print_distances(label, dists):
    print(f"{label}: u rel {dists[0]:.3e}, mean rel (norm) {dists[1]:.3e}, cov Gram rel "
          f"{dists[2]:.3e}", flush=True)


def phase_f32_kernels(tq, dev):
    """X0. The f32 instantiations of K1, K2 and K4 against their plain
    versions on the card at the f32 solver shapes (K1: the white step and
    init panels, the latent step panel; K2: the N = 1e4 leaves; K4: the R
    form's first leaf at leaf 128 and 32), twice each with bitwise-equal
    results, the tolerance 1e-4 of the output's largest entry (phase 3's f32
    holds); then their times beside the f32 bound (bytes halved, operations
    at the 67 TFLOP/s FP32 rate) and torch.geqrf's f32 time."""
    rng = np.random.default_rng(5)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = dict.fromkeys(("panel_lq", "leaf_lq", "leaf_qr"), 0.0)
    cases = [("panel_lq", 128, 3586), ("panel_lq", 128, 1538), ("panel_lq", 128, 6658),
             ("leaf_lq", 64, 20257), ("leaf_lq", 64, 30002),
             ("leaf_qr", 3586, 128), ("leaf_qr", 3586, 32)]
    for name, rows, cols in cases:
        x = torch.tensor(rng.standard_normal((rows, cols)), dtype=torch.float32, device=dev)
        if name == "leaf_qr":
            outs = [tq.leaf_qr(x) for _ in range(2)]
            ref = tq.leaf_qr_reference(x)
        else:
            outs = [getattr(tq, name)(x, 0) for _ in range(2)]
            ref = tq.panel_lq_reference(x, 0)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        err = max((a - b).abs().max().item() for a, b in zip(outs[0], ref))
        tol = 1e-4 * ref[0].abs().max().item()
        print(f"X0 {name} f32 {rows} x {cols} vs plain: max|d| {err:.3e} (tol {tol:.3e}); two "
              f"launches bitwise equal: {same}", flush=True)
        check(np.isfinite(err) and err <= tol, f"X0 {name} f32 {rows} x {cols}: kernel disagrees")
        check(same, f"X0 {name} f32 {rows} x {cols}: two launches differ")
        worst[name] = max(worst[name], err)
    f32 = torch.float32
    timed = {
        "panel_lq": time_wide(tq, tq.panel_lq, "panel", rng, dev, 128, 3586, "step panel",
                              num_sms, f32),
        "leaf_lq": time_wide(tq, tq.leaf_lq, "leaf_lq", rng, dev, 64, 20257, "banded window",
                             num_sms, f32),
        "leaf_qr": time_tall(tq, rng, dev, 3586, 128, "leaf 128", num_sms, f32),
    }
    time_wide(tq, tq.panel_lq, "panel", rng, dev, 128, 1538, "white init panel", num_sms, f32)
    time_tall(tq, rng, dev, 3586, 32, "first leaf of a white step", num_sms, f32)
    return {name: dict(max_abs_err=worst[name], **timed[name]) for name in timed}


def phase_f32_bench(pt, tq, dev, launches, card_line, heat64, f64_run):
    """X1. The JAX bench's configuration in f32 end to end (N = 512, nu = 2,
    Constant(1e-3), the dx-adapted FD kernel, Matern52 + WhiteNoise): mesh,
    FD, init and 20 steps on the K1 f32 path (353 ``panel_lq``), then on
    the plain f32 path, held to each other and to phase 5's f64 run; the
    f32 steps on phase 5's f64 init with its cache cast to f32 (693
    ``panel_lq``: the f64 init, the f64 and the f32 steps), held to the f64
    steps; and the TF32 trailing updates (``precision="default"``: the init
    plain, 340 ``panel_lq``). Returns the f32 problem and its plain run."""
    from pnmol_tpu_torch.experiments import common

    constant = pt.odetools.step.Constant(DT)
    with common.precision_policy(torch.float32):
        heat, setup_s = timed_sync(lambda: full_width_heat(pt, dev))
        dtypes = {getattr(heat, k).dtype for k in ("L", "E_sqrtm", "B", "R_sqrtm", "y0")}
        check(dtypes == {torch.float32} and heat.mesh_spatial.points.dtype == torch.float32,
              f"X1: the f32 problem's dtypes {dtypes}")
        print(f"X1 N={N_POINTS} f32 problem (mesh and FD) built in {setup_s:.3f} s", flush=True)
        launches.reset()
        hh = run_solver(heat_solver(pt, "householder", steprule=constant), heat)
        plain = run_solver(heat_solver(pt, None, steprule=constant), heat)
        launches.read(f"X1 N={N_POINTS} f32 FD path", {"panel_lq": EXPECTED_LAUNCHES})
    for label, run in (("householder kernel", hh), ("plain torch.linalg.qr", plain)):
        report_run(f"X1 N={N_POINTS} f32 {label}", run, card_line, decays=False)
        check_f32_bounded(f"X1 {label}", run)
        check_f32_state(f"X1 {label}", run)
    dists = f32_distances(hh, plain)
    print_distances("X1 f32 kernel path vs f32 plain path", dists)
    check(dists[1] <= F32_MEAN_TOL and dists[2] <= F32_GRAM_TOL, "X1: f32 paths disagree")
    for label, run in (("kernel", hh), ("plain", plain)):
        dists = f32_distances(run, f64_run)
        print_distances(f"X1 f32 {label} path vs phase 5's f64 kernel path", dists)
        check(dists[0] <= F32_U_TOL_ASSEMBLED, f"X1 f32 {label}: u off the f64 run")
    print(f"X1 f32 against phase 5's f64 (kernel path): {hh['steps_per_s']:.2f} against "
          f"{f64_run['steps_per_s']:.2f} steps/s, init {hh['init_s']:.3f} against "
          f"{f64_run['init_s']:.3f} s; plain f32 {plain['steps_per_s']:.2f} steps/s "
          f"[{card_line}]", flush=True)

    # the step loop in f32 on phase 5's f64 init, its cache cast to f32
    launches.reset()
    cast = cast_cache_steps(pt, pt.white.LinearWhiteNoiseEK1, pt.white.make_white_step_fn,
                            heat64)
    launches.read(f"X1 N={N_POINTS} f64 init, f64 steps and f32 steps on the cast cache",
                  {"panel_lq": EXPECTED_LAUNCHES + 17 * NUM_STEPS})
    mean, cov = cast["f32"]["state"].y.mean, cast["f32"]["state"].y.cov_sqrtm
    check(mean.dtype == cov.dtype == torch.float32
          and bool(torch.isfinite(mean).all() and torch.isfinite(cov).all()),
          "X1 cast cache: the f32 state is not float32 or not finite")
    dists = f32_distances(cast["f32"], cast["f64"])
    print_distances("X1 f32 steps on phase 5's f64 init, cache cast to f32, vs its f64 steps",
                    dists)
    print(f"X1 cast cache: f32 steps {cast['f32']['steps_per_s']:.2f} steps/s, f64 "
          f"{cast['f64']['steps_per_s']:.2f} (bare step loops) [{card_line}]", flush=True)
    check(dists[0] <= F32_U_TOL_CAST and dists[1] <= F32_MEAN_TOL_CAST
          and dists[2] <= F32_GRAM_TOL_CAST, "X1: the f32 step loop leaves the f64 steps")

    # TF32 trailing updates, the card's counterpart of the TPU bench's
    # matmul_precision "default" (bench_artifacts/pdefilter_steps_per_sec_n512.json)
    before = torch.backends.cuda.matmul.allow_tf32
    with common.precision_policy(torch.float32):
        launches.reset()
        tf32 = run_solver(heat_solver(pt, tq.make_householder_lq_factorization(
            precision="default"), steprule=constant), heat)
        launches.read(f"X1 N={N_POINTS} f32 TF32 trailing updates", {
            "panel_lq": EXPECTED_LAUNCHES - 13})
    check(torch.backends.cuda.matmul.allow_tf32 == before, "X1: the TF32 scope leaked")
    report_run(f"X1 N={N_POINTS} f32 TF32 (precision='default'), householder kernel", tf32,
               card_line, decays=False)
    check_f32_bounded("X1 TF32", tf32)
    check_f32_state("X1 TF32", tf32)
    print_distances("X1 TF32 vs phase 5's f64 kernel path", f32_distances(tf32, f64_run))
    print_distances("X1 TF32 vs the f32 kernel path", f32_distances(tf32, hh))
    print(f"X1 TF32: {tf32['steps_per_s']:.2f} steps/s against f32 {hh['steps_per_s']:.2f} and "
          f"f64 {f64_run['steps_per_s']:.2f} [{card_line}]", flush=True)
    return heat, plain


def phase_f32_latent_and_r_form(pt, tq, launches, heat, plain, heat64, latent64, card_line):
    """X2. The latent solver on the f32 problem on K1 (601 ``panel_lq``) and
    on the plain path. Its noise-free measurement leaves the latent stack
    conditioned beyond f32 (in f64 the two paths' stacked means already
    part by 4.2e-8, ROADMAP queue 3), so in f32 the mean is not determined:
    on the CPU the JAX package's f32 run reads max|u| 0.1334 after the 20
    steps (f64: 0.0998) and the port's two paths part by O(1), differently
    with the thread count (ROADMAP 3.5); this run holds the f32 dtypes,
    finite values and the launch count, and prints the distances. The
    covariance is determined: on phase 5's f64 latent init with its cache
    cast to f32 (1181 ``panel_lq``: the f64 init, the f64 and the f32
    steps), the f32 steps' Gram is held to the f64 steps' (the JAX
    package's reads 5.1e-5 on the CPU, its u 0.23).
    X3. The R form at leaf 128 on K4 in f32 (340 ``leaf_qr``), held to X1's
    plain run as X1's paths are held."""
    from pnmol_tpu_torch.experiments import common

    constant = pt.odetools.step.Constant(DT)
    with common.precision_policy(torch.float32):
        launches.reset()
        runs = {fac: run_solver(heat_solver(pt, fac, cls=pt.latent.LinearLatentForceEK1,
                                            steprule=constant), heat)
                for fac in ("householder", None)}
        launches.read(f"X2 N={N_POINTS} f32 latent path", {"panel_lq": EXPECTED_LATENT_LAUNCHES})
        launches.reset()
        rf = run_solver(heat_solver(pt, tq.make_householder_factorization(leaf=128),
                                    steprule=constant), heat)
        launches.read(f"X3 N={N_POINTS} f32 R form at leaf 128",
                      {"leaf_qr": EXPECTED_LEAF128_LAUNCHES})
    for fac, label in (("householder", "householder kernel"), (None, "plain torch.linalg.qr")):
        report_run(f"X2 N={N_POINTS} f32 latent, {label}", runs[fac], card_line, d=N_POINTS,
                   decays=False)
        check_f32_state(f"X2 {label}", runs[fac])
        print_distances(f"X2 f32 latent {label} vs phase 9's f64 plain run (solution half)",
                        f32_distances(runs[fac], latent64, d=N_POINTS))
    print_distances("X2 f32 latent kernel path vs f32 plain path (solution half)",
                    f32_distances(runs["householder"], runs[None], d=N_POINTS))
    launches.reset()
    cast = cast_cache_steps(pt, pt.latent.LinearLatentForceEK1, pt.latent.make_latent_step_fn,
                            heat64)
    launches.read(f"X2 N={N_POINTS} latent f64 init, f64 steps and f32 steps on the cast cache",
                  {"panel_lq": EXPECTED_LATENT_LAUNCHES + 29 * NUM_STEPS})
    dists = f32_distances(cast["f32"], cast["f64"], d=N_POINTS)
    print_distances("X2 f32 latent steps on phase 5's f64 init, cache cast to f32, vs its f64 "
                    "steps (solution half)", dists)
    check(cast["f32"]["state"].y.cov_sqrtm.dtype == torch.float32
          and dists[2] <= F32_LATENT_GRAM_TOL_CAST,
          "X2: the f32 latent steps' covariance leaves the f64 steps'")
    report_run(f"X3 N={N_POINTS} f32 R form at leaf 128, leaf kernel", rf, card_line,
               decays=False)
    check_f32_bounded("X3", rf)
    check_f32_state("X3", rf)
    dists = f32_distances(rf, plain)
    print_distances("X3 f32 R form at leaf 128 vs X1's f32 plain path", dists)
    check(dists[1] <= F32_MEAN_TOL and dists[2] <= F32_GRAM_TOL, "X3: f32 R form disagrees")


def phase_f32_large(pt, dev, launches, card_line, f64_large):
    """X4. bench.py's N = 1e4 point in f32 end to end (nu = 1, two-QR
    banded on the K2 leaf route: 256-row blocks of 64-row leaves, as in
    f64): initialize and 3 steps, init seconds, steps/s and peak memory
    beside phase 15's f64 banded run; the first step held to the plain f32
    two-QR path's first step (the mean 1e-4, the standard deviations 1e-3)."""
    from pnmol_tpu_torch.experiments import common

    n, d = LARGE_NU + 1, LARGE_N
    with common.precision_policy(torch.float32):
        heat, setup_s = timed_sync(lambda: dx_adapted_heat(pt, dev, LARGE_N, X4_STEPS))
        m, D = d + heat.B.shape[0], n * d
        per_step = leaf_launches(D, 256, 64) + leaf_launches(m + D, 256, 64)
        init = leaf_launches(m + 2 * d, 256, 64)
        solver = pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(DT), num_derivatives=LARGE_NU,
            spatial_kernel=prior(pt), factorization="householder", fused=False,
            propagate_band="banded")
        held = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        launches.reset()
        t0 = time.perf_counter()
        first = None
        for state, info in solver.solution_generator(heat):
            torch.cuda.synchronize()
            if info["num_steps"] == 0:
                t_init = time.perf_counter()
            elif info["num_steps"] == 1:
                first = (state.y.mean.clone(), state.y.cov_sqrtm.norm(dim=1))
        t_end = time.perf_counter()
        launches.read(f"X4 N={LARGE_N} f32 two-QR banded", {"leaf_lq": init + X4_STEPS * per_step})
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        steps = info["num_steps"]
        check(steps == X4_STEPS, f"X4: ran {steps} steps")
        mean, cov = state.y.mean, state.y.cov_sqrtm
        check(mean.dtype == cov.dtype == torch.float32 and bool(torch.isfinite(mean).all()
                                                                and torch.isfinite(cov).all()),
              "X4: the f32 state is not float32 or not finite")
        steps_per_s = steps / (t_end - t_init)
        print(f"X4 N={LARGE_N} f32 two-QR banded (leaf route): problem {setup_s:.3f} s, init "
              f"{t_init - t0:.3f} s, {steps_per_s:.4f} steps/s, peak {peak:.2f} GiB ({held:.2f} "
              f"held before); phase 15's f64 banded run: init {f64_large['init_s']:.3f} s, "
              f"{f64_large['steps_per_s']:.4f} steps/s, peak {f64_large['peak_gib']:.2f} GiB "
              f"[{card_line}]", flush=True)
        del solver, state, mean, cov
        plain = pt.white.LinearWhiteNoiseEK1(
            steprule=pt.odetools.step.Constant(DT), num_derivatives=LARGE_NU,
            spatial_kernel=prior(pt), factorization=None, fused=False)
        launches.reset()
        state = step_once(plain, heat)["state"]
        launches.read(f"X4 N={LARGE_N} f32 plain two-QR, one step", {})
    mean_rel = ((first[0].double() - state.y.mean.double()).norm()
                / state.y.mean.double().norm()).item()
    std_rel = rel_max(first[1].double(), state.y.cov_sqrtm.norm(dim=1).double())
    print(f"X4 N={LARGE_N} f32 first step, banded kernel path vs plain two-QR: mean rel (norm) "
          f"{mean_rel:.3e}, std rel {std_rel:.3e} [{card_line}]", flush=True)
    check(mean_rel <= F32_MEAN_TOL and std_rel <= F32_GRAM_TOL, "X4: f32 paths disagree")
    del heat, plain, state, first
    torch.cuda.empty_cache()


def phase_f32_steady(pt, dev, launches, card_line, steady64):
    """X5. The seeded steady state at N = 512 (phase E's configuration)
    under the f32 policy: the f32 recursion's seed has no Cholesky factor in
    f32 (the JAX package's is NaN) and raises; the recursion promoted to f64
    (``dtype="float64"``: the init LQ on K1, the seed and polish plain, the
    frozen blocks cast back) on the f32-assembled problem, held to the same
    run on the CPU on that problem's operators copied to the host, max|u|
    printed beside JAX's; and on phase E's f64 problem cast to f32, max|u|
    held to phase E's. Mean-only steps/s of each beside phase E's f64 rate."""
    from pnmol_tpu_torch import interop
    from pnmol_tpu_torch.experiments import common

    constant = pt.odetools.step.Constant(STEADY_DT)

    def solver(opts):
        return pt.white.LinearWhiteNoiseEK1(
            steprule=constant, num_derivatives=NU, spatial_kernel=prior(pt),
            factorization="householder", steady_state=opts)

    with common.precision_policy(torch.float32):
        heat = dx_adapted_heat(pt, dev, N_POINTS, STEADY_STEPS, dt=STEADY_DT)
        try:
            solver(True).initialize(heat)
            raised = None
        except torch.linalg.LinAlgError as err:
            raised = str(err).splitlines()[0]
        print(f"X5 N={N_POINTS} f32 seeded steady state, the recursion in f32: the seed's "
              f"Cholesky raises ({raised}), as the JAX package's f32 seed gives NaN", flush=True)
        check(raised is not None, "X5: the f32 seed factorized: the pinned behavior changed")
    cast = cast_problem(steady64["heat"],
                        lambda: dx_adapted_heat(pt, dev, N_POINTS, STEADY_STEPS, dt=STEADY_DT))
    bare64 = steady64["bare"]
    promoted_runs = {}
    for label, pde in (("the f32 problem", heat), ("phase E's f64 problem cast to f32", cast)):
        with common.precision_policy(torch.float32):
            promoted = solver({"dtype": "float64"})
            launches.reset()
            run = run_solver(promoted, pde, num_steps=STEADY_STEPS)
            launches.read(f"X5 promoted on {label}", {"panel_lq": 13})
            check_f32_state(f"X5 promoted on {label}", run)
            sc = promoted.steady_cache
            check(all(x.dtype == torch.float32 for x in (sc.cov_inf, sc.L21, sc.Sl_inv,
                                                          sc.err_vec)),
                  "X5: the frozen blocks are not float32")
            bare, _ = bare_steps_per_s(promoted, run["state"], pde, STEADY_STEPS)
        promoted_runs[label] = (promoted, run["state"].y.mean)
        u = run["state"].y.mean[0].abs().max().item()
        info = promoted.steady_diagnostics
        print(f"X5 N={N_POINTS} promoted (f64 recursion) on {label}: init {run['init_s']:.3f} s, "
              f"SDA {info['sda_iterations']} iterations, dare_residual "
              f"{info['dare_residual']:.3e}, polish {sc.iterations} (delta {sc.delta:.3e}); "
              f"max|u| after {STEADY_STEPS} mean-only steps {u:.10f} (phase E f64 "
              f"{JAX_STEADY_MAX_U}, rel {abs(u / JAX_STEADY_MAX_U - 1):.3e}; the JAX package's "
              f"f32 problem {JAX_STEADY_F32_PROMOTED_MAX_U}); mean-only {bare:.1f} steps/s in a "
              f"bare loop (f32), phase E's f64 {bare64:.1f} [{card_line}]", flush=True)
        check(np.isfinite(u), f"X5 on {label}: not finite")
        if pde is cast:
            check(abs(u / JAX_STEADY_MAX_U - 1) <= F32_STEADY_TOL_CAST,
                  "X5: the f32 frozen steps on the cast problem leave phase E's max|u|")

    # the same promoted run on the CPU, on the f32 problem's operators
    # copied to the host: where the card and the CPU part, the operators are
    # not the cause
    with common.precision_policy(torch.float32):
        host = interop.discretized_problem(
            **{k: getattr(heat, k).cpu().numpy() for k in ("L", "E_sqrtm", "B", "R_sqrtm", "y0")},
            points=heat.mesh_spatial.points.cpu().numpy(), t0=heat.t0, tmax=heat.tmax,
            device="cpu")
        host_solver = solver({"dtype": "float64"})
        (final, _), host_s = timed_sync(lambda: host_solver.simulate_final_state(host))
    card_solver, card_mean = promoted_runs["the f32 problem"]
    card_mean, host_mean = card_mean.cpu().double(), final.y.mean.double()
    u_card, u_host = card_mean[0].abs().max().item(), host_mean[0].abs().max().item()
    mean_rel = ((card_mean - host_mean).norm() / host_mean.norm()).item()
    blocks = {}
    for key, sc in (("card", card_solver.steady_cache), ("host", host_solver.steady_cache)):
        cov, L21, Sl_inv = (x.cpu().double() for x in (sc.cov_inf, sc.L21, sc.Sl_inv))
        blocks[key] = (cov @ cov.T, L21 @ Sl_inv)
    gram_rel = rel_max(blocks["card"][0], blocks["host"][0])
    gain_rel = rel_max(blocks["card"][1], blocks["host"][1])
    info = host_solver.steady_diagnostics
    print(f"X5 N={N_POINTS} promoted on the f32 problem, the card against the CPU on the same "
          f"operators ({host_s:.3f} s there; SDA {info['sda_iterations']} iterations, "
          f"dare_residual {info['dare_residual']:.3e}, polish "
          f"{host_solver.steady_cache.iterations}): frozen covariance Gram rel {gram_rel:.3e}, "
          f"gain rel {gain_rel:.3e}; max|u| {u_card:.10f} against {u_host:.10f} (rel "
          f"{abs(u_card / u_host - 1):.3e}), mean rel (norm) {mean_rel:.3e} [{card_line}]",
          flush=True)
    check(abs(u_card / u_host - 1) <= F32_STEADY_TOL_HOST and mean_rel <= F32_STEADY_TOL_HOST
          and gram_rel <= F32_STEADY_BLOCKS_TOL_HOST and gain_rel <= F32_STEADY_BLOCKS_TOL_HOST,
          "X5: the card's promoted run on the f32 problem leaves the CPU's on its operators")


def phase_f32_drivers(pt, dev, launches, card_line, f64_rows):
    """``--drivers``: the JAX drivers' f32 legs. The work-precision legs in
    f32 (``lv_cuda_f32``, ``heat_512_cuda_f32``, ``heat_2048_cuda_f32`` at
    S1's dts), each row beside the card's f64 row: where the f64 row's RMSE
    is at least 10 times the f32 leg's floor (its smallest RMSE) the f32 row
    is held to it at 10% (the JAX driver's claim, that f32 lands on the f64
    curve until its roundoff floor binds), else it is printed as bound.
    Then the decay probe at N = 1e4 on an f32 problem, the recursion in
    f32 (its seed may have no f32 Cholesky factor, as at N = 512 in X5:
    printed) and promoted to f64, 2048 mean-only steps in f32 each: the
    ratios beside S2's f64 one (PERF.md §7). The lv leg's FD assembly may
    have no f32 Cholesky factor on the card (printed)."""
    from pnmol_tpu_torch.experiments import common, steady_decay_probe
    from pnmol_tpu_torch.experiments import work_precision as wp

    by_dt = {(row["problem"], row["n"], row["dt"]): row for row in f64_rows}
    for leg in wp.F32_LEGS:
        dts = WP_HEAT_2048_DTS if leg.startswith("heat_2048") else None
        (result, status), seconds = timed_sync(lambda: common.run_leg(leg, wp.run_leg, leg,
                                                                      dts=dts))
        if leg.startswith("lv") and status["status"] == "failed":
            # the default SquareExponential() stencils on dx 0.01 are near
            # singular (ROADMAP 3.3); in f32 cuSOLVER's Cholesky refuses
            # them where LAPACK's factors them (the JAX package's and the
            # port's CPU runs): rounding's call, recorded, not held
            print(f"X {leg}: failed in {seconds:.3f} s: {status['error'][:160]}", flush=True)
            check("LinAlgError" in status["error"], f"X {leg}: {status['error']}")
            continue
        check(status["status"] == "completed", f"X {leg}: {status['error']}")
        rows = result["rows"]
        floor = min(row["rmse_rel"] for row in rows)
        print(f"X {leg}: {seconds:.3f} s, the f32 floor (smallest rmse_rel) {floor:.6e} "
              f"[{card_line}]", flush=True)
        for row in rows:
            want = by_dt[row["problem"], row["n"], row["dt"]]
            check(row["dtype"] == "float32" and np.isfinite(row["rmse_rel"]),
                  f"X {leg} dt={row['dt']}: not an f32 row or not finite")
            bound = want["rmse_rel"] < 10 * floor
            gap = abs(row["rmse_rel"] / want["rmse_rel"] - 1)
            print(f"X {leg} dt={row['dt']}: rmse_rel {row['rmse_rel']:.6e} (f64 "
                  f"{want['rmse_rel']:.6e}, rel {gap:.3e}{', bound by the f32 floor' if bound else ''}), "
                  f"chi2 {row['chi2']:.6e} (f64 {want['chi2']:.6e}), {row['steps_per_s']:.2f} "
                  f"steps/s (f64 {want['steps_per_s']:.2f}) [{card_line}]", flush=True)
            check(bound or gap <= 0.1, f"X {leg} dt={row['dt']}: off the f64 curve")

    # the decay on an f32 problem: the recursion in f32 (as the TPU's run),
    # then promoted to f64
    for opts, label in ((True, "f32 recursion"), ({"dtype": "float64"}, "f64 recursion")):
        with common.precision_policy(torch.float32):
            heat = dx_adapted_heat(pt, dev, LARGE_N, 1)
            solver = pt.white.LinearWhiteNoiseEK1(
                steprule=pt.odetools.step.Constant(STEADY_DT), num_derivatives=1,
                spatial_kernel=prior(pt), steady_state=opts,
                **steady_decay_probe.solver_options(dev, LARGE_N))
            try:
                state, build_s = timed_sync(lambda: solver.initialize(heat))
            except torch.linalg.LinAlgError as err:
                print(f"X decay N={LARGE_N} f32 problem, {label}: the seed has no Cholesky "
                      f"factor in f32 ({str(err).splitlines()[0][:120]})", flush=True)
                check(opts is True, f"X decay N={LARGE_N}: the {label} failed")
                del heat, solver
                torch.cuda.empty_cache()
                continue
            del heat
            record, seconds = timed_sync(lambda: steady_decay_probe.measure(solver, state,
                                                                            DECAY_STEPS))
        decay_line(f"X decay N={LARGE_N} f32 problem, {label} (build {build_s:.3f} s)",
                   record, card_line, seconds)
        check(np.isfinite(record["ratio"]) and record["dtype"] == "torch.float32",
              f"X decay N={LARGE_N} f32, {label}: not finite or not f32")
        del solver, state
        torch.cuda.empty_cache()


class Laps:
    """Seconds of each group of phases by the host clock, printed as it ends."""

    def __init__(self):
        self.last = time.perf_counter()

    def lap(self, label):
        now = time.perf_counter()
        print(f"time: phases {label} {now - self.last:.1f} s", flush=True)
        self.last = now


def phase_build(cuda_build):
    """One nvcc per source, all started together."""
    def timed(name):
        t0 = time.perf_counter()
        lib = cuda_build.build(name)
        return lib, time.perf_counter() - t0

    sources = sorted(set(SOURCES.values()))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(timed, name) for name in sources}
    for future in futures.values():
        lib, seconds = future.result()
        print(f"build: {lib.name} in {seconds:.2f} s", flush=True)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    card_line = card()
    print(f"card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    import pnmol_tpu_torch as pt
    from pnmol_tpu_torch.ops import cuda_build
    from pnmol_tpu_torch.ops import gram as tgram
    from pnmol_tpu_torch.ops import qr_householder as tq

    dev = torch.device("cuda", 0)
    wrappers = {"panel_lq": tq.panel_lq, "leaf_lq": tq.leaf_lq,
                "gram_radial": tgram.gram_radial, "leaf_qr": tq.leaf_qr}
    clock = Laps()
    phase_build(cuda_build)
    clock.lap("build")
    if sys.argv[1:] == ["--figures"]:
        phase_figures_full(pt, dev, Launches(wrappers), card_line, clock)
        print(f"the four figures at full size passed in {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if sys.argv[1:] == ["--drivers"]:
        phase_drivers_full(pt, dev, Launches(wrappers), card_line, clock)
        print(f"the four measurement drivers at full size passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: none, --figures or --drivers")

    panel = phase_kernel(tq, dev)
    gram = phase_gram(tgram, cuda_build, dev)
    leaf = phase_leaf(tq, dev)
    leaf_lq = phase_leaf_lq(tq, dev)
    clock.lap("3 (kernels)")
    launches = Launches(wrappers)
    white, latent = pt.white.LinearWhiteNoiseEK1, pt.latent.LinearLatentForceEK1
    # d = 6: every pre-array is one 128-row panel (white: init 20 rows, steps
    # 26; latent: init 32, steps 44) or, in the R form, one or two 32-column
    # leaves per step (white 44 x 26; latent 80 x 44); the init stays plain
    phase_golden(pt, dev, launches, white, "white", "householder", {"panel_lq": 6},
                 "the panel kernel")
    phase_golden(pt, dev, launches, white, "white", tq.make_householder_factorization(),
                 {"leaf_qr": 5}, "the R-form hook (leaf kernel)")
    phase_gradients(pt, tq, dev, launches, card_line)
    clock.lap("4, M")
    heat, plain, pnmol = phase_full_width(pt, dev, launches, card_line)
    phase_utilities(pt, dev, launches, card_line, heat)
    phase_collocation(pt, dev, launches, card_line)
    phase_r_form(pt, tq, launches, heat, plain, card_line)
    phase_golden(pt, dev, launches, latent, "latent", "householder", {"panel_lq": 6},
                 "the panel kernel")
    phase_golden(pt, dev, launches, latent, "latent", tq.make_householder_factorization(),
                 {"leaf_qr": 10}, "the R-form hook (leaf kernel)")
    latent_plain = phase_latent(pt, launches, heat, card_line)
    phase_lotka_volterra(pt, dev, launches, card_line)
    adaptive_plain = phase_adaptive(pt, dev, launches, card_line)
    phase_semilinear_latent(pt, dev, launches, card_line)
    phase_latent_r_form(pt, tq, launches, heat, latent_plain, card_line)
    clock.lap("5-13, O")
    phase_latent_large(pt, dev, launches, card_line)
    large64 = phase_large_n(pt, dev, launches, card_line)
    clock.lap("14-15")
    phase_mol(pt, dev, launches, card_line, pnmol)
    phase_smoothing(pt, dev, launches, card_line)
    clock.lap("A-B")
    phase_figure1(pt, dev, launches, card_line)
    phase_figure2(pt, dev, launches, card_line)
    clock.lap("P1-P2 (figures 1-2)")
    phase_figure4(pt, dev, launches, card_line)
    clock.lap("C, P3 (figure 4)")
    phase_figure3(pt, dev, launches, card_line)
    clock.lap("L, P4 (figure 3)")
    phase_mle(pt, tgram, dev, launches, card_line)
    clock.lap("D")
    steady = phase_steady(pt, dev, launches, card_line)
    clock.lap("E")
    phase_sharded_steady_gloo(pt, dev, launches, card_line, steady)
    clock.lap("E2")
    steady64 = {key: steady[key] for key in ("heat", "bare")}  # for phase X5
    del steady
    steady_large = phase_steady_large(pt, dev, launches, card_line)
    clock.lap("F")
    phase_sharded_steady_large(pt, dev, launches, card_line, steady_large)
    del steady_large
    clock.lap("N")
    phase_heat_2d(pt, tgram, dev, launches, card_line)
    phase_advection_3d(pt, dev, launches, card_line)
    phase_nd_small(pt, dev, launches, card_line)
    clock.lap("G-I")
    phase_sharded_large(pt, dev, launches, card_line)
    clock.lap("J")
    phase_sharded_gloo(pt, dev, launches, card_line, plain, latent_plain_short(pt, dev),
                       adaptive_plain)
    clock.lap("K")
    phase_work_precision(pt, dev, launches, card_line)
    clock.lap("S1 (work precision)")
    phase_steady_probes(pt, dev, launches, card_line)
    clock.lap("S2 (steady probes; N=1e4 decay in F)")
    phase_latent_rung(pt, dev, launches, card_line, *LATENT_RUNGS[0])
    phase_scale_gram(pt, dev, launches, card_line)
    clock.lap("S3 (scale demo)")
    panel_f32 = phase_f32_kernels(tq, dev)
    f32_heat, f32_plain = phase_f32_bench(pt, tq, dev, launches, card_line, heat, pnmol)
    phase_f32_latent_and_r_form(pt, tq, launches, f32_heat, f32_plain, heat, latent_plain,
                                card_line)
    del f32_heat, f32_plain
    clock.lap("X0-X3 (f32 kernels, the f32 bench configuration, latent, R form)")
    phase_f32_large(pt, dev, launches, card_line, large64)
    clock.lap("X4 (f32 at N=1e4)")
    phase_f32_steady(pt, dev, launches, card_line, steady64)
    clock.lap("X5 (f32 steady state)")
    check("jax" not in sys.modules and "pnmol_tpu" not in sys.modules, "JAX was imported")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)

    records = []
    for name, replaces, measured in (
        ("panel_lq", "pnmol_tpu/ops/qr_householder.py:535", panel),
        ("leaf_lq", "pnmol_tpu/ops/qr_householder.py:350", leaf_lq),
        ("gram_radial", "pnmol_tpu/ops/pallas_gram.py:51", gram),
        ("leaf_qr", "pnmol_tpu/ops/qr_householder.py:75", leaf),
    ):
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"pnmol_tpu_torch/csrc/{SOURCES[name]}.cu",
            "replaces": replaces,
            "launches": launches.totals[name],
            **{key: measured[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
            # phase X0's f32 instantiation at the f32 solver shapes
            **({"f32": panel_f32[name]} if name in panel_f32 else {}),
        })
    print(json.dumps({"kernels": records}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
