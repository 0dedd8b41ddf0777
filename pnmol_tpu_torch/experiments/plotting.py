"""Figure rendering from the drivers' saved arrays (the port's copy of
``experiments/plotting.py``).

Each ``figure_N(root, fast=False)`` loads the arrays a driver wrote under
the output root ``root`` (``<root>/figureN/``, or ``figureN_fast/``) and
writes ``<root>/figureN.pdf`` and ``.png`` beside them, never into
``experiments/results/``. The panel layouts are the JAX package's: figure 1
the 3x3 contour grid (mean / std / error per method row), figure 2 the 2x6
gridspec (operator sparsity, RMSE-vs-stencil curves, GP samples), figure 3
the 2x5 log-norm imshow grid (rel/abs error, std, chi^2, runtime), figure
4 the three work-precision loglog panels with the calibration band.
Styling comes from the package's own ``style/paper.mplstyle``. Only this
module imports matplotlib.
"""

import pathlib

import matplotlib.colors as mcolors
import matplotlib.pyplot as plt
import numpy as np

STYLESHEET = pathlib.Path(__file__).resolve().parent / "style" / "paper.mplstyle"

# AISTATS template geometry: 2-column layout,
# 6.75 in total line width, 3.25 in per column.
AISTATS_LINEWIDTH_DOUBLE = 6.75
AISTATS_TEXTWIDTH_SINGLE = 3.25


def _use_style():
    plt.style.use(str(STYLESHEET))


class _Arrays:
    """The arrays of one figure under an output root, and where its render
    goes."""

    def __init__(self, root, figure, fast):
        self.name = figure + "_fast" if fast else figure
        self.root = pathlib.Path(root)

    def __call__(self, name):
        return np.load(self.root / self.name / f"{name}.npy")

    def save(self, fig):
        out = self.root / self.name
        fig.savefig(out.with_suffix(".pdf"), bbox_inches="tight")
        fig.savefig(out.with_suffix(".png"), dpi=200, bbox_inches="tight")
        plt.close(fig)
        print(f"saved {out}.pdf/.png")


def figure_1(root, fast=False):
    """Method rows x (mean, std, error) contour panels."""
    _load = _Arrays(root, "figure1", fast)
    _use_style()
    methods = ["pnmol_white", "pnmol_latent", "tornadox"]
    labels = {"pnmol_white": "White", "pnmol_latent": "Latent",
              "tornadox": "PN+MOL"}
    ref_means = _load("reference_means")
    ref_ts = _load("reference_ts")

    fig, axes = plt.subplots(
        nrows=len(methods), ncols=3, dpi=200,
        figsize=(AISTATS_LINEWIDTH_DOUBLE, 1.2 * AISTATS_TEXTWIDTH_SINGLE),
        sharex=True, sharey=True,
    )
    contour_args = {"alpha": 0.8, "levels": 20}
    means_style = {"vmin": 0.0, "vmax": 0.1, "cmap": "Greys"}
    error_style = {"cmap": "inferno"}
    for axis_row, method in zip(axes, methods):
        means = _load(f"{method}_means")
        stds = _load(f"{method}_stds")
        ts = _load(f"{method}_ts")
        xs = _load(f"{method}_xs").squeeze()
        n = min(len(means), len(ref_means), len(ts))
        m = min(means.shape[1], ref_means.shape[1], len(xs))
        X, T = np.meshgrid(xs[:m], ts[:n])
        error = np.abs(ref_means[:n, :m] - means[:n, :m])

        axis_row[0].contourf(X, T, means[:n, :m], **contour_args, **means_style)
        bar = axis_row[1].contourf(
            X, T, stds[:n, :m] + 1e-12, **contour_args, **error_style
        )
        fig.colorbar(bar, ax=axis_row[1])
        bar = axis_row[2].contourf(
            X, T, error + 1e-12, **contour_args, **error_style
        )
        fig.colorbar(bar, ax=axis_row[2])
        axis_row[0].set_ylabel(labels[method])
        for ax in axis_row:
            ax.set_xticklabels(())
            ax.set_yticklabels(())
    for ax in axes[-1]:
        ax.set_xlabel("Space")
    ax1, ax2, ax3 = axes[0]
    ax1.set_title(r"$\bf a.$ " + "Mean", loc="left", fontsize="medium")
    ax2.set_title(r"$\bf b.$ " + "Std.-dev.", loc="left", fontsize="medium")
    ax3.set_title(r"$\bf c.$ " + "Error", loc="left", fontsize="medium")
    _load.save(fig)


def figure_2(root, fast=False):
    """2x6 gridspec: L/E sparsity, RMSE-vs-stencil curves, GP samples
   ."""
    _load = _Arrays(root, "figure2", fast)
    _use_style()
    rmse_all = _load("fig2_rmse_all")
    input_scales = _load("fig2_input_scales")
    stencil_sizes = _load("fig2_stencil_sizes")
    L_sparse = _load("fig2_L_sparse")
    L_dense = _load("fig2_L_dense")
    E_sparse = _load("fig2_E_sparse")
    E_dense = _load("fig2_E_dense")
    xgrid = _load("fig2_xgrid").squeeze()
    fx = _load("fig2_fx")
    samples = [_load(f"fig2_s{i}") for i in (1, 2, 3)]

    fig = plt.figure(
        constrained_layout=True, dpi=200,
        figsize=(AISTATS_LINEWIDTH_DOUBLE, 0.8 * AISTATS_TEXTWIDTH_SINGLE),
    )
    gs = fig.add_gridspec(2, 6)
    ax_L_sparse = fig.add_subplot(gs[0, 0])
    ax_L_dense = fig.add_subplot(gs[1, 0])
    ax_E_sparse = fig.add_subplot(gs[0, 1])
    ax_E_dense = fig.add_subplot(gs[1, 1])
    ax_rmse = fig.add_subplot(gs[:, 2:4])
    ax_curve = fig.add_subplot(gs[:, 4:])

    clip = 1e-12
    blues = {"cmap": "Blues", "aspect": "auto"}
    ax_L_sparse.imshow(np.abs(L_sparse) + clip, **blues)
    ax_L_dense.imshow(
        np.abs(L_dense) + clip, vmax=7 * np.median(np.abs(L_dense)), **blues
    )
    ax_E_sparse.imshow(
        np.abs(E_sparse @ E_sparse.T) + clip, **blues,
        norm=mcolors.LogNorm(vmin=clip),
    )
    ax_E_dense.imshow(
        np.abs(E_dense @ E_dense.T) + clip, **blues, norm=mcolors.LogNorm()
    )
    for ax, title in [
        (ax_L_sparse, r"$\bf a.$ $|L|$ (FD)"),
        (ax_E_sparse, r"$\bf b.$ $|EE^\top|$ (FD)"),
        (ax_L_dense, r"$\bf c.$ $|L|$ (dense)"),
        (ax_E_dense, r"$\bf d.$ $|EE^\top|$ (dense)"),
    ]:
        ax.set_title(title, loc="left", fontsize="small")
        ax.set_xticks(())
        ax.set_yticks(())

    for j, scale in enumerate(input_scales):
        ax_rmse.semilogy(
            stencil_sizes, rmse_all[:, j], marker=".", label=rf"$r={scale:g}$"
        )
    ax_rmse.set_xlabel("Stencil size")
    ax_rmse.set_ylabel("RMSE")
    ax_rmse.set_title(r"$\bf e.$ FD error", loc="left", fontsize="small")
    ax_rmse.legend(fontsize="x-small", fancybox=False, edgecolor="black")

    ax_curve.plot(xgrid, fx, color="black", linestyle="dashed", label="Target")
    for s, scale in zip(samples, input_scales):
        ax_curve.plot(xgrid, s[:, 0], linewidth=0.8, label=rf"$r={scale:g}$")
    ax_curve.set_xlabel("Space")
    ax_curve.set_title(r"$\bf f.$ GP samples", loc="left", fontsize="small")
    ax_curve.legend(fontsize="x-small", fancybox=False, edgecolor="black")
    _load.save(fig)


def figure_3(root, fast=False):
    """2x5 log-norm imshow grid: rel/abs error, std, chi^2, runtime for
    PNMOL-white vs MOL."""
    _load = _Arrays(root, "figure3", fast)
    _use_style()
    methods = ["pnmol_white", "tornadox"]
    nicer = {"tornadox": "MOL", "pnmol_white": "PNMOL"}
    fields = ["error_rel", "error_abs", "std", "chi2", "runtime"]
    results = {
        m: [np.abs(_load(f"{m}_{f}")) + 1e-16 for f in fields]
        for m in methods
    }
    lims = [
        (
            min(results[m][i].min() for m in methods),
            max(results[m][i].max() for m in methods),
        )
        for i in range(len(fields))
    ]

    fig, axes = plt.subplots(
        nrows=2, ncols=5, dpi=400,
        figsize=(AISTATS_LINEWIDTH_DOUBLE, 0.8 * AISTATS_TEXTWIDTH_SINGLE),
        sharex=True, sharey=True, constrained_layout=True,
    )
    for axis_row, method in zip(axes, methods):
        DTs = _load(f"{method}_dt")
        DXs = _load(f"{method}_dx")
        extents = [
            float(DTs.min()), float(DTs.max()),
            float(DXs.max()), float(DXs.min()),
        ]
        axis_row[0].set_ylabel(f"{nicer[method]}\ndx")
        for ax, mat, (vmin, vmax) in zip(axis_row, results[method], lims):
            im = ax.imshow(
                mat, norm=mcolors.LogNorm(vmin=vmin, vmax=vmax),
                extent=extents, aspect="auto", cmap="RdYlBu",
            )
            fig.colorbar(im, ax=ax)
    titles = [
        r"$\bf a1$. Relative Error", r"$\bf a2$. Absolute Error",
        r"$\bf a3$. Std. dev.", r"$\bf a4$. $\chi^2$-statistic",
        r"$\bf a5$. Run time [s]",
    ]
    for ax, title in zip(axes[0], titles):
        ax.set_title(title, fontsize="small", loc="left")
    for i, ax in enumerate(axes[1]):
        ax.set_title(rf"$\bf b{i + 1}$.", fontsize="small", loc="left")
    for ax in axes[-1]:
        ax.set_xlabel("dt")
    _load.save(fig)


def figure_4(root, fast=False, dxs=(0.01, 0.05, 0.2)):
    """Work-precision: RMSE vs nsteps / runtime / chi^2, calibration band;
    one line style per dx of ``dxs``."""
    _load = _Arrays(root, "figure4", fast)
    _use_style()
    fig, axes = plt.subplots(
        ncols=3, sharey=True, dpi=200, constrained_layout=True,
        figsize=(AISTATS_LINEWIDTH_DOUBLE, 0.75 * AISTATS_TEXTWIDTH_SINGLE),
    )
    ax_nsteps, ax_runtime, ax_chi2 = axes
    colors = {"mol": "C0", "pnmol_white": "C1", "pnmol_latent": "C2"}
    nicer = {"mol": "MOL", "pnmol_white": "PNMOL (white)",
             "pnmol_latent": "PNMOL (latent)"}
    linestyles = [":", "--", "-"]

    for dx, ls in zip(dxs, linestyles):
        prefix = f"dx_{dx}"
        for method in ("mol", "pnmol_white", "pnmol_latent"):
            rmse = _load(f"{prefix}_{method}_rmse")
            chi2 = _load(f"{prefix}_{method}_chi2")
            nsteps = _load(f"{prefix}_{method}_nsteps")
            time = _load(f"{prefix}_{method}_time")
            style = {
                "color": colors[method], "linestyle": ls, "marker": ".",
                "label": f"{nicer[method]} (dx={dx})",
            }
            ax_nsteps.loglog(nsteps, rmse, **style)
            ax_runtime.loglog(time, rmse, **style)
            ax_chi2.loglog(chi2, rmse, **style)

    ax_nsteps.set_xlabel("Number of time-steps")
    ax_runtime.set_xlabel("Run time [s]")
    ax_chi2.set_xlabel(r"$\chi^2$-statistic")
    ax_nsteps.set_ylabel("RMSE")
    ax_nsteps.legend(
        loc="lower left", handlelength=2.5, fontsize=4,
        fancybox=False, edgecolor="black",
    ).get_frame().set_linewidth(0.5)
    for ax in axes:
        ax.grid(which="minor", axis="y", linewidth=0.5, linestyle="dotted",
                alpha=0.75)
    ax_nsteps.set_title(r"$\bf a.$ " + "RMSE vs. Number of time-steps",
                        loc="left", fontsize="small")
    ax_runtime.set_title(r"$\bf b.$ " + "RMSE vs. Run time",
                         loc="left", fontsize="small")
    ax_chi2.set_title(r"$\bf c.$ " + "RMSE vs. Calibration",
                      loc="left", fontsize="small")
    # the well-calibrated chi^2 band
    ax_chi2.axvspan(0.01, 100.0, color="gray", alpha=0.2)
    _load.save(fig)
