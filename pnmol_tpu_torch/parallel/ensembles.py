"""Data-parallel ensembles: batched filter steps and the dt sweep.

Counterpart of :mod:`pnmol_tpu.parallel.ensembles`: a batch of white-noise
filter instances advances as ONE step batched with ``torch.func.vmap``, the
dt sweep pads each lane's constant schedule to the longest (full steps, or
the mean-only steps of frozen per-lane stationary factors), and on a mesh
each rank of the ``"batch"`` axis takes its own members (blocks of
:func:`~pnmol_tpu_torch.parallel.meshes.block_bounds`) and the results are
gathered over the batch axis.
"""

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from pnmol_tpu_torch.parallel import meshes
from pnmol_tpu_torch.solvers import pdefilter
from pnmol_tpu_torch.solvers.white import make_steady_state_white_step, white_attempt_step


class EnsembleState(NamedTuple):
    """Batched filter state: leading axis = ensemble member."""

    mean: torch.Tensor  # (E, n, d)
    cov_sqrtm: torch.Tensor  # (E, D, D)
    diffusion_sum: torch.Tensor  # (E,)


def stack_caches(caches):
    """Stack per-member solver caches (or steady caches) into one batched
    cache; scalar fields become 1-D tensors."""
    return type(caches[0])(*(torch.stack(xs) if isinstance(xs[0], torch.Tensor)
                             else torch.tensor(xs) for xs in zip(*caches)))


def _members(E, mesh):
    """This rank's ``(start, stop)`` members and every rank's count, over
    the mesh's batch axis (all members without a mesh)."""
    if mesh is None:
        return (0, E), None
    sizes = meshes.block_sizes(E, mesh.shape["batch"])
    return mesh.bounds(E, "batch"), sizes


def _gathered(outputs, sizes, mesh):
    if mesh is None:
        return outputs
    return tuple(mesh.gather_rows(x, sizes, "batch") for x in outputs)


def make_ensemble_step_fn(*, num_derivatives, f, df, linear, mesh=None):
    """Batched white-noise step over a stacked cache.

    Returns ``step(cache_batched, mean (E, n, d), cov (E, D, D), t_next, dt)
    -> (means, covs, errors, references, diffusions)``, each with the
    leading member axis; ``cache_batched`` from :func:`stack_caches`. With
    ``mesh``, each rank of the batch axis advances its members and the
    results are gathered (no communication inside the step).
    """

    def single(cache, mean, cov, t_next, dt):
        return white_attempt_step(cache, mean, cov, t_next, dt,
                                  num_derivatives=num_derivatives, f=f, df=df, linear=linear)

    batched = vmap(single, in_dims=(0, 0, 0, None, None))

    def step(cache, mean, cov, t_next, dt):
        (start, stop), sizes = _members(mean.shape[0], mesh)
        mine = type(cache)(*(x[start:stop] for x in cache))
        return _gathered(batched(mine, mean[start:stop], cov[start:stop], t_next, dt),
                         sizes, mesh)

    return step


def _padded_schedules(t0, tmax, dts, start, stop, like):
    """The lanes ``start:stop`` of the dt ladder's constant schedules, padded
    to the longest: ``(t_next, dt, live)`` each (max_len, lanes), and every
    lane's step count. A padded step repeats the lane's last dt."""
    schedules = [pdefilter.constant_step_schedule(t0, tmax, dt) for dt in dts]
    lengths = [len(d) for _, d in schedules]
    max_len = max(lengths)
    E = len(dts)
    ts_next = np.zeros((E, max_len))
    dts_pad = np.zeros((E, max_len))
    mask = np.zeros((E, max_len), dtype=bool)
    for i, (ts, ds) in enumerate(schedules):
        ts_next[i, :lengths[i]] = ts + ds
        dts_pad[i, :lengths[i]] = ds
        ts_next[i, lengths[i]:] = ts[-1] + ds[-1]
        dts_pad[i, lengths[i]:] = ds[-1]
        mask[i, :lengths[i]] = True
    return (torch.tensor(ts_next[start:stop].T, **like),
            torch.tensor(dts_pad[start:stop].T, **like),
            torch.tensor(mask[start:stop].T, device=like["device"]),
            torch.tensor(lengths[start:stop], **like))


def dt_sweep_final_states(*, cache, num_derivatives, f, df, linear, mean0, cov0, t0, tmax, dts,
                          mesh=None):
    """All constant-step solves of ONE problem over a dt ladder, as one
    padded batched loop (the figure-3 sweep).

    Every lane shares the cache and runs its own constant schedule
    (:func:`pnmol_tpu_torch.solvers.pdefilter.constant_step_schedule`);
    schedules are padded to the longest lane, and a padded step computes
    with the lane's own last dt and is discarded. The step is the fused
    ``torch.linalg.qr`` one, batched over the lanes with ``vmap``; on a mesh
    the lanes are split over the batch axis and gathered. Returns ``(means
    (E, n, d), cov_sqrtms (E, D, D), diffusion_sq (E,))`` with the factors
    scaled by the calibration, the ``simulate_final_state`` semantics.
    """
    dts = [float(dt) for dt in dts]
    (start, stop), sizes = _members(len(dts), mesh)
    like = dict(dtype=mean0.dtype, device=mean0.device)
    ts_next, dts_pad, live, lengths = _padded_schedules(t0, tmax, dts, start, stop, like)

    def single(mean, cov, t_next, dt):
        return white_attempt_step(cache, mean, cov, t_next, dt,
                                  num_derivatives=num_derivatives, f=f, df=df, linear=linear)

    lane_step = vmap(single)
    lanes = stop - start
    mean = mean0.expand((lanes,) + tuple(mean0.shape)).clone()
    cov = cov0.expand((lanes,) + tuple(cov0.shape)).clone()
    diff_sum = mean0.new_zeros(lanes)
    for k in range(ts_next.shape[0]):
        new_mean, new_cov, _, _, diff = lane_step(mean, cov, ts_next[k], dts_pad[k])
        keep = live[k]
        mean = torch.where(keep[:, None, None], new_mean, mean)
        cov = torch.where(keep[:, None, None], new_cov, cov)
        diff_sum = diff_sum + torch.where(keep, diff, 0.0)
    diffusion = diff_sum / lengths
    cov = cov * torch.sqrt(diffusion)[:, None, None]
    return _gathered((mean, cov, diffusion), sizes, mesh)


def steady_dt_sweep_final_states(*, cache, num_derivatives, mean0, t0, tmax, dts, steady_caches,
                                 mesh=None):
    """The dt sweep with FROZEN per-lane stationary factors.

    For linear problems at constant dt each lane's covariance recursion
    converges to its own (dt-specific) Riccati fixed point, so each lane
    only needs the mean-only step of ``make_steady_state_white_step`` with
    its own ``(Sl_inv, L21, err_vec)``: O(D m) a lane-step instead of the
    pre-array QR. ``steady_caches`` stacks the per-dt
    :class:`~pnmol_tpu_torch.solvers.white.SteadyStateCache` (leading axis
    ``len(dts)``, :func:`stack_caches`); the schedules and their masking
    are :func:`dt_sweep_final_states`'s, and the lanes are batched with
    ``vmap`` (on a mesh split over the batch axis and gathered). Returns
    ``(means (E, n, d), cov_sqrtms (E, D, D), diffusion_sq (E,))``, lane
    i's factor ``steady_caches.cov_inf[i]`` scaled by its calibration.
    """
    dts = [float(dt) for dt in dts]
    (start, stop), sizes = _members(len(dts), mesh)
    like = dict(dtype=mean0.dtype, device=mean0.device)
    ts_next, dts_pad, live, lengths = _padded_schedules(t0, tmax, dts, start, stop, like)
    mine = type(steady_caches)(*(x[start:stop] for x in steady_caches))

    def single(steady, mean, t_next, dt):
        step = make_steady_state_white_step(cache=cache, steady=steady,
                                            num_derivatives=num_derivatives)
        new_mean, _, _, _, diff = step(mean, None, t_next, dt)
        return new_mean, diff

    lane_step = vmap(single)
    lanes = stop - start
    mean = mean0.expand((lanes,) + tuple(mean0.shape)).clone()
    diff_sum = mean0.new_zeros(lanes)
    for k in range(ts_next.shape[0]):
        new_mean, diff = lane_step(mine, mean, ts_next[k], dts_pad[k])
        keep = live[k]
        mean = torch.where(keep[:, None, None], new_mean, mean)
        diff_sum = diff_sum + torch.where(keep, diff, 0.0)
    diffusion = diff_sum / lengths
    cov = mine.cov_inf * torch.sqrt(diffusion)[:, None, None]
    return _gathered((mean, cov, diffusion), sizes, mesh)
