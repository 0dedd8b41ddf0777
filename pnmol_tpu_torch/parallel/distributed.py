"""The multi-process runtime seam: process groups, the rank launcher, the
two-rank dry run.

Counterpart of :mod:`pnmol_tpu.parallel.distributed`. JAX joins processes
with ``jax.distributed.initialize`` and lets GSPMD span hosts; here every
rank is one process in a ``torch.distributed`` process group:

* :func:`init_distributed` starts the group from torchrun's variables
  (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``) with the
  backend the caller names (``"nccl"`` or ``"gloo"``); with no rendezvous
  configured it is a no-op, so library code can call it unconditionally.
* :func:`global_mesh` is :func:`pnmol_tpu_torch.parallel.meshes.make_mesh`
  over every rank of the group.
* :func:`spawn_ranks` runs a function on ``world_size`` local processes, one
  rank each, and raises with each failing rank's output on a non-zero exit
  or a timeout.
* :func:`two_process_cpu_dryrun` runs a psum and one distributed-QR white
  step on two gloo ranks on the CPU.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

def init_distributed(backend=None, *, master_addr=None, master_port=None, world_size=None,
                     rank=None, device=None):
    """Start the process group (idempotent); True if a group is running.

    Arguments default to ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE``
    / ``RANK``. Without a rendezvous address and port (given or set) this is
    a no-op returning False: a single process with nothing configured runs
    without a group. A configured rendezvous starts a group even of one
    rank. ``backend`` must then be named: ``"nccl"`` (``device`` is the
    rank's CUDA device, made current) or ``"gloo"``.
    """
    if dist.is_initialized():
        return True
    master_addr = master_addr or os.environ.get("MASTER_ADDR")
    master_port = master_port or os.environ.get("MASTER_PORT")
    if master_addr is None or master_port is None:
        return False
    world_size = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed needs backend='nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=f"tcp://{master_addr}:{master_port}",
                            world_size=world_size, rank=rank)
    return True


def global_mesh(batch=None):
    """(batch, space) mesh over every rank of the process group."""
    from pnmol_tpu_torch.parallel import meshes

    return meshes.make_mesh(batch=batch)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_REPO = str(pathlib.Path(__file__).resolve().parents[2])


def _rank_main(job_dir):
    """Body of one spawned rank: join the group, run the target, save its
    result, leave the group."""
    job = pathlib.Path(job_dir)
    with open(job / "job.pkl", "rb") as fh:
        target, payload, backend, device = pickle.load(fh)
    rank = int(os.environ["RANK"])
    device = device.format(rank=rank)
    init_distributed(backend=backend, device=device)
    try:
        result = target(payload, device)
        torch.save(result, job / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, world_size, *, backend, device, payload=None, timeout=900):
    """Run ``target(payload, device)`` on ``world_size`` local ranks.

    Each rank is a fresh Python process that joins a ``backend`` group at a
    free localhost port and unpickles ``target`` by its module path, so the
    target must live in an importable module (one that imports what the
    rank may import). ``device`` may hold ``{rank}``. Returns one
    ``(result, output)`` pair per rank, the result as ``torch.save`` wrote
    it. Raises ``RuntimeError`` with each failing rank's output on a
    non-zero exit or after ``timeout`` seconds; every process is stopped.
    """
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()  # the ranks share the card with this process
    port = _free_port()
    module = sys.modules[target.__module__]
    paths = [_REPO]
    if getattr(module, "__file__", None) and "." not in target.__module__:
        paths.append(str(pathlib.Path(module.__file__).resolve().parent))
    with tempfile.TemporaryDirectory(prefix="pnmol_ranks_") as job:
        with open(pathlib.Path(job) / "job.pkl", "wb") as fh:
            pickle.dump((target, payload, backend, device), fh)
        procs = []
        for rank in range(world_size):
            env = dict(os.environ)
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world_size), RANK=str(rank),
                       PYTHONPATH=os.pathsep.join(paths + [env.get("PYTHONPATH", "")]))
            code = ("import sys; from pnmol_tpu_torch.parallel import distributed; "
                    "distributed._rank_main(sys.argv[1])")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, job], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
        outputs, failed = [], []
        for rank, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for other in procs:
                    other.kill()
                out, _ = proc.communicate()
                failed.append((rank, "timeout", out))
                outputs.append(out)
                continue
            outputs.append(out)
            if proc.returncode != 0:
                failed.append((rank, proc.returncode, out))
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if failed:
            details = "\n---\n".join(f"rank {r} ({rc}):\n{out[-4000:]}" for r, rc, out in failed)
            raise RuntimeError(f"{len(failed)} of {world_size} ranks failed:\n{details}")
        return [(torch.load(pathlib.Path(job) / f"rank{r}.pt", weights_only=False), outputs[r])
                for r in range(world_size)]


def _dryrun_rank(payload, device):
    """One rank of :func:`two_process_cpu_dryrun`."""
    import pnmol_tpu_torch as pt
    from pnmol_tpu_torch.parallel import sharded_filter

    torch.set_num_threads(1)
    mesh = global_mesh(batch=1)
    assert mesh.shape["space"] == dist.get_world_size() == 2
    total = mesh.psum(torch.ones(2, dtype=torch.float64), "space")
    assert float(total[0]) == 2.0, total

    heat = pt.pde.examples.heat_1d_discretized(dx=1.0 / 15, tmax=1.0, device=device)
    solver = pt.white.LinearWhiteNoiseEK1(
        steprule=pt.odetools.step.Constant(0.05),
        spatial_kernel=pt.kernels.Matern52() + pt.kernels.WhiteNoise(),
    )
    state = solver.initialize(heat)
    cache = sharded_filter.shard_cache(solver._cache, mesh, distributed_qr=True)
    step = sharded_filter.make_space_sharded_white_step(
        cache=cache, num_derivatives=2, mesh=mesh, linear=True, distributed_qr=True,
        panel_size=16,
    )
    cov = mesh.shard(state.y.cov_sqrtm, sharded_filter.cov_layout(True))
    out = step(state.y.mean, cov, 0.05, 0.05)
    assert not torch.isnan(out[0]).any()
    print(f"rank {mesh.rank}: 2-rank dryrun OK, mean shape {tuple(out[0].shape)}", flush=True)
    return None


def two_process_cpu_dryrun(timeout=600):
    """Two gloo ranks on the CPU: a psum over the space axis and one
    distributed-QR white step of ``heat_1d_discretized(dx=1/15)``. Raises on
    any rank's failure; returns the ranks' outputs."""
    runs = spawn_ranks(_dryrun_rank, 2, backend="gloo", device="cpu", timeout=timeout)
    return [out for _, out in runs]
