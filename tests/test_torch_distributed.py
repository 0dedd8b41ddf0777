"""The port's multi-process seam: the no-op cases of ``init_distributed``
and the two-rank gloo dry run (a psum and one distributed-QR white step
over two processes on the CPU), counterparts of
``tests/test_distributed.py``."""

import pytest
import torch

from pnmol_tpu_torch.parallel import distributed

torch.set_num_threads(1)


def test_init_distributed_is_noop_without_configuration(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed(backend="gloo") is False


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.init_distributed(backend="gloo") is False


def test_init_distributed_needs_a_backend(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError):
        distributed.init_distributed()


def test_two_process_cpu_dryrun():
    outs = distributed.two_process_cpu_dryrun()
    assert len(outs) == 2
    assert all("dryrun OK" in o for o in outs)


def _fails_on_rank_one(payload, device):
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank one fails")
    return "ok"


def test_spawn_ranks_raises_with_the_failing_ranks_output():
    with pytest.raises(RuntimeError, match="rank one fails"):
        distributed.spawn_ranks(_fails_on_rank_one, 2, backend="gloo", device="cpu",
                                timeout=120)
