"""Utilities of the port: checkpoints, typed configs, finite checks and
live-memory dumps, profiling and the FLOP model, resilient solves, and the
communication and FLOP model of the sharded tier
(:mod:`pnmol_tpu_torch.utils.comm_model`)."""

from pnmol_tpu_torch.utils import (
    checkpoint,
    comm_model,
    configs,
    debug,
    profiling,
    resilience,
)

__all__ = ["checkpoint", "comm_model", "configs", "debug", "profiling", "resilience"]
