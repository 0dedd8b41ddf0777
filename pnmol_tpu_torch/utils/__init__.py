"""Utilities of the port: the communication and FLOP model of the sharded
tier (:mod:`pnmol_tpu_torch.utils.comm_model`)."""

from pnmol_tpu_torch.utils import comm_model

__all__ = ["comm_model"]
