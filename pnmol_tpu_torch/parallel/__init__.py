"""The space-sharded tier over ``torch.distributed`` (explicit SPMD).

Counterpart of :mod:`pnmol_tpu.parallel`, its steady-state half included.
The JAX tier is written for GSPMD: it gives arrays a sharding and lets XLA
insert the collectives, with only the panel factorizations written as
``shard_map`` bodies. PyTorch has no GSPMD, so here every rank is one
process holding its own block of each sharded tensor, and the code names
every collective:

* Each ``shard_map`` body becomes a per-rank function on the rank's block,
  and each ``psum`` / ``all_gather`` / ``ppermute`` a collective of the
  :class:`~pnmol_tpu_torch.parallel.meshes.Mesh` of that name. Where the JAX
  tier leaves a layout change to GSPMD, the port issues the collective GSPMD
  would insert (a gather, an all-to-all, a broadcast), counted apart.
* Layouts follow the JAX ``PartitionSpec``\\ s: the covariance factor and
  ``Ql`` column-sharded under ``distributed_qr=True`` (so the pre-array is
  row-sharded with no reshard) and row-sharded otherwise; the mean and the
  (m+D, m+D) R of ``blocked_qr_r`` replicated; the R of
  ``blocked_qr_r_sharded`` row-sharded with panel-aligned owners. Padding
  follows the JAX geometry (``blocked_qr_r_sharded``'s P L columns,
  ``_chol_pad_geometry``'s panel rows).
* The mesh owns the process groups (one per space row and per batch
  column) and counts every collective's kind and per-rank payload under the
  conventions of :mod:`pnmol_tpu_torch.utils.comm_model`.
* The backend is the caller's: ``init_distributed(backend=...)``. Under
  ``"nccl"`` device tensors go to the collectives as they are; under
  ``"gloo"`` a CUDA operand is staged through host memory and back, and the
  bytes are counted (the compute stays on the device).
* TPU and XLA workarounds stay behind: the scan-bodied panel sweep (the
  port's sweep is one Python loop with a shrinking trailing width, JAX's
  ``loop="unrolled"``), the cache-as-traced-argument pattern,
  ``with_sharding_constraint`` and the virtual CPU devices.

Modules: :mod:`meshes`, :mod:`distributed` (process group, rank launcher),
:mod:`sharded_linalg`, :mod:`sharded_filter` (steps and solves, and the
steady tier: the sharded Riccati convergence, the placement of the frozen
blocks and the mean-only solve), :mod:`sharded_dare` (the row-sharded
doubling seed), :mod:`sharded_init` (distributed initialization) and
:mod:`ensembles` (batched steps, the dt sweep and its frozen-gain form).
"""

from pnmol_tpu_torch.parallel import (
    distributed,
    ensembles,
    meshes,
    sharded_dare,
    sharded_filter,
    sharded_init,
    sharded_linalg,
)

__all__ = ["distributed", "ensembles", "meshes", "sharded_dare", "sharded_filter",
           "sharded_init", "sharded_linalg"]
