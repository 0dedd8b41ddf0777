"""The ("batch", "space") rank grid and its named, counted collectives.

Counterpart of :mod:`pnmol_tpu.parallel.meshes`. Where a ``jax.sharding.Mesh``
is a grid of devices that GSPMD partitions arrays over, a :class:`Mesh` here
is a grid of ``torch.distributed`` ranks, and every rank holds its OWN block
of each sharded tensor. The mesh owns one process group per space row and
per batch column and issues the collectives under JAX's names:

* :meth:`Mesh.psum` (``jax.lax.psum``: an all-reduce),
* :meth:`Mesh.all_gather` (``jax.lax.all_gather``: stacks the blocks),
* :meth:`Mesh.ppermute` (``jax.lax.ppermute`` by a ring shift, over
  ``batch_isend_irecv``),

plus the collectives GSPMD would insert where the JAX tier lets it move
data between layouts: :meth:`Mesh.gather_rows` (an all-gather of uneven row
blocks), :meth:`Mesh.exchange` (an all-to-all of per-peer blocks, behind
:meth:`Mesh.reshard_rows` and :meth:`Mesh.transpose_rows`) and
:meth:`Mesh.broadcast`.

Every collective records its kind and its per-rank payload in elements under
the conventions of :mod:`pnmol_tpu_torch.utils.comm_model` (an all-reduce its
operand, an all-gather the local block, a ppermute the block it sends), in
one of two regions: ``"schedule"`` for the collectives the JAX tier names in
its ``shard_map`` bodies (the ones the comm model counts) and ``"layout"``
for the ones GSPMD inserts there. Under the ``gloo`` backend a CUDA operand
is copied to host memory for the collective and the result copied back; the
bytes moved are counted in :attr:`Mesh.staged_bytes`.

Blocks: a dimension of size ``n`` sharded over ``P`` ranks is cut into
``ceil(n / P)``-sized blocks, the last ones short or empty
(:func:`block_bounds`), as JAX cuts an uneven sharding.
"""

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("batch", "space")


class Layout(NamedTuple):
    """Which mesh axis shards each tensor dimension (``None``: replicated),
    as a ``PartitionSpec``; trailing dimensions are replicated."""

    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh=None):
    return Layout(("batch",))


def space_sharding(mesh=None, rank=1):
    """Shard the leading tensor dimension over the 'space' axis."""
    return Layout(("space",) + (None,) * (rank - 1))


def column_sharding(mesh=None):
    """Shard the second dimension of a matrix over the 'space' axis."""
    return Layout((None, "space"))


def replicated(mesh=None):
    return Layout(())


def block_bounds(n, parts, index):
    """``(start, stop)`` of block ``index`` of ``n`` rows cut into ``parts``
    blocks of ``ceil(n / parts)`` (the last ones short or empty)."""
    size = -(-n // parts)
    return min(index * size, n), min((index + 1) * size, n)


def all_block_bounds(n, parts):
    return [block_bounds(n, parts, i) for i in range(parts)]


def block_sizes(n, parts):
    """Every block's row count: the ``sizes`` of :meth:`Mesh.gather_rows`."""
    return [stop - start for start, stop in all_block_bounds(n, parts)]


def _factor(n, batch):
    if batch is None:
        batch = 1
        for candidate in range(int(n**0.5), 0, -1):
            if n % candidate == 0:
                batch = candidate
                break
    if n % batch != 0:
        raise ValueError(f"batch={batch} must divide world_size={n}")
    return batch, n // batch


class Mesh:
    """A ("batch", "space") grid of ranks with named, counted collectives.

    Rank ``r`` sits at ``(r // space, r % space)``, the row-major order of
    JAX's ``devices.reshape(batch, space)``. Without an initialized process
    group the mesh is one rank and every collective is the identity (still
    counted), so single-process code runs the same functions.
    """

    def __init__(self, world_size=None, batch=None):
        self.distributed = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        n = world if world_size is None else world_size
        if n != world:
            raise ValueError(f"world_size={n} is not the {world} ranks of the process group")
        batch, space = _factor(n, batch)
        self.shape = {"batch": batch, "space": space}
        self.axis_names = AXES
        rank = dist.get_rank() if self.distributed else 0
        self.rank = rank
        self.backend = dist.get_backend() if self.distributed else None
        self.index = {"batch": rank // space, "space": rank % space}
        self._ranks = {}
        self._groups = {}
        if self.distributed:
            # every rank creates every group, in the same order
            for b in range(batch):
                ranks = [b * space + s for s in range(space)]
                group = dist.new_group(ranks)
                if b == self.index["batch"]:
                    self._ranks["space"], self._groups["space"] = ranks, group
            for s in range(space):
                ranks = [b * space + s for b in range(batch)]
                group = dist.new_group(ranks)
                if s == self.index["space"]:
                    self._ranks["batch"], self._groups["batch"] = ranks, group
        self.reset_counts()

    # -- bookkeeping ------------------------------------------------------

    def reset_counts(self):
        """Zero the collective counters and the staged bytes."""
        self.counts = {}
        self.staged_bytes = 0

    def _record(self, kind, region, elements):
        entry = self.counts.setdefault((kind, region), {"calls": 0, "elements": 0})
        entry["calls"] += 1
        entry["elements"] += int(elements)

    def totals(self, region="schedule"):
        """``{kind: total payload elements}`` of one region."""
        return {k: v["elements"] for (k, reg), v in self.counts.items() if reg == region}

    def calls(self, region="schedule"):
        """``{kind: number of collectives}`` of one region."""
        return {k: v["calls"] for (k, reg), v in self.counts.items() if reg == region}

    # -- layouts ----------------------------------------------------------

    def bounds(self, n, axis="space"):
        """This rank's ``(start, stop)`` of ``n`` rows sharded over ``axis``."""
        return block_bounds(n, self.shape[axis], self.index[axis])

    def shard(self, x, layout):
        """This rank's block of a full tensor under ``layout``."""
        for dim, axis in enumerate(layout.spec):
            if axis is not None:
                start, stop = self.bounds(x.shape[dim], axis)
                x = x.narrow(dim, start, stop - start)
        return x

    # -- transport ----------------------------------------------------------

    def _staged(self, x):
        """The operand a collective takes: a host copy under gloo."""
        if self.backend == "gloo" and x.is_cuda:
            self.staged_bytes += x.numel() * x.element_size()
            return x.cpu()
        return x

    def _unstaged(self, y, like):
        if y.device != like.device:
            self.staged_bytes += y.numel() * y.element_size()
            return y.to(like.device)
        return y

    def _group(self, axis):
        return self._groups.get(axis) if self.distributed else None

    # -- the named collectives ----------------------------------------------

    def psum(self, x, axis="space", *, region="schedule"):
        """Sum of ``x`` over the ranks of ``axis`` (an all-reduce)."""
        self._record("all-reduce", region, x.numel())
        group = self._group(axis)
        if group is None:
            return x.clone()
        buf = self._staged(x.contiguous())
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, group=group)
        return self._unstaged(buf, x)

    def all_gather(self, x, axis="space", *, region="schedule"):
        """The blocks of every rank of ``axis``, stacked: ``(P, *x.shape)``."""
        self._record("all-gather", region, x.numel())
        group = self._group(axis)
        if group is None:
            return x[None].clone()
        buf = self._staged(x.contiguous())
        stacked = buf.new_empty((self.shape[axis],) + tuple(buf.shape))
        dist.all_gather(list(stacked.unbind(0)), buf, group=group)
        return self._unstaged(stacked, x)

    def ppermute(self, x, axis="space", shift=1, *, region="schedule"):
        """Send ``x`` to the rank ``shift`` places on along ``axis`` (a ring)
        and return the block of the rank ``shift`` places back."""
        self._record("ppermute", region, x.numel())
        P = self.shape[axis]
        me = self.index[axis]
        dst, src = (me + shift) % P, (me - shift) % P
        if dst == me or self._group(axis) is None:
            return x.clone()
        ranks = self._ranks[axis]
        buf = self._staged(x.contiguous())
        out = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, ranks[dst], group=self._groups[axis]),
               dist.P2POp(dist.irecv, out, ranks[src], group=self._groups[axis])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._unstaged(out, x)

    def broadcast(self, x, axis="space", src=0, *, region="layout"):
        """Rank ``src`` of ``axis``'s ``x`` on every rank of ``axis``."""
        self._record("broadcast", region, x.numel())
        group = self._group(axis)
        if group is None:
            return x.clone()
        buf = self._staged(x.contiguous())
        if buf is x:
            buf = x.clone()
        dist.broadcast(buf, self._ranks[axis][src], group=group)
        return self._unstaged(buf, x)

    def exchange(self, sends, recv_shapes, axis="space", *, region="layout"):
        """All-to-all of per-peer blocks: ``sends[q]`` goes to rank ``q`` of
        ``axis``; returns the blocks received, of ``recv_shapes[q]`` from
        rank ``q``. Empty blocks are not sent; the own block is copied."""
        me = self.index[axis]
        self._record("all-to-all", region,
                     sum(s.numel() for q, s in enumerate(sends) if q != me))
        like = sends[me]
        out = [None] * len(sends)
        ops, pending = [], []
        for q, (send, shape) in enumerate(zip(sends, recv_shapes)):
            if q == me:
                out[q] = send.clone()
                continue
            if self._group(axis) is None:
                raise RuntimeError("exchange between ranks needs a process group")
            peer = self._ranks[axis][q]
            if send.numel():
                ops.append(dist.P2POp(dist.isend, self._staged(send.contiguous()), peer,
                                      group=self._groups[axis]))
            recv = torch.empty(shape, dtype=like.dtype,
                               device="cpu" if self.backend == "gloo" else like.device)
            if recv.numel():
                ops.append(dist.P2POp(dist.irecv, recv, peer, group=self._groups[axis]))
            pending.append((q, recv))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for q, recv in pending:
            out[q] = self._unstaged(recv, like)
        return out

    # -- layout changes built on the collectives ------------------------------

    def gather_rows(self, x, sizes, axis="space", *, region="layout"):
        """The full tensor from row blocks of ``sizes[q]`` rows on rank ``q``
        (an all-gather of the blocks, padded to the longest)."""
        longest = max(sizes)
        pad = longest - x.shape[0]
        if pad:
            x = torch.cat((x, x.new_zeros((pad,) + tuple(x.shape[1:]))))
        stacked = self.all_gather(x, axis, region=region)
        if len(sizes) == 1:
            return stacked[0, :sizes[0]]
        return torch.cat([stacked[q, :s] for q, s in enumerate(sizes)])

    def reshard_rows(self, x, src, dst, axis="space", *, region="layout"):
        """Rows held in the blocks ``src[q] = (start, stop)`` of each rank
        ``q`` moved to the blocks ``dst[q]``; identical partitions move
        nothing."""
        if list(src) == list(dst):
            return x
        me = self.index[axis]
        s0, s1 = src[me]
        d0, d1 = dst[me]
        sends, shapes = [], []
        for q in range(self.shape[axis]):
            lo, hi = max(s0, dst[q][0]), min(s1, dst[q][1])
            sends.append(x[max(lo - s0, 0):max(hi - s0, 0)])
            lo, hi = max(d0, src[q][0]), min(d1, src[q][1])
            shapes.append((max(hi - lo, 0),) + tuple(x.shape[1:]))
        parts = self.exchange(sends, shapes, axis, region=region)
        return torch.cat(parts) if parts else x[:0]

    def transpose_rows(self, x, shape, axis="space", *, region="layout"):
        """This rank's row block of ``X^T`` from its row block of ``X`` of
        global ``shape`` (both in :func:`block_bounds` blocks): the
        all-to-all that turns a row-sharded matrix column-sharded."""
        n_rows, n_cols = shape
        P = self.shape[axis]
        cols = all_block_bounds(n_cols, P)
        rows = all_block_bounds(n_rows, P)
        me = self.index[axis]
        sends = [x[:, c0:c1] for c0, c1 in cols]
        shapes = [(r1 - r0, cols[me][1] - cols[me][0]) for r0, r1 in rows]
        return torch.cat(self.exchange(sends, shapes, axis, region=region)).T


def make_mesh(world_size=None, batch=None):
    """The ("batch", "space") mesh over the first ``world_size`` ranks of the
    default process group (all of them by default).

    ``batch`` fixes the data-parallel axis; by default the grid is split as
    evenly as possible with the batch axis no larger than the space axis.
    Raises ``ValueError`` for a ``batch`` that does not divide the ranks.
    Every rank must call this, in the same order as its other group calls.
    """
    return Mesh(world_size, batch)
