"""The collectives of the port's models and steps on a mesh of more than
one device: explicit Megatron-style tensor parallelism and data
parallelism on each rank's local tensors.

The reference runs its models under GSPMD, which inserts the
collectives; the port's models run eagerly on the local tensors of
their DTensors and call the collectives here themselves.  ``Par`` is
this rank's place on the mesh: the ``model`` axis (tensor, sequence and
Mamba d_inner parallelism) and the data plane (``data``, or ``pod`` x
``data``), each with its process group, size and this rank's index.  A
mesh of one device has no ``Par``: the models then run exactly the code
they run without a mesh.

Every collective is a ``torch.ops._c10d_functional`` op, so
``launch.analysis`` counts it (kind, operand bytes), on real tensors as
on the dry run's fake ones.  Where autograd runs through one, it sits
inside a ``torch.autograd.Function`` with its backward:

* ``copy_to_model``: identity; its backward all-reduces over ``model``
  (the input of a column-parallel matmul, or a weight every rank uses
  in part);
* ``reduce_from_model``: all-reduce over ``model``; identity backward
  (the output of a row-parallel matmul);
* ``gather``: all-gather over an axis (an FSDP leaf over the data
  plane); its backward reduce-scatters the gradient onto the shard;
* ``gather_whole``: all-gather over an axis for a computation that
  every rank of the plane repeats whole (an MoE layer's router logits,
  which every rank routes whole); its backward keeps this rank's slice
  of the gradient, which is already the whole one;
* ``exchange_halves``: the all-to-all of a Mamba block's ``in_proj``
  output; its backward is the reverse exchange;
* ``exchange_chunks``: the all-to-all of an MoE layer's expert queues
  over the data plane (chunk j to rank j, in equal parts); its backward
  is the same exchange of the gradient.

One collective is built from another, the same way on every backend:
the gloo process group that two ranks on one card share crashes on the
functional all-gather of CUDA tensors (and so does a DTensor's
``full_tensor``, which calls it), so an all-gather is an all-reduce of
this rank's shard placed into zeros: the sum adds only zeros to each
element.  It is counted as the all-reduce it is.  The reduce-scatter
and the all-to-all are the functional ops themselves.
"""

from __future__ import annotations

import functools
import math

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.tree import at, map_with_path

_F = torch.ops._c10d_functional


def _all_reduce(x: torch.Tensor, group: str, op: str = "sum"
                ) -> torch.Tensor:
    return _F.wait_tensor(_F.all_reduce(x.contiguous(), op, group))


def _all_gather(x: torch.Tensor, dim: int, group: str, size: int,
                rank: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order: this
    rank's piece placed into zeros, all-reduced."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    full = x.new_zeros(shape)
    full.narrow(dim, rank * n, n).copy_(x)
    return _all_reduce(full, group)


def _reduce_scatter(x: torch.Tensor, dim: int, group: str, size: int
                    ) -> torch.Tensor:
    """This rank's ``dim``-slice of the ranks' sum."""
    y = x.movedim(dim, 0).contiguous()
    y = _F.wait_tensor(_F.reduce_scatter_tensor(y, "sum", size, group))
    return y.movedim(0, dim)


def _all_to_all(x: torch.Tensor, out_splits: list, in_splits: list,
                group: str) -> torch.Tensor:
    """Rows of ``x`` (dim 0) sent by ``in_splits`` to each rank, received
    by ``out_splits`` from each, in rank order."""
    return _F.wait_tensor(_F.all_to_all_single(
        x.contiguous(), out_splits, in_splits, group))


class Plane:
    """One axis, or the data plane, of a mesh: its group's name, its
    size and this rank's index along it."""

    def __init__(self, group: str, size: int, rank: int) -> None:
        self.group, self.size, self.rank = group, size, rank

    def chunk(self, n: int) -> tuple[int, int]:
        """This rank's [start, stop) of a dim of ``n`` sharded over the
        plane (``torch.chunk``'s split, as a DTensor's ``Shard``)."""
        step = -(-n // self.size)
        start = min(self.rank * step, n)
        return start, min(start + step, n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, plane):
        ctx.dim, ctx.plane = dim, plane
        return _all_gather(x, dim, plane.group, plane.size, plane.rank)

    @staticmethod
    def backward(ctx, g):
        p = ctx.plane
        return _reduce_scatter(g, ctx.dim, p.group, p.size), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, plane):
        ctx.dim, ctx.plane, ctx.n = dim, plane, x.shape[dim]
        return _all_gather(x, dim, plane.group, plane.size, plane.rank)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.plane.rank * ctx.n, ctx.n), None, None


class _ExchangeChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plane):
        ctx.plane = plane
        return _exchange_chunks(x, plane)

    @staticmethod
    def backward(ctx, g):
        return _exchange_chunks(g, ctx.plane), None


def _exchange_chunks(x: torch.Tensor, plane: Plane) -> torch.Tensor:
    """``x`` (size, ...): chunk j sent to rank j; chunk i of the result
    came from rank i."""
    split = [1] * plane.size
    return _all_to_all(x, split, split, plane.group)


def _exchange(y: torch.Tensor, plane: Plane, forward: bool
              ) -> torch.Tensor:
    """The all-to-all of ``exchange_halves`` (or, with ``forward``
    false, its reverse).  Forward: rank r's half j is global chunk
    k = 2r + j, for rank k mod m (in rank order as j grows); rank r
    receives x's chunk from rank r // 2 and z's from rank (m + r) // 2
    (in rank order).  Each half is one row of the exchange."""
    m, r = plane.size, plane.rank
    c = y.shape[-1] // 2
    rows = torch.stack([y[..., :c], y[..., c:]])
    mine = [(2 * r) % m, (2 * r + 1) % m]  # where this rank's halves go
    theirs = [r // 2, (m + r) // 2]  # where its [x, z] come from
    split = lambda ranks: [ranks.count(i) for i in range(m)]  # noqa: E731
    out = _all_to_all(rows, *((split(theirs), split(mine)) if forward
                              else (split(mine), split(theirs))),
                      plane.group)
    return torch.cat([out[0], out[1]], dim=-1)


class _ExchangeHalves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, plane):
        ctx.plane = plane
        return _exchange(y, plane, True)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.plane, False), None


class Par:
    """This rank's place on a mesh of more than one device (module
    docstring).  Reads the mesh's dim names and sizes at once; the
    groups and this rank's coordinates at first use, so a builder can
    make one for a mesh it only lays out."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.names = names
        self.data_axes = tuple(a for a in names if a in ("pod", "data"))
        self.model_size = int(mesh.shape[names.index("model")])
        self.data_size = math.prod(int(mesh.shape[names.index(a)])
                                   for a in self.data_axes)

    @classmethod
    def of(cls, mesh) -> "Par | None":
        """A ``Par`` for ``mesh``, or None on a mesh of one device."""
        return None if mesh.size() == 1 else cls(mesh)

    # ------------------------------------------------------ the planes --
    # The mesh's layout is read on real tensors even where a step is
    # traced on fake ones (the dry run): it is metadata, not a value.
    @functools.cached_property
    def model(self) -> Plane:
        with unset_fake_temporarily():
            return Plane(self.mesh.get_group("model").group_name,
                         self.model_size, self.mesh.get_local_rank("model"))

    @functools.cached_property
    def data(self) -> Plane:
        """The data plane: ``data``, or ``pod`` x ``data`` (pod outer)."""
        axes = self.data_axes
        with unset_fake_temporarily():
            if len(axes) == 1:
                group = self.mesh.get_group(axes[0])
            else:
                group = self.mesh[axes]._flatten().get_group()
            rank = 0
            for a in axes:
                rank = rank * int(self.mesh.shape[self.names.index(a)]) \
                    + self.mesh.get_local_rank(a)
        return Plane(group.group_name, self.data_size, rank)

    def is_data(self, entry) -> bool:
        """Does a spec entry name the data plane?"""
        return entry is not None and (
            entry if isinstance(entry, tuple) else (entry,)) == self.data_axes

    def plane(self, entry) -> Plane | None:
        """The plane a spec entry shards over: ``model``, the data plane,
        or None for an unsharded dim."""
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        if axes == ("model",):
            return self.model
        if axes == self.data_axes:
            return self.data
        raise ValueError(f"no plane for the spec entry {entry!r}")

    def tp(self, n: int) -> bool:
        """Does a dim of ``n`` shard over ``model`` (``MeshRules._div``)?"""
        return self.model_size > 1 and n >= self.model_size \
            and n % self.model_size == 0

    # ------------------------------------------------ model collectives --
    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.model.group)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.model.group)

    def max_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ``model``; no gradient."""
        return _all_reduce(x.detach(), self.model.group, "max")

    def exchange_halves(self, y: torch.Tensor) -> torch.Tensor:
        """A Mamba ``in_proj`` output (..., 2 Di / m) -> (..., 2 Di / m)
        as [x, z] of this rank's d_inner chunk.  ``in_proj`` (D, 2 Di)
        shards its columns contiguously, so rank r holds global chunks
        2r and 2r + 1 of Di / m columns: chunk k is x's chunk k (k < m)
        or z's chunk k - m, and belongs to rank k mod m."""
        return _ExchangeHalves.apply(y, self.model)

    def exchange_chunks(self, x: torch.Tensor, entry) -> torch.Tensor:
        """``x`` (n, ...), n the size of the plane of ``entry``: chunk j
        sent to its rank j, chunk i of the result received from rank i
        (one all-to-all in equal parts; the same exchange of the
        gradient back)."""
        plane = self.plane(entry)
        if plane is None or plane.size == 1:
            return x
        return _ExchangeChunks.apply(x, plane)

    # ----------------------------------------------- sharded dims -------
    def gather_whole(self, x: torch.Tensor, dim: int, entry
                     ) -> torch.Tensor:
        """``gather``, for a computation that every rank of the plane
        repeats whole: the backward keeps this rank's slice of the
        gradient (each rank's is the whole gradient already)."""
        plane = self.plane(entry)
        if plane is None or plane.size == 1:
            return x
        return _GatherWhole.apply(x, dim % x.ndim, plane)

    def gather(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """``x`` all-gathered along ``dim`` over the plane of ``entry``
        (the reduce-scatter of the gradient back); ``x`` itself where
        ``entry`` is None or its plane holds one device."""
        plane = self.plane(entry)
        if plane is None or plane.size == 1:
            return x
        return _Gather.apply(x, dim % x.ndim, plane)

    def shard(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """This rank's slice of ``x`` along ``dim`` over the plane of
        ``entry`` (no collective)."""
        plane = self.plane(entry)
        if plane is None:
            return x
        start, stop = plane.chunk(x.shape[dim])
        return x.narrow(dim, start, stop - start)

    def sum_over(self, x: torch.Tensor, entry) -> torch.Tensor:
        """``x`` summed over the plane of ``entry``; no gradient rule."""
        plane = self.plane(entry)
        if plane is None or plane.size == 1:
            return x
        return _all_reduce(x, plane.group)

    def replicas(self, spec) -> int:
        """Ranks that hold the same shard of a leaf of ``spec``."""
        split = 1
        for entry in spec:
            plane = None if entry is None else (
                self.model_size if entry == "model" else self.data_size)
            split *= plane or 1
        return self.mesh.size() // split

    def gather_fsdp(self, params, specs):
        """The parameter tree with each leaf whose spec shards a dim over
        the data plane (FSDP) all-gathered over it along that dim: the
        model-parallel shards the model computes on.  Per step: every
        such leaf is gathered before the step's first layer.  Under
        autograd each gradient is reduce-scattered back onto the shard
        (summed over the data plane).  ``specs``: the FSDP entries alone
        (``MeshRules.fsdp_pspecs``: a routed-expert leaf over the data
        plane stays sharded, the MoE layer's all-to-all computes on it)."""
        def gather(path, t):
            for d, entry in enumerate(at(specs, path)):
                if self.is_data(entry):
                    t = self.gather(t, d, entry)
            return t
        return map_with_path(gather, params)

    def sum_over_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every rank of the mesh."""
        x = _all_reduce(x, self.model.group) if self.model_size > 1 else x
        return _all_reduce(x, self.data.group) if self.data_size > 1 else x
