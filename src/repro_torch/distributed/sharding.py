"""Sharding rules: param-name/shape -> spec -> DTensor placements.

Port of the JAX reference's ``repro/distributed/sharding.py``, over a
torch ``DeviceMesh``.  Mesh axes: ``("data", "model")`` single pod,
``("pod", "data", "model")`` multi-pod.  Data parallelism runs over
(pod, data); tensor/expert/sequence parallelism over ``model``.

Parameter policy (megatron-style TP + optional FSDP), as the reference's:
  * embed / unembed (V, D)           -> V over model (row-parallel gather)
  * attention wq (D,H,hd), wo        -> H over model
  * attention wk/wv (D,KV,hd)        -> KV over model if divisible, else
                                        replicated
  * MLA wuk/wuv/wuq (r,H,d)          -> H over model; latent projections
                                        (D,r) replicated
  * MLP wg/wu (D,F) / wd (F,D)       -> F over model
  * MoE router (D,E)                 -> E over model;
    experts (E,D,F)/(E,F,D)          -> E over model, or over the data
                                        plane above 256 MiB a layer (F
                                        then over model; expert
                                        parallel, never FSDP-gathered:
                                        ``expert_parallel``)
  * Mamba in/out/conv/x_proj/dt/A    -> d_inner over model
  * norms / biases                   -> replicated
  * with ``fsdp=True``: the largest remaining dim of every >=2D param is
    additionally sharded over the data axes (ZeRO-3).

A spec is ``P(*entries)``, one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names; it compares entry for entry with the
reference's ``PartitionSpec``.  ``placements(spec, mesh)`` turns it into
DTensor placements, and ``Sharding`` (mesh, placements, and the spec
they came from) stands where the reference has a ``NamedSharding``.
The rules read only the mesh's dimension names and sizes, as the
reference reads only ``axis_names`` and ``shape``, so they build at any
mesh size; ``shard_tree`` lays tensors out on them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.tree import at, map_with_path, tree_map


class P:
    """A partition spec: one entry per tensor dim, each ``None``, an
    axis name, or a tuple of axis names (sharded over all of them, the
    first outermost)."""

    def __init__(self, *entries) -> None:
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` if the spec names that axis on tensor dim
    ``d``, else ``Replicate()``.  A tensor dim sharded over several axes
    is split over them in mesh order (``("pod", "data")``: pod first)."""
    dim_of = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                dim_of[axis] = d
    return tuple(Shard(dim_of[name]) if name in dim_of else Replicate()
                 for name in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives: its mesh and placements, and the spec they
    came from (the reference's ``NamedSharding``)."""
    mesh: Any
    placements: tuple
    spec: P

    @classmethod
    def of(cls, mesh, spec: P) -> "Sharding":
        return cls(mesh, placements(spec, mesh), spec)


def shard_tree(tree, shardings):
    """Each tensor of ``tree`` laid out as a DTensor on its ``Sharding``
    in ``shardings`` (a tree of the same paths).  On a mesh of one the
    tensor becomes the DTensor's local tensor, with no copy; on a larger
    mesh every rank holds the whole tensor and keeps its shard
    (``distribute_tensor``)."""
    def put(path, t):
        sh = at(shardings, path)
        if sh.mesh.size() == 1:
            return DTensor.from_local(t, sh.mesh, sh.placements,
                                      run_check=False)
        return distribute(t, sh)
    return map_with_path(put, tree)


def distribute(t: torch.Tensor, sh: Sharding) -> DTensor:
    """``t``, the whole leaf on any device, onto its mesh and
    placements: each rank holds the whole leaf and keeps its shard, on
    the mesh's device, with no collective (``src_data_rank=None``)."""
    return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                             sh.placements, src_data_rank=None)


def local(x):
    """A DTensor's local tensor; any other value as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any  # a torch DeviceMesh: only its dim names and sizes are read
    fsdp: bool = False
    zero1: bool = True  # shard optimizer state over the data plane too

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"

    def axis_size(self, name: str) -> int:
        return int(self.mesh.shape[self.axis_names.index(name)])

    def data_size(self) -> int:
        """Devices of the data plane (pod x data)."""
        return int(np.prod([self.axis_size(a) for a in self.data_axes]))

    def data_axis(self):
        """The data plane as one spec entry: an axis name, or the tuple
        ``("pod", "data")``."""
        d = self.data_axes
        return d if len(d) > 1 else d[0]

    # ------------------------------------------------------------------
    def _div(self, dim: int, axis: str) -> bool:
        return dim >= self.axis_size(axis) and dim % self.axis_size(axis) == 0

    def param_spec(self, path: tuple, shape: tuple[int, ...]) -> P:
        """Spec of a parameter leaf given its path and shape."""
        name = path[-1] if path else ""
        m = self.model_axis
        spec: list = [None] * len(shape)
        nd = len(shape)
        # non-divisible head counts are handled by TP head padding in the
        # model configs (n_heads_padded), not by a fallback here
        if name in ("embed", "unembed"):
            spec[0] = m if self._div(shape[0], m) else None
        elif name in ("wq", "wo"):
            # (*, D, H, hd) or (*, H, hd, D): shard H
            h_axis = nd - 3 + (1 if name == "wq" else 0)
            if self._div(shape[h_axis], m):
                spec[h_axis] = m
        elif name in ("wk", "wv", "wuk", "wuv", "wuq"):
            h_axis = nd - 2
            if self._div(shape[h_axis], m):
                spec[h_axis] = m
        elif name in ("wg", "wu", "wd"):
            f_axis = nd - 1 if name in ("wg", "wu") else nd - 2
            if self.moe_leaf(path, shape):
                # EP over the data plane + TP(F) over model for big
                # experts (no per-use gathers); small experts (granite:
                # 33 MB a layer) keep EP over model
                e_axis = nd - 3  # (..., E, D, F) / (..., E, F, D)
                dsize = self.data_size()
                big = int(np.prod(shape[-3:])) * 2 > (256 << 20)
                if big and shape[e_axis] >= dsize \
                        and shape[e_axis] % dsize == 0:
                    spec[e_axis] = self.data_axis()
                elif self._div(shape[e_axis], m):
                    spec[e_axis] = m
                if spec[e_axis] != m and spec[e_axis] is not None \
                        and self._div(shape[f_axis], m):
                    spec[f_axis] = m
            elif self._div(shape[f_axis], m):  # dense MLP: shard F
                spec[f_axis] = m
        elif name in ("router", "in_proj", "dt_proj", "conv_w", "conv_b",
                      "dt_bias", "D_skip"):  # (*, ..., E | Di)
            if self._div(shape[-1], m):
                spec[nd - 1] = m
        elif name in ("x_proj", "out_proj", "A_log"):  # (*, Di, ...)
            if self._div(shape[-2], m):
                spec[nd - 2] = m
        # norms and everything else stay replicated

        used: set = set()
        for e in spec:
            if e is not None:
                used.update(e if isinstance(e, tuple) else (e,))
        if self.fsdp and nd >= 2 and not (used & set(self.data_axes)):
            # the biggest unsharded dim divisible by the data plane
            dsize = self.data_size()
            cands = [i for i, s in enumerate(spec) if s is None
                     and shape[i] >= dsize and shape[i] % dsize == 0]
            if cands:
                spec[max(cands, key=lambda j: shape[j])] = self.data_axis()
        return P(*spec)

    def expert_parallel(self, path, shape) -> bool:
        """Does a routed-expert leaf shard its E over the data plane
        (expert parallelism, not FSDP: the MoE layer's all-to-all
        computes on the shard, which is never gathered)?"""
        if not self.moe_leaf(path, shape):
            return False
        rules = dataclasses.replace(self, fsdp=False)
        return rules.param_spec(path, shape)[len(shape) - 3] \
            == self.data_axis()

    def fsdp_pspecs(self, param_shapes):
        """``params_pspecs`` with the FSDP entries over the data plane
        alone: an expert-parallel leaf's E entry (``expert_parallel``)
        dropped.  What ``Par.gather_fsdp`` gathers."""
        def spec(path, leaf):
            shape = tuple(leaf.shape)
            s = list(self.param_spec(path, shape))
            if self.expert_parallel(path, shape):
                s[len(shape) - 3] = None
            return P(*s)
        return map_with_path(spec, param_shapes)

    def moe_leaf(self, path, shape) -> bool:
        """Routed-expert tensor?  Transformer MoE experts live under
        'ffn' and are 4D when layer-stacked (L, E, D, F) -- dense stacked
        MLPs are 3D (L, D, F) and shared experts sit under 'shared'.
        Hybrid MoE experts live under 'moe' and are 5D (G, n, E, D, F)."""
        keys = set(path)
        nd = len(shape)
        if "shared" in keys:
            return False
        return ("moe" in keys and nd >= 5) or ("ffn" in keys and nd >= 4)

    # ------------------------------------------------------------------
    def params_pspecs(self, param_shapes):
        """The tree of ``P`` for a tree of ``Spec`` (or tensors)."""
        return map_with_path(
            lambda path, leaf: self.param_spec(path, tuple(leaf.shape)),
            param_shapes)

    def params_shardings(self, param_shapes):
        """The tree of ``Sharding`` for a tree of ``Spec`` (or tensors)."""
        return tree_map(lambda spec: Sharding.of(self.mesh, spec),
                        self.params_pspecs(param_shapes))

    # ------------------------------------------------------------------
    def batch_spec(self) -> P:
        return P(self.data_axis())

    def act_spec(self) -> P:
        return P(self.data_axis(), None, None)

    def act_sharder(self):
        """Callable pinning (B, S, D) activations to batch-over-data,
        replicated over ``model``.  A DTensor whose batch divides the
        data plane is redistributed so; anything else (a plain tensor, a
        batch that does not divide) comes back unchanged."""
        dsize = self.data_size()
        mesh, daxis = self.mesh, self.data_axis()

        def shard(x):
            if not isinstance(x, DTensor) or x.ndim < 2 \
                    or x.shape[0] < dsize or x.shape[0] % dsize:
                return x
            spec = P(daxis, *([None] * (x.ndim - 1)))
            return x.redistribute(mesh, placements(spec, mesh))
        return shard

    def _batch_entry(self, batch: int):
        dsize = self.data_size()
        return self.data_axis() if batch % dsize == 0 and batch >= dsize \
            else None

    def cache_spec(self, n_kv_heads: int, batch: int,
                   stacked_dims: int = 1) -> P:
        """Decode-cache spec for (L..., B, T, KV, hd) tensors.

        Shards batch over data if divisible; KV heads over model if
        divisible, else sequence over model (flash-decoding layout).
        """
        lead = [None] * stacked_dims
        b = self._batch_entry(batch)
        if self._div(n_kv_heads, self.model_axis):
            return P(*lead, b, None, self.model_axis, None)
        return P(*lead, b, self.model_axis, None, None)

    def latent_cache_spec(self, batch: int, stacked_dims: int = 1) -> P:
        """(L, B, T, r) MLA latent cache: batch over data, T over model."""
        return P(*[None] * stacked_dims, self._batch_entry(batch),
                 self.model_axis, None)

    def ssm_state_spec(self, batch: int, stacked_dims: int = 1) -> P:
        """(L..., B, Di, N) SSM state: Di over model, batch over data."""
        return P(*[None] * stacked_dims, self._batch_entry(batch),
                 self.model_axis, None)

    def conv_state_spec(self, batch: int, stacked_dims: int = 1) -> P:
        """(L..., B, K-1, Di): Di over model."""
        return P(*[None] * stacked_dims, self._batch_entry(batch), None,
                 self.model_axis)


def sharded(fn, out_shardings, mesh):
    """``fn`` as a step over DTensors: the twin of the reference's
    ``jax.jit(fn, in_shardings, out_shardings)``.

    The step takes DTensors (plain tensors and other values pass as they
    are), runs ``fn`` on their local tensors -- on a mesh of one each is
    the whole tensor, in any placement; on a larger one ``fn`` computes
    on this rank's shards and holds the collectives itself
    (``distributed.collectives``) -- and wraps every output tensor as a
    DTensor in its placements of ``out_shardings`` (a tree of
    ``Sharding`` with the outputs' paths), without a copy.  ``step.local``
    is ``fn``.
    """
    def step(*args):
        out = fn(*map_with_path(lambda _path, x: local(x), args))

        def wrap(path, t):
            sh = at(out_shardings, path)
            return DTensor.from_local(t, sh.mesh, sh.placements,
                                      run_check=False)
        return map_with_path(wrap, out)
    step.local = fn
    return step
