"""Parameter tree <-> bytes, with a mesh-independent manifest.

Port of the JAX reference's ``repro/checkpoint/serializer.py``, in the
same format: each leaf serializes to its raw little-endian bytes (bf16
as its 16-bit patterns) plus a manifest record (path joined by ``/``,
dtype name, global shape).  The blobs and records equal the reference's
for the same weights, so either package restores the other's
checkpoints.  One field differs on purpose: the manifest's ``"treedef"``
is a JAX repr the port cannot produce, so the port writes its own
string there; both packages restore by leaf path only and never read it.

A DTensor leaf serializes as its whole tensor, so the format never holds
the mesh: a checkpoint written on one mesh restores onto any other
(``deserialize(shardings=)``, the elastic restore).
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import distribute
from repro_torch.tree import at, flatten_with_path, map_with_path

_SEP = "/"
TREEDEF = "repro_torch: nested dict, leaves by path"


def _path_str(path) -> str:
    return _SEP.join(str(k) for k in path)


def _leaf_record(leaf) -> tuple[str, list[int], bytes]:
    """(dtype name, shape, raw bytes) of a tensor, a DTensor (its whole
    tensor) or a host array."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), \
                t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def serialize(tree) -> tuple[str, dict[str, bytes]]:
    """Returns (manifest_json, {leaf_path: raw_bytes})."""
    records = []
    blobs: dict[str, bytes] = {}
    for path, leaf in flatten_with_path(tree):
        name = _path_str(path)
        dtype, shape, payload = _leaf_record(leaf)
        records.append({"path": name, "dtype": dtype, "shape": shape})
        blobs[name] = payload
    return json.dumps({"treedef": TREEDEF, "leaves": records}), blobs


def _from_record(rec: dict, raw: bytes) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(rec["shape"]).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, np.dtype(rec["dtype"])).reshape(rec["shape"])
    return torch.from_numpy(arr.copy())


def deserialize(manifest_json: str, blobs: dict[str, bytes], like,
                shardings=None):
    """Rebuild a tree with the structure of ``like``.

    ``like``: a tree of tensors (or anything) giving the structure.
    ``shardings``: None, or a tree of ``Sharding`` with ``like``'s paths:
    each leaf then goes straight from its bytes onto its mesh and
    placements, as a DTensor, one leaf at a time (the elastic restore
    path).  Without it each leaf is restored onto the device of its
    ``like`` leaf when that is a tensor, else onto the CPU (the manifest
    holds no device or mesh).
    """
    records = {r["path"]: r for r in json.loads(manifest_json)["leaves"]}

    def leaf(path, ref):
        name = _path_str(path)
        t = _from_record(records[name], blobs[name])
        if shardings is not None:
            return distribute(t, at(shardings, path))
        return t.to(ref.device) if torch.is_tensor(ref) else t
    return map_with_path(leaf, like)
