"""SEARS-backed checkpoint manager -- the paper's system as the storage
substrate of a model's weights.

Port of the JAX reference's ``repro/checkpoint/manager.py`` over the
port's ``SEARSStore``.  Per save, every leaf of the tree becomes one
SEARS file ``ckpt/<run>/<step:08d>/<leaf-path>``, so the store gives:

* **dedup across steps** -- unchanged leaves, and unchanged spans inside
  changed ones (content-defined chunking), are stored once;
* **(n,k) erasure-coded pieces** -- any n-k storage nodes of a cluster
  can die between save and restore with no data loss;
* **k-of-n restore reads**, with ULB binding keeping one cluster per run;
* **elastic restore** -- the manifest holds global shapes only, so a
  checkpoint written on one mesh restores onto any other
  (``restore(shardings=)``).

``save_async`` copies the tree to the host now and serializes and
uploads it on a background thread.
"""

from __future__ import annotations

import threading

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import serializer
from repro_torch.core.store import SEARSStore
from repro_torch.tree import flatten_with_path, tree_map


class CheckpointError(RuntimeError):
    pass


def _host_copy(leaf):
    """A tensor's (a DTensor's whole tensor's) copy on the host."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return leaf


class SEARSCheckpointManager:
    def __init__(self, store: SEARSStore | None = None, run: str = "run0",
                 user: str = "trainer", keep_last: int = 3, **store_kw):
        store_kw.setdefault("binding", "ulb")  # fast-restart read path
        store_kw.setdefault("num_clusters", 4)
        self.store = store or SEARSStore(**store_kw)
        self.run = run
        self.user = user
        self.keep_last = keep_last
        self._steps: list[int] = []
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _fname(self, step: int, leaf: str) -> str:
        return f"ckpt/{self.run}/{step:08d}/{leaf}"

    def _manifest_name(self, step: int) -> str:
        return self._fname(step, "MANIFEST.json")

    def save(self, step: int, tree, timestamp: float = 0.0) -> dict:
        """Synchronous save. Returns upload stats summary."""
        manifest, blobs = serializer.serialize(tree)
        with self._lock:
            total_up = 0
            total_bytes = 0
            for name, blob in blobs.items():
                st = self.store.put_file(self.user, self._fname(step, name),
                                         blob, timestamp=timestamp)
                total_up += st.bytes_uploaded
                total_bytes += st.file_bytes
            self.store.put_file(self.user, self._manifest_name(step),
                                manifest.encode(), timestamp=timestamp)
            self._steps.append(step)
            self._gc()
        return {"step": step, "bytes": total_bytes,
                "bytes_after_dedup": total_up,
                "dedup_saving": 1.0 - total_up / max(1, total_bytes)}

    def save_async(self, step: int, tree, timestamp: float = 0.0):
        """Device->host copy now; chunk/hash/encode/upload in background."""
        host_tree = tree_map(_host_copy, tree)
        self.wait()
        t = threading.Thread(target=self.save,
                             args=(step, host_tree, timestamp), daemon=True)
        t.start()
        self._pending = t

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        while len(self._steps) > self.keep_last:
            old = self._steps.pop(0)
            for fname in list(self.store.switching[self.user].table):
                if fname.startswith(f"ckpt/{self.run}/{old:08d}/"):
                    self.store.delete_file(self.user, fname)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(self._steps)

    def latest_step(self) -> int | None:
        return max(self._steps) if self._steps else None

    def restore(self, like, step: int | None = None, shardings=None):
        """Restore the checkpoint at ``step`` (default: latest complete).

        ``like``: tree of tensors giving the structure; each leaf comes
        back on its ``like`` leaf's device.  ``shardings``: optional tree
        of ``Sharding`` -- each leaf goes straight onto its mesh and
        placements instead (elastic restore).
        Raises CheckpointError if more than n-k pieces of any chunk are
        gone.
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise CheckpointError("no checkpoints saved")
        with self._lock:
            try:
                manifest_blob, _ = self.store.get_file(
                    self.user, self._manifest_name(step))
            except ValueError as e:  # < k pieces survive
                raise CheckpointError(
                    f"checkpoint manifest unrecoverable: {e}") from e
            blobs: dict[str, bytes] = {}
            restore_stats = []
            for path, _leaf in flatten_with_path(like):
                name = serializer._path_str(path)
                try:
                    blob, st = self.store.get_file(
                        self.user, self._fname(step, name))
                except ValueError as e:  # < k pieces survive
                    raise CheckpointError(
                        f"checkpoint leaf {name} unrecoverable: {e}") from e
                blobs[name] = blob
                restore_stats.append(st)
        tree = serializer.deserialize(manifest_blob.decode(), blobs, like,
                                      shardings=shardings)
        self.last_restore_time = sum(s.time_s for s in restore_stats)
        return tree
