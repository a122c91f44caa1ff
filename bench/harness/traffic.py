"""The one traffic generator: every mix file is a set of its parameters.

Frozen, vectorised copy of the content model of ``core/workload.py``
(the paper's section IV dataset), so that a change to the program cannot
change the traffic:

* ``_BlockPool`` / ``_mixed_bytes``: a file is a run of ``block``-byte
  blocks; each is, with probability ``shared_fraction``, a block drawn
  uniformly from a pool of ``pool_blocks`` shared blocks, else fresh
  private bytes;
* the backup-image churn of ``generate_events``: a file's next
  generation is its previous one with ``max(1, size * churn // spot)``
  spots of ``spot`` bytes rewritten in place, each at an offset drawn in
  ``[0, size - spot)``.  The original seeded each image with
  ``hash(user) % 1000``, which Python salts per process; here every draw
  comes from a stable digest of ``--seed``, and the pool and generation
  0 from one of a constant.

Structure (which blocks are shared, pool indices, spot offsets) is drawn
with NumPy; the random bytes come from a ``torch.Generator`` on the
run's device in large calls, and a round of new files is assembled
there in one pass, so set-up stays short.  The same seed on the same
device gives the same bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

SLAB = 64 << 20  # bytes drawn per generator call


def derive(seed: int, purpose: str) -> int:
    """A 62-bit seed for one purpose, stable across processes."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 2


@dataclasses.dataclass(frozen=True)
class Content:
    """A mix's content parameters (the keys of its ``content`` object)."""

    users: int
    files_per_user: int
    file_bytes: int
    block: int = 16 << 10
    shared_fraction: float = 0.0
    pool_blocks: int = 0
    churn: float | None = None  # None: every round's files are new
    spot: int = 4096

    @classmethod
    def from_mix(cls, mix: dict) -> "Content":
        return cls(**mix["content"])


class Generator:
    """Round after round of (user, filename, bytes) for one mix and seed.

    Without ``churn`` a round's files are new (mixed private and pooled
    blocks); with it, round 0 is each file's generation 0 and round r its
    generation r.  Rounds must be asked for in order.
    """

    def __init__(self, content: Content, seed: int, device) -> None:
        import torch
        self.c = content
        self.rng = np.random.default_rng(derive(seed, "structure"))
        self._torch = torch
        self._device = device
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(derive(seed, "bytes"))
        # The shared pool and the backups' generation 0 are one corpus for
        # every seed: how well a pooled block dedups, and how an image
        # chunks, depend on where its content fires cuts, and over 256
        # blocks or 10 images that moves the space a window costs by a
        # percent or more from seed to seed.  The seed draws the rest:
        # which pooled blocks go where, the private bytes, the edits.
        self._corpus = torch.Generator(device=device)
        self._corpus.manual_seed(derive(0, "corpus"))
        self.pool = self.random(content.pool_blocks * content.block,
                                self._corpus) \
            .reshape(content.pool_blocks, content.block)
        self._pool_dev = torch.from_numpy(self.pool).to(device)
        self._images: list[np.ndarray] = []
        self._next = 0

    def random(self, nbytes: int, gen=None) -> np.ndarray:
        """``nbytes`` fresh random bytes (uint8) on the host."""
        out = np.empty(nbytes, dtype=np.uint8)
        for s in range(0, nbytes, SLAB):
            n = min(SLAB, nbytes - s)
            t = self._torch.randint(0, 256, (n,), dtype=self._torch.uint8,
                                    generator=gen or self._gen,
                                    device=self._device)
            out[s:s + n] = t.cpu().numpy()
        return out

    def users(self) -> list[str]:
        return [f"user{u:03d}" for u in range(self.c.users)]

    def pool_file(self) -> bytes:
        """Every pooled block once, in order: what set-up stores."""
        return self.pool.tobytes()

    def _mixed(self, count: int, gen=None) -> list[np.ndarray]:
        """``count`` new files, assembled on the device in one pass."""
        torch, c = self._torch, self.c
        nblk = -(-c.file_bytes // c.block)
        shared = self.rng.random((count, nblk)) < c.shared_fraction \
            if c.pool_blocks else np.zeros((count, nblk), dtype=bool)
        pick = self.rng.integers(0, max(1, c.pool_blocks), (count, nblk))
        files = torch.randint(0, 256, (count, nblk, c.block),
                              dtype=torch.uint8, generator=gen or self._gen,
                              device=self._device)
        if shared.any():
            mask = torch.from_numpy(shared).to(self._device)
            rows = torch.from_numpy(pick[shared]).to(self._device)
            files[mask] = self._pool_dev[rows]
        flat = files.reshape(count, nblk * c.block)[:, :c.file_bytes]
        return list(flat.cpu().numpy())

    def _churned(self, img: np.ndarray) -> np.ndarray:
        c = self.c
        out = img.copy()
        spots = max(1, int(len(img) * c.churn) // c.spot)
        offs = self.rng.integers(0, max(1, len(img) - c.spot), spots)
        fresh = self.random(spots * c.spot).reshape(spots, c.spot)
        for off, b in zip(offs, fresh):
            out[off:off + c.spot] = b
        return out

    def round(self) -> list[tuple[str, str, bytes]]:
        """The next round: (user, filename, data) of every file."""
        c, r = self.c, self._next
        self._next += 1
        count = c.users * c.files_per_user
        if c.churn is None:
            arrays = self._mixed(count)
        elif r == 0:
            arrays = self._images = self._mixed(count, self._corpus)
        else:
            self._images = [self._churned(img) for img in self._images]
            arrays = self._images
        out = []
        for i, arr in enumerate(arrays):
            u, f = divmod(i, c.files_per_user)
            out.append((f"user{u:03d}", f"r{r:04d}/f{f:02d}", arr.tobytes()))
        return out
