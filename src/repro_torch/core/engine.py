"""Data-plane coding engines: the hash / RS-encode / RS-decode seam.

The store splits into a *control plane* (chunking, dedup lookups, binding,
placement -- per-chunk metadata work, ``repro_torch.core.pipeline``) and a
*data plane* (bulk byte work over batches of chunks).  ``CodingEngine`` is
that data plane's interface; two implementations:

* ``NumpyEngine`` -- the original per-chunk host path (``hashlib`` SHA-1,
  one GF(256) matmul per chunk).  Reference semantics.
* ``TorchEngine`` -- batches chunks into (B, k, L) uint8 tensors (length
  buckets padded to the GF kernel's TILE_L, batch padded to a power of
  two) and dispatches through ``repro_torch.kernels.ops``: the GF(256)
  CUDA kernel for encode/decode, the gear-CDC fire kernel for chunking
  and the SHA-1 kernel for chunk ids.  It runs on the CUDA device unless
  the caller passes ``device="cpu"``, which runs each kernel's plain
  torch version -- same batching, same bytes.
* ``TorchFusedEngine`` -- ``TorchEngine`` plus the fused ingest: a put
  window's SHA-1 ids and RS encode run as one launch per piece-length
  bucket (``kernels/csrc/fused_ingest.cu``).

All engines produce identical bytes, so every store-level artifact --
piece placement, dedup ratio, ``StoreStats`` -- is engine-invariant.
"""

from __future__ import annotations

import abc

from repro_torch.core import chunking, hashing
from repro_torch.core.chunking import Chunker
from repro_torch.core.rs_code import RSCode


class CodingEngine(abc.ABC):
    """Bulk chunk/hash/encode/decode over batches of files (the data plane)."""

    name: str = "base"

    @abc.abstractmethod
    def chunk_blobs(self, chunker: Chunker,
                    blobs: list[bytes]) -> list[list[tuple[int, int]]]:
        """CDC spans for a batch of files: one rolling-hash pass per window.

        Returns per-blob ``[(offset, length), ...]`` lists, byte-identical
        to ``chunker.chunk_spans`` on each blob individually.
        """

    @abc.abstractmethod
    def hash_chunks(self, chunks: list[bytes]) -> list[bytes]:
        """Chunk ids (20-byte SHA-1 by default) for a batch of chunks."""

    @abc.abstractmethod
    def encode_blobs(self, code: RSCode,
                     blobs: list[bytes]) -> list[list[bytes]]:
        """RS-encode each blob into n pieces."""

    @abc.abstractmethod
    def decode_blobs(self, code: RSCode,
                     jobs: list[tuple[dict[int, bytes], int]]
                     ) -> list[bytes]:
        """Reconstruct each blob from (piece_map, nbytes) jobs."""

    def recode_blobs(self, code: RSCode,
                     jobs: list[tuple[dict[int, bytes], int]]
                     ) -> tuple[list[bytes], list[list[bytes]]]:
        """Repair path: decode (piece_map, nbytes) jobs, re-encode to n.

        One decode batch plus one encode batch, so a repair sub-batch
        costs O(length buckets) launches regardless of how many chunks --
        across how many clusters -- it carries.  Returns ``(blobs,
        pieces_per_blob)``; shared by both engines through their batched
        ``decode_blobs``/``encode_blobs``.
        """
        blobs = self.decode_blobs(code, jobs)
        return blobs, self.encode_blobs(code, blobs)

    # -- heterogeneous batches: one window, many storage-class policies ----
    # A mixed-class flush window carries work under several (n, k) codes
    # and several chunker configs at once.  The *_multi entry points keep
    # the window's launch economics: they group by policy and issue one
    # batched call per group, so a window costs O(code buckets x length
    # buckets) GF launches and O(chunker configs) gear launches -- never
    # O(files) or O(chunks).  Results come back in input order.

    def _by_policy(self, jobs: list[tuple], batch_fn) -> list:
        """Group (policy, *job) tuples by policy, run one batched call per
        group, and scatter results back into input order.  ``batch_fn``
        receives the policy and that group's job payloads (the tuple
        remainders, unwrapped when they are single values)."""
        groups: dict = {}
        for i, job in enumerate(jobs):
            groups.setdefault(job[0], []).append(i)
        out: list = [None] * len(jobs)
        for policy, idxs in groups.items():
            payload = [jobs[i][1] if len(jobs[i]) == 2 else jobs[i][1:]
                       for i in idxs]
            for i, res in zip(idxs, batch_fn(policy, payload)):
                out[i] = res
        return out

    def chunk_blobs_multi(self, jobs: list[tuple[Chunker, bytes]]
                          ) -> list[list[tuple[int, int]]]:
        """CDC spans for (chunker, blob) jobs: one gear pass per chunker."""
        return self._by_policy(jobs, self.chunk_blobs)

    def encode_blobs_multi(self, jobs: list[tuple[RSCode, bytes]]
                           ) -> list[list[bytes]]:
        """RS-encode (code, blob) jobs: one encode batch per distinct code."""
        return self._by_policy(jobs, self.encode_blobs)

    def decode_blobs_multi(self,
                           jobs: list[tuple[RSCode, dict[int, bytes], int]]
                           ) -> list[bytes]:
        """Decode (code, piece_map, nbytes) jobs, one batch per code."""
        return self._by_policy(jobs, self.decode_blobs)

    def recode_blobs_multi(self,
                           jobs: list[tuple[RSCode, dict[int, bytes], int]]
                           ) -> tuple[list[bytes], list[list[bytes]]]:
        """Repair recode of (code, piece_map, nbytes) jobs across codes.

        One decode + one encode batch per distinct code, so a cross-class
        repair sub-batch stays O(code buckets x length buckets) launches.
        """
        paired = self._by_policy(
            jobs, lambda code, group: list(zip(*self.recode_blobs(
                code, group))))
        blobs = [b for b, _ in paired]
        pieces = [p for _, p in paired]
        return blobs, pieces

    # -- fused ingest seam -------------------------------------------------
    # ``supports_fused_ingest`` advertises a hash+encode path that keeps
    # each chunk resident on the device for both passes (one launch per
    # bucket instead of separate SHA-1 and GF dispatches).  The staged
    # default below is the semantic contract the fused override must
    # match byte-for-byte (differential-tested in tests/test_ingest.py).

    supports_fused_ingest: bool = False

    def hash_encode_blobs_multi(self, jobs: list[tuple[RSCode, bytes]]
                                ) -> tuple[list[bytes], list[list[bytes]]]:
        """Chunk ids + RS pieces for (code, blob) jobs, input order.

        Staged reference semantics: hash everything, then encode
        everything.  ``TorchFusedEngine`` overrides this with the fused
        one-launch-per-bucket path.
        """
        ids = self.hash_chunks([blob for _, blob in jobs])
        return ids, self.encode_blobs_multi(jobs)

    # -- begin/finish splits: the double-buffering seam --------------------
    # ``*_begin`` issues a window's device work (or defers host work) and
    # returns an opaque token; ``*_finish`` materializes results.  The
    # base defaults defer everything to finish time -- correct for any
    # engine -- so the pipelined store paths work unchanged on
    # ``NumpyEngine``; ``TorchEngine`` overrides them to genuinely issue
    # launches ahead (CUDA launches run asynchronously on the stream),
    # which is where the overlap comes from.

    def chunk_blobs_begin(self, chunker: Chunker, blobs: list[bytes]):
        """Stage a window's CDC pass; resolve with ``chunk_blobs_finish``."""
        return (chunker, blobs)

    def chunk_blobs_finish(self, pending) -> list[list[tuple[int, int]]]:
        return self.chunk_blobs(*pending)

    def chunk_blobs_multi_begin(self, jobs: list[tuple[Chunker, bytes]]):
        """Stage a mixed-chunker window; resolve with the finish twin."""
        return jobs

    def chunk_blobs_multi_finish(self, token) -> list[list[tuple[int, int]]]:
        return self.chunk_blobs_multi(token)

    def decode_blobs_multi_begin(
            self, jobs: list[tuple[RSCode, dict[int, bytes], int]]):
        """Stage a decode window; resolve with ``decode_blobs_multi_finish``."""
        return jobs

    def decode_blobs_multi_finish(self, token) -> list[bytes]:
        return self.decode_blobs_multi(token)

    def _by_policy_begin(self, jobs: list[tuple], begin_fn):
        """Begin-side half of ``_by_policy``: group by policy, issue one
        ``begin_fn(policy, payload)`` per group, keep the scatter plan."""
        groups: dict = {}
        for i, job in enumerate(jobs):
            groups.setdefault(job[0], []).append(i)
        started = []
        for policy, idxs in groups.items():
            payload = [jobs[i][1] if len(jobs[i]) == 2 else jobs[i][1:]
                       for i in idxs]
            started.append((idxs, begin_fn(policy, payload)))
        return (len(jobs), started)

    def _by_policy_finish(self, token, finish_fn) -> list:
        """Finish-side half: resolve each group and scatter to input order."""
        n, started = token
        out: list = [None] * n
        for idxs, pending in started:
            for i, res in zip(idxs, finish_fn(pending)):
                out[i] = res
        return out


class NumpyEngine(CodingEngine):
    """Per-chunk host path: hashlib + one numpy GF matmul per chunk."""

    name = "numpy"

    def __init__(self, hash_fn=hashing.chunk_id) -> None:
        self.hash_fn = hash_fn

    def chunk_blobs(self, chunker: Chunker,
                    blobs: list[bytes]) -> list[list[tuple[int, int]]]:
        # vectorized host path: one fused gear pass over the whole window
        return chunking.chunk_spans_batch(chunker, blobs,
                                          chunking.gear_candidates_np)

    def hash_chunks(self, chunks: list[bytes]) -> list[bytes]:
        return [self.hash_fn(c) for c in chunks]

    def encode_blobs(self, code: RSCode,
                     blobs: list[bytes]) -> list[list[bytes]]:
        return [code.encode_bytes(b) for b in blobs]

    def decode_blobs(self, code: RSCode, jobs) -> list[bytes]:
        return [code.decode_bytes(pieces, nbytes) for pieces, nbytes in jobs]


class TorchEngine(CodingEngine):
    """Batched device path: gear fire + length-bucketed GF + batched SHA-1.

    Mirrors the JAX reference's ``KernelEngine``.  ``device=None`` (the
    default) means the CUDA device and raises when CUDA is absent -- the
    engine never drifts to the host.  ``device="cpu"`` is the explicit
    host choice: every kernel wrapper then takes its plain torch version,
    which is what the CPU tests run.

    SHA-1 launches use a batch of at most ``hash_batch`` messages padded
    to ``max_hash_len`` bytes of message schedule, so the launch-shape set
    stays bounded.  Chunks longer than ``max_hash_len`` would grow that
    shape, so they hash on the host with ``hash_fn`` instead, as does a
    custom ``hash_fn`` (it has no kernel twin).
    """

    name = "kernel"

    HASH_BATCH = 512

    def __init__(self, hash_fn=hashing.chunk_id, device=None,
                 max_hash_len: int = 8192,
                 hash_batch: int | None = None) -> None:
        import torch
        if device is None:
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine runs on the CUDA device and CUDA is not "
                "available; pass device='cpu' for the plain torch path")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.hash_fn = hash_fn
        self.max_hash_len = max_hash_len
        self.hash_batch = hash_batch or self.HASH_BATCH

    def chunk_blobs_begin(self, chunker: Chunker, blobs: list[bytes]):
        """Issue the window's gear launch; the bitmap stays on device."""
        from repro_torch.kernels import ops
        return chunking.chunk_spans_batch_begin(
            chunker, blobs,
            lambda stream, mask: ops.gear_fire_issue(
                stream, mask, device=self.device))

    def chunk_blobs_finish(self, pending) -> list[list[tuple[int, int]]]:
        """Block on the fire bitmap; greedy selection on host."""
        from repro_torch.kernels import ops
        return chunking.chunk_spans_batch_finish(
            pending, ops.gear_fire_resolve)

    def chunk_blobs(self, chunker: Chunker,
                    blobs: list[bytes]) -> list[list[tuple[int, int]]]:
        """One device gear launch per window; greedy selection on host."""
        return self.chunk_blobs_finish(self.chunk_blobs_begin(chunker, blobs))

    def chunk_blobs_multi_begin(self, jobs: list[tuple[Chunker, bytes]]):
        """Issue one gear launch per distinct chunker, all in flight."""
        return self._by_policy_begin(jobs, self.chunk_blobs_begin)

    def chunk_blobs_multi_finish(self, token) -> list[list[tuple[int, int]]]:
        return self._by_policy_finish(token, self.chunk_blobs_finish)

    def decode_blobs_multi_begin(
            self, jobs: list[tuple[RSCode, dict[int, bytes], int]]):
        """Issue decode launches per code; outputs stay on the device."""
        from repro_torch.kernels import ops
        return self._by_policy_begin(
            jobs, lambda code, group: ops.rs_decode_blobs_begin(
                code, group, device=self.device))

    def decode_blobs_multi_finish(self, token) -> list[bytes]:
        from repro_torch.kernels import ops
        return self._by_policy_finish(token, ops.rs_decode_blobs_finish)

    def hash_chunks(self, chunks: list[bytes]) -> list[bytes]:
        if self.hash_fn is not hashing.chunk_id:
            # custom id functions have no kernel twin -- host path
            return [self.hash_fn(c) for c in chunks]
        from repro_torch.kernels import ops
        out: list[bytes | None] = [None] * len(chunks)
        batch: list[bytes] = []
        batch_pos: list[int] = []
        for i, c in enumerate(chunks):
            if len(c) > self.max_hash_len:
                # oversized chunk: padding it would grow the
                # (hash_batch, M, 16) launch shape -- hash on the host
                out[i] = self.hash_fn(c)
            else:
                batch.append(c)
                batch_pos.append(i)
        for i in range(0, len(batch), self.hash_batch):
            group = batch[i: i + self.hash_batch]
            # pad the batch axis to the next power of two (clamped to
            # hash_batch) so the launch-shape set stays bounded
            # ({1, 2, 4, ..., hash_batch} x bucketed block widths)
            target = min(1 << max(0, len(group) - 1).bit_length(),
                         self.hash_batch)
            pad = target - len(group)
            blocks, counts = hashing.sha1_pad_batch(
                group + [b""] * pad, max_len=self.max_hash_len)
            words = ops.sha1_digest_words(blocks, counts, device=self.device)
            digests = hashing.digest_words_to_bytes(ops.words_to_host(words))
            for pos, digest in zip(batch_pos[i: i + self.hash_batch],
                                   digests):
                out[pos] = digest
        return out  # type: ignore[return-value]

    def encode_blobs(self, code: RSCode,
                     blobs: list[bytes]) -> list[list[bytes]]:
        from repro_torch.kernels import ops
        return ops.rs_encode_blobs(code, blobs, device=self.device)

    def decode_blobs(self, code: RSCode, jobs) -> list[bytes]:
        from repro_torch.kernels import ops
        return ops.rs_decode_blobs(code, jobs, device=self.device)


class TorchFusedEngine(TorchEngine):
    """TorchEngine plus the fused ingest path.

    Mirrors the JAX reference's ``FusedEngine``.  It inherits every
    batched entry point; ``hash_encode_blobs_multi`` becomes the fused
    SHA-1 + GF-encode dispatch (``kernels.ops.fused_hash_encode_blobs``):
    each chunk goes to the device packed (B, k, L) once and one launch
    per piece-length bucket returns both its id and its pieces, so a put
    window costs 1 gear + O(piece-length buckets) launches instead of
    1 gear + SHA-1 batches + O(length buckets) GF.  Encoding is
    speculative -- every unique chunk of the window is encoded before the
    dedup lookup decides whether its pieces are needed.  The store takes
    the staged ``hash_chunks`` + ``encode_blobs_multi`` path when
    ``supports_fused_ingest`` is false (a custom ``hash_fn``), and under
    write-back, whose ack must not pay the encode.
    """

    name = "fused"

    @property
    def supports_fused_ingest(self) -> bool:  # type: ignore[override]
        # the fused kernel computes SHA-1; a custom id function has no
        # device twin, so the store must take the staged path
        return self.hash_fn is hashing.chunk_id

    def hash_encode_blobs_multi(self, jobs: list[tuple[RSCode, bytes]]
                                ) -> tuple[list[bytes], list[list[bytes]]]:
        if not self.supports_fused_ingest:
            return super().hash_encode_blobs_multi(jobs)
        from repro_torch.kernels import ops
        ids: list = [None] * len(jobs)
        pieces: list = [None] * len(jobs)
        # intra-window duplicates (same code, same bytes) cost one lane;
        # RSCode is a frozen dataclass, so value-equal codes coalesce
        rep: dict = {}
        for i, (code, blob) in enumerate(jobs):
            rep.setdefault((code, blob), i)
        groups: dict = {}
        for (code, _), i in rep.items():
            groups.setdefault(code, []).append(i)
        for code, idxs in groups.items():
            gids, gpieces = ops.fused_hash_encode_blobs(
                code, [jobs[i][1] for i in idxs], device=self.device)
            for i, cid, ps in zip(idxs, gids, gpieces):
                ids[i], pieces[i] = cid, ps
        for i, (code, blob) in enumerate(jobs):
            if ids[i] is None:
                j = rep[(code, blob)]
                ids[i], pieces[i] = ids[j], pieces[j]
        return ids, pieces


def make_engine(spec, hash_fn=hashing.chunk_id) -> CodingEngine:
    """Resolve an engine spec to a ``CodingEngine``.

    Accepted specs: a ``CodingEngine`` instance, ``'numpy'`` (per-chunk
    host path), ``'kernel'`` / ``'torch'`` (``TorchEngine``) or
    ``'fused'`` (``TorchFusedEngine``).  The last two run on the CUDA
    device and raise without CUDA.
    """
    if isinstance(spec, CodingEngine):
        return spec
    if spec == "numpy":
        return NumpyEngine(hash_fn)
    if spec in ("kernel", "torch"):
        return TorchEngine(hash_fn)
    if spec == "fused":
        return TorchFusedEngine(hash_fn)
    raise ValueError(f"unknown coding engine {spec!r}")
