"""Systematic (n,k) Reed-Solomon erasure codes over GF(2^8).

Construction: G = [I_k ; P] with P an (n-k, k) Cauchy matrix
``P[i,j] = 1/(x_i + y_j)`` (x,y disjoint element sets), so every k-row
subset of G is invertible (MDS property).  The first k code pieces are the
data itself -- the paper's fast path where, if the k systematic pieces are
the first to arrive, reconstruction is a memcpy.

Encode/decode of batches is delegated to ``repro_torch.kernels.ops`` (the
CUDA GF(256) kernel, or its plain torch version for CPU tensors); this
module provides the host-side numpy path used by the storage simulator
plus the matrix machinery shared by both.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import gf256


@functools.lru_cache(maxsize=None)
def generator_matrix(n: int, k: int) -> np.ndarray:
    """Systematic MDS generator matrix, shape (n, k), dtype int32."""
    if not (0 < k <= n <= gf256.FIELD // 2):
        raise ValueError(f"need 0 < k <= n <= 128, got (n,k)=({n},{k})")
    ident = np.eye(k, dtype=np.int32)
    if n == k:
        return ident
    x = np.arange(k, n, dtype=np.int32)  # n-k values: k .. n-1
    y = np.arange(k, dtype=np.int32)  # k values: 0 .. k-1  (disjoint from x)
    denom = x[:, None] ^ y[None, :]  # GF addition is XOR
    P = gf256.gf_inv(denom)
    return np.concatenate([ident, P], axis=0)


@functools.lru_cache(maxsize=None)
def decode_matrix(n: int, k: int, indices: tuple[int, ...]) -> np.ndarray:
    """Inverse of the k rows of G selected by ``indices`` (k,k) int32."""
    if len(indices) != k:
        raise ValueError(f"need exactly k={k} piece indices, got {len(indices)}")
    G = generator_matrix(n, k)
    sub = G[np.asarray(indices, dtype=np.int64)]
    return gf256.gf_mat_inv(sub)


# -- batch packing helpers (shared by the numpy path and the CUDA
# -- bucketed dispatch in ``repro_torch.kernels.ops``) -------------------
def padded_piece_len(piece_len: int, quantum: int) -> int:
    """Round a piece length up to the bucketing quantum (e.g. TILE_L)."""
    return -(-piece_len // quantum) * quantum


def bucket_by_piece_len(piece_lens: list[int], quantum: int
                        ) -> dict[int, list[int]]:
    """Group blob indices into buckets keyed by padded piece length.

    GF(256) coding is independent per byte column, so blobs whose piece
    lengths round to the same quantum can share one (B, k, Lp) launch:
    the zero columns past each blob's true L encode/decode to zeros and
    are sliced away, leaving bytes identical to an unpadded call.
    """
    buckets: dict[int, list[int]] = {}
    for i, L in enumerate(piece_lens):
        buckets.setdefault(padded_piece_len(L, quantum), []).append(i)
    return buckets


def pack_blob(blob: bytes, k: int, piece_len: int,
              padded_len: int | None = None) -> np.ndarray:
    """Lay a blob out as (k, Lp) uint8 rows, zero-padded past ``piece_len``.

    Row r holds blob bytes [r*L : (r+1)*L] in columns [:L] -- the exact
    layout of ``RSCode.encode_bytes`` -- so column-sliced results match
    the unpadded encoding byte for byte.
    """
    L = piece_len
    Lp = L if padded_len is None else padded_len
    if Lp < L:
        raise ValueError(f"padded_len {Lp} < piece_len {L}")
    buf = np.zeros(k * L, dtype=np.uint8)
    buf[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    out = np.zeros((k, Lp), dtype=np.uint8)
    out[:, :L] = buf.reshape(k, L)
    return out


def pack_pieces(pieces: dict[int, bytes], indices: tuple[int, ...],
                piece_len: int, padded_len: int | None = None) -> np.ndarray:
    """Stack received pieces (in ``indices`` order) as (k, Lp) uint8."""
    L = piece_len
    Lp = L if padded_len is None else padded_len
    rows = []
    for i in indices:
        p = np.frombuffer(pieces[i], dtype=np.uint8)
        if p.shape[0] != L:
            raise ValueError(
                f"piece shape mismatch: {p.shape[0]} != {L}")
        rows.append(p)
    out = np.zeros((len(indices), Lp), dtype=np.uint8)
    out[:, :L] = np.stack(rows)
    return out


def _gf_matmul_batched_np(M: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(r,k) GF matrix applied to (..., k, L) uint8 -> (..., r, L) uint8."""
    data = np.asarray(data, dtype=np.int32)
    r, k = M.shape
    out = np.zeros(data.shape[:-2] + (r, data.shape[-1]), dtype=np.int32)
    for j in range(k):
        out ^= gf256.gf_mul(M[:, j].reshape((1,) * (data.ndim - 2) + (r, 1)),
                            data[..., j : j + 1, :])
    return out.astype(np.uint8)


def _to_host(x) -> np.ndarray:
    """Host numpy view of an ``apply_fn`` result (tensor or array).

    ``np.asarray`` raises on a CUDA tensor, so a torch result is copied
    to the host here -- the only device sync of the batch drivers, and it
    happens on the finish side only.
    """
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)


# -- generic bucketed batch drivers (one implementation; the numpy
# -- RSCode methods and the CUDA dispatch in kernels/ops.py both
# -- delegate here, differing only in apply_fn / quantum / pad_batch) --
def batch_encode_blobs(code: "RSCode", blobs: list[bytes], apply_fn,
                       quantum: int = 1,
                       pad_batch=lambda b: b) -> list[list[bytes]]:
    """Encode blobs -> n pieces each, one ``apply_fn`` call per bucket.

    ``apply_fn(M, arr)`` applies a GF(256) matrix to (B, k, Lp) uint8 and
    returns (B, r, Lp); ``pad_batch`` rounds the batch axis up (e.g. to a
    power of two to bound compiled kernel shapes).
    """
    piece_lens = [code.piece_len(len(b)) for b in blobs]
    out: list[list[bytes] | None] = [None] * len(blobs)
    G = generator_matrix(code.n, code.k)
    for Lp, idxs in bucket_by_piece_len(piece_lens, quantum).items():
        arr = np.zeros((pad_batch(len(idxs)), code.k, Lp), dtype=np.uint8)
        for row, i in enumerate(idxs):
            arr[row] = pack_blob(blobs[i], code.k, piece_lens[i], Lp)
        enc = _to_host(apply_fn(G, arr))  # (Bp, n, Lp)
        for row, i in enumerate(idxs):
            L = piece_lens[i]
            out[i] = [enc[row, j, :L].tobytes() for j in range(code.n)]
    return out  # type: ignore[return-value]


def batch_decode_blobs_begin(code: "RSCode",
                             jobs: list[tuple[dict[int, bytes], int]],
                             apply_fn, quantum: int = 1,
                             pad_batch=lambda b: b):
    """Issue the decode batches for (piece_map, nbytes) jobs, unmaterialized.

    Does everything ``batch_decode_blobs`` does up to -- and including --
    dispatching one ``apply_fn`` call per (index set, padded length)
    bucket, but does *not* materialize the results: with a device
    ``apply_fn`` the returned state holds in-flight CUDA tensors (the
    kernels run asynchronously on the stream), so the caller can overlap
    host work with the GF decode.  Systematic arrivals are reassembled host-side immediately
    (the paper's memcpy fast path needs no launch).  Validation errors
    (too few pieces, shape mismatch) raise here, never at finish.
    """
    out: list[bytes | None] = [None] * len(jobs)
    piece_lens: list[int] = []
    nbytes_list: list[int] = []
    buckets: dict[tuple[tuple[int, ...], int], list[int]] = {}
    systematic = tuple(range(code.k))
    for i, (pieces, nbytes) in enumerate(jobs):
        if len(pieces) < code.k:
            raise ValueError(
                f"need >= k={code.k} pieces to decode, got {len(pieces)}")
        idx = tuple(sorted(pieces)[: code.k])
        L = code.piece_len(nbytes)
        piece_lens.append(L)
        nbytes_list.append(nbytes)
        if idx == systematic:
            if any(len(pieces[j]) != L for j in idx):
                raise ValueError(f"piece shape mismatch: want piece_len {L}")
            out[i] = b"".join(pieces[j] for j in idx)[:nbytes]
            continue
        buckets.setdefault((idx, padded_piece_len(L, quantum)), []).append(i)
    launched = []
    for (idx, Lp), idxs in buckets.items():
        arr = np.zeros((pad_batch(len(idxs)), code.k, Lp), dtype=np.uint8)
        for row, i in enumerate(idxs):
            arr[row] = pack_pieces(jobs[i][0], idx, piece_lens[i], Lp)
        M = decode_matrix(code.n, code.k, idx)
        launched.append((apply_fn(M, arr), idxs))  # (Bp, k, Lp) in flight
    return out, launched, piece_lens, nbytes_list


def batch_decode_blobs_finish(state) -> list[bytes]:
    """Materialize a ``batch_decode_blobs_begin`` state -> decoded blobs."""
    out, launched, piece_lens, nbytes_list = state
    for dec, idxs in launched:
        dec = _to_host(dec)  # blocks on the in-flight launch
        for row, i in enumerate(idxs):
            L, nbytes = piece_lens[i], nbytes_list[i]
            out[i] = dec[row, :, :L].reshape(-1)[:nbytes].tobytes()
    return out  # type: ignore[return-value]


def batch_decode_blobs(code: "RSCode",
                       jobs: list[tuple[dict[int, bytes], int]], apply_fn,
                       quantum: int = 1,
                       pad_batch=lambda b: b) -> list[bytes]:
    """Decode (piece_map, nbytes) jobs, bucketed by (index set, length).

    Each bucket shares one decode matrix and one ``apply_fn`` call;
    systematic arrivals -- the k data pieces came first -- are
    reassembled host-side (the paper's memcpy fast path).
    """
    return batch_decode_blobs_finish(batch_decode_blobs_begin(
        code, jobs, apply_fn, quantum=quantum, pad_batch=pad_batch))


@dataclasses.dataclass(frozen=True)
class RSCode:
    """(n,k) systematic Reed-Solomon codec."""

    n: int
    k: int

    def __post_init__(self):
        generator_matrix(self.n, self.k)  # validate early

    # -- array API (numpy host path) ------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """(..., k, L) uint8 data pieces -> (..., n, L) uint8 code pieces."""
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[-2] != self.k:
            raise ValueError(f"expected k={self.k} data pieces, got {data.shape}")
        return _gf_matmul_batched_np(generator_matrix(self.n, self.k), data)

    def decode(self, pieces: np.ndarray, indices) -> np.ndarray:
        """Reconstruct (..., k, L) data from any k pieces.

        ``pieces``: (..., k, L) uint8 -- the k received pieces, in the order
        given by ``indices`` (each in [0, n)).
        """
        indices = tuple(int(i) for i in indices)
        pieces = np.asarray(pieces, dtype=np.uint8)
        if sorted(indices) == list(range(self.k)):
            # systematic fast path: the data pieces themselves arrived
            order = np.argsort(np.asarray(indices))
            return np.take(pieces, order, axis=-2)
        M = decode_matrix(self.n, self.k, indices)
        return _gf_matmul_batched_np(M, pieces)

    # -- bytes API (storage path) ----------------------------------------
    def piece_len(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.k))

    def encode_bytes(self, blob: bytes) -> list[bytes]:
        """Split a blob into k pieces (zero-padded) and encode to n pieces."""
        L = self.piece_len(len(blob))
        buf = np.zeros(self.k * L, dtype=np.uint8)
        buf[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        pieces = self.encode(buf.reshape(self.k, L))
        return [pieces[i].tobytes() for i in range(self.n)]

    def decode_bytes(self, pieces: dict[int, bytes], nbytes: int) -> bytes:
        """Reconstruct the original blob from any k of the n pieces.

        ``pieces`` maps piece index -> piece bytes; ``nbytes`` is the
        original blob length (stored in chunk metadata).
        """
        if len(pieces) < self.k:
            raise ValueError(
                f"need >= k={self.k} pieces to decode, got {len(pieces)}")
        idx = sorted(pieces)[: self.k]
        L = self.piece_len(nbytes)
        stack = np.stack(
            [np.frombuffer(pieces[i], dtype=np.uint8) for i in idx])
        if stack.shape != (self.k, L):
            raise ValueError(f"piece shape mismatch: {stack.shape} != {(self.k, L)}")
        data = self.decode(stack, idx)
        return data.reshape(-1)[:nbytes].tobytes()

    # -- batch bytes API (numpy; bucketed by piece length) ----------------
    def encode_blobs(self, blobs: list[bytes], quantum: int = 1
                     ) -> list[list[bytes]]:
        """Batched ``encode_bytes``: one matmul per piece-length bucket."""
        return batch_encode_blobs(self, blobs, _gf_matmul_batched_np,
                                  quantum=quantum)

    def decode_blobs(self, jobs: list[tuple[dict[int, bytes], int]],
                     quantum: int = 1) -> list[bytes]:
        """Batched ``decode_bytes``: jobs are (piece_map, nbytes) pairs."""
        return batch_decode_blobs(self, jobs, _gf_matmul_batched_np,
                                  quantum=quantum)

    @property
    def storage_overhead(self) -> float:
        """Space expansion factor n/k of the code."""
        return self.n / self.k
