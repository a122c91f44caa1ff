"""Public entry points of the port's kernels: the storage data plane's,
and ``flash_attention`` for the models.

Mirrors the JAX reference's ``repro.kernels.ops``, with ``device=`` in
place of ``impl=``: on a CUDA device every entry point launches the
hand-written CUDA kernel, and on ``device="cpu"`` it runs the kernel's
plain torch version -- same bucketing, same bytes.  Inputs arrive as
numpy arrays and are uploaded here; results stay on the device until a
``*_finish`` / ``*_resolve`` (or the batch drivers in ``core.rs_code``)
brings them to the host, which is the only place that syncs.

Launch economics are the reference's: ``LAUNCHES`` ticks once per
dispatch at the same places, the GF bucketing quantum is ``TILE_L`` and
batches pad to powers of two.  PyTorch traces nothing, so ``TRACES``
ticks once per newly seen (family, kind, device type, launch shape); a
second same-bucket call adds nothing, as a jit-cache hit adds nothing in
the reference.  The fixed tables are loaded per device with
``load_tables``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.kernels import (flash_attn, fused_ingest, gear_cdc,
                                 gf_matmul, sha1)
from repro_torch.kernels.launches import LAUNCHES, TRACES
from repro_torch.kernels.tables import load_tables  # noqa: F401 (public API)

_SEEN_SHAPES: set[tuple] = set()


def _new_shape(key: tuple) -> bool:
    """True the first time a (family, kind, device, shape) key is seen."""
    if key in _SEEN_SHAPES:
        return False
    _SEEN_SHAPES.add(key)
    return True


def _upload(arr: np.ndarray, device: torch.device,
            length: int | None = None) -> torch.Tensor:
    """Host array -> tensor on ``device`` (zero-padded to ``length`` rows)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if length is not None and length != arr.shape[0]:
        out = torch.zeros((length,) + tuple(arr.shape[1:]), dtype=t.dtype,
                          device=device)
        out[: arr.shape[0]].copy_(t)
        return out
    return t.to(device)


def words_to_host(words: torch.Tensor) -> np.ndarray:
    """(B, 5) int32 digest-word tensor -> host uint32 array (syncs)."""
    return words.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------- GF matmul
def rs_apply(M: np.ndarray, data, device="cuda") -> torch.Tensor:
    """Apply an (r,k) GF(256) coding matrix to (B, k, L) uint8 pieces.

    RS encode: M = generator_matrix(n, k)  -> (B, n, L) code pieces.
    RS decode: M = decode_matrix(n, k, received_idx) -> (B, k, L) data.
    Returns the result on ``device``, not synchronized.
    """
    LAUNCHES.gf += 1
    device = torch.device(device)
    if not torch.is_tensor(data):
        data = _upload(np.asarray(data, np.uint8), device)
    M = np.asarray(M)
    if _new_shape(("gf", device.type, M.shape, tuple(data.shape))):
        TRACES.gf += 1
    return gf_matmul.gf_matmul(M, data.to(device))


def rs_encode(code, data, device="cuda") -> torch.Tensor:
    """Batched RS encode: (B, k, L) -> (B, n, L) using ``RSCode`` params."""
    from repro_torch.core.rs_code import generator_matrix
    return rs_apply(generator_matrix(code.n, code.k), data, device=device)


def rs_decode(code, pieces, indices, device="cuda") -> torch.Tensor:
    """Batched RS decode: (B, k, L) received pieces (+ their indices)."""
    from repro_torch.core.rs_code import decode_matrix
    M = decode_matrix(code.n, code.k, tuple(int(i) for i in indices))
    return rs_apply(M, pieces, device=device)


# -------------------------------------------- bucketed blob dispatch ------
# Blobs are raw ``bytes``, each laid out (k, L) uint8 with L =
# code.piece_len(len(blob)) (``rs_code.pack_blob``), bucketed by L
# rounded up to TILE_L so one launch serves a whole bucket; the batch
# axis pads to the next power of two.  Zero pad columns / rows are exact
# under GF(256), so the sliced results equal per-blob host coding.

def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 1 else 1


def rs_encode_blobs(code, blobs: list[bytes],
                    device="cuda") -> list[list[bytes]]:
    """Batched RS encode of variable-length blobs -> n pieces per blob."""
    from repro_torch.core import rs_code
    return rs_code.batch_encode_blobs(
        code, blobs, lambda M, arr: rs_apply(M, arr, device=device),
        quantum=gf_matmul.TILE_L, pad_batch=_pow2)


def rs_decode_blobs(code, jobs: list[tuple[dict[int, bytes], int]],
                    device="cuda") -> list[bytes]:
    """Batched RS decode; jobs are (piece_map, original_nbytes) pairs.

    Jobs sharing a received-index set and padded length decode in one
    launch; systematic arrivals take the host-side memcpy fast path.
    """
    from repro_torch.core import rs_code
    return rs_code.batch_decode_blobs(
        code, jobs, lambda M, arr: rs_apply(M, arr, device=device),
        quantum=gf_matmul.TILE_L, pad_batch=_pow2)


def rs_decode_blobs_begin(code, jobs: list[tuple[dict[int, bytes], int]],
                          device="cuda"):
    """Issue the decode launches for a job batch without materializing.

    The returned state holds in-flight device outputs, so the caller can
    overlap host work with the decode; ``rs_decode_blobs_finish`` copies
    them to the host.  Nothing here syncs the device.
    """
    from repro_torch.core import rs_code
    return rs_code.batch_decode_blobs_begin(
        code, jobs, lambda M, arr: rs_apply(M, arr, device=device),
        quantum=gf_matmul.TILE_L, pad_batch=_pow2)


def rs_decode_blobs_finish(state) -> list[bytes]:
    """Copy the launches issued by ``rs_decode_blobs_begin`` -> blobs."""
    from repro_torch.core import rs_code
    return rs_code.batch_decode_blobs_finish(state)


# ------------------------------------------------------------------ gear ---
def _upload_stream(data: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a byte stream zero-padded to ``gear_cdc.bucket_len``."""
    return _upload(data, device, gear_cdc.bucket_len(data.shape[0]))


def gear_hash(data, device="cuda") -> torch.Tensor:
    """(N,) uint8 -> (N,) gear hashes as int32 bits, left on the device.

    The stream is zero-padded to ``gear_cdc.bucket_len`` so varying
    lengths reuse a bounded set of launch shapes.  Counted in
    ``LAUNCHES.gear``.
    """
    data = np.asarray(data, np.uint8)
    device = torch.device(device)
    n = data.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    LAUNCHES.gear += 1
    stream = _upload_stream(data, device)
    if _new_shape(("gear", "hash", device.type, stream.shape[0])):
        TRACES.gear += 1
    return gear_cdc.gear_hash(stream)[:n]


def gear_hash_stream(data, device="cuda") -> np.ndarray:
    """One gear launch over a whole ingest stream -> host (N,) uint32."""
    data = np.asarray(data, np.uint8)
    if data.shape[0] == 0:
        return np.zeros((0,), np.uint32)
    return gear_hash(data, device=device).cpu().numpy().view(np.uint32)


def gear_fire_issue(data, mask, device="cuda"):
    """Dispatch one fused gear hash + mask launch; the result stays on device.

    Returns the in-flight (N,) bool fire bitmap (``None`` for an empty
    stream), so the caller can do host work -- greedy selection of the
    previous window, plan building -- while the launch runs;
    ``gear_fire_resolve`` compacts it when it is needed.  Nothing here
    syncs the device.
    """
    data = np.asarray(data, np.uint8)
    device = torch.device(device)
    if data.shape[0] == 0:
        return None
    LAUNCHES.gear += 1
    stream = _upload_stream(data, device)
    if _new_shape(("gear", "fire", device.type, stream.shape[0])):
        TRACES.gear += 1
    return gear_cdc.gear_fire(stream, np.uint32(mask))[: data.shape[0]]


def gear_fire_resolve(fire) -> np.ndarray:
    """Compact an issued fire bitmap on its device -> sorted positions."""
    if fire is None:
        return np.zeros(0, np.int64)
    return torch.nonzero(fire).reshape(-1).cpu().numpy().astype(np.int64)


def gear_candidate_positions(data, mask, device="cuda") -> np.ndarray:
    """One gear launch over an ingest stream -> sorted candidate positions.

    The device twin of ``chunking.gear_candidates_np``: hash and mask test
    run fused on the device; the compaction runs there too and only the
    sparse positions come back.
    """
    return gear_fire_resolve(gear_fire_issue(data, mask, device=device))


# ------------------------------------------------------------------ sha1 ---
def sha1_digests(chunks: list[bytes], device="cuda") -> list[bytes]:
    """Batched SHA-1 of byte chunks -> 20-byte digests."""
    if not chunks:
        return []
    blocks, counts = hashing.sha1_pad_batch(chunks)
    words = sha1_digest_words(blocks, counts, device=device)
    return hashing.digest_words_to_bytes(words_to_host(words))


def sha1_digest_words(blocks, counts, device="cuda") -> torch.Tensor:
    """(B, M, 16) uint32 padded blocks + (B,) counts -> (B, 5) int32 bits."""
    LAUNCHES.sha1 += 1
    device = torch.device(device)
    blocks = np.ascontiguousarray(np.asarray(blocks, np.uint32))
    counts = np.asarray(counts, np.int32).reshape(-1)
    if _new_shape(("sha1", device.type, blocks.shape)):
        TRACES.sha1 += 1
    return sha1.sha1_digest_words(_upload(blocks.view(np.int32), device),
                                  _upload(counts, device))


# ----------------------------------------------------------- fused ingest --
# One launch per piece-length bucket computing SHA-1 chunk ids AND the RS
# code pieces of the same chunks: the packed (B, k, Lp) bytes go to the
# device once and the kernel pads each SHA-1 message itself, instead of
# the staged path's SHA-1 launch over host-padded blocks plus a GF launch.
# Counted in ``LAUNCHES.fused`` (neither .sha1 nor .gf ticks).

def _sha1_block_width(lens: list[int], max_len: int) -> int:
    """Block axis of ``hashing.sha1_pad_batch(group, max_len)`` for a
    bucket of messages of ``lens`` bytes padded with empty ones to ``Bp``:
    the power of two of the bucket's need, clamped to the cap.  The
    reference's jitted dispatch keys on it, so ``TRACES`` does too."""
    need = max([(n + 8) // 64 + 1 for n in lens] + [1])
    cap = (max_len + 9 + 63) // 64
    return min(1 << (need - 1).bit_length(), cap)


def fused_hash_encode_blobs(code, blobs: list[bytes], device="cuda"
                            ) -> tuple[list[bytes], list[list[bytes]]]:
    """Fused SHA-1 + RS encode of a blob batch -> (ids, pieces per blob).

    Blobs are bucketed by padded piece length exactly like
    ``rs_encode_blobs`` (quantum TILE_L, power-of-two batch, no cap), so
    a window costs O(length buckets) fused launches.  Only each bucket's
    real rows come back to the host.  Byte-identical to running
    ``sha1_digests`` and ``rs_encode_blobs`` separately.
    """
    from repro_torch.core import rs_code
    if not blobs:
        return [], []
    device = torch.device(device)
    G = np.ascontiguousarray(np.asarray(
        rs_code.generator_matrix(code.n, code.k), dtype=np.uint8))
    piece_lens = [code.piece_len(len(b)) for b in blobs]
    ids: list[bytes | None] = [None] * len(blobs)
    pieces: list[list[bytes] | None] = [None] * len(blobs)
    for Lp, idxs in rs_code.bucket_by_piece_len(
            piece_lens, gf_matmul.TILE_L).items():
        nreal, Bp = len(idxs), _pow2(len(idxs))
        data = np.zeros((nreal, code.k, Lp), dtype=np.uint8)
        for row, i in enumerate(idxs):
            data[row] = rs_code.pack_blob(blobs[i], code.k, piece_lens[i], Lp)
        lens = [len(blobs[i]) for i in idxs]
        nbytes = np.zeros(Bp, dtype=np.int32)
        nbytes[:nreal] = lens
        plens = np.ones(Bp, dtype=np.int32)
        plens[:nreal] = [piece_lens[i] for i in idxs]
        LAUNCHES.fused += 1
        Mb = _sha1_block_width(lens, code.k * Lp)
        if _new_shape(("fused", device.type, G.shape, (Bp, Mb, 16),
                       (Bp, code.k, Lp))):
            TRACES.fused += 1
        words, enc = fused_ingest.fused_ingest(
            G, _upload(data, device, Bp), _upload(nbytes, device),
            _upload(plens, device))
        digests = hashing.digest_words_to_bytes(words_to_host(words[:nreal]))
        enc = enc[:nreal].cpu().numpy()
        for row, i in enumerate(idxs):
            L = piece_lens[i]
            ids[i] = digests[row]
            pieces[i] = [enc[row, j, :L].tobytes() for j in range(code.n)]
    return ids, pieces  # type: ignore[return-value]


# ----------------------------------------------------------- attention ----
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None) -> torch.Tensor:
    """Fused GQA flash attention: the hand-written kernel on a CUDA
    tensor, its plain version on a CPU one.

    q: (B,S,H,hd); k,v: (B,T,KV,hd), the queries the last S of T
    positions.  Not a storage dispatch, so no ``LAUNCHES`` tick; the
    kernel wrapper counts its launches in ``KERNELS["flash_attn"]``.
    """
    return flash_attn.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
