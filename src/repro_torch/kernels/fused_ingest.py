"""Fused ingest -- SHA-1 chunk ids and RS encode of one bucket -- on CUDA.

Port of the JAX reference's ``_fused_ingest_pallas``
(``repro/kernels/ops.py``), which issues the SHA-1 and GF kernels under
one jit.  ``csrc/fused_ingest.cu`` is one launch with two roles: hashing
blocks on K4's warp-specialised rounds, whose assembler warps stage each
packed chunk from the slab and pad it on the device, and encoding
blocks on K1's bit-plane product, whose constants (``gf_matmul``'s, built
once per matrix and tables) this wrapper passes.  It reads only the
packed ``(B, k, Lp)`` bytes and each chunk's length and piece length: no
host-built message schedule.

A CPU tensor takes the plain version (``ref.fused_ingest_ref``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gf_matmul import (ALIGN, MAX_DIM, TILE_L,
                                          _constants, _device_matrix,
                                          host_bytes)
from repro_torch.kernels.launches import KERNELS
from repro_torch.kernels.tables import Tables, tables


def launch(M: torch.Tensor, data: torch.Tensor, nbytes: torch.Tensor,
           piece_lens: torch.Tensor, words: torch.Tensor, enc: torch.Tensor,
           t: Tables) -> None:
    """Launch the CUDA kernel: words (B,5) and enc (B,n,Lp) = M x data.

    ``M`` is a device matrix made by ``gf_matmul._device_matrix``, whose
    host bytes give the kernel's constants without a copy back; ``t`` the
    device's tables.  Neither synchronises nor copies to the host, so a
    CUDA graph can capture it once a first call has built the constants.
    """
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ingest kernel needs CUDA tensors, got {dev}")
    if M.dtype != torch.uint8 or data.dtype != torch.uint8 \
            or enc.dtype != torch.uint8:
        raise TypeError("fused_ingest: M, data and enc must be uint8")
    if nbytes.dtype != torch.int32 or piece_lens.dtype != torch.int32 \
            or words.dtype != torch.int32:
        raise TypeError("fused_ingest: nbytes, piece_lens and words must "
                        "be int32")
    r, k = M.shape
    if data.dim() != 3:
        raise ValueError(f"fused_ingest: data must be (B, k, Lp), got "
                         f"{tuple(data.shape)}")
    B, kd, Lp = data.shape
    if kd != k or B == 0 or not (0 < r <= MAX_DIM) or not (0 < k <= MAX_DIM) \
            or nbytes.shape != (B,) or piece_lens.shape != (B,) \
            or words.shape != (B, 5) or enc.shape != (B, r, Lp):
        raise ValueError(
            f"fused_ingest: shapes M {tuple(M.shape)}, data "
            f"{tuple(data.shape)}, nbytes {tuple(nbytes.shape)}, piece_lens "
            f"{tuple(piece_lens.shape)}, words {tuple(words.shape)}, enc "
            f"{tuple(enc.shape)}")
    if Lp % TILE_L or Lp == 0:
        raise ValueError(f"fused_ingest: Lp={Lp} is not a multiple of "
                         f"{TILE_L}")
    for name, x in (("M", M), ("data", data), ("nbytes", nbytes),
                    ("piece_lens", piece_lens), ("words", words),
                    ("enc", enc)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"fused_ingest: {name} must be contiguous on "
                             f"{dev}")
    if data.data_ptr() % ALIGN or enc.data_ptr() % ALIGN:
        raise ValueError(f"fused_ingest: data and enc must be {ALIGN}-byte "
                         f"aligned")
    mbytes = host_bytes(M)
    if mbytes is None:
        raise ValueError("fused_ingest: M must come from "
                         "gf_matmul._device_matrix (the kernel's constants "
                         "are built from its host bytes)")
    host, consts = _constants(mbytes, r, k, t, dev)
    err = _build.library().sears_fused_ingest(
        host.ctypes.data, consts.data_ptr(), data.data_ptr(),
        nbytes.data_ptr(), piece_lens.data_ptr(), words.data_ptr(),
        enc.data_ptr(), B, r, k, Lp,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_ingest")
    KERNELS["fused_ingest"] += 1


def fused_ingest(G: np.ndarray, data: torch.Tensor, nbytes: torch.Tensor,
                 piece_lens: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """SHA-1 ids and RS pieces of one packed bucket.

    ``G`` is the host (n, k) generator matrix; ``data`` (B, k, Lp) uint8
    holds the chunks packed by ``rs_code.pack_blob``; ``nbytes`` and
    ``piece_lens`` (B,) int32 give each chunk's length and piece length
    (a pad row has length 0).  Returns ((B, 5) digest words as int32
    bits, (B, n, Lp) uint8 pieces) on ``data``'s device, not synchronized.
    """
    Gnp = np.ascontiguousarray(np.asarray(G, dtype=np.uint8))
    dev = data.device
    t = tables(dev)
    Gdev = _device_matrix(Gnp.tobytes(), *Gnp.shape, dev)
    if dev.type == "cpu":
        return ref.fused_ingest_ref(Gdev, data, nbytes, piece_lens,
                                    t.gf_log, t.gf_exp)
    B = data.shape[0]
    words = torch.empty((B, 5), dtype=torch.int32, device=dev)
    enc = torch.empty((B, Gnp.shape[0], data.shape[2]), dtype=torch.uint8,
                      device=dev)
    launch(Gdev, data, nbytes.reshape(-1), piece_lens.reshape(-1), words,
           enc, t)
    return words, enc
