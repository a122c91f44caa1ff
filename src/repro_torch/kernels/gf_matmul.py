"""GF(2^8) matmul (Reed-Solomon encode/decode) on the CUDA device.

Port of the JAX reference's bit-sliced Pallas kernel
(``repro/kernels/gf_matmul.py``).  The TPU lifted the field product to a
bit-plane matmul because it has no fast gathers; Hopper has fast
shared-memory lookups, so ``csrc/gf_matmul.cu`` applies the coding
matrix with log/exp tables in shared memory.  ``TILE_L`` stays the
bucketing quantum of the batched blob paths.

A CPU tensor takes the plain version (``ref.gf_matmul_ref``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launches import KERNELS
from repro_torch.kernels.tables import Tables, tables

TILE_L = 512  # bytes of piece per block; the bucketing quantum
MAX_DIM = 128  # codes have n <= 128 (rs_code.generator_matrix)


@functools.lru_cache(maxsize=None)
def _device_matrix(mbytes: bytes, r: int, k: int,
                   device: torch.device) -> torch.Tensor:
    """Device-resident (r,k) uint8 coding matrix, memoized by content."""
    m = np.frombuffer(mbytes, dtype=np.uint8).reshape(r, k).copy()
    return torch.from_numpy(m).to(device)


def launch(M: torch.Tensor, data: torch.Tensor, out: torch.Tensor,
           t: Tables) -> None:
    """Launch the CUDA kernel: out (B,r,L) = M (r,k) x data (B,k,L)."""
    r, k = M.shape
    B, kd, L = data.shape
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"gf_matmul kernel needs CUDA tensors, got {dev}")
    for name, x in (("M", M), ("data", data), ("out", out),
                    ("klog", t.gf_klog), ("kexp", t.gf_kexp)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"gf_matmul: {name} must be contiguous on {dev}")
    if M.dtype != torch.uint8 or data.dtype != torch.uint8 \
            or out.dtype != torch.uint8:
        raise TypeError("gf_matmul: M, data and out must be uint8")
    if kd != k or out.shape != (B, r, L) or not (0 < r <= MAX_DIM) \
            or not (0 < k <= MAX_DIM) or B == 0:
        raise ValueError(f"gf_matmul: shapes M {tuple(M.shape)}, data "
                         f"{tuple(data.shape)}, out {tuple(out.shape)}")
    if L % TILE_L or L == 0:
        raise ValueError(f"gf_matmul: L={L} is not a multiple of {TILE_L}")
    if data.data_ptr() % 4 or out.data_ptr() % 4:
        raise ValueError("gf_matmul: data and out must be 4-byte aligned")
    err = _build.library().sears_gf_matmul(
        M.data_ptr(), t.gf_klog.data_ptr(), t.gf_kexp.data_ptr(),
        data.data_ptr(), out.data_ptr(), B, r, k, L,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gf_matmul")
    KERNELS["gf_matmul"] += 1


def gf_matmul(M: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Apply an (r,k) GF(256) coding matrix to (B, k, L) uint8 pieces.

    Returns (B, r, L) uint8 on ``data``'s device, not synchronized.
    ``M`` is a host numpy matrix, uploaded once per distinct matrix.
    """
    if data.dim() == 2:
        data = data[None]
    Mnp = np.ascontiguousarray(np.asarray(M, dtype=np.uint8))
    dev = data.device
    t = tables(dev)
    Mdev = _device_matrix(Mnp.tobytes(), *Mnp.shape, dev)
    if dev.type == "cpu":
        return ref.gf_matmul_ref(Mdev, data, t.gf_log, t.gf_exp)
    B, k, L = data.shape
    pad = (-L) % TILE_L
    if pad or not data.is_contiguous():
        padded = torch.zeros((B, k, L + pad), dtype=torch.uint8, device=dev)
        padded[..., :L] = data
        data = padded
    out = torch.empty((B, Mnp.shape[0], L + pad), dtype=torch.uint8,
                      device=dev)
    launch(Mdev, data, out, t)
    return out[..., :L]
