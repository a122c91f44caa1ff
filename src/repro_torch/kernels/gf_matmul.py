"""GF(2^8) matmul (Reed-Solomon encode/decode) on the CUDA device.

Port of the JAX reference's bit-sliced Pallas kernel
(``repro/kernels/gf_matmul.py``).  ``csrc/gf_matmul.cu`` keeps its
algebra -- a product by a constant is linear over GF(2), so it splits
into bit planes -- on Hopper's integer ALUs: each byte mask of the data
is ANDed with the constant ``M[i, j] * 2^b`` and XORed into the output.
The wrapper builds those constants (``bitplane_constants``) and hands
them to the kernel, which holds no tables.  ``TILE_L`` stays the
bucketing quantum of the batched blob paths.

A CPU tensor takes the plain version (``ref.gf_matmul_ref``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launches import KERNELS
from repro_torch.kernels.tables import Tables, tables

TILE_L = 512  # bytes of piece per bucket step; the bucketing quantum
MAX_DIM = 128  # codes have n <= 128 (rs_code.generator_matrix)
ALIGN = 16  # bytes: the kernel moves data and out in 16-byte words


# The host bytes of each matrix ``_device_matrix`` made, by the tensor's
# id beside a weak reference to it: the fused kernel's wrapper builds its
# constants from them without a copy back.
_HOST_BYTES: dict[int, tuple[weakref.ref, bytes]] = {}


@functools.lru_cache(maxsize=None)
def _device_matrix(mbytes: bytes, r: int, k: int,
                   device: torch.device) -> torch.Tensor:
    """Device-resident (r,k) uint8 coding matrix, memoized by content."""
    m = np.frombuffer(mbytes, dtype=np.uint8).reshape(r, k).copy()
    t = torch.from_numpy(m).to(device)
    # searslint: ignore[begin-purity] -- memo side table, read by no plan
    _HOST_BYTES[id(t)] = (weakref.ref(t), mbytes)
    return t


def host_bytes(M: torch.Tensor) -> bytes | None:
    """The host bytes of a matrix made by ``_device_matrix``, else None."""
    ref_, mbytes = _HOST_BYTES.get(id(M), (None, None))
    return mbytes if ref_ is not None and ref_() is M else None


def bitplane_constants(M, t: Tables) -> np.ndarray:
    """The kernel's constants of an (r, k) matrix: (r, k, 8) uint32 with
    word [i, j, b] = M[i, j] * 2^b in GF(2^8), in all four bytes; built
    from the loaded tables (``t.gf_bitplane``)."""
    return t.gf_bitplane[np.asarray(M, dtype=np.uint8)]


@functools.lru_cache(maxsize=None)
def _constants(mbytes: bytes, r: int, k: int, t: Tables,
               device: torch.device) -> tuple[np.ndarray, torch.Tensor]:
    """An (r,k) matrix's constants on the host (the instantiated shapes
    take them as kernel parameters) and on the device (the generic
    instantiation reads them there), built once per matrix and tables."""
    M = np.frombuffer(mbytes, dtype=np.uint8).reshape(r, k)
    host = np.ascontiguousarray(bitplane_constants(M, t))
    return host, torch.from_numpy(host.view(np.int32).copy()).to(device)


def launch(M, data: torch.Tensor, out: torch.Tensor, t: Tables) -> None:
    """Launch the CUDA kernel: out (B,r,L) = M (r,k) x data (B,k,L), with
    ``M`` the host matrix and ``t`` the device's tables."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"gf_matmul kernel needs CUDA tensors, got {dev}")
    M = np.asarray(M)
    if M.dtype != np.uint8 or data.dtype != torch.uint8 \
            or out.dtype != torch.uint8:
        raise TypeError("gf_matmul: M, data and out must be uint8")
    for name, x in (("data", data), ("out", out)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"gf_matmul: {name} must be contiguous on {dev}")
    if M.ndim != 2 or data.dim() != 3:
        raise ValueError(f"gf_matmul: shapes M {M.shape}, data "
                         f"{tuple(data.shape)}")
    r, k = M.shape
    B, kd, L = data.shape
    if kd != k or out.shape != (B, r, L) or not (0 < r <= MAX_DIM) \
            or not (0 < k <= MAX_DIM) or B == 0:
        raise ValueError(f"gf_matmul: shapes M {M.shape}, data "
                         f"{tuple(data.shape)}, out {tuple(out.shape)}")
    if L % TILE_L or L == 0:
        raise ValueError(f"gf_matmul: L={L} is not a multiple of {TILE_L}")
    if data.data_ptr() % ALIGN or out.data_ptr() % ALIGN:
        raise ValueError(f"gf_matmul: data and out must be {ALIGN}-byte "
                         f"aligned")
    host, consts = _constants(M.tobytes(), r, k, t, dev)
    err = _build.library().sears_gf_matmul(
        host.ctypes.data, consts.data_ptr(), data.data_ptr(),
        out.data_ptr(), B, r, k, L,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gf_matmul")
    KERNELS["gf_matmul"] += 1


def gf_matmul(M: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Apply an (r,k) GF(256) coding matrix to (B, k, L) uint8 pieces.

    Returns (B, r, L) uint8 on ``data``'s device, not synchronized.
    ``M`` is a host numpy matrix; its constants go to the device once.
    """
    if data.dim() == 2:
        data = data[None]
    Mnp = np.ascontiguousarray(np.asarray(M, dtype=np.uint8))
    dev = data.device
    t = tables(dev)
    if dev.type == "cpu":
        Mdev = _device_matrix(Mnp.tobytes(), *Mnp.shape, dev)
        return ref.gf_matmul_ref(Mdev, data, t.gf_log, t.gf_exp)
    B, k, L = data.shape
    pad = (-L) % TILE_L
    if pad or not data.is_contiguous() or data.data_ptr() % ALIGN:
        padded = torch.zeros((B, k, L + pad), dtype=torch.uint8, device=dev)
        padded[..., :L] = data
        data = padded
    out = torch.empty((B, Mnp.shape[0], L + pad), dtype=torch.uint8,
                      device=dev)
    launch(Mnp, data, out, t)
    return out[..., :L]
