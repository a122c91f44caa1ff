"""Gear CDC rolling hash on the CUDA device.

Port of the JAX reference's Pallas kernels (``repro/kernels/gear_cdc.py``):
the fire kernel, which fuses the boundary test ``(h & mask) == 0`` into
the hash and writes a bool bitmap, and the hash-only kernel, which
writes the uint32 hashes.  Both run from one templated CUDA kernel in
``csrc/gear_cdc.cu``:

    h[t] = sum_{j=0..31} 2^j * gear[byte[t-j]]   (mod 2^32)

with zero history before stream position 0.  Streams are zero-padded to
``bucket_len``, a power-of-two multiple of ``TILE``, so launch shapes --
and ``TRACES.gear`` -- match the reference; pad positions only affect
hashes past the real end, which are sliced off.

A CPU tensor takes the plain version (``ref.gear_hash_ref``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launches import KERNELS
from repro_torch.kernels.tables import tables

TILE = 8192  # output bytes per block (256 threads x 32 positions)


def bucket_len(n: int) -> int:
    """Padded stream length for ``n`` bytes: a power-of-two multiple of TILE.

    Power-of-two tile counts bound the set of launch shapes to
    log2(N/TILE) while wasting at most 2x compute.
    """
    tiles = max(1, -(-n // TILE))
    return TILE * (1 << (tiles - 1).bit_length())


def pad_to_bucket(data):
    """Zero-pad a (N,) uint8 array or tensor to ``bucket_len(N)``."""
    n = data.shape[0]
    pad = bucket_len(n) - n
    if not pad:
        return data
    if torch.is_tensor(data):
        out = torch.zeros(n + pad, dtype=data.dtype, device=data.device)
        out[:n] = data
        return out
    return np.pad(data, (0, pad))


def _mask_bits(mask) -> int:
    """A uint32 mask as the int32 with the same bits (torch has no uint32 &)."""
    return int(np.asarray(mask, dtype=np.uint32).view(np.int32))


def launch(data: torch.Tensor, mask, out: torch.Tensor) -> None:
    """Launch the CUDA kernel over a padded stream.

    ``out`` is a bool tensor for the fire bitmap or an int32 tensor (the
    uint32 hashes' bits) for the hash-only form.
    """
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"gear kernel needs CUDA tensors, got {dev}")
    fire = out.dtype == torch.bool
    if not fire and out.dtype != torch.int32:
        raise TypeError("gear: out must be bool (fire) or int32 (hash)")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError("gear: data must be a (N,) uint8 tensor")
    n = data.shape[0]
    if n == 0 or n % TILE or out.shape != (n,):
        raise ValueError(f"gear: stream length {n} must be a positive "
                         f"multiple of {TILE}, out {tuple(out.shape)}")
    gear = tables(dev).gear
    for name, x in (("data", data), ("out", out), ("gear", gear)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"gear: {name} must be contiguous on {dev}")
    if data.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("gear: data and out must be 16-byte aligned")
    err = _build.library().sears_gear(
        data.data_ptr(), gear.data_ptr(),
        int(np.asarray(mask, dtype=np.uint32)), out.data_ptr(), n, int(fire),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gear")
    KERNELS["gear_fire" if fire else "gear_hash"] += 1


def gear_fire(data: torch.Tensor, mask) -> torch.Tensor:
    """(N,) uint8 + boundary mask -> (N,) bool fire bitmap (one launch).

    Returns the device tensor unsynchronized, so callers overlap host
    work with the launch and compact it when they resolve it.
    """
    n = data.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=data.device)
    padded = pad_to_bucket(data)
    if data.device.type == "cpu":
        h = ref.gear_hash_ref(padded, tables(data.device).gear)
        return ((h & _mask_bits(mask)) == 0)[:n]
    out = torch.empty(padded.shape[0], dtype=torch.bool, device=data.device)
    launch(padded.contiguous(), mask, out)
    return out[:n]


def gear_hash(data: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 -> (N,) gear hashes as int32 bits (view as np.uint32)."""
    n = data.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=data.device)
    padded = pad_to_bucket(data)
    if data.device.type == "cpu":
        return ref.gear_hash_ref(padded, tables(data.device).gear)[:n]
    out = torch.empty(padded.shape[0], dtype=torch.int32, device=data.device)
    launch(padded.contiguous(), 0, out)
    return out[:n]
