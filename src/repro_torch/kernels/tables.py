"""The data plane's fixed tables, uploaded once per device.

SEARS has no learned weights; its parameters are fixed tables: the gear
table of the CDC rolling hash (``core.chunking.GEAR_TABLE``) and the
GF(2^8) log/exp tables (``core.gf256``).  ``load_tables`` takes them as
numpy arrays, uploads them to a device once, and derives the forms the
CUDA kernels read.  Every kernel wrapper and every plain version reads
its tables from here, so a caller that loads other arrays (for example
the JAX reference's, in the tests) changes what both compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.chunking import GEAR_TABLE
from repro_torch.core.gf256 import GF_EXP, GF_LOG


@dataclasses.dataclass(frozen=True, eq=False)
class Tables:
    """One device's copy of the fixed tables (hashed by identity: memos
    key on the load)."""

    gear: torch.Tensor     # (256,) int32: the uint32 gear values' bits
    gf_log: torch.Tensor   # (256,) int64: GF log (plain version)
    gf_exp: torch.Tensor   # (510,) int64: doubled GF exp (plain version)
    # (256, 8) uint32, on the host: c * 2^b in GF(2^8) in all four bytes
    # of word [c, b]; K1's and K5's bit-plane constants are rows of it
    gf_bitplane: np.ndarray


_TABLES: dict[tuple[str, int | None], Tables] = {}


def _key(device) -> tuple[str, int | None]:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def load_tables(gear_table: np.ndarray = GEAR_TABLE,
                gf_log: np.ndarray = GF_LOG, gf_exp: np.ndarray = GF_EXP,
                device="cuda") -> Tables:
    """Upload the gear and GF tables to ``device``; the kernels read these.

    ``gear_table`` is (256,) uint32, ``gf_log`` (256,) and ``gf_exp``
    (510,) integer arrays of the field with generator 2 (the exp table
    doubled so a sum of two logs needs no mod 255).  Replaces any tables
    loaded for the device before.
    """
    gear = np.asarray(gear_table)
    log = np.asarray(gf_log, dtype=np.int64)
    exp = np.asarray(gf_exp, dtype=np.int64)
    if gear.shape != (256,) or log.shape != (256,) or exp.shape != (510,):
        raise ValueError(f"need (256,) gear, (256,) log and (510,) exp "
                         f"tables, got {gear.shape}, {log.shape}, "
                         f"{exp.shape}")
    if np.any(log[1:] > 254) or np.any(log < 0) or np.any(exp < 0) \
            or np.any(exp > 255):
        raise ValueError("GF log values must lie in [0, 254] and exp "
                         "values in [0, 255]")
    c = np.arange(256)[:, None]
    prod = np.where(c == 0, 0,
                    exp[log[np.maximum(c, 1)] + log[1 << np.arange(8)]])
    bitplane = prod.astype(np.uint32) * np.uint32(0x01010101)
    gear_bits = np.ascontiguousarray(gear.astype(np.uint32)).view(np.int32)
    device = torch.device(device)
    t = Tables(gear=torch.from_numpy(gear_bits.copy()).to(device),
               gf_log=torch.from_numpy(log).to(device),
               gf_exp=torch.from_numpy(exp).to(device),
               gf_bitplane=bitplane)
    _TABLES[_key(device)] = t
    return t


def tables(device) -> Tables:
    """The tables loaded for ``device``, loading the defaults at first use."""
    t = _TABLES.get(_key(device))
    return t if t is not None else load_tables(device=device)
