"""Flash attention (GQA, causal / sliding window) on the CUDA device.

Port of the JAX reference's Pallas kernel (``repro/kernels/flash_attn.py``)
in its model layout: q (B, S, H, hd), k and v (B, T, KV, hd), the queries
being the last S of the T positions.  ``csrc/flash_attn.cu`` gives one
block to each (batch, query head, tile of 64 queries) and loops over the
key tiles inside it, reading every tensor where it lies through its
strides: the reference's transposes and pads are TPU layout work.

A CPU tensor takes the plain version (``ref.flash_attention_ref``); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launches import KERNELS

HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, scale: float, causal: bool,
           window: int) -> None:
    """Launch the CUDA kernel: out (B,S,H,hd) = attention(q, k, v)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attn kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attn: dtype {q.dtype} is not one of "
                        f"{list(_DTYPES)}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attn: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attn: head_dim {hd} not in {HEAD_DIMS} or "
                         f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if KV == 0 or H % KV or not 0 < S <= T or B > 65535 or H > 65535:
        raise ValueError(f"flash_attn: needs H % KV == 0 and 0 < S <= T, "
                         f"got H={H} KV={KV} S={S} T={T}")
    if out.shape != q.shape or not out.is_contiguous():
        raise ValueError(f"flash_attn: out must be contiguous "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.device != dev or x.dtype != q.dtype or x.stride(-1) != 1:
            raise ValueError(f"flash_attn: {name} must be {q.dtype} on {dev} "
                             f"with unit stride in head_dim")
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    err = _build.library().sears_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, S, T, H, KV, hd, ctypes.addressof(strides),
        float(scale), int(bool(causal)), int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attn")
    KERNELS["flash_attn"] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, KV, hd).  Returns (B, S, H, hd)."""
    scale = scale or (1.0 / np.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch(q, k, v, out, scale=scale, causal=causal, window=window)
    return out
