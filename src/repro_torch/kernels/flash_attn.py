"""Flash attention (GQA, causal / sliding window) on the CUDA device.

Port of the JAX reference's Pallas kernel (``repro/kernels/flash_attn.py``)
in its model layout: q (B, S, H, hd), k and v (B, T, KV, hd), the queries
being the last S of the T positions.  Two hand-written kernels in
``csrc/flash_attn.cu``, chosen by dtype and nothing else, both fed by
TMA, which reads each tensor where it lies through a tensor map: that
needs a 16-byte aligned base and (batch, sequence, head) strides that are
multiples of 16 bytes, and ``_check`` raises on anything else (nothing
copies or reroutes such a tensor).

Head dims: each kernel is instantiated at hd 32, 64, 96, 128 and 256;
any other hd up to ``MAX_HEAD_DIM`` whose row is a multiple of 16 bytes
(8 bf16 or 4 fp32 columns) runs on the smallest instance above it, its
tensor maps filling the columns past hd with zeros, and only the real hd
columns are stored.  The C entry point picks the instance from the hd
it is given.  ``_check`` raises before any launch on hd > 256 (wgmma's N
and the shared memory budget) and on a row that TMA cannot read.

- bf16 -> ``sears_flash_attn_bf16``: wgmma on the tensor cores, its tiles
  in 128-byte swizzle rows where hd is a multiple of 64, else 64-byte
  ones.  Counted in ``KERNELS["flash_attn"]``.
- fp32 -> ``sears_flash_attn_fp32``: FFMA on the CUDA cores, register
  tiles of 8 x 8 scores a thread (at hd 32 and 64) read from
  128-byte-swizzled tiles without bank conflicts, K and V through one TMA
  ring in turn, a warp-private p buffer.  It is bound by operations: 4 hd
  a live query-key pair at the 67 TFLOP/s of the fp32 CUDA cores, the
  bytes being about 1/80 of that.  The tensor cores do not hold the 2e-5
  tolerance for every input: TF32 breaks it, and split TF32 (three
  products of hi / lo halves) reads 2.4-4.2% of the gate on standard
  normal inputs but 285% on inputs scaled x4, where fp32 FMAs read 3%.
  Counted in ``KERNELS["flash_attn_fp32"]``.

A CPU tensor takes the plain version (``ref.flash_attention_ref``); a
CUDA tensor launches the kernel of its dtype or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launches import KERNELS

MAX_HEAD_DIM = 256  # wgmma's largest N; the shared memory budget
# dtype -> (C entry point, launch counter)
ENTRY = {torch.bfloat16: ("sears_flash_attn_bf16", "flash_attn"),
         torch.float32: ("sears_flash_attn_fp32", "flash_attn_fp32")}
TMA_ALIGN = 16  # bytes: a tensor map's base and strides


def _check(q, k, v, out) -> None:
    """Raise on what the kernels do not take."""
    if q.dtype not in ENTRY:
        raise TypeError(f"flash_attn: dtype {q.dtype} is not one of "
                        f"{list(ENTRY)}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attn: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    size = q.element_size()
    if not 0 < hd <= MAX_HEAD_DIM or hd * size % TMA_ALIGN:
        raise ValueError(f"flash_attn: head_dim {hd} is not in 1.."
                         f"{MAX_HEAD_DIM} with rows of a multiple of "
                         f"{TMA_ALIGN} bytes ({q.dtype})")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attn: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if KV == 0 or H % KV or not 0 < S <= T or B > 65535 or H > 65535:
        raise ValueError(f"flash_attn: needs H % KV == 0 and 0 < S <= T, "
                         f"got H={H} KV={KV} S={S} T={T}")
    if out.shape != q.shape or not out.is_contiguous():
        raise ValueError(f"flash_attn: out must be contiguous "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.device != q.device or x.dtype != q.dtype or x.stride(-1) != 1:
            raise ValueError(f"flash_attn: {name} must be {q.dtype} on "
                             f"{q.device} with unit stride in head_dim")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attn: {name}'s base is not "
                             f"{TMA_ALIGN}-byte aligned (TMA)")
        if any(s * size % TMA_ALIGN for s in x.stride()[:3]):
            raise ValueError(f"flash_attn: {name}'s strides "
                             f"{x.stride()[:3]} are not multiples of "
                             f"{TMA_ALIGN} bytes (TMA)")


def dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             out: torch.Tensor, *, scale: float, causal: bool, window: int,
             stream: int) -> None:
    """Check the tensors, then call the C entry point of q's dtype on
    ``stream`` (a ``cudaStream_t`` as an int)."""
    _check(q, k, v, out)
    name, counter = ENTRY[q.dtype]
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    err = getattr(_build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H,
        KV, hd, ctypes.addressof(strides), float(scale), int(bool(causal)),
        int(window), stream)
    _build.check(err, name)
    KERNELS[counter] += 1


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, scale: float, causal: bool,
           window: int) -> None:
    """Launch the CUDA kernel: out (B,S,H,hd) = attention(q, k, v)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attn kernel needs CUDA tensors, got {dev}")
    dispatch(q, k, v, out, scale=scale, causal=causal, window=window,
             stream=torch.cuda.current_stream(dev).cuda_stream)


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
