"""Batched SHA-1 on the CUDA device.

Port of the JAX reference's Pallas kernel (``repro/kernels/sha1.py``):
SHA-1 is sequential over the 64-byte blocks of one message but parallel
across messages, so ``csrc/sha1.cu`` hashes each message in one consumer
lane over that message's real blocks, while a producer warp stages the
blocks and expands their schedules ahead of it.  Input comes from
``core.hashing.sha1_pad_batch`` (padding done on the host, words held as
big-endian values); output digests match ``hashlib.sha1`` bit for bit.

A CPU tensor takes the plain version (``ref.sha1_ref``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launches import KERNELS


def launch(blocks: torch.Tensor, counts: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch the CUDA kernel: (B,M,16) blocks + (B,) counts -> out (B,5)."""
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"sha1 kernel needs CUDA tensors, got {dev}")
    if blocks.dtype != torch.int32 or counts.dtype != torch.int32 \
            or out.dtype != torch.int32:
        raise TypeError("sha1: blocks, counts and out must be int32")
    if blocks.dim() != 3 or blocks.shape[2] != 16 or blocks.shape[0] == 0 \
            or blocks.shape[1] == 0:
        raise ValueError(f"sha1: blocks must be (B, M, 16), got "
                         f"{tuple(blocks.shape)}")
    B, M, _ = blocks.shape
    if counts.shape != (B,) or out.shape != (B, 5):
        raise ValueError(f"sha1: counts {tuple(counts.shape)} / out "
                         f"{tuple(out.shape)} do not match B={B}")
    for name, x in (("blocks", blocks), ("counts", counts), ("out", out)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"sha1: {name} must be contiguous on {dev}")
    if blocks.data_ptr() % 16:
        raise ValueError("sha1: blocks must be 16-byte aligned")
    err = _build.library().sears_sha1(
        blocks.data_ptr(), counts.data_ptr(), out.data_ptr(), B, M,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sha1")
    KERNELS["sha1"] += 1


def sha1_digest_words(blocks: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """(B, M, 16) int32 padded blocks + (B,) counts -> (B, 5) digests.

    Words travel as int32 tensors holding the uint32 bits; view the
    result as ``np.uint32`` on the host.
    """
    counts = counts.reshape(-1)
    if blocks.device.type == "cpu":
        return ref.sha1_ref(blocks, counts)
    out = torch.empty((blocks.shape[0], 5), dtype=torch.int32,
                      device=blocks.device)
    launch(blocks.contiguous(), counts.to(torch.int32).contiguous(), out)
    return out
