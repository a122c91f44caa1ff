"""The port's flash attention (K6) against the JAX reference's kernel.

On the CPU the port's ``ops.flash_attention`` runs its plain version
(``ref.flash_attention_ref``); the reference runs its Pallas kernel in
interpret mode.  Same numpy inputs from a seed; the tolerances are
``tests/test_flash_attn.py``'s: 2e-5 in fp32 (sums in another order),
2e-2 in bf16 (p rounded to bf16 before P.V in both, in another order).
The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro_torch.kernels import flash_attn, ops, ref
from repro_torch.kernels.launches import KERNELS

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, S, T, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32),
            rng.standard_normal((B, T, KV, hd), dtype=np.float32))


@pytest.mark.parametrize("B,S,T,H,KV,hd,dtype,window", [
    (1, 256, 256, 2, 2, 32, "float32", 0),    # MHA single block
    (1, 300, 300, 2, 1, 32, "float32", 0),    # unaligned seq (padding path)
    (1, 512, 512, 2, 2, 32, "float32", 128),  # sliding window
    (1, 256, 768, 4, 4, 32, "bfloat16", 0),   # more KV than Q, bf16
    (1, 256, 256, 2, 1, 96, "float32", 0),    # phi-3-vision's head dim
    (1, 300, 300, 4, 2, 80, "bfloat16", 0),   # a routed head dim
])
def test_port_flash_matches_pallas_kernel(B, S, T, H, KV, hd, dtype, window):
    q, k, v = _inputs(B, S, T, H, KV, hd)
    want = jflash.flash_attention(
        *(jnp.asarray(x).astype(_JNP[dtype]) for x in (q, k, v)),
        causal=True, window=window, interpret=True)
    before = dict(KERNELS)
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v)),
        causal=True, window=window)
    assert KERNELS == before  # the CPU path launches nothing
    assert got.dtype == _TORCH[dtype] and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_port_flash_non_causal_matches_pallas_kernel():
    q, k, v = _inputs(1, 256, 256, 2, 2, 32, seed=1)
    want = jflash.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=False, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_plain_version_chunks_rows_without_changing_them(monkeypatch):
    """``FLASH_Q_CHUNK`` only bounds the score transient."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 130, 200, 4, 2, 64))
    whole = ref.flash_attention_ref(q, k, v, window=50)  # one chunk
    for chunk in (7, 64):
        monkeypatch.setattr(ref, "FLASH_Q_CHUNK", chunk)
        torch.testing.assert_close(
            ref.flash_attention_ref(q, k, v, window=50), whole, rtol=0,
            atol=0)


def test_non_cpu_tensors_go_to_the_kernel_launch():
    meta = {"device": "meta"}
    q = torch.empty((1, 64, 4, 64), **meta)
    kv = torch.empty((1, 64, 2, 64), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention(q, kv, kv)


# ---------------------------------------------------------------- dispatch --
# The wrapper's routing and checks, with the CUDA library replaced by a
# recorder: nothing here needs a card or nvcc.
class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("sears_flash_attn"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _qkvo(dtype, B=1, S=64, T=96, H=4, KV=2, hd=64):
    q = torch.zeros((B, S, H, hd), dtype=dtype)
    k = torch.zeros((B, T, KV, hd), dtype=dtype)
    v = torch.zeros((B, T, KV, hd), dtype=dtype)
    return q, k, v, torch.empty_like(q)


@pytest.mark.parametrize("dtype,entry,counter", [
    (torch.bfloat16, "sears_flash_attn_bf16", "flash_attn"),
    (torch.float32, "sears_flash_attn_fp32", "flash_attn_fp32"),
])
def test_dtype_routes_to_its_own_kernel(monkeypatch, dtype, entry, counter):
    """bf16 reaches the tensor-core entry point, fp32 the CUDA-core one
    (FFMA fed by the same TMA ring), each ticking its own counter; nothing
    else is called."""
    rec = _Recorder()
    monkeypatch.setattr(flash_attn._build, "library", lambda: rec)
    q, k, v, out = _qkvo(dtype)
    before = dict(KERNELS)
    flash_attn.dispatch(q, k, v, out, scale=0.125, causal=True, window=16,
                        stream=7)
    assert [name for name, _ in rec.calls] == [entry]
    args = rec.calls[0][1]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[4:10] == (1, 64, 96, 4, 2, 64)  # B, S, T, H, KV, hd
    assert args[11:] == (0.125, 1, 16, 7)  # scale, causal, window, stream
    ticked = {n: KERNELS[n] - before[n] for n in KERNELS}
    assert ticked == {n: int(n == counter) for n in KERNELS}


def _misaligned_base(x):
    """x's values one element further into a buffer: base off by 2-4 B."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    return buf[1:].view(x.shape)


def _padded_heads(x):
    """x with each head row one element longer: head stride not a
    multiple of 16 bytes, unit stride in head_dim kept."""
    B, L, Hh, hd = x.shape
    return torch.zeros((B, L, Hh, hd + 1), dtype=x.dtype)[..., :hd]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("fault", ["base", "strides"])
def test_kernels_reject_what_tma_cannot_read(monkeypatch, dtype, which,
                                             fault):
    """Both kernels read q, k and v through TMA tensor maps: a base off
    16 bytes or a stride that is not a multiple of 16 bytes raises before
    any launch, in either dtype."""
    rec = _Recorder()
    monkeypatch.setattr(flash_attn._build, "library", lambda: rec)
    t = dict(zip("qkvo", _qkvo(dtype)))
    t[which] = (_misaligned_base if fault == "base" else _padded_heads)(
        t[which])
    match = "aligned" if fault == "base" else "multiples of 16 bytes"
    before = dict(KERNELS)
    with pytest.raises(ValueError, match=match):
        flash_attn.dispatch(t["q"], t["k"], t["v"], t["o"], scale=0.125,
                            causal=True, window=0, stream=0)
    assert rec.calls == [] and KERNELS == before


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "sears_flash_attn_bf16"),
    (torch.float32, "sears_flash_attn_fp32"),
])
@pytest.mark.parametrize("hd", [32, 64, 80, 96, 128, 256])
def test_fp32_long_shape_layout_passes_the_tma_rule(monkeypatch, hd, dtype,
                                                     entry):
    """Contiguous q, k, v in the long shape's layout (32 query and 8 KV
    heads) meet TMA's rule at every head dim the kernels take, native (32,
    64, 96, 128, 256) or routed (80), in either dtype, and reach their
    dtype's entry point with the real head dim: the C side picks the
    instance."""
    rec = _Recorder()
    monkeypatch.setattr(flash_attn._build, "library", lambda: rec)
    q, k, v, out = _qkvo(dtype, S=128, T=128, H=32, KV=8, hd=hd)
    flash_attn.dispatch(q, k, v, out, scale=hd ** -0.5, causal=True,
                        window=0, stream=0)
    assert [name for name, _ in rec.calls] == [entry]
    args = rec.calls[0][1]
    assert args[4:10] == (1, 128, 128, 32, 8, hd)  # B, S, T, H, KV, hd
    assert args[11] == pytest.approx(hd ** -0.5)


@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 264),   # past wgmma's N = 256
    (torch.bfloat16, 384),
    (torch.float32, 512),
    (torch.bfloat16, 36),    # a 72-byte row: not a multiple of 16 bytes
    (torch.float32, 30),     # a 120-byte row
])
def test_head_dims_outside_the_kernels_raise(monkeypatch, dtype, hd):
    """Past 256, or with a row TMA cannot read, a head dim raises before
    any launch: nothing reroutes it to the plain version."""
    rec = _Recorder()
    monkeypatch.setattr(flash_attn._build, "library", lambda: rec)
    q, k, v, out = _qkvo(dtype, hd=hd)
    before = dict(KERNELS)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn.dispatch(q, k, v, out, scale=0.125, causal=True,
                            window=0, stream=0)
    assert rec.calls == [] and KERNELS == before
