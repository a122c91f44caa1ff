"""The port's three further dense configs -- gemma3-1b, internlm2-20b and
deepseek-coder-33b -- against the JAX reference on the same inputs.

Each config equals the reference's field for field, in full and in its
``reduced()`` form, with the same full parameter count.  The reduced
forms' weights come from the reference's own ``init(PRNGKey(0))`` and
cross as host arrays, bit for bit.  Prefill and decode are held as
``tests/test_torch_model.py`` holds llama3.2-1b: the logits within 2e-2
of their largest value, the bf16 k/v cache within 2e-2.  The prompt (72
tokens) is longer than the reduced window (64), so gemma3's local layers
decode past their window.  The TP pad slots of the query heads stay zero
and masked: a pad slot's weights reach no output.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import api as japi
from repro_torch.configs.base import get_config
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.tree import flatten_with_path

ARCHS = ("gemma3_1b", "internlm2_20b", "deepseek_coder_33b")
LOGIT_TOL = 2e-2  # of the largest |logit|
CACHE_TOL = 2e-2  # bf16, atol = rtol
B, P, STEPS = 2, 72, 3


def _close(got: torch.Tensor, want, tol: float, rtol: float | None = None
           ) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _bits(t) -> np.ndarray:
    a = t.view(torch.int16).numpy() if torch.is_tensor(t) \
        and t.dtype == torch.bfloat16 else np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    """A reduced config: the reference's model and own params, as numpy,
    and the port's model over the same params."""
    jcfg = jget_config(request.param).reduced()
    jmodel = japi.get_model(jcfg, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    tcfg = get_config(request.param).reduced()
    return request.param, jmodel, jparams, host, tcfg, api.get_model(tcfg)


def test_configs_equal_the_reference_field_for_field(reduced):
    arch, _, _, _, tcfg, _ = reduced
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget_config(arch))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        jget_config(arch).reduced())
    assert get_config(arch).param_count() == jget_config(arch).param_count()
    assert tcfg.param_count() == jget_config(arch).reduced().param_count()


def test_weight_carry_is_bit_exact(reduced):
    _, _, _, host, _, tmodel = reduced
    params = api.params_from_numpy(host, "cpu")
    want = jax.tree_util.tree_flatten_with_path(host)[0]
    got = flatten_with_path(params)
    shapes = flatten_with_path(tmodel.param_shapes())
    assert len(got) == len(want) == len(shapes)
    for (jpath, a), (path, t), (_, spec) in zip(want, got, shapes):
        assert tuple(t.shape) == a.shape == spec.shape, path
        assert t.dtype == spec.dtype, path
        assert np.array_equal(_bits(t), _bits(a)), path


def test_prefill_and_decode_match_reference(reduced):
    _, jmodel, jparams, host, tcfg, tmodel = reduced
    tparams = api.params_from_numpy(host, "cpu")
    if tcfg.sliding_window:
        assert P > tcfg.sliding_window and 0 in tmodel._windows()
    rng = np.random.default_rng(5)
    T = P + STEPS
    toks = rng.integers(0, tcfg.vocab_size, size=(B, P))
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=T))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tlog, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(toks)}, cache_len=T)
    scale = float(jnp.max(jnp.abs(jlog.astype(jnp.float32))))
    _close(tlog, jlog, LOGIT_TOL * scale, rtol=0)
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape
        _close(tcache[name], jcache[name], CACHE_TOL)

    decode = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, tcfg.vocab_size, size=(STEPS, B, 1))
    for i in range(STEPS):
        jlog, jcache = decode(jparams, jcache,
                              jnp.asarray(feed[i], jnp.int32),
                              jnp.int32(P + i))
        with torch.no_grad():
            tlog, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(feed[i]), P + i)
        _close(tlog, jlog, LOGIT_TOL * scale, rtol=0)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], CACHE_TOL)


def test_padded_head_slots_stay_zero_and_masked(reduced):
    _, _, _, host, tcfg, tmodel = reduced
    hm = L.head_mask(tcfg)
    if not (tcfg.n_heads_padded or tcfg.n_kv_heads_padded):
        assert hm is None and tcfg.h_store == tcfg.n_heads
        return
    pad = hm == 0
    assert int(pad.sum()) == tcfg.h_store - tcfg.n_heads
    # zero in the port's own init and in the reference's carried weights
    for params in (tmodel.init(torch.Generator().manual_seed(0)),
                   api.params_from_numpy(host, "cpu")):
        attn = params["layers"]["attn"]
        assert not attn["wq"][:, :, pad].any()
        assert not attn["wo"][:, pad].any()
    # masked: weights in the pad slots of wq reach no logit
    params = api.params_from_numpy(host, "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, size=(B, 12)))
    with torch.no_grad():
        want, _ = tmodel.prefill(params, {"tokens": toks})
        wq = params["layers"]["attn"]["wq"].clone()
        wq[:, :, pad] = 1.0
        params["layers"]["attn"]["wq"] = wq
        got, _ = tmodel.prefill(params, {"tokens": toks})
    assert torch.equal(got, want)


def test_dense_init_scales_in_place_to_the_same_bits():
    """``dense_init`` scales its fp32 draw in place (one fp32 copy of a
    leaf at a time on the card): the same bits as ``scale * x``."""
    got = L.dense_init(torch.Generator().manual_seed(7), (3, 64, 96))
    x = torch.randn((3, 64, 96), generator=torch.Generator().manual_seed(7))
    want = (0.02 * x).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
