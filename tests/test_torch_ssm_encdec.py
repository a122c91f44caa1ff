"""The port's Mamba-1 layers and its SSM, hybrid and encoder-decoder
models -- and the configs that use them, falcon-mamba-7b, jamba-1.5-large
and whisper-tiny -- against the JAX reference on the same inputs.

* The configs equal the reference's field for field, full and
  ``reduced()`` (their parameter counts are held with every other id's
  in ``tests/test_torch_moe_mla.py``).
* ``mamba_scan`` at S = 100 (a chunk of 64 and a short last one, which
  the reference pads), its continuation from ``h0`` / ``conv_state``
  (``tests/test_layers.py``'s case) and ``mamba_step`` over a few
  tokens, on both ``ssm_compute_dtype`` branches, from the reference's
  own ``mamba_init``.  ``y`` (bf16) and the conv tail (fp32 of bf16
  values) within ``SCAN_Y_TOL`` of their largest |value|; the fp32 state
  within ``SCAN_H_TOL[dtype]``.
* ``mamba_init``'s fp32 leaves: ``A_log``, ``dt_bias``, ``D_skip`` and
  ``conv_b`` equal the reference's bit for bit; ``conv_w`` and
  ``dt_proj`` are drawn with the reference's spread (0.1, within
  ``SPREAD_TOL``), the bf16 projections with 0.02.
* The reduced falcon-mamba, jamba (one group of 8 layers: the
  reference's 16-layer reduced jamba doubles the file's time for a
  second copy of the same pattern) and whisper, from the reference's own
  ``init(PRNGKey(0))``: the weight carry bit for bit, the forward's
  logits, prefill and 3 decode steps, held as
  ``tests/test_torch_moe_mla.py`` holds its configs: logits within
  ``LOGIT_TOL`` of their largest value, the bf16 slot caches (k/v)
  within ``CACHE_TOL``, the fp32 SSM state (``h``, ``conv``) within
  ``CACHE_TOL`` of each layer's largest |value|, the bf16 cross caches
  (``ek``/``ev``) within ``CACHE_TOL``, and decode leaves them as
  prefill wrote them, bit for bit.  jamba runs on the reference's weights
  cast to fp32, held within ``FP32_TOL`` (logits and state): in bf16
  the two packages' activations, an ulp apart after the Mamba layers,
  break its router's near ties apart at margins up to 1.8e-3 (measured;
  a fifth of its (token, layer) pairs lie that near with 8 experts), so
  no batch row would keep its state clear of a flip.  In fp32 no top-k
  set flipped at the smallest margin seen, 4.7e-5; a position within
  ``ROUTE_TIE`` of a tie is left out all the same, and with it the state
  of its batch row.  jamba in bf16 is held with the reference's own
  routing replayed into the port (``moe_route(idx=...)``), under the
  bf16 bounds of the other configs.
* One loss and its gradients for reduced falcon-mamba against
  ``jax.value_and_grad``, under ``tests/test_torch_train.py``'s fp32
  bounds (weights cast to fp32); the batch shifted by one token must fail
  them.  Per-layer remat changes no bit of the gradients.
* ``make_batch`` of an encoder-decoder config gives the reference's bits
  on one seed.

Tolerance rule (as for the MoE): twice the largest reading, rounded up
to one significant digit.  Readings: the fp32 scan's state 1.07e-7
(``SCAN_H_TOL`` fp32 1e-6, one step of 2^-20 above it), the bf16 scan's
0.0097 (bf16 products in another order: 2e-2); ``y`` and the conv tail
read 0 (the same bits), and ``SCAN_Y_TOL`` allows one bf16 ulp.  The
models keep the bounds of the other model tests (``LOGIT_TOL``,
``CACHE_TOL``): falcon-mamba's logits read 0, whisper's logits and
caches 0.0027-0.0081, jamba's fp32 logits and caches at most 1.2e-6
(``FP32_TOL`` 1e-5).
"""

from __future__ import annotations

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import get_config as jget_config
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.configs.base import SHAPES, ModelConfig, get_config
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.train.step import value_and_grad
from repro_torch.tree import flatten_with_path

ARCHS = ("falcon_mamba_7b", "jamba_15_large", "whisper_tiny")
SCAN_Y_TOL = 2.0 ** -8  # of the largest |value|: one bf16 ulp
SCAN_H_TOL = {"fp32": 1e-6, "bf16": 2e-2}  # of the largest |h|
SPREAD_TOL = 0.1  # drawn leaves: |std / scale - 1|
LOGIT_TOL = 2e-2  # of the largest |logit|
CACHE_TOL = 2e-2  # bf16 caches: atol = rtol; the fp32 state: of its max
GRAD_TOL = 2e-6   # fp32 weights: tests/test_torch_train.py's bound
LOSS_TOL = 1e-3   # fp32 weights, of |loss|: the same file's
# jamba in fp32: the packages' router logits agree to ~1e-7 (logits read
# 6e-7 of the largest), so a near tie is a margin under 100x that
ROUTE_TIE = 1e-5
MAX_TIED = 0.1
FP32_TOL = 1e-5  # jamba's logits and state, fp32 weights: of the largest
B, P, STEPS = 2, 72, 3
SLOT, STATE, CROSS = ("k", "v"), ("h", "conv"), ("ek", "ev")


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got: torch.Tensor, want) -> float:
    want = _np(want)
    return float(np.abs(got.float().detach().numpy() - want).max()
                 / np.abs(want).max())


def _close(got: torch.Tensor, want, tol: float, rtol: float | None = None
           ) -> None:
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _bits(t) -> np.ndarray:
    a = t.view(torch.int16).numpy() if torch.is_tensor(t) \
        and t.dtype == torch.bfloat16 else np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _host(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jget_config(arch).reduced())


# ----------------------------------------------------------------- Mamba ---
def _ssm_configs(dtype: str) -> tuple[JConfig, ModelConfig]:
    kw = dict(name="t", family="ssm", n_layers=2, d_model=64, n_heads=0,
              n_kv_heads=0, d_ff=0, vocab_size=256, ssm_state=8,
              d_inner=32, dt_rank=4, ssm_compute_dtype=dtype)
    return JConfig(**kw), ModelConfig(**kw)


def _reference_mamba(x, p, cfg, split: int, steps: int):
    """The reference's scan of all of ``x``, its scan of ``x[:, split:]``
    continued from the state after ``x[:, :split]``, and ``steps`` decode
    steps from zero."""
    whole = JL.mamba_scan(x, p, cfg)
    _, h1, c1 = JL.mamba_scan(x[:, :split], p, cfg)
    cont = JL.mamba_scan(x[:, split:], p, cfg, h0=h1, conv_state=c1)
    h = jnp.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state), jnp.float32)
    conv = jnp.zeros((x.shape[0], cfg.ssm_conv - 1, cfg.d_inner),
                     jnp.float32)
    for t in range(steps):
        y, h, conv = JL.mamba_step(x[:, t:t + 1], p, cfg, h, conv)
    return whole, (h1, c1), cont, (y, h, conv)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mamba_scan_and_step_match_reference(dtype):
    jcfg, tcfg = _ssm_configs(dtype)
    jp = JL.mamba_init(jax.random.PRNGKey(0), jcfg)
    tp = api.params_from_numpy(_host(jp), "cpu")
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 100, 64), jnp.bfloat16)
    tx = api._tensor(np.asarray(x), "cpu")
    split, steps = 40, 5
    whole, (h1, c1), cont, step = jax.jit(functools.partial(
        _reference_mamba, cfg=jcfg, split=split, steps=steps))(x, jp)

    def held(got, want):
        (y, h, conv), (jy, jh, jconv) = got, want
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        assert tuple(h.shape) == jh.shape and tuple(conv.shape) == jconv.shape
        assert _rel(y, jy) <= SCAN_Y_TOL and _rel(conv, jconv) <= SCAN_Y_TOL
        assert _rel(h, jh) <= SCAN_H_TOL[dtype]

    assert 100 % L.SSM_CHUNK  # a short last chunk
    held(L.mamba_scan(tx, tp, tcfg), whole)
    held(L.mamba_scan(tx[:, split:], tp, tcfg,
                      h0=api._tensor(np.asarray(h1), "cpu"),
                      conv_state=api._tensor(np.asarray(c1), "cpu")), cont)
    h = torch.zeros(2, jcfg.d_inner, jcfg.ssm_state)
    conv = torch.zeros(2, jcfg.ssm_conv - 1, jcfg.d_inner)
    for t in range(steps):
        y, h, conv = L.mamba_step(tx[:, t:t + 1], tp, tcfg, h, conv)
    held((y, h, conv), step)


def test_mamba_init_follows_the_reference_rules():
    jcfg, tcfg = _ssm_configs("fp32")
    jcfg = dataclasses.replace(jcfg, d_inner=512, dt_rank=32, d_model=256)
    tcfg = dataclasses.replace(tcfg, d_inner=512, dt_rank=32, d_model=256)
    want = _host(JL.mamba_init(jax.random.PRNGKey(0), jcfg))
    got = L.mamba_init(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert (t.dtype == torch.float32) == (name in L.MAMBA_FP32), name
    for name in ("A_log", "dt_bias", "D_skip", "conv_b"):
        assert np.array_equal(got[name].numpy(), want[name]), name
    for name, scale in (("conv_w", 0.1), ("dt_proj", 0.1), ("in_proj", 0.02),
                        ("x_proj", 0.02), ("out_proj", 0.02)):
        spread = float(got[name].float().std())
        assert abs(spread / scale - 1) <= SPREAD_TOL, (name, spread)
        assert abs(float(np.std(want[name].astype(np.float32))) / scale
                   - 1) <= SPREAD_TOL, name
    # the model's init makes every stacked leaf by the same rule
    model = api.get_model(get_config("falcon_mamba_7b").reduced())
    mixer = model.init(torch.Generator().manual_seed(0))["layers"]["mixer"]
    assert np.array_equal(mixer["A_log"].numpy(), np.broadcast_to(
        np.asarray(jnp.log(jnp.arange(1, 17, dtype=jnp.float32))),
        (2, 256, 16)))
    assert bool((mixer["dt_bias"] == L.DT_BIAS).all())


# -------------------------------------------------------- reduced models ---
def _reduced_config(cfg):
    """jamba at one group of its pattern (see the module docstring)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every)
    return cfg


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    """A reduced config: the reference's model, its own params as numpy
    (``own``) and the params both packages run (``host``: the same, or
    cast to fp32 for jamba), the port's model, and the tolerances of the
    logits and the state."""
    jcfg = _reduced_config(jget_config(request.param).reduced())
    jmodel = japi.get_model(jcfg, remat=False)
    own = host = _host(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tcfg = _reduced_config(get_config(request.param).reduced())
    tol = (LOGIT_TOL, CACHE_TOL)
    if tcfg.n_experts:
        host = jax.tree.map(lambda a: a.astype(np.float32), own)
        tol = (FP32_TOL, FP32_TOL)
    return types.SimpleNamespace(
        arch=request.param, jmodel=jmodel, own=own, host=host,
        jparams=jax.tree.map(jnp.asarray, host), tcfg=tcfg,
        tmodel=api.get_model(tcfg, remat=False), tol=tol)


def _batches(cfg, tokens, rng) -> tuple[dict, dict]:
    """The same batch for both packages: tokens, and for an
    encoder-decoder frames as long as the prompt."""
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if cfg.family == "encdec":
        frames = rng.normal(size=tokens.shape + (cfg.d_model,)).astype(
            np.float32)
        jb["frames"] = jnp.asarray(frames, jnp.bfloat16)
        tb["frames"] = torch.from_numpy(frames).to(torch.bfloat16)
    return jb, tb


def _routed(tmodel, run):
    """``run()`` under ``no_grad`` with the MoE routing logged -> (its
    result, the (B, S) mask of positions at least ``ROUTE_TIE`` from a
    tie in every MoE layer; None without MoE)."""
    tmodel.moe_log = []
    try:
        with torch.no_grad():
            out = run()
        log = tmodel.moe_log
    finally:
        tmodel.moe_log = None
    if not log:
        return out, None
    return out, torch.stack([m for _, _, m in log]).amin(0) >= ROUTE_TIE


def test_weight_carry_is_bit_exact(reduced):
    arch, tcfg, tmodel = reduced.arch, reduced.tcfg, reduced.tmodel
    params = api.params_from_numpy(reduced.own, "cpu")
    want = jax.tree_util.tree_flatten_with_path(reduced.own)[0]
    got = flatten_with_path(params)
    shapes = flatten_with_path(tmodel.param_shapes())
    assert len(got) == len(want) == len(shapes)
    for (_, a), (path, t), (_, spec) in zip(want, got, shapes):
        assert tuple(t.shape) == a.shape == spec.shape, path
        assert t.dtype == spec.dtype, path
        assert np.array_equal(_bits(t), _bits(a)), path
    if arch == "whisper_tiny":  # pad slots zero in the port's own init
        own = tmodel.init(torch.Generator().manual_seed(0))
        hm = L.head_mask(tcfg)
        for stack, name in (("enc_layers", "attn"),
                            ("dec_layers", "cross_attn")):
            wq = own[stack][name]["wq"]
            assert not wq[:, :, hm == 0].any() and wq[:, :, hm == 1].any()


def test_forward_matches_reference(reduced):
    r = reduced
    jmodel, jparams, tcfg, tmodel = r.jmodel, r.jparams, r.tcfg, r.tmodel
    logit_tol = r.tol[0]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, 24))
    jb, tb = _batches(tcfg, toks, rng)
    want = _np(jax.jit(jmodel.forward)(jparams, jb))
    params = api.params_from_numpy(r.host, "cpu")
    got, untied = _routed(tmodel, lambda: tmodel.forward(params, tb))
    assert got.shape == want.shape == (B, 24, tcfg.vocab_size)
    err = np.abs(got.float().numpy() - want).max(-1) / np.abs(want).max()
    if untied is not None:
        assert float(untied.float().mean()) >= 1 - MAX_TIED
        err = err[untied.numpy()]
    assert err.max() <= logit_tol


def test_prefill_and_decode_match_reference(reduced):
    r = reduced
    jmodel, jparams, tcfg, tmodel = r.jmodel, r.jparams, r.tcfg, r.tmodel
    logit_tol, state_tol = r.tol
    tparams = api.params_from_numpy(r.host, "cpu")
    rng = np.random.default_rng(5)
    T = P + STEPS
    toks = rng.integers(0, tcfg.vocab_size, size=(B, P))
    jb, tb = _batches(tcfg, toks, rng)
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=T))(
        jparams, jb)
    (tlog, tcache), untied = _routed(
        tmodel, lambda: tmodel.prefill(tparams, tb, cache_len=T))
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        assert tcache[name].shape == jcache[name].shape, name
        assert _bits(tcache[name][:0]).dtype == _bits(np.asarray(
            jcache[name][:0])).dtype, name
    masks = [torch.ones(B, P, dtype=torch.bool) if untied is None
             else untied]
    assert float(masks[0].float().mean()) >= 1 - MAX_TIED
    scale = float(jnp.max(jnp.abs(jlog.astype(jnp.float32))))
    rows = masks[0][:, -1].numpy()
    _close(tlog[rows], _np(jlog)[rows], logit_tol * scale, rtol=0)
    cross = {name: tcache[name].clone() for name in CROSS if name in tcache}
    for name in cross:
        _close(cross[name], jcache[name], CACHE_TOL)

    decode = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, tcfg.vocab_size, size=(STEPS, B, 1))
    for i in range(STEPS):
        jlog, jcache = decode(jparams, jcache,
                              jnp.asarray(feed[i], jnp.int32),
                              jnp.int32(P + i))
        (tlog, tcache), untied = _routed(tmodel, lambda: tmodel.decode_step(
            tparams, tcache, torch.from_numpy(feed[i]), P + i))
        masks.append(torch.ones(B, 1, dtype=torch.bool) if untied is None
                     else untied)
        rows = masks[-1][:, 0].numpy()
        _close(tlog[rows], _np(jlog)[rows], logit_tol * scale, rtol=0)
    where = torch.cat(masks, dim=1).numpy()
    for name in set(SLOT) & set(tcache):
        _close(tcache[name][:, where], _np(jcache[name])[:, where],
               CACHE_TOL)
    rows = where.all(axis=1)  # the state of a row holds all its tokens
    assert rows.any()
    for name in STATE:
        if name not in tcache:
            continue
        got = tcache[name].flatten(0, -4)[:, rows]  # (layers, rows, ...)
        want = _np(jcache[name]).reshape(got.shape[0], B,
                                         *got.shape[2:])[:, rows]
        for layer in range(got.shape[0]):
            err = np.abs(got[layer].numpy() - want[layer]).max()
            assert err <= state_tol * np.abs(want[layer]).max(), (name,
                                                                  layer)
    for name in cross:  # decode leaves them as prefill wrote them
        assert torch.equal(tcache[name], cross[name])


def test_bf16_hybrid_with_the_reference_routing_replayed():
    """jamba in bf16, its weights as drawn: each MoE layer's top-k sets
    in the reference (``jax.lax.top_k``, wrapped for the test with a
    ``jax.debug.callback`` that hands them out as they are computed) are
    replayed into the port through ``layers.moe_route(idx=...)``; no near
    tie can then route the two packages apart.  Prefill and 3 decode steps: logits
    within ``LOGIT_TOL`` of their largest value, the slot caches within
    ``CACHE_TOL``, the SSM state within ``CACHE_TOL`` of each layer's
    largest |value| (the bf16 bounds of the other configs, stated before
    the first run).  Controls that must fail the same bounds: the last
    step's state and logits against the reference's one step earlier.
    Readings: logits at most 0.0126, the state 0.0116 (``h``) and 0.0117
    (``conv``), the slot caches 0; the controls 1.41 and 0.48."""
    jcfg = _reduced_config(jget_config("jamba_15_large").reduced())
    jmodel = japi.get_model(jcfg, remat=False)
    own = _host(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tcfg = _reduced_config(get_config("jamba_15_large").reduced())
    tmodel = api.get_model(tcfg, remat=False)
    rng = np.random.default_rng(7)
    S, T = 24, 24 + STEPS
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S))
    feed = rng.integers(0, tcfg.vocab_size, size=(STEPS, B, 1))

    chosen, top_k = [], jax.lax.top_k

    def recorded(x, k):  # each top-k set, in the order the layers run
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: chosen.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx
    jparams = jax.tree.map(jnp.asarray, own)
    jouts = []
    jax.lax.top_k = recorded
    try:
        jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(
            p, b, cache_len=T))(jparams,
                                {"tokens": jnp.asarray(toks, jnp.int32)})
        jouts.append((_np(jlog), jax.tree.map(_np, jcache)))
        decode = jax.jit(jmodel.decode_step)
        for i in range(STEPS):
            jlog, jcache = decode(jparams, jcache,
                                  jnp.asarray(feed[i], jnp.int32),
                                  jnp.int32(S + i))
            jouts.append((_np(jlog), jax.tree.map(_np, jcache)))
        jax.effects_barrier()
    finally:
        jax.lax.top_k = top_k
    n_moe = len(chosen) // (1 + STEPS)
    assert n_moe == 4 and len(chosen) == n_moe * (1 + STEPS)

    route, replayed = L.moe_route, []

    def replay(xg, router, cfg, idx=None):
        want = torch.from_numpy(chosen[len(replayed)].astype(np.int64))
        assert idx is None and want.shape == (*xg.shape[:2],
                                              cfg.experts_per_token)
        replayed.append(want)
        return route(xg, router, cfg, idx=want)
    tparams = api.params_from_numpy(own, "cpu")
    touts = []
    L.moe_route = replay
    try:
        with torch.no_grad():
            tlog, tcache = tmodel.prefill(
                tparams, {"tokens": torch.from_numpy(toks)}, cache_len=T)
            touts.append((tlog.float().numpy(), {
                k: v.float().clone().numpy() for k, v in tcache.items()}))
            for i in range(STEPS):
                tlog, tcache = tmodel.decode_step(
                    tparams, tcache, torch.from_numpy(feed[i]), S + i)
                touts.append((tlog.float().numpy(), {
                    k: v.float().clone().numpy() for k, v in tcache.items()}))
    finally:
        L.moe_route = route
    assert len(replayed) == len(chosen)

    def logit_err(got, want):
        return np.abs(got - want).max() / np.abs(want).max()

    def state_err(got, want):  # per layer, of its largest |value|
        got, want = got.reshape(-1, *got.shape[-3:]), \
            want.reshape(-1, *want.shape[-3:])
        return max(np.abs(g - w).max() / np.abs(w).max()
                   for g, w in zip(got, want))
    for (tl, tc), (jl, jc) in zip(touts, jouts):
        assert logit_err(tl, jl) <= LOGIT_TOL
        for name in SLOT:
            np.testing.assert_allclose(tc[name], jc[name], rtol=CACHE_TOL,
                                       atol=CACHE_TOL)
        for name in STATE:
            assert state_err(tc[name], jc[name]) <= CACHE_TOL, name
    # the controls: one step off must fail the bounds
    assert logit_err(touts[-1][0], jouts[-2][0]) > LOGIT_TOL
    assert state_err(touts[-1][1]["h"], jouts[-2][1]["h"]) > CACHE_TOL


# ---------------------------------------------------- loss and gradients ---
@pytest.fixture(scope="module")
def mamba_grads():
    """Reduced falcon-mamba: the reference's own params cast to fp32, a
    batch from a seed, and the reference's loss and gradients."""
    cfg = jget_config("falcon_mamba_7b").reduced()
    jmodel = japi.get_model(cfg, remat=False)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        jmodel.init)(jax.random.PRNGKey(0)))
    shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=80)
    toks = np.asarray(japi.make_batch(cfg, shape, np.random.default_rng(0),
                                      batch_override=2)["tokens"])
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, host), {"tokens": jnp.asarray(toks)})
    return host, toks, float(loss), _host(grads)


def _grad_errors(host, tokens, jgrads) -> tuple[float, dict]:
    model = api.get_model(get_config("falcon_mamba_7b").reduced(),
                          remat=False)
    loss, grads = value_and_grad(model, api.params_from_numpy(host, "cpu"),
                                 {"tokens": torch.from_numpy(tokens.copy())})
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = flatten_with_path(grads)
    assert len(jflat) == len(tflat)
    err = {}
    for (_, a), (path, t) in zip(jflat, tflat):
        a = a.astype(np.float32)
        err["/".join(path)] = float(np.abs(a - t.float().numpy()).max()
                                    / np.abs(a).max())
    return float(loss), err


def test_mamba_loss_and_gradients_match_reference(mamba_grads):
    host, toks, want, jgrads = mamba_grads
    loss, err = _grad_errors(host, toks, jgrads)
    assert abs(loss - want) <= LOSS_TOL * abs(want)
    assert max(err.values()) <= GRAD_TOL, err
    # control: the batch shifted by one token must fail the tolerance
    _, shifted = _grad_errors(host, np.roll(toks, 1, axis=1), jgrads)
    assert max(shifted.values()) > 10 * GRAD_TOL, shifted


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_of_the_mamba_stack_changes_no_bit(policy):
    cfg = get_config("falcon_mamba_7b").reduced()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(1))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 70)))}
    want = value_and_grad(api.get_model(cfg, remat=False), params, batch)
    got = value_and_grad(api.get_model(cfg, remat=True, remat_policy=policy),
                         params, batch)
    assert torch.equal(got[0], want[0])
    for (path, a), (_, b) in zip(flatten_with_path(got[1]),
                                 flatten_with_path(want[1])):
        assert torch.equal(a, b), path


# ------------------------------------------------------------ make_batch ---
def test_make_batch_of_an_encdec_config_matches_reference():
    jcfg = jget_config("whisper_tiny").reduced()
    want = japi.make_batch(jcfg, dataclasses.replace(
        JSHAPES["train_4k"], seq_len=16), np.random.default_rng(3),
        batch_override=2)
    got = api.make_batch(get_config("whisper_tiny").reduced(),
                         dataclasses.replace(SHAPES["train_4k"], seq_len=16),
                         np.random.default_rng(3), batch_override=2,
                         device="cpu")
    assert sorted(got) == sorted(want) == ["frames", "tokens"]
    assert got["frames"].dtype == torch.bfloat16
    assert got["frames"].shape == (2, 16, jcfg.d_model)
    for name in ("tokens", "frames"):
        assert np.array_equal(_bits(got[name]), _bits(np.asarray(
            want[name])))
