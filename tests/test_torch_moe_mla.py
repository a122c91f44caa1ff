"""The port's MoE FFN, MLA attention and patch inputs -- and the configs
that use them, granite-moe-1b, deepseek-v2-236b and phi-3-vision --
against the JAX reference on the same inputs.

* The configs equal the reference's field for field, full and
  ``reduced()``; ``param_count`` and ``active_param_count`` equal the
  reference's for every config (all ten ids).
* ``layers.moe`` on the reference's own cases (``tests/test_layers.py``)
  and on a padded last group under drops (capacity factor 0.05): the
  routing -- experts ``idx`` and ``keep`` -- equals the reference's
  exactly (computed by the reference's own statements), and the output
  is within ``MOE_TOL`` of its largest |value| (bf16 expert products
  rounded in another order).
* ``mla_latent``, the naive and the absorbed attention, on both query
  branches (``wdq`` / ``q_norm`` / ``wuq``, and ``wq`` where
  ``q_lora_rank`` is 0), within ``MLA_TOL`` of the largest |value|.
* The reduced configs from the reference's own ``init(PRNGKey(0))``:
  the weight carry bit for bit, the forward's logits, prefill and 3
  decode steps (phi-3-vision with patches prepended) as
  ``tests/test_torch_dense_configs.py`` holds its configs: logits within
  ``LOGIT_TOL`` of their largest value, the bf16 cache within
  ``CACHE_TOL``.  A position whose top-k set lies within ``ROUTE_TIE``
  of a tie in the port's router (the two packages may break it apart:
  measured margins of the positions that did, 1.3e-4 and 2.0e-4) is left
  out, and at most ``MAX_TIED`` of them may be.
* One loss and its gradients for reduced deepseek-v2 (MoE and MLA)
  against ``jax.value_and_grad``, under ``tests/test_torch_train.py``'s
  fp32 bounds (largest reading 1.02e-6); the batch shifted by one token
  must fail them.  The case runs on the weights cast to fp32: in bf16
  the two packages' activations lie an ulp apart and break a near tie of
  the router differently (a token of 128 did, at a margin of 1.4e-4),
  which moves a whole token's gradient from one expert's weights to
  another's (0.35 of the leaf's largest value).
* ``make_batch`` of a VLM config gives the reference's bits on one seed;
  per-layer remat of the MoE and MLA model changes no bit of the
  gradients.

Tolerance rule for ``MOE_TOL`` (as for the flash gate): twice the
largest reading, rounded up to one significant digit; readings 0.0050 to
0.0075 (the top-2 case).  MLA read 0 (the same bits) on every function
of both branches; ``MLA_TOL`` allows one bf16 ulp of the largest
value.
"""

from __future__ import annotations

import dataclasses
import functools

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
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      get_config)
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.train.step import value_and_grad
from repro_torch.tree import flatten_with_path

ARCHS = ("granite_moe_1b", "deepseek_v2_236b", "phi3_vision_4b")
MOE_TOL = 2e-2   # of the largest |y|
MLA_TOL = 2.0 ** -8  # of the largest |value|: one bf16 ulp
LOGIT_TOL = 2e-2  # of the largest |logit|
CACHE_TOL = 2e-2  # bf16, atol = rtol
GRAD_TOL = 2e-6   # fp32 weights: tests/test_torch_train.py's bound
LOSS_TOL = 1e-3   # fp32 weights, of |loss|: the same file's
B, P, STEPS = 2, 72, 3
# A top-k set whose k-th router logit lies less than this above the next
# is a near tie: the two packages' bf16 activations, an ulp apart, move a
# logit by ~1e-4, so the reference may break it the other way.  Such
# positions are left out of the model comparisons (their routing, and so
# their output, may differ); at most MAX_TIED of the positions may be.
ROUTE_TIE = 1e-3
MAX_TIED = 0.1


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


def _specs(tree) -> list:
    """[(path, shape, dtype)] of a parameter tree."""
    return [(path, tuple(t.shape), t.dtype)
            for path, t in flatten_with_path(tree)]


def _configs(**kw) -> tuple[JConfig, ModelConfig]:
    base = dict(name="t", family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=128, vocab_size=256)
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


# --------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jget_config(arch).reduced())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()


# ------------------------------------------------------------------- MoE ---
def _reference_routing(xg, router, cfg):
    """The reference's ``moe`` routing statements (idx and keep per
    slot), run on the reference's side."""
    E, K = cfg.n_experts, cfg.experts_per_token
    G, M, _ = xg.shape
    logits = xg.astype(jnp.float32) @ router.astype(jnp.float32)
    _, idx = jax.lax.top_k(logits, K)
    C = max(1, int(np.ceil(M * K * cfg.capacity_factor / E)))
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, K * M, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(
        G, K, M, E).transpose(0, 2, 1, 3)
    return idx, ((pos < C) & (onehot > 0)).any(-1)


def _reference_moe(x, p, cfg, M: int):
    """The reference's MoE output and its routing of the padded groups
    of ``x``."""
    N = x.shape[0] * x.shape[1]
    xg = jnp.pad(x.reshape(N, -1), ((0, (-N) % M), (0, 0))).reshape(
        -1, M, x.shape[-1])
    return (JL.moe(x, p, cfg),) + _reference_routing(xg, p["router"], cfg)


MOE_CASES = {
    # tests/test_layers.py's cases: top-2 at capacity 4, capacity drops,
    # top-1 on a permutation-equivariance group
    "top2_uniform_capacity": (dict(n_experts=4, experts_per_token=2,
                                   moe_d_ff=32, moe_group_size=16,
                                   capacity_factor=4.0), (2, 8)),
    "capacity_drops": (dict(n_experts=2, experts_per_token=1, moe_d_ff=32,
                            moe_group_size=32, capacity_factor=0.05),
                       (1, 32)),
    "top1_permutation": (dict(n_experts=4, experts_per_token=1, moe_d_ff=32,
                              moe_group_size=8, capacity_factor=8.0),
                         (1, 8)),
    # 21 tokens in groups of 16: the last group holds 11 zero pad rows,
    # whose slot 0 takes expert 0's only place ahead of any real slot 1
    "padded_group_drops": (dict(n_experts=8, experts_per_token=2,
                                moe_d_ff=32, moe_group_size=16,
                                capacity_factor=0.05, n_shared_experts=2),
                           (3, 7)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_routing_exact_and_output_matches_reference(case):
    kw, (b, s) = MOE_CASES[case]
    jcfg, tcfg = _configs(**kw)
    jp = JL.moe_init(jax.random.PRNGKey(0), jcfg)
    assert _specs(L.moe_init(torch.Generator().manual_seed(0), tcfg)) == \
        _specs(api.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    x = jax.random.normal(jax.random.PRNGKey(1), (b, s, 64), jnp.bfloat16)
    N, M = b * s, min(jcfg.moe_group_size, b * s)
    want, idx, keep = jax.jit(functools.partial(
        _reference_moe, cfg=jcfg, M=M))(x, jp)
    idx, keep = np.asarray(idx), np.asarray(keep)
    tx = api._tensor(np.asarray(x), "cpu")
    log = []
    got = L.moe(tx, api.params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu"), tcfg, log)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, 64)
    assert _rel(got, want) <= MOE_TOL

    xg = torch.cat([tx.reshape(N, 64), tx.new_zeros((-N) % M, 64)])
    r = L.moe_route(xg.reshape(-1, M, 64),
                    api._tensor(np.asarray(jp["router"]), "cpu"), tcfg)
    assert np.array_equal(r.idx.numpy(), idx)
    assert np.array_equal(r.keep.numpy(), keep)
    # the log holds the real tokens' rows of the same routing
    (log_idx, log_keep, margin), = log
    assert margin.shape == (b, s) and bool((margin >= 0).all())
    K = tcfg.experts_per_token
    assert np.array_equal(log_idx.numpy(),
                          idx.reshape(-1, K)[:N].reshape(b, s, K))
    assert np.array_equal(log_keep.numpy(),
                          keep.reshape(-1, K)[:N].reshape(b, s, K))
    if case == "padded_group_drops":
        # pad rows tie on all experts and take 0..K-1 first, and their
        # places push real tokens out of capacity
        pad = idx.reshape(-1, K)[N:]
        assert (pad == np.arange(K)).all() and keep.reshape(-1, K)[N:].any()
        assert not keep.reshape(-1, K)[:N].all()


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_route_takes_replayed_choices(case):
    """``moe_route(idx=...)`` with its own top k gives its routing back
    bit for bit; with other experts it takes them, gated by the softmax
    of their own logits, each in a queue place of its own."""
    kw, (b, s) = MOE_CASES[case]
    _, tcfg = _configs(**kw)
    gen = torch.Generator().manual_seed(2)
    M, E = min(tcfg.moe_group_size, b * s), tcfg.n_experts
    xg = torch.randn((-(-b * s // M), M, 64), generator=gen)
    router = torch.randn((64, E), generator=gen)
    r = L.moe_route(xg, router, tcfg)
    again = L.moe_route(xg, router, tcfg, idx=r.idx)
    for field in ("idx", "gates", "pos", "keep", "margin"):
        assert torch.equal(getattr(again, field), getattr(r, field)), field
    other = (r.idx + 1) % E
    o = L.moe_route(xg, router, tcfg, idx=other)
    assert torch.equal(o.idx, other) and torch.equal(o.margin, r.margin)
    assert torch.equal(o.gates, torch.softmax(
        (xg @ router).gather(-1, other), dim=-1))
    place = (o.idx * b * s * tcfg.experts_per_token + o.pos).flatten(1)
    assert all(len(set(row.tolist())) == row.numel() for row in place)


def test_serve_check_replays_the_serves_routing():
    """``chip_smoke.replayed_routing`` routes a prefill's MoE layers as
    a serve's log says, also where the log chose other experts than the
    prefill would, yields the prefill's own routing, and puts
    ``moe_route`` back after the block."""
    import chip_smoke
    cfg = dataclasses.replace(get_config("granite_moe_1b").reduced(),
                              n_layers=2)
    model = api.get_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 12)))
    n, P, E = 3, 10, cfg.n_experts
    model.moe_log = []
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens[:, :P]})
        for i in range(n - 1):
            model.prefill(params, {"tokens": tokens[:, :P + i + 1]})
    # the prefill over all P+n-1 positions: (idx, margin) a layer
    natural = [(idx, margin) for idx, _, margin in model.moe_log[-2:]]
    # the serve's log: the prompt's routing, then one token a step; the
    # second step's token at layer 1 sent to other experts
    serve_log = [(idx[:, :P], None, margin[:, :P])
                 for idx, margin in natural]
    for i in range(n - 1):
        for idx, margin in natural:
            one = idx[:, P + i:P + i + 1].clone()
            if i == 1 and idx is natural[1][0]:
                one = (one + 1) % E
            serve_log.append((one, None, margin[:, P + i:P + i + 1]))
    natural = [idx for idx, _ in natural]
    route = L.moe_route
    model.moe_log = []
    with torch.no_grad(), chip_smoke.replayed_routing(
            serve_log, n, P + n - 1) as own:
        model.prefill(params, {"tokens": tokens[:, :P + n - 1]})
    assert L.moe_route is route
    got = [entry[0] for entry in model.moe_log]
    assert torch.equal(got[0], natural[0])
    assert torch.equal(got[1][:, :P + 1], natural[1][:, :P + 1])
    assert torch.equal(got[1][:, P + 1], (natural[1][:, P + 1] + 1) % E)
    assert all(torch.equal(o[0], w) for o, w in zip(own, natural))
    flips = chip_smoke.routing_flips(serve_log, own, P, n)
    assert flips["routing_pairs"] == 2 * 2 * (n - 1)
    assert flips["routing_flips"] == 2 and flips["prompt_routing_flips"] == 0


# ------------------------------------------------------------------- MLA ---
def _reference_mla(x, p, positions, cfg):
    """The reference's latent, its naive attention over all positions,
    and its absorbed attention of the last query against the bf16 latent
    cache of all of them."""
    c, kr = JL.mla_latent(x, p, cfg, positions)
    naive = JL.mla_attend_naive(x, p, cfg, c=c, k_rope=kr, q_pos=positions,
                                kv_pos=positions)
    absorbed = JL.mla_attend_absorbed(
        x[:, -1:], p, cfg, c=c.astype(jnp.bfloat16),
        k_rope=kr.astype(jnp.bfloat16), q_pos=positions[-1:],
        kv_pos=positions)
    return c, kr, naive, absorbed


@pytest.mark.parametrize("q_lora_rank", [24, 0], ids=["wdq", "wq"])
def test_mla_latent_naive_and_absorbed_match_reference(q_lora_rank):
    jcfg, tcfg = _configs(use_mla=True, kv_lora_rank=32,
                          q_lora_rank=q_lora_rank, qk_nope_head_dim=32,
                          qk_rope_head_dim=16, v_head_dim=24)
    jp = JL.mla_init(jax.random.PRNGKey(0), jcfg)
    tp = api.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert ("wdq" in tp) == bool(q_lora_rank) and ("wq" in tp) != bool(
        q_lora_rank)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        L.mla_shapes(tcfg)
    assert _specs(L.mla_init(torch.Generator().manual_seed(0), tcfg)) == \
        _specs(tp)
    S = 12
    x = jax.random.normal(jax.random.PRNGKey(1), (2, S, 64), jnp.bfloat16)
    tx = api._tensor(np.asarray(x), "cpu")
    pos = jnp.arange(S)
    tpos = torch.arange(S)
    jc, jkr, jnaive, jabsorbed = jax.jit(functools.partial(
        _reference_mla, cfg=jcfg))(x, jp, pos)
    tc, tkr = L.mla_latent(tx, tp, tcfg, tpos)
    assert _rel(tc, jc) <= MLA_TOL and _rel(tkr, jkr) <= MLA_TOL
    got = L.mla_attend_naive(tx, tp, tcfg, c=tc, k_rope=tkr, q_pos=tpos,
                             kv_pos=tpos)
    assert got.dtype == torch.bfloat16 and _rel(got, jnaive) <= MLA_TOL
    # absorbed: the last query against the bf16 latent cache of all S
    got = L.mla_attend_absorbed(
        tx[:, -1:], tp, tcfg, c=tc.to(torch.bfloat16),
        k_rope=tkr.to(torch.bfloat16), q_pos=tpos[-1:], kv_pos=tpos)
    want = jabsorbed
    assert got.dtype == torch.bfloat16 and _rel(got, want) <= MLA_TOL


# -------------------------------------------------------- reduced models ---
@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    """A reduced config: the reference's model and own params, as numpy,
    the port's model over the same params, and for a VLM seeded
    patches."""
    jcfg = jget_config(request.param).reduced()
    jmodel = japi.get_model(jcfg, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    tcfg = get_config(request.param).reduced()
    patches = None
    if jcfg.n_patches:
        patches = np.random.default_rng(4).normal(
            size=(B, jcfg.n_patches, jcfg.d_model)).astype(np.float32)
    return (request.param, jmodel, jparams, host, tcfg,
            api.get_model(tcfg, remat=False), patches)


def _batches(tokens, patches) -> tuple[dict, dict]:
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if patches is not None:
        jb["patches"] = jnp.asarray(patches, jnp.bfloat16)
        tb["patches"] = torch.from_numpy(patches).to(torch.bfloat16)
    return jb, tb


def test_weight_carry_is_bit_exact(reduced):
    _, _, _, host, tcfg, tmodel, _ = reduced
    params = api.params_from_numpy(host, "cpu")
    want = jax.tree_util.tree_flatten_with_path(host)[0]
    got = flatten_with_path(params)
    shapes = flatten_with_path(tmodel.param_shapes())
    assert len(got) == len(want) == len(shapes)
    for (jpath, a), (path, t), (_, spec) in zip(want, got, shapes):
        assert tuple(t.shape) == a.shape == spec.shape, path
        assert t.dtype == spec.dtype, path
        assert np.array_equal(_bits(t), _bits(a)), path
    # the port's own init draws the fp32 router; the norms stay at 0
    own = tmodel.init(torch.Generator().manual_seed(0))
    if tcfg.n_experts:
        router = own["layers"]["ffn"]["router"]
        assert router.dtype == torch.float32 and router.std() > 0.01
    if tcfg.use_mla:
        assert not own["layers"]["attn"]["kv_norm"].any()


def _routed(tmodel, run):
    """``run()`` under ``no_grad`` with the port's MoE routing logged ->
    (its result, the (B, S) mask of positions whose top-k set lies at
    least ``ROUTE_TIE`` from a tie in every MoE layer; None without
    MoE)."""
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


def test_forward_matches_reference(reduced):
    _, jmodel, jparams, host, tcfg, tmodel, patches = reduced
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size,
                                             size=(B, 24))
    jb, tb = _batches(toks, patches)
    want = _np(jax.jit(jmodel.forward)(jparams, jb))
    params = api.params_from_numpy(host, "cpu")
    got, untied = _routed(tmodel, lambda: tmodel.forward(params, tb))
    assert got.shape == want.shape
    assert got.shape[1] == 24 + tcfg.n_patches
    err = np.abs(got.float().numpy() - want).max(-1) / np.abs(want).max()
    if untied is not None:
        assert float(untied.float().mean()) >= 1 - MAX_TIED
        err = err[untied.numpy()]
    assert err.max() <= LOGIT_TOL


def test_prefill_and_decode_match_reference(reduced):
    _, jmodel, jparams, host, tcfg, tmodel, patches = reduced
    tparams = api.params_from_numpy(host, "cpu")
    rng = np.random.default_rng(5)
    S = P + tcfg.n_patches
    T = S + STEPS
    toks = rng.integers(0, tcfg.vocab_size, size=(B, P))
    jb, tb = _batches(toks, patches)
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=T))(
        jparams, jb)
    (tlog, tcache), untied = _routed(
        tmodel, lambda: tmodel.prefill(tparams, tb, cache_len=T))
    names = ("c", "kr") if tcfg.use_mla else ("k", "v")
    assert sorted(tcache) == sorted(jcache) == sorted(names)
    for name in names:
        assert tcache[name].shape == jcache[name].shape
        assert tcache[name].dtype == torch.bfloat16
    masks = [torch.ones(B, S, dtype=torch.bool) if untied is None
             else untied]
    assert float(masks[0].float().mean()) >= 1 - MAX_TIED
    scale = float(jnp.max(jnp.abs(jlog.astype(jnp.float32))))
    rows = masks[0][:, -1].numpy()
    _close(tlog[rows], _np(jlog)[rows], LOGIT_TOL * scale, rtol=0)

    decode = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, tcfg.vocab_size, size=(STEPS, B, 1))
    for i in range(STEPS):
        jlog, jcache = decode(jparams, jcache,
                              jnp.asarray(feed[i], jnp.int32),
                              jnp.int32(S + i))
        (tlog, tcache), untied = _routed(tmodel, lambda: tmodel.decode_step(
            tparams, tcache, torch.from_numpy(feed[i]), S + i))
        masks.append(torch.ones(B, 1, dtype=torch.bool) if untied is None
                     else untied)
        rows = masks[-1][:, 0].numpy()
        _close(tlog[rows], _np(jlog)[rows], LOGIT_TOL * scale, rtol=0)
    # the cache of every position whose routing held clear of a tie
    where = torch.cat(masks, dim=1).numpy()
    for name in names:
        _close(tcache[name][:, where], _np(jcache[name])[:, where],
               CACHE_TOL)


# ---------------------------------------------------- loss and gradients ---
@pytest.fixture(scope="module")
def deepseek_grads():
    """Reduced deepseek-v2 (MoE with shared experts, MLA): the
    reference's own params cast to fp32, a batch from a seed, and the
    reference's loss and gradients."""
    cfg = jget_config("deepseek_v2_236b").reduced()
    jmodel = japi.get_model(cfg, remat=False)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        jmodel.init)(jax.random.PRNGKey(0)))
    shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=32)
    toks = np.asarray(japi.make_batch(cfg, shape, np.random.default_rng(0),
                                      batch_override=4)["tokens"])
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, host), {"tokens": jnp.asarray(toks)})
    return host, toks, float(loss), jax.tree.map(np.asarray, grads)


def _grad_errors(host, tokens, jgrads) -> tuple[float, dict]:
    model = api.get_model(get_config("deepseek_v2_236b").reduced(),
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


def test_moe_mla_loss_and_gradients_match_reference(deepseek_grads):
    host, toks, want, jgrads = deepseek_grads
    loss, err = _grad_errors(host, toks, jgrads)
    assert abs(loss - want) <= LOSS_TOL * abs(want)
    assert max(err.values()) <= GRAD_TOL, err
    # control: the batch shifted by one token must fail the tolerance
    _, shifted = _grad_errors(host, np.roll(toks, 1, axis=1), jgrads)
    assert max(shifted.values()) > 10 * GRAD_TOL, shifted


# ------------------------------------------------------------ make_batch ---
def test_make_batch_of_a_vlm_config_matches_reference():
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16)
    jcfg = jget_config("phi3_vision_4b").reduced()
    want = japi.make_batch(jcfg, dataclasses.replace(
        JSHAPES["train_4k"], seq_len=16), np.random.default_rng(3),
        batch_override=2)
    got = api.make_batch(get_config("phi3_vision_4b").reduced(), shape,
                         np.random.default_rng(3), batch_override=2,
                         device="cpu")
    assert sorted(got) == sorted(want) == ["patches", "tokens"]
    assert got["patches"].dtype == torch.bfloat16
    assert got["patches"].shape == (2, jcfg.n_patches, jcfg.d_model)
    for name in ("tokens", "patches"):
        assert np.array_equal(_bits(got[name]), _bits(np.asarray(
            want[name])))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_of_moe_and_mla_changes_no_bit(policy):
    """Per-layer remat recomputes the MoE's routing, gathers and expert
    products (``"dots"`` keeps only the projections without batch dims):
    the gradients are those of the run without remat, bit for bit."""
    cfg = get_config("deepseek_v2_236b").reduced()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(1))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 16)))}
    want = value_and_grad(api.get_model(cfg, remat=False), params, batch)
    got = value_and_grad(api.get_model(cfg, remat=True, remat_policy=policy),
                         params, batch)
    assert torch.equal(got[0], want[0])
    for (path, a), (_, b) in zip(flatten_with_path(got[1]),
                                 flatten_with_path(want[1])):
        assert torch.equal(a, b), path
