"""The port's dense model, its weight carry and its SEARS checkpoints,
against the JAX reference on the same inputs.

Inputs are made from a seed with numpy (or by the reference's own
``init(PRNGKey(0))``) and handed to both packages as host arrays.
Tolerances: fp32 1e-5 (the same arithmetic, sums in another order); bf16
2e-2 (both packages round to bf16, at places that differ by a rounding
or two); the model's logits are held to 2e-2 of their largest value.
Checkpoint blobs and the weight carry are held bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_config as jget_config
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.checkpoint import serializer as tser
from repro_torch.checkpoint.manager import (CheckpointError,
                                            SEARSCheckpointManager)
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.tree import flatten_with_path

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(arr).astype(_JNP[dtype]),
            torch.from_numpy(np.array(arr)).to(_TORCH[dtype]))


def _close(got: torch.Tensor, want, tol: float, rtol: float | None = None
           ) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol if rtol is None else rtol, atol=tol)


def _cfg_kw() -> dict:
    return dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)


# -------------------------------------------------------------- layers ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_and_mlp_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64), dtype=np.float32)
    w = 0.1 * rng.standard_normal(64, dtype=np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, "float32")
    _close(L.rms_norm(tx, tw), JL.rms_norm(jx, jw), TOL[dtype])
    b = rng.standard_normal(64, dtype=np.float32)
    _close(L.layer_norm(tx, tw, torch.from_numpy(b)),
           JL.layer_norm(jx, jw, jnp.asarray(b)), TOL[dtype])

    heads = rng.standard_normal((2, 9, 4, 32), dtype=np.float32)
    jh, th = _pair(heads, dtype)
    pos = np.arange(100, 109)
    for tpos, jpos in ((torch.from_numpy(pos), jnp.asarray(pos)),
                       (torch.from_numpy(np.stack([pos, pos + 7])),
                        jnp.asarray(np.stack([pos, pos + 7])))):
        _close(L.rope(th, tpos, 500_000.0), JL.rope(jh, jpos, 500_000.0),
               TOL[dtype])

    p = {n: 0.05 * rng.standard_normal(s, dtype=np.float32)
         for n, s in (("wg", (64, 96)), ("wu", (64, 96)), ("wd", (96, 64)))}
    jp = {n: _pair(a, dtype)[0] for n, a in p.items()}
    tp = {n: _pair(a, dtype)[1] for n, a in p.items()}
    for act in ("swiglu", "gelu"):
        _close(L.mlp(tx, tp, act), JL.mlp(jx, jp, act), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path,S,T,window,causal", [
    ("direct", 40, 64, 9, True),    # queries the last S of T, a window
    ("direct", 33, 50, 0, False),
    # two query and two key blocks of 1024, the second ones padded
    ("blockwise", 1100, 1100, 0, True),
])
def test_attention_paths_match_reference(dtype, path, S, T, window, causal):
    rng = np.random.default_rng(1)
    B, H, KV, hd = 1, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    args = dict(window=window, causal=causal, scale=0.25)
    want = getattr(JL, f"_attention_{path}")(
        jq, jk, jv, q_pos=jnp.arange(T - S, T), kv_pos=jnp.arange(T), **args)
    got = getattr(L, f"_attention_{path}")(
        tq, tk, tv, q_pos=torch.arange(T - S, T), kv_pos=torch.arange(T),
        **args)
    assert got.dtype == _TORCH[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_attend_matches_reference(dtype):
    rng = np.random.default_rng(2)
    jcfg, tcfg = JModelConfig(**_cfg_kw()), ModelConfig(**_cfg_kw())
    shapes = L.gqa_shapes(tcfg)
    p = {n: 0.1 * rng.standard_normal(s, dtype=np.float32)
         for n, s in shapes.items()}
    x = rng.standard_normal((2, 12, 64), dtype=np.float32)
    jp = {n: _pair(a, dtype)[0] for n, a in p.items()}
    tp = {n: _pair(a, dtype)[1] for n, a in p.items()}
    jx, tx = _pair(x, dtype)
    jpos, tpos = jnp.arange(12), torch.arange(12)
    jk, jv = JL.gqa_project_kv(jx, jp, jcfg, jpos)
    tk, tv = L.gqa_project_kv(tx, tp, tcfg, tpos)
    _close(tk, jk, TOL[dtype])
    want = JL.gqa_attend(jx, jp, jcfg, k=jk, v=jv, q_pos=jpos, kv_pos=jpos)
    got = L.gqa_attend(tx, tp, tcfg, k=tk, v=tv, q_pos=tpos, kv_pos=tpos)
    _close(got, want, TOL[dtype])


# --------------------------------------------------------------- model ----
@pytest.fixture(scope="module")
def reduced_llama():
    """Reduced llama3.2-1b: the reference's own params, as numpy."""
    cfg = jget_config("llama32_1b").reduced()
    jmodel = japi.get_model(cfg, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    return cfg, jmodel, jparams, host


def test_config_and_param_count_match_reference(reduced_llama):
    jcfg = reduced_llama[0]
    tcfg = get_config("llama32_1b").reduced()
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "rope_theta", "tie_embeddings"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.param_count() == jcfg.param_count()
    full = get_config("llama32_1b")
    assert full.param_count() == jget_config("llama32_1b").param_count()
    shapes = api.get_model(tcfg).param_shapes()
    assert [("/".join(p), tuple(s.shape)) for p, s in
            flatten_with_path(shapes)] == [
        (jser._path_str(p), tuple(a.shape))
        for p, a in jax.tree_util.tree_flatten_with_path(reduced_llama[3])[0]]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no_such_arch")


def test_weight_carry_is_bit_exact(reduced_llama):
    host = reduced_llama[3]
    params = api.params_from_numpy(host, "cpu")
    for (path, a), (_, t) in zip(
            jax.tree_util.tree_flatten_with_path(host)[0],
            flatten_with_path(params)):
        want_dtype = torch.bfloat16 if a.dtype.name == "bfloat16" \
            else torch.from_numpy(np.zeros(1, a.dtype)).dtype
        assert t.dtype == want_dtype and tuple(t.shape) == a.shape, path
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert np.array_equal(bits.numpy(), a.view(np.int16)
                              if a.dtype.name == "bfloat16" else a), path


def test_prefill_and_decode_match_reference(reduced_llama):
    cfg, jmodel, jparams, host = reduced_llama
    tmodel = api.get_model(get_config("llama32_1b").reduced())
    tparams = api.params_from_numpy(host, "cpu")
    rng = np.random.default_rng(0)
    B, P, steps = 2, 24, 4
    T = P + steps
    toks = rng.integers(0, cfg.vocab_size, size=(B, P))
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=T))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tlog, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(toks)}, cache_len=T)
    scale = float(jnp.max(jnp.abs(jlog.astype(jnp.float32))))
    _close(tlog, jlog, 2e-2 * scale, rtol=0)
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape
        _close(tcache[name], jcache[name], 2e-2)

    decode = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab_size, size=(steps, B, 1))
    for i in range(steps):
        jlog, jcache = decode(jparams, jcache, jnp.asarray(feed[i], jnp.int32),
                              jnp.int32(P + i))
        with torch.no_grad():
            tlog, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(feed[i]), P + i)
        _close(tlog, jlog, 2e-2 * scale, rtol=0)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], 2e-2)


def test_fp32_weights_keep_the_bf16_cache_as_the_reference(reduced_llama):
    """fp32 weights: both packages round the cache to bf16 and promote
    the attention output back to fp32.  Logits at 1e-3 of the largest
    (fp32 sums in another order), the cache at the bf16 tolerance."""
    cfg, jmodel, _, host = reduced_llama
    host32 = jax.tree.map(lambda a: a.astype(np.float32), host)
    jparams = jax.tree.map(jnp.asarray, host32)
    tmodel = api.get_model(get_config("llama32_1b").reduced())
    tparams = api.params_from_numpy(host32, "cpu")
    rng = np.random.default_rng(1)
    B, P, steps = 2, 24, 2
    toks = rng.integers(0, cfg.vocab_size, size=(B, P))
    T = P + steps
    jlog, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=T))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tlog, tcache = tmodel.prefill(
            tparams, {"tokens": torch.from_numpy(toks)}, cache_len=T)
    assert jcache["k"].dtype == jnp.bfloat16
    assert tcache["k"].dtype == tcache["v"].dtype == torch.bfloat16
    scale = float(jnp.max(jnp.abs(jlog)))
    _close(tlog, jlog, 1e-3 * scale, rtol=0)
    decode = jax.jit(jmodel.decode_step)
    feed = rng.integers(0, cfg.vocab_size, size=(steps, B, 1))
    for i in range(steps):
        jlog, jcache = decode(jparams, jcache, jnp.asarray(feed[i], jnp.int32),
                              jnp.int32(P + i))
        with torch.no_grad():
            tlog, tcache = tmodel.decode_step(
                tparams, tcache, torch.from_numpy(feed[i]), P + i)
        assert tlog.dtype == torch.float32
        _close(tlog, jlog, 1e-3 * scale, rtol=0)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], 2e-2)


def test_forward_matches_prefill_logits():
    """The full-sequence forward's last position is the prefill's."""
    model = api.get_model(get_config("llama32_1b").reduced())
    params = model.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 9)))
    with torch.no_grad():
        full = model(params, {"tokens": toks})
        last, _ = model.prefill(params, {"tokens": toks})
    torch.testing.assert_close(full[:, -1], last, rtol=0, atol=0)


# ---------------------------------------------------------- checkpoint ----
def _small_tree(seed=0) -> dict:
    """A tree of every leaf kind the checkpoints hold, as numpy."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 128), dtype=np.float32),
            "emb": np.asarray(jnp.asarray(
                rng.standard_normal((1000, 32), dtype=np.float32),
                jnp.bfloat16)),
            "nested": {"b": rng.standard_normal(7, dtype=np.float32),
                       "step": np.int32(3)}}


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_serializers_write_identical_blobs(reduced_llama):
    host = reduced_llama[3]
    for tree in (_small_tree(), host):
        jman, jblobs = jser.serialize(jax.tree.map(jnp.asarray, tree))
        tman, tblobs = tser.serialize(api.params_from_numpy(tree, "cpu"))
        assert list(tblobs) == list(jblobs)
        assert all(tblobs[n] == jblobs[n] for n in jblobs)
        import json
        assert json.loads(tman)["leaves"] == json.loads(jman)["leaves"]


def test_checkpoints_cross_restore_bit_for_bit(reduced_llama):
    host = reduced_llama[3]
    jtree = jax.tree.map(jnp.asarray, host)
    ttree = api.params_from_numpy(host, "cpu")
    # written by the reference, restored by the port
    jman, jblobs = jser.serialize(jtree)
    got = tser.deserialize(jman, jblobs, ttree)
    for (_, a), (_, b) in zip(flatten_with_path(got),
                              flatten_with_path(ttree)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    # written by the port, restored by the reference
    tman, tblobs = tser.serialize(ttree)
    back = jser.deserialize(tman, tblobs, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a).view(np.uint8),
                              np.asarray(b).view(np.uint8))


def test_manager_survives_dead_nodes_and_dedups_steps():
    tree = api.params_from_numpy(_small_tree(), "cpu")
    mgr = SEARSCheckpointManager(node_capacity=1 << 26, engine="numpy")
    s1 = mgr.save(5, tree)
    assert s1["bytes_after_dedup"] > 0
    s2 = mgr.save(6, tree)  # unchanged: fully deduped
    assert s2["bytes_after_dedup"] == 0 and s2["dedup_saving"] == 1.0
    for cluster in mgr.store.clusters:
        cluster.kill_nodes([0, 3, 5, 7, 9])  # n-k = 5 failures per cluster
    out = mgr.restore(tree, step=5)
    for (_, a), (_, b) in zip(flatten_with_path(out),
                              flatten_with_path(tree)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    for cluster in mgr.store.clusters:
        cluster.kill_nodes([1])  # one more: fewer than k pieces remain
    with pytest.raises(CheckpointError):
        mgr.restore(tree)


def test_manager_save_async_snapshots_the_tree():
    tree = api.params_from_numpy(_small_tree(), "cpu")
    mgr = SEARSCheckpointManager(node_capacity=1 << 26, engine="numpy",
                                 keep_last=1)
    want = {n: t.clone() for n, t in (("w", tree["w"]),)}
    mgr.save_async(1, tree)
    tree["w"].add_(1.0)  # a later in-place update must not reach the save
    mgr.wait()
    out = mgr.restore(tree)
    assert torch.equal(out["w"], want["w"])
    mgr.save(2, tree)
    assert mgr.steps() == [2]
    assert not any("/00000001/" in f
                   for f in mgr.store.switching["trainer"].table)
