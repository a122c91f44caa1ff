"""The port's training path against the JAX reference, on the CPU.

Inputs come from a seed with numpy (or from the reference's own
``init(PRNGKey(0))``) and cross as host arrays; the port runs with
``device="cpu"``.  What is held, and how:

* data: ``SyntheticCorpus`` / ``ByteCorpus`` batches and ``host_slice``
  equal the reference's exactly (both are the same numpy code);
* the int8 block quantizer: ``q`` and ``scale`` exact;
* ``optimizer.apply``, three steps on the same master / moments /
  gradients, for both moment dtypes.  Where the gradient norm stays
  under ``grad_clip`` the clip factor is exactly 1 in both, and m, v,
  the int8 ``q`` and ``scale`` and the step are exact; the master copy
  is within ``MASTER_ULP`` units in the last place, because XLA's CPU
  ``sqrt`` is not correctly rounded (one ulp off torch's, at most).
  Where the norm clips, the two norms sum in another order, so every
  fp32 leaf is held at ``CLIPPED_RTOL`` of its largest value; the int8
  ``q`` and ``scale`` stay exact;
* ``TransformerLM.loss`` of reduced llama3.2-1b from carried weights:
  1e-3 x |loss| with fp32 weights, 2e-2 x |loss| with bf16 weights (the
  tolerances of ``tests/test_torch_model.py``);
* per-leaf gradients of autograd against ``jax.value_and_grad`` of the
  reference's loss, each leaf's largest error over its largest |g|,
  within ``GRAD_TOL``; the same batch shifted by one token must fail it;
* the step's invariants: ``remat`` and the ``"dots"`` policy change no
  bit; 2 microbatches match 1 as the reference's
  ``test_trainer_microbatch_equivalence`` holds them (rtol 2e-2);
* the trainer's invariants, as the reference's
  ``tests/test_checkpoint_trainer.py`` and ``tests/test_system.py`` state
  them (the reference's own ``Trainer`` raises on the installed JAX):
  the loss falls, a crash and restart reproduce the uninterrupted run
  bit for bit, int8 moments train, files and a checkpoint in one store
  survive n-k dead nodes in every cluster, an unchanged step dedups;
* train-state checkpoints restore both ways between the packages, bit
  for bit: through the serializers, and saved by one package's
  ``SEARSCheckpointManager`` and restored by the other's.

Tolerance rule for ``MASTER_ULP``, ``CLIPPED_RTOL`` and ``GRAD_TOL`` (as
for the flash gate): twice the largest reading, rounded up to one
significant digit.  Readings: master 4 ulp (fp32 moments, on a tree
with a third leaf of (3, 300); the two leaves kept read 0 and 2 ulp);
clipped 4.10e-9 of the largest value (fp32 moments, ``state/master/a``;
int8 moments read 5.12e-10; m, v, ``q`` and ``scale`` read 0);
gradients 9.6e-7 (fp32 weights) and 0.0111 (bf16 weights), both at
``layers/ffn/wg``; the shifted control reads 1.13.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.checkpoint.manager import SEARSCheckpointManager as JManager
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jdata
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.checkpoint import serializer as tser
from repro_torch.checkpoint.manager import SEARSCheckpointManager
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core.store import SEARSStore
from repro_torch.core.workload import WorkloadConfig, generate_events
from repro_torch.data import pipeline as tdata
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepConfig, build_train_step, \
    value_and_grad
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
MASTER_ULP = 8
CLIPPED_RTOL = 9e-9
GRAD_TOL = {"float32": 2e-6, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _bits(t) -> np.ndarray:
    """Integer view of a tensor's or array's bits (bf16 as int16)."""
    if torch.is_tensor(t):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _pairs(jtree, ttree) -> list:
    """[(path, reference leaf as numpy, port leaf)] in flattening order."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = flatten_with_path(ttree)
    assert [jser._path_str(p) for p, _ in jflat] == \
        ["/".join(map(str, p)) for p, _ in tflat]
    return [("/".join(map(str, p)), np.asarray(a), t)
            for (_, a), (p, t) in zip(jflat, tflat)]


# ----------------------------------------------------------------- data ----
def test_corpora_and_host_slice_match_reference():
    for vocab in (512, 128_256):
        jc = jdata.SyntheticCorpus(jdata.DataConfig(32, 4, vocab, seed=3))
        tc = tdata.SyntheticCorpus(tdata.DataConfig(32, 4, vocab, seed=3))
        for step in (0, 1, 17):
            jb, tb = jc.batch(step), tc.batch(step)
            assert tb["tokens"].dtype == np.int32
            assert np.array_equal(tb["tokens"], jb["tokens"])
            for i in range(2):
                assert np.array_equal(tdata.host_slice(tb, i, 2)["tokens"],
                                      jdata.host_slice(jb, i, 2)["tokens"])
    paths = [str(ROOT / "src/repro/data/pipeline.py"),
             str(ROOT / "src/repro/models/losses.py"),
             str(ROOT / "no-such-file")]
    jb = jdata.ByteCorpus(jdata.DataConfig(64, 3, 200, seed=1), paths)
    tb = tdata.ByteCorpus(tdata.DataConfig(64, 3, 200, seed=1), paths)
    for step in (0, 4):
        assert np.array_equal(tb.batch(step)["tokens"],
                              jb.batch(step)["tokens"])
    with pytest.raises(ValueError, match="empty corpus"):
        tdata.ByteCorpus(tdata.DataConfig(8, 1, 200), [paths[-1]])


# ------------------------------------------------------------ optimizer ----
def test_quantizer_matches_reference_exactly():
    rng = np.random.default_rng(0)
    for shape in ((300,), (2, 5, 513), (4, 1)):
        x = rng.standard_normal(shape, dtype=np.float32)
        x.flat[0] = 0.5 * np.abs(x).max() / 127.0 * 3  # a half-way case
        jq = jopt._quantize(jnp.asarray(x))
        tq = topt._quantize(torch.from_numpy(x))
        assert tq["q"].dtype == torch.int8 and tq["scale"].dtype == \
            torch.float32
        assert np.array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
        assert np.array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
        assert np.array_equal(
            topt._dequantize(tq, shape).numpy(),
            np.asarray(jopt._dequantize(jq, shape)))


_OPT_SHAPES = {"a": (2, 2, 513), "b": {"c": (70,)}}


def _opt_tree(fn):
    return jax.tree.map(fn, _OPT_SHAPES,
                        is_leaf=lambda x: isinstance(x, tuple))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("moment_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])  # under / over the clip
def test_adamw_apply_matches_reference(moment_dtype, grad_scale):
    rng = np.random.default_rng(1)
    params = _opt_tree(lambda s: np.asarray(jnp.asarray(
        rng.standard_normal(s, dtype=np.float32), jnp.bfloat16)))
    jcfg = jopt.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    tcfg = topt.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    js = jopt.init(jax.tree.map(jnp.asarray, params), jcfg)
    ts = topt.init(api.params_from_numpy(params, "cpu"), tcfg)
    for _ in range(3):
        g = _opt_tree(lambda s: grad_scale * rng.standard_normal(
            s, dtype=np.float32))
        js, jp = jopt.apply(js, jax.tree.map(jnp.asarray, g), jcfg)
        ts, tp = topt.apply(ts, api.params_from_numpy(g, "cpu"), tcfg)
    clipped = grad_scale == 1.0
    assert (float(jopt._global_norm(g)) > jcfg.grad_clip) == clipped
    for path, a, t in _pairs({"params": jp, "state": js},
                             {"params": tp, "state": ts}):
        assert t.dtype == api._tensor(a, "cpu").dtype, path
        b = _bits(t)
        if clipped and a.dtype.kind == "f":
            scale = np.abs(a.astype(np.float32)).max()
            err = np.abs(a.astype(np.float32) - t.float().numpy()).max()
            assert err <= CLIPPED_RTOL * scale, (path, err / scale)
        elif path.startswith("state/master"):
            assert _ulps(a, b) <= MASTER_ULP, (path, _ulps(a, b))
        elif path.startswith("params/"):  # master rounded to bf16
            assert np.abs(b.astype(int) - _bits(a).astype(int)).max() <= 1
        else:  # step, m, v, q, scale
            assert np.array_equal(b, _bits(a)), path


# ---------------------------------------------------- model, loss, grads ----
@pytest.fixture(scope="module")
def reference():
    """Reduced llama3.2-1b: the reference's own params as numpy, a batch
    from a seed, and the reference's loss and gradients for the weights
    in bf16 (as initialized) and cast to fp32."""
    cfg = jget_config("llama32_1b").reduced()
    jmodel = japi.get_model(cfg, remat=False)
    host = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=32)
    batch = japi.make_batch(cfg, shape, rng, batch_override=4)
    toks = np.asarray(batch["tokens"])
    vg = jax.jit(jax.value_and_grad(jmodel.loss))
    out = {"cfg": cfg, "tokens": toks}
    for dtype in ("bfloat16", "float32"):
        w = host if dtype == "bfloat16" else \
            jax.tree.map(lambda a: a.astype(np.float32), host)
        loss, grads = vg(jax.tree.map(jnp.asarray, w),
                         {"tokens": jnp.asarray(toks)})
        out[dtype] = (w, float(loss), jax.tree.map(np.asarray, grads))
    return out


def _port_model(**kw):
    return api.get_model(get_config("llama32_1b").reduced(), **kw)


def test_make_batch_matches_reference(reference):
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32)
    got = api.make_batch(get_config("llama32_1b").reduced(), shape,
                         np.random.default_rng(0), batch_override=4,
                         device="cpu")
    assert got["tokens"].dtype == torch.int32
    assert np.array_equal(got["tokens"].numpy(), reference["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_reference(reference, dtype):
    w, want, _ = reference[dtype]
    params = api.params_from_numpy(w, "cpu")
    with torch.no_grad():
        got = _port_model(remat=False).loss(
            params, {"tokens": torch.from_numpy(reference["tokens"])})
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= LOSS_TOL[dtype] * abs(want)


def _grad_errors(reference, dtype, tokens) -> dict:
    w, _, jgrads = reference[dtype]
    _, grads = value_and_grad(_port_model(remat=False),
                              api.params_from_numpy(w, "cpu"),
                              {"tokens": torch.from_numpy(tokens)})
    out = {}
    for path, a, t in _pairs(jgrads, grads):
        assert t.dtype == api._tensor(a, "cpu").dtype, path
        a = a.astype(np.float32)
        out[path] = float(np.abs(a - t.float().numpy()).max()
                          / np.abs(a).max())
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_reference(reference, dtype):
    err = _grad_errors(reference, dtype, reference["tokens"])
    assert max(err.values()) <= GRAD_TOL[dtype], err
    # control: the batch shifted by one token must fail the tolerance
    shifted = _grad_errors(reference, dtype,
                           np.roll(reference["tokens"], 1, axis=1))
    assert max(shifted.values()) > 10 * GRAD_TOL[dtype], shifted


# ----------------------------------------------------------------- step ----
def _state():
    params = _port_model().init(torch.Generator().manual_seed(0))
    return params, topt.init(params, topt.AdamWConfig())


def _batch(B=4, S=32, step=0):
    cfg = get_config("llama32_1b").reduced()
    corpus = tdata.SyntheticCorpus(tdata.DataConfig(S, B, cfg.vocab_size))
    return {"tokens": torch.from_numpy(corpus.batch(step)["tokens"])}


def test_remat_changes_no_bit():
    cfg = get_config("llama32_1b").reduced()
    params, opt_state = _state()
    batch = _batch(B=2, S=16)
    rules = MeshRules(make_host_mesh("cpu"))
    outs = [build_train_step(cfg, rules, TrainStepConfig(
        remat=remat, remat_policy=policy))[0](params, opt_state, batch)
            for remat, policy in ((False, "nothing"), (True, "nothing"),
                                  (True, "dots"))]
    for other in outs[1:]:
        for (path, a), (_, b) in zip(flatten_with_path(outs[0]),
                                     flatten_with_path(other)):
            assert torch.equal(a, b), path


@pytest.mark.parametrize("int8_grad_accum", [False, True])
def test_microbatches_match_one_batch(int8_grad_accum):
    cfg = get_config("llama32_1b").reduced()
    params, opt_state = _state()
    batch = _batch()
    rules = MeshRules(make_host_mesh("cpu"))
    one = build_train_step(cfg, rules, TrainStepConfig(remat=False))[0](
        params, opt_state, batch)
    two = build_train_step(cfg, rules, TrainStepConfig(
        remat=False, microbatches=2, int8_grad_accum=int8_grad_accum))[0](
        params, opt_state, batch)
    np.testing.assert_allclose(float(two[2]["loss"]), float(one[2]["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(two[2]["grad_norm"]),
                               float(one[2]["grad_norm"]), rtol=2e-2)
    assert int(two[2]["step"]) == int(one[2]["step"]) == 1
    assert two[1]["step"].dtype == torch.int32 and two[1]["step"].dim() == 0


# -------------------------------------------------------------- trainer ----
def _trainer(manager=None, total=6, **kw):
    cfg = get_config("llama32_1b").reduced()
    dcfg = tdata.DataConfig(seq_len=32, global_batch=4,
                            vocab_size=cfg.vocab_size)
    tcfg = TrainerConfig(
        total_steps=total, ckpt_every=3, seed=0,
        step_cfg=TrainStepConfig(
            microbatches=kw.pop("microbatches", 1), remat=False,
            adamw=topt.AdamWConfig(
                lr=1e-3, moment_dtype=kw.pop("moment_dtype", "fp32"))))
    manager = manager or SEARSCheckpointManager(node_capacity=1 << 28,
                                                engine="numpy")
    return Trainer(cfg, dcfg, tcfg, manager=manager, device="cpu")


def _losses(metrics) -> list[float]:
    return [m["loss"] for m in metrics if "loss" in m]


@pytest.fixture(scope="module")
def uninterrupted():
    """Six fp32-moment steps, checkpointed at step 3 and 6."""
    tr = _trainer(total=6)
    return tr, tr.run()


@pytest.mark.parametrize("moment_dtype", ["fp32", "int8"])
def test_trainer_runs_and_loss_decreases(moment_dtype, uninterrupted):
    metrics = uninterrupted[1] if moment_dtype == "fp32" else \
        _trainer(total=6, moment_dtype=moment_dtype).run()
    losses = _losses(metrics)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_trainer_crash_restart_is_exact(uninterrupted):
    """Crash after step 3, n-k storage nodes die, restart: the same
    state and losses as the uninterrupted run, bit for bit."""
    tr_a, m_a = uninterrupted
    mgr = SEARSCheckpointManager(node_capacity=1 << 28, run="b",
                                 engine="numpy")
    _trainer(manager=mgr, total=3).run()  # "crashes" after the save at 3
    for cluster in mgr.store.clusters:
        cluster.kill_nodes([0, 2, 4, 6, 8])
    tr_b = _trainer(manager=mgr, total=6)
    m_b = tr_b.run()
    assert m_b[0]["step"] == 4  # resumed, not restarted
    assert _losses(m_b) == _losses(m_a)[3:]
    for (path, a), (_, b) in zip(flatten_with_path(tr_a.final_state),
                                 flatten_with_path(tr_b.final_state)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_files_and_checkpoints_survive_failures_in_one_store():
    """``tests/test_system.py``'s scenario on the port, with reduced
    llama3.2-1b in place of the unported granite-moe."""
    store = SEARSStore(n=10, k=5, num_clusters=4, node_capacity=1 << 30,
                       binding="ulb", engine="numpy")
    wcfg = WorkloadConfig(scale=1 / 800_000, n_days=1)
    events = list(generate_events(wcfg))[:20]
    for ev in events:
        store.put_file(ev.user, ev.filename, ev.data)
    mgr = SEARSCheckpointManager(store=store, run="sys")
    tr = _trainer(manager=mgr, total=4)
    tr.tcfg.ckpt_every = 2
    tr.run()
    params_before = tr.final_state[0]
    for c in store.clusters:
        c.kill_nodes([0, 2, 4, 6, 8])
    out, _ = store.get_file(events[0].user, events[0].filename)
    assert out == events[0].data
    state = mgr.restore({"params": tr.param_shapes, "opt": tr.opt_shapes})
    # the trainer's state is DTensors on its mesh; restored without
    # shardings, the leaves are whole tensors
    for (path, a), (_, b) in zip(flatten_with_path(state["params"]),
                                 flatten_with_path(params_before)):
        assert a.dtype == b.dtype and torch.equal(a, b.full_tensor()), path
    assert int(state["opt"]["step"]) == 4
    assert store.stats().dedup_ratio > 0.3


def test_unchanged_step_dedups():
    tr = _trainer(total=3)
    tr.run()
    state = {"params": tr.final_state[0], "opt": tr.final_state[1]}
    again = tr.manager.save(4, state)  # the step-3 state, unchanged
    assert again["bytes"] > 0 and again["bytes_after_dedup"] == 0
    assert again["dedup_saving"] == 1.0


# --------------------------------------------------------- cross-restore ----
@pytest.fixture(scope="module")
def train_state(reference):
    """The reference's train state (int8 moments, after one update) and
    the port's carry of it."""
    w, _, jgrads = reference["bfloat16"]
    cfg = jopt.AdamWConfig(moment_dtype="int8")
    jstate = jax.jit(jopt.init, static_argnums=1)(
        jax.tree.map(jnp.asarray, w), cfg)
    jstate, jparams = jax.jit(jopt.apply, static_argnums=2)(
        jstate, jax.tree.map(jnp.asarray, jgrads), cfg)
    jtree = {"params": jparams, "opt": jstate}
    return jtree, api.params_from_numpy(jax.tree.map(np.asarray, jtree),
                                        "cpu")


def _port_specs():
    tr = _trainer(moment_dtype="int8")
    return {"params": tr.param_shapes, "opt": tr.opt_shapes}


def test_train_state_checkpoints_cross_restore(train_state):
    """The two trees serialize to the same blobs, and each package
    deserializes the other's checkpoint bit for bit."""
    jtree, ttree = train_state
    jman, jblobs = jser.serialize(jtree)
    tman, tblobs = tser.serialize(ttree)
    assert list(tblobs) == list(jblobs)
    assert all(tblobs[n] == jblobs[n] for n in jblobs)
    assert json.loads(tman)["leaves"] == json.loads(jman)["leaves"]
    # the reference's checkpoint into the port, onto the trainer's specs
    got = tser.deserialize(jman, jblobs, _port_specs())
    for path, a, t in _pairs(jtree, got):
        assert t.shape == a.shape and np.array_equal(_bits(t), _bits(a)), \
            path
    # the port's checkpoint into the reference
    back = jser.deserialize(tman, tblobs, jtree)
    for path, a, t in _pairs(back, ttree):
        assert np.array_equal(_bits(t), _bits(a)), path


def _copy_files(src, dst) -> None:
    """Every file of ``src``'s store, read back and written into
    ``dst``'s under the same name: what a job restarted on the other
    package finds."""
    for name in sorted(src.store.switching[src.user].table):
        data, _ = src.store.get_file(src.user, name)
        dst.store.put_file(dst.user, name, data)


def test_train_state_cross_restores_between_managers(train_state):
    """Saved at step 2 by one package's ``SEARSCheckpointManager`` and
    restored by the other's, both ways, bit for bit; the two saves store
    the same leaf files, and manifests that list the same leaves (their
    ``treedef`` strings are each package's own)."""
    jtree, ttree = train_state
    kw = {"node_capacity": 1 << 28, "engine": "numpy"}
    jsaved, tsaved = JManager(**kw), SEARSCheckpointManager(**kw)
    jstat, tstat = jsaved.save(2, jtree), tsaved.save(2, ttree)
    assert tstat == jstat
    names = sorted(jsaved.store.switching[jsaved.user].table)
    assert names == sorted(tsaved.store.switching[tsaved.user].table)
    for name in names:
        a = jsaved.store.get_file(jsaved.user, name)[0]
        b = tsaved.store.get_file(tsaved.user, name)[0]
        if name.endswith("/MANIFEST.json"):
            a, b = json.loads(a)["leaves"], json.loads(b)["leaves"]
        assert a == b, name
    # the reference's checkpoint, restored by the port's manager
    tload = SEARSCheckpointManager(**kw)
    _copy_files(jsaved, tload)
    got = tload.restore(_port_specs(), step=2)
    for path, a, t in _pairs(jtree, got):
        assert t.shape == a.shape and np.array_equal(_bits(t), _bits(a)), \
            path
    # the port's checkpoint, restored by the reference's manager
    jload = JManager(**kw)
    _copy_files(tsaved, jload)
    back = jload.restore(jtree, step=2)
    for path, a, t in _pairs(back, ttree):
        assert np.array_equal(_bits(t), _bits(a)), path


# ------------------------------------------------------------- launcher ----
def test_launcher_trains_on_the_cpu_and_needs_cuda_otherwise(monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "llama32_1b", "--tiny", "--device",
                           "cpu", "--steps", "2", "--ckpt-every", "2",
                           "--batch", "2", "--seq", "16",
                           "--int8-moments"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("step      1") and "final metrics" in lines[-1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "llama32_1b", "--tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_config("llama32_1b").reduced(),
                tdata.DataConfig(16, 2, 512))
