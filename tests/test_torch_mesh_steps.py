"""The port's serve and train steps on a mesh of one device, and its
elastic restore, on the CPU.

The mesh is ``make_host_mesh("cpu")``: a (1, 1) ``("data", "model")``
mesh over a gloo group of world size 1 made from a ``HashStore``.  What
is held:

* prefill and three decode steps through ``build_prefill_step`` /
  ``build_decode_step`` equal the plain model's, bit for bit, on a
  reduced config of each family (dense, MoE, MLA, VLM, SSM, hybrid,
  encoder-decoder); the steps wrap the weights without a copy (the same
  storage) and decode writes the cache in place.  Each output's shape
  is ``cache_specs``'s, but for the two the reference's builders also
  give: a VLM's prefill cache holds ``max(seq_len, prompt + patches)``
  slots (``cache_len=S`` counts no patches), and an encoder-decoder's
  cross caches are as long as its frames;
* ``shard_act`` is called where the reference calls it (once a layer,
  or a hybrid group, of the full-sequence pass; never in the
  encoder-decoder) and changes no bit; given a DTensor it pins the
  batch over ``data``;
* on a larger mesh every family's steps build, and llama3.2-1b's and
  the MoE, MLA and hybrid configs' run on 4 gloo ranks of a (4, 1)
  mesh, equal to the plain model's;
* ``Trainer(mesh=default_mesh("cpu"))`` on reduced llama3.2-1b gives the
  plain step's losses and state bit for bit, its state DTensors in the
  step's placements; ``restore(shardings=)`` puts every leaf straight
  onto its placements, bit for bit, for the trainer's checkpoint and for
  one the reference wrote;
* the same checkpoint restored by 4 gloo ranks on a (2, 2) mesh with
  ``MeshRules(fsdp=True)``'s shardings: on every rank each local shard
  equals its slice of the saved leaf.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.checkpoint import serializer as tser
from repro_torch.checkpoint.manager import SEARSCheckpointManager
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline as tdata
from repro_torch.distributed.sharding import MeshRules, shard_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import prefix_len, prompts
from repro_torch.models import api
from repro_torch.serve.step import build_decode_step, build_prefill_step
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepConfig, build_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig, default_mesh
from repro_torch.tree import at, flatten_with_path, tree_map

from children import Children, failures

FAMILIES = ("llama32_1b", "granite_moe_1b", "deepseek_v2_236b",
            "phi3_vision_4b", "falcon_mamba_7b", "jamba_15_large",
            "whisper_tiny")
B, P, STEPS = 2, 8, 3


@pytest.fixture(scope="module")
def mesh():
    """The host mesh over a gloo group of one rank, destroyed after."""
    if dist.is_initialized() and dist.get_world_size() != 1:
        dist.destroy_process_group()
    try:
        yield make_host_mesh("cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _config(arch):
    cfg = get_config(arch).reduced()
    if cfg.family == "hybrid":  # one group of its pattern
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
    return cfg


def _leaves(tree) -> list:
    return [t for _, t in flatten_with_path(tree)]


def _ptr(t) -> int:
    return t.untyped_storage().data_ptr()


# ------------------------------------------------------------- serving ---
@pytest.mark.parametrize("arch", FAMILIES)
def test_steps_on_a_mesh_of_one_equal_the_plain_model(mesh, arch):
    cfg = _config(arch)
    model = api.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = prompts(cfg, B, P, 0, "cpu")
    Pt = prefix_len(batch)  # decoder positions: patches and tokens
    feed = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, B, 1)))
    with torch.no_grad():
        want = [model.prefill(params, batch, cache_len=Pt + STEPS + 1)]
        cache = want[0][1]
        for i in range(STEPS):
            want.append(model.decode_step(params, cache, feed[i], Pt + i))
            want[-1] = (want[-1][0].clone(), None)
    want_cache = cache

    rules = MeshRules(mesh)
    shape = ShapeConfig("serve", P + STEPS + 1, B, "decode")
    prefill, (param_sh, batch_sh), _, _ = build_prefill_step(cfg, rules,
                                                            shape)
    decode, in_sh, out_sh, cache_shapes = build_decode_step(cfg, rules,
                                                            shape)
    dparams = shard_tree(params, param_sh)
    assert [_ptr(t.to_local()) for t in _leaves(dparams)] == \
        [_ptr(t) for t in _leaves(params)]  # wrapped, not copied
    logits, dcache = prefill(dparams, shard_tree(batch, batch_sh))
    assert isinstance(logits, DTensor) and torch.equal(
        logits.to_local(), want[0][0])
    assert sorted(dcache) == sorted(cache_shapes)
    local = {}
    for name, t in dcache.items():
        assert t.placements == out_sh[1][name].placements, name
        spec = cache_shapes[name].shape
        expect = list(spec)
        if cfg.n_patches and name in ("k", "v"):  # cache_len=S: no patches
            expect[2] = max(shape.seq_len, Pt)
        if name in ("ek", "ev"):  # as long as the frames
            expect[2] = batch["frames"].shape[1]
        assert tuple(t.shape) == tuple(expect), name
        t = t.to_local()
        if name in ("k", "v") and tuple(t.shape) != spec:  # the VLM's
            t = torch.zeros(spec, dtype=t.dtype).index_copy_(
                2, torch.arange(t.shape[2]), t)
        local[name] = t
    dcache = shard_tree(local, in_sh[1])
    for i in range(STEPS):
        before = {k: _ptr(v.to_local()) for k, v in dcache.items()}
        logits, dcache = decode(dparams, dcache, shard_tree(
            feed[i], in_sh[2]), Pt + i)
        assert {k: _ptr(v.to_local()) for k, v in dcache.items()} == before
        assert torch.equal(logits.to_local(), want[i + 1][0]), i
    for name, t in dcache.items():
        assert torch.equal(t.to_local(), want_cache[name]), name


def test_serve_launchers_decode_the_same_number_of_steps(monkeypatch,
                                                        capsys):
    """``--tokens N``: N decode steps after the prefill in both
    launchers.  The reference's steps are counted as calls of its jitted
    ``decode_step``, the port's as calls of its model's."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch
    from repro_torch.models.transformer import TransformerLM

    counts = {"reference": 0, "port": 0}
    jit = jax.jit

    def counting_jit(fn, **kw):
        step = jit(fn, **kw)
        if getattr(fn, "__name__", "") != "decode_step":
            return step

        def call(*a):
            counts["reference"] += 1
            return step(*a)
        return call
    monkeypatch.setattr(jax, "jit", counting_jit)
    orig = TransformerLM.decode_step

    def counted(self, *a, **kw):
        counts["port"] += 1
        return orig(self, *a, **kw)
    monkeypatch.setattr(TransformerLM, "decode_step", counted)
    argv = ["--arch", "llama32_1b", "--tiny", "--tokens", "4", "--batch",
            "1", "--prompt-len", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jlaunch.main()
    tlaunch.main(argv + ["--device", "cpu"])
    assert counts == {"reference": 4, "port": 4}
    assert "4 decode steps x 1 seqs" in capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES + ("internlm2_20b",))
def test_shard_act_is_called_where_the_reference_calls_it(mesh, arch):
    cfg = _config(arch)
    calls = []
    hook = MeshRules(mesh).act_sharder()

    def counted(x):
        calls.append(tuple(x.shape))
        return hook(x)
    plain = api.get_model(cfg)
    hooked = api.get_model(cfg, shard_act=counted)
    params = plain.init(torch.Generator().manual_seed(0))
    batch = prompts(cfg, B, P, 2, "cpu")
    with torch.no_grad():
        want, got = plain.forward(params, batch), hooked.forward(params,
                                                                  batch)
    assert torch.equal(got, want)
    layers = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1),
              "encdec": 0}.get(cfg.family, cfg.n_layers)
    x = (B, prefix_len(batch), cfg.d_model)
    assert calls == [x] * layers


def test_act_sharder_pins_a_dtensor_batch_over_data(mesh):
    shard = MeshRules(mesh).act_sharder()
    x = torch.randn(4, 3, 8)
    assert shard(x) is x
    d = DTensor.from_local(x, mesh, (Replicate(), Replicate()),
                           run_check=False)
    y = shard(d)
    assert y.placements == (Shard(0), Replicate())
    assert torch.equal(y.full_tensor(), x)


class _Mesh4:
    """Stands for a (4, 1) mesh: what the rules read, and its size."""
    mesh_dim_names = ("data", "model")
    shape = (4, 1)
    device_type = "cpu"

    def size(self) -> int:
        return 4


_LARGER = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    import numpy as np
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.distributed.sharding import MeshRules, shard_tree, sharded
    from repro_torch.models import api
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.train.step import TrainStepConfig, build_train_step
    from repro_torch.train import optimizer as topt

    tmp, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    rules = MeshRules(mesh)
    shape = ShapeConfig("serve", 16, 8, "decode")
    plain_rules = MeshRules(type("M", (), dict(
        mesh_dim_names=("data", "model"), shape=(1, 1), device_type="cpu",
        size=lambda self: 1))())
    out = {}
    for arch in sys.argv[3].split(","):
        cfg = get_config(arch).reduced()
        if cfg.family == "hybrid":  # one group of its pattern
            cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
        model = api.get_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (8, 12)))
        with torch.no_grad():
            want, cache = model.prefill(params, {"tokens": tokens},
                                        cache_len=16)
            want_next = model.decode_step(params, cache, tokens[:, :1],
                                          12)[0]
        prefill, (psh, bsh), _, _ = build_prefill_step(cfg, rules, shape)
        decode, in_sh, _, _ = build_decode_step(cfg, rules, shape)
        dparams = shard_tree(params, psh)
        logits, dcache = prefill(dparams, shard_tree({"tokens": tokens},
                                                     bsh))
        got = logits.full_tensor()
        logits, _ = decode(dparams, dcache,
                           shard_tree(tokens[:, :1], in_sh[2]), 12)
        got_next = logits.full_tensor()
        step, in_sh, out_sh, _, _ = build_train_step(cfg, rules,
                                                     TrainStepConfig())
        state = (params, topt.init(params, TrainStepConfig().adamw))
        *_, m = sharded(step, out_sh, mesh)(
            shard_tree(state[0], in_sh[0]), shard_tree(state[1], in_sh[1]),
            shard_tree({"tokens": tokens}, in_sh[2]))
        plain = build_train_step(cfg, plain_rules, TrainStepConfig())[0]
        *_, pm = plain(*state, {"tokens": tokens})
        out[arch] = {
            "prefill_equal": torch.equal(got, want),
            "decode_equal": torch.equal(got_next, want_next),
            "loss_rel_err": abs(float(m["loss"]) - float(pm["loss"]))
            / float(pm["loss"])}
    with open(f"{tmp}/larger{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")
LARGER_ARCHS = ("granite_moe_1b", "deepseek_v2_236b", "jamba_15_large",
                "llama32_1b")


@pytest.fixture(scope="module")
def larger(tmp_path_factory):
    """4 gloo ranks of a (4, 1) mesh, once for the module: each arch of
    ``LARGER_ARCHS`` served and trained one step there (``_LARGER``);
    every rank's readings, by arch."""
    tmp = tmp_path_factory.mktemp("larger")
    with Children([[sys.executable, "-c", _LARGER, str(tmp), str(r),
                    ",".join(LARGER_ARCHS)] for r in range(4)]) as children:
        exits = children.wait(240)
    assert not (failed := failures(exits)), failed
    return [json.loads((tmp / f"larger{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("arch", LARGER_ARCHS)
def test_steps_on_a_larger_mesh_build_but_refuse_to_run(arch, larger):
    """On a (4, 1) mesh every config's steps build with the reference's
    shardings, and run on 4 gloo ranks of that mesh (the MoE, MLA and
    hybrid configs too: none refuses any more, the name is kept): the
    prefill and decode logits equal the plain model's bit for bit (the
    batch over ``data``, each rank's rows whole; an MoE layer's groups
    span the data ranks and are routed whole), and the train step's loss
    is the plain step's within 1e-3."""
    cfg = _config(arch)
    rules = MeshRules(_Mesh4())
    shape = ShapeConfig("serve", 16, 8, "decode")
    param_sh = build_prefill_step(cfg, rules, shape)[1][0]
    in_sh = build_decode_step(cfg, rules, shape)[1]
    build_train_step(cfg, rules, TrainStepConfig())
    assert at(param_sh, ("embed",)).placements == (Replicate(), Shard(0))
    assert in_sh[2].placements == (Shard(0), Replicate())
    for rank in larger:
        got = rank[arch]
        assert got["prefill_equal"] and got["decode_equal"], got
        assert got["loss_rel_err"] <= 1e-3, got


# ------------------------------------------------------------ training ---
def _tcfg(total: int) -> TrainerConfig:
    return TrainerConfig(total_steps=total, ckpt_every=3, seed=0,
                         step_cfg=TrainStepConfig(
                             remat=False, adamw=topt.AdamWConfig(
                                 lr=1e-3, moment_dtype="int8")))


def _dcfg(cfg) -> tdata.DataConfig:
    return tdata.DataConfig(seq_len=16, global_batch=4,
                            vocab_size=cfg.vocab_size)


@pytest.fixture(scope="module")
def trained(mesh):
    """Reduced llama3.2-1b, int8 moments: three steps through the
    trainer on the mesh of one (saved at step 3), and three plain steps
    from the same seed."""
    cfg = get_config("llama32_1b").reduced()
    mgr = SEARSCheckpointManager(node_capacity=1 << 28, engine="numpy")
    tr = Trainer(cfg, _dcfg(cfg), _tcfg(3), mesh=default_mesh("cpu"),
                 manager=mgr)
    metrics = tr.run()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    state = (params, topt.init(params, tr.tcfg.step_cfg.adamw))
    losses = []
    for step in range(3):
        *state, m = tr.step_fn(*state, {"tokens": torch.from_numpy(
            tr.data.batch(step)["tokens"])})
        losses.append(float(m["loss"]))
    return tr, metrics, tuple(state), losses


def test_trainer_on_a_mesh_of_one_equals_the_plain_step(trained):
    tr, metrics, plain, losses = trained
    assert tr.mesh.shape == (1, 1) and tr.device.type == "cpu"
    assert [m["loss"] for m in metrics if "loss" in m] == losses
    for sub, shardings, ref in zip(tr.final_state, tr.out_sh, plain):
        for path, t in flatten_with_path(sub):
            assert isinstance(t, DTensor), path
            assert t.placements == at(shardings, path).placements, path
            want = at(ref, path)
            assert t.dtype == want.dtype and torch.equal(t.to_local(),
                                                         want), path


def _check_restored(tree, shardings, want) -> None:
    for path, t in flatten_with_path(tree):
        assert isinstance(t, DTensor), path
        assert t.placements == at(shardings, path).placements, path
        w = at(want, path)
        w = w.full_tensor() if isinstance(w, DTensor) else w
        assert t.dtype == w.dtype and torch.equal(t.full_tensor(), w), path


def test_restore_puts_each_leaf_on_its_placements(trained):
    tr, *_ = trained
    tr2 = Trainer(tr.model_cfg, _dcfg(tr.model_cfg), _tcfg(3),
                  mesh=tr.mesh, manager=tr.manager)
    seen = []
    orig = tser.deserialize

    def record(*a, **kw):
        seen.append(kw.get("shardings") is not None)
        return orig(*a, **kw)
    tser.deserialize = record
    try:
        (params, opt_state), start = tr2.restore_or_init()
    finally:
        tser.deserialize = orig
    assert start == 3 and seen == [True]
    _check_restored({"params": params, "opt": opt_state},
                    {"params": tr2.in_sh[0], "opt": tr2.in_sh[1]},
                    {"params": tr.final_state[0], "opt": tr.final_state[1]})


def test_restore_with_shardings_of_a_checkpoint_the_reference_wrote(
        trained):
    tr, *_ = trained
    jcfg = jget_config("llama32_1b").reduced()
    rng = np.random.default_rng(3)
    params = jax.tree.map(  # weights from a seed, at the reference's shapes
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype),
        japi.get_model(jcfg).param_shapes())
    jtree = {"params": params, "opt": jax.jit(jopt.init, static_argnums=1)(
        params, jopt.AdamWConfig(moment_dtype="int8"))}
    manifest, blobs = jser.serialize(jtree)
    shardings = {"params": tr.in_sh[0], "opt": tr.in_sh[1]}
    got = tser.deserialize(manifest, blobs, {"params": tr.param_shapes,
                                             "opt": tr.opt_shapes},
                           shardings=shardings)
    want = api.params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    _check_restored(got, shardings, want)


# --------------------------------------------- elastic restore, 4 ranks ---
_RANK = textwrap.dedent("""
    import datetime, pickle, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from repro_torch.checkpoint.manager import SEARSCheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.train import optimizer as topt
    from repro_torch.train.step import TrainStepConfig, build_train_step
    from repro_torch.tree import at, flatten_with_path, tree_map

    tmp, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with open(f"{tmp}/ckpt.pkl", "rb") as f:
        files, saved = pickle.load(f)
    mgr = SEARSCheckpointManager(node_capacity=1 << 28, engine="numpy")
    for name, data in files.items():
        mgr.store.put_file(mgr.user, name, data)
    tcfg = TrainStepConfig(adamw=topt.AdamWConfig(moment_dtype="int8"))
    _, in_sh, _, pshapes, oshapes = build_train_step(
        get_config("llama32_1b").reduced(), MeshRules(mesh, fsdp=True), tcfg)
    shardings = {"params": in_sh[0], "opt": in_sh[1]}
    tree = mgr.restore({"params": pshapes, "opt": oshapes}, step=3,
                       shardings=shardings)
    coord = mesh.get_coordinate()
    split = 0
    for path, t in flatten_with_path(tree):
        assert t.placements == at(shardings, path).placements, path
        want = at(saved, path)
        for i, p in enumerate(t.placements):  # this rank's slice
            if isinstance(p, Shard):
                want = want.chunk(mesh.size(i), dim=p.dim)[coord[i]]
                split += 1
        got = t.to_local()
        assert got.dtype == want.dtype and torch.equal(got, want), path
    print("rank", rank, "ok", split)
    dist.destroy_process_group()
""")


def test_elastic_restore_onto_four_gloo_ranks(trained, tmp_path):
    """Saved on the mesh of one, restored on a (2, 2) mesh of 4 ranks
    with the FSDP rules: every rank's shard is its slice, bit for bit."""
    tr, *_ = trained
    mgr = tr.manager
    files = {name: mgr.store.get_file(mgr.user, name)[0]
             for name in sorted(mgr.store.switching[mgr.user].table)
             if name.startswith(f"ckpt/{mgr.run}/{3:08d}/")}
    saved = tree_map(lambda t: t.full_tensor(), {
        "params": tr.final_state[0], "opt": tr.final_state[1]})
    with open(tmp_path / "ckpt.pkl", "wb") as f:
        pickle.dump((files, saved), f)
    with Children([[sys.executable, "-c", _RANK, str(tmp_path), str(r)]
                   for r in range(4)]) as children:
        exits = children.wait(120)
    assert not (failed := failures(exits)), failed
    for r, e in enumerate(exits):
        words = e.out.split()
        assert words[:3] == ["rank", str(r), "ok"] and int(words[3]) > 0



def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_launcher_joins_its_coordinator_and_builds_its_mesh():
    """``--coordinator`` makes the process group (one gloo rank here);
    the host mesh then trains, and ``--production-mesh`` refuses a group
    of fewer than 256 ranks, as the reference refuses fewer devices."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama32_1b", "--tiny", "--device", "cpu", "--steps", "1",
            "--ckpt-every", "5", "--batch", "2", "--seq", "16",
            "--num-hosts", "1", "--host-id", "0"]
    # two groups: the refusal's exit must not cut the run short
    with Children([base + ["--coordinator", f"localhost:{_free_port()}"]]
                  ) as run, Children([base + [
                      "--coordinator", f"localhost:{_free_port()}",
                      "--production-mesh"]]) as refusal:
        (ran,), (refused,) = run.wait(120), refusal.wait(120)
    assert ran.returncode == 0, ran.err[-3000:]
    assert ran.out.startswith("step      1")
    assert refused.returncode != 0
    assert "needs a process group of 256 ranks; there are 1" in refused.err
