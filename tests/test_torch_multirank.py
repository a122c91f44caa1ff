"""The port's steps on meshes of four CPU ranks, against the reference's
GSPMD steps on four forced devices and against the port's mesh of one.

One module fixture runs, all at once:

* 4 gloo ranks (subprocesses over ``file://``, ``GLOO_SOCKET_IFNAME=lo``),
  each on three meshes: (2, 2) with FSDP off (``2x2``) and on
  (``2x2_fsdp``), and (1, 4) (``1x4``: reduced llama3.2-1b's 2 KV heads
  do not divide the ``model`` axis, so its cache shards its slots and
  each rank picks its query heads' KV group).  On each mesh they serve
  the reduced llama3.2-1b, gemma3-1b, phi-3-vision, whisper-tiny and
  falcon-mamba-7b through ``build_prefill_step`` / ``build_decode_step``
  (a prompt of 12 tokens, after 16 patches for phi-3-vision, then 3 fed
  tokens), train reduced llama3.2-1b for 3 steps with int8 moments
  (``Trainer(mesh=)`` on the meshes without FSDP, ``build_train_step``
  with ``MeshRules(fsdp=True)`` on the other), and run the ZeRO-1
  update once on gradients given to every mesh alike.  Each rank counts
  the collectives of its steps (``analysis.analyze_step``) and writes
  the ``full_tensor()`` of every output to a file;
* one JAX subprocess: the reference's ``build_prefill_step`` /
  ``build_decode_step`` / ``build_train_step`` under ``jax.jit`` with
  their shardings, on ``jax.make_mesh((2, 2), ("data", "model"),
  axis_types=(AxisType.Auto,) * 2)`` over 4 forced CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), on the same
  weights and inputs.

The mesh of one is the plain model and step (the mesh-of-one builders
equal them bit for bit: ``tests/test_torch_mesh_steps.py``).  The
weights are the port's seed-0 draws: fp32 copies of them for llama,
gemma3, phi-3-vision and falcon-mamba, for a tight bound; bf16 for
whisper-tiny, whose frames are bf16 (the port's encoder takes no fp32
weights against them), at the serve gates.  Bounds, each a share of the
largest |value| of the tensor held:

* fp32 weights: prefill logits 1e-5 (read: 4.6e-7); decode logits
  5e-3 (read: 4.1e-4 against the mesh of one, 2.6e-3 against the
  reference, gemma3 both: the cache is bf16 whatever the weights, and an
  entry that rounds to the other neighbour moves the next steps); each
  bf16 cache entry within 2^-7 of its own |value| (one bf16 ulp) plus
  5e-3 of the largest (read: the excess 2.5e-4 and 2.4e-3); the fp32
  SSM state 1e-5 (read: 3.9e-7);
* bf16 weights (whisper-tiny): 0.05 for logits and caches, the serve
  gates of ``chip_smoke.py`` (read: 6.6e-3);
* training, 3 steps of bf16 weights: loss within 1e-3 and grad norm
  within 5e-3 relative a step (read: 1e-4 and 7.8e-4); the fp32 master
  copy within 2 lr a step, absolute (read: 3.7e-3 of 6e-3: AdamW moves
  an entry by up to lr a step whatever its gradient's size, so a
  gradient near 0 that rounds the other way flips its step);
* the ZeRO-1 update from the same gradients: the master copy within
  1e-6 of the largest |value| (read: 0), the bf16 moment within one
  bf16 ulp, the int8 moment within one quantization step of its block.

``launch/train.py --num-hosts 2`` trains on two gloo ranks, a (2, 1)
host mesh, within the train bounds of one rank's run.

The dry run's trace of the same steps (``TRACED``) on a fake 4-rank
group counts the same collectives as the real ranks issued: the same kinds and number,
and the same bytes where the ranks ran the configs' own bf16 weights
(the train step, whisper-tiny; the fp32 copies double the others').
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline as tdata
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch import dryrun
from repro_torch.launch.serve import prefix_len, prompts
from repro_torch.models import api
from repro_torch.serve.step import build_decode_step, build_prefill_step
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepConfig, build_train_step
from repro_torch.tree import flatten_with_path, tree_map

from children import Children, failures, one_thread

ARCHS = ("llama32_1b", "gemma3_1b", "phi3_vision_4b", "whisper_tiny",
         "falcon_mamba_7b")
BF16_ARCHS = ("whisper_tiny",)
LAYOUTS = {"2x2": ((2, 2), False), "2x2_fsdp": ((2, 2), True),
           "1x4": ((1, 4), False)}
B, P, STEPS = 4, 12, 3
TRAIN_B, TRAIN_S, TRAIN_STEPS, LR = 4, 16, 3, 1e-3
TCFG = TrainStepConfig(remat=False, adamw=topt.AdamWConfig(
    lr=LR, moment_dtype="int8"))
FP32_PREFILL, FP32_DECODE, STATE_TOL, BF16_ULP = 1e-5, 5e-3, 1e-5, 2.0 ** -7
SERVE_GATE = 5e-2
LOSS_TOL, GNORM_TOL = 1e-3, 5e-3
# the steps the dry run traces beside the ranks' counts: GQA's heads and
# slots, the all-to-all, the bf16 bytes, the train step's data plane
TRACED = (("llama32_1b", "prefill"), ("llama32_1b", "decode"),
          ("falcon_mamba_7b", "prefill"), ("whisper_tiny", "decode"),
          ("llama32_1b", "train"))


class _Mesh1:
    """Stands for a mesh of one device: what the builders read."""
    mesh_dim_names = ("data", "model")
    shape = (1, 1)
    device_type = "cpu"

    def size(self) -> int:
        return 1


# ---------------------------------------------------------------- ranks ---
_RANK = textwrap.dedent("""
    import datetime, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.manager import SEARSCheckpointManager
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import pipeline as tdata
    from repro_torch.distributed.sharding import MeshRules, shard_tree, sharded
    from repro_torch.launch import analysis
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.train import optimizer as topt
    from repro_torch.train.step import TrainStepConfig, build_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import map_with_path, at, tree_map

    tmp, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=60))
    inp = torch.load(f"{tmp}/port_in.pt", weights_only=False)
    tcfg = TrainStepConfig(remat=False, adamw=topt.AdamWConfig(
        lr=inp["lr"], moment_dtype="int8"))

    def full(tree):
        return tree_map(lambda t: t.full_tensor()
                        if isinstance(t, DTensor) else t, tree)

    def local(tree):
        return tree_map(lambda t: t.to_local()
                        if isinstance(t, DTensor) else t, tree)

    def counted(fn, *args):
        res = []
        st = analysis.analyze_step(lambda: res.append(fn(*args)))
        return res[0], (dict(st.coll_by_kind), st.n_collectives,
                        st.coll_bytes)

    out = {"serve": {}, "train": {}, "update": {}, "counts": {}}
    for layout, (shape, fsdp) in inp["layouts"].items():
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        rules = MeshRules(mesh, fsdp=fsdp)
        for arch, d in inp["serve"].items():
            cfg = get_config(arch).reduced()
            sc = ShapeConfig("serve", d["T"], d["B"], "decode")
            prefill, (psh, bsh), _, _ = build_prefill_step(cfg, rules, sc)
            decode, in_sh, _, _ = build_decode_step(cfg, rules, sc)
            params = shard_tree(d["params"], psh)
            (logits, cache), n = counted(prefill, params,
                                         shard_tree(d["batch"], bsh))
            out["counts"][layout, arch, "prefill"] = n
            got = [logits.full_tensor()]
            for i, tok in enumerate(d["feed"]):
                (logits, cache), n = counted(
                    decode, params, cache, shard_tree(tok, in_sh[2]),
                    d["Pt"] + i)
                if i == 0:
                    out["counts"][layout, arch, "decode"] = n
                got.append(logits.full_tensor())
            out["serve"][layout, arch] = {"logits": got,
                                          "cache": full(cache)}
        # 3 train steps: the trainer where it takes the rules, else the
        # builder's step through sharded() as the trainer runs it
        t = inp["train"]
        cfg = get_config("llama32_1b").reduced()
        dcfg = tdata.DataConfig(seq_len=t["S"], global_batch=t["B"],
                                vocab_size=cfg.vocab_size)
        if not fsdp:
            tr = Trainer(cfg, dcfg, TrainerConfig(
                total_steps=t["steps"], ckpt_every=1000, seed=0,
                step_cfg=tcfg), mesh=mesh, manager=SEARSCheckpointManager(
                    node_capacity=1 << 28, engine="numpy"))
            first = []
            plain_step = tr.sharded_step

            def step(*a):
                if first:
                    return plain_step(*a)
                res, n = counted(plain_step, *a)
                first.append(n)
                return res
            tr.sharded_step = step
            metrics = [(m["loss"], m["grad_norm"]) for m in tr.run()
                       if "loss" in m]
            state, count = tr.final_state, first[0]
        else:
            step_fn, in_sh, out_sh, _, _ = build_train_step(cfg, rules, tcfg)
            run = sharded(step_fn, out_sh, mesh)
            state = (shard_tree(t["params"], in_sh[0]),
                     shard_tree(t["opt"], in_sh[1]))
            metrics = []
            for s, tokens in enumerate(t["batches"]):
                args = (*state, shard_tree({"tokens": tokens}, in_sh[2]))
                if s == 0:
                    (*state, m), count = counted(run, *args)
                else:
                    *state, m = run(*args)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out["counts"][layout, "llama32_1b", "train"] = count
        out["train"][layout] = {"metrics": metrics,
                                "master": full(state[1]["master"]),
                                "params": full(state[0])}
        # the update alone, from gradients every mesh is given
        step_fn, in_sh, out_sh, _, _ = build_train_step(cfg, rules, tcfg)
        u = inp["update"]
        new_params, new_opt, m = step_fn.update(
            local(shard_tree(u["opt"], in_sh[1])), torch.zeros(()),
            local(shard_tree(u["grads"], in_sh[0])))
        wrap = lambda path, x, sh: DTensor.from_local(  # noqa: E731
            x, mesh, at(sh, path).placements, run_check=False)
        out["update"][layout] = {
            "params": full(map_with_path(
                lambda p, x: wrap(p, x, out_sh[0]), new_params)),
            "opt": full(map_with_path(
                lambda p, x: wrap(p, x, out_sh[1]), new_opt)),
            "grad_norm": float(m["grad_norm"])}
    torch.save(out, f"{tmp}/out{rank}.pt")
    dist.destroy_process_group()
""")

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig, get_config
    from repro.distributed.sharding import MeshRules
    from repro.serve.step import build_decode_step, build_prefill_step
    from repro.train import optimizer as jopt
    from repro.train.step import TrainStepConfig, build_train_step

    tmp = sys.argv[1]
    with open(f"{tmp}/ref_in.pkl", "rb") as f:
        inp = pickle.load(f)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = MeshRules(mesh)
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    out = {"serve": {}}
    for arch, d in inp["serve"].items():
        cfg = get_config(arch).reduced()
        params = jax.tree.map(jnp.asarray, d["params"])
        shape = ShapeConfig("serve", d["T"], d["B"], "decode")
        fn, (psh, bsh), osh, _ = build_prefill_step(cfg, rules, shape)
        logits, cache = jax.jit(fn, in_shardings=(psh, bsh),
                                out_shardings=osh)(
            params, jax.tree.map(jnp.asarray, d["batch"]))
        got = [np.asarray(logits)]
        fn, ish, osh, _ = build_decode_step(cfg, rules, shape)
        dec = jax.jit(fn, in_shardings=ish, out_shardings=osh)
        for i, tok in enumerate(d["feed"]):
            logits, cache = dec(params, cache, jnp.asarray(tok),
                                jnp.int32(d["Pt"] + i))
            got.append(np.asarray(logits))
        out["serve"][arch] = {"logits": got, "cache": host(cache)}
    t = inp["train"]
    tcfg = TrainStepConfig(remat=False, adamw=jopt.AdamWConfig(
        lr=t["lr"], moment_dtype="int8"))
    step, ish, osh, _, _ = build_train_step(
        get_config("llama32_1b").reduced(), rules, tcfg)
    jstep = jax.jit(step, in_shardings=ish, out_shardings=osh)
    params = jax.tree.map(jnp.asarray, t["params"])
    state = (params, jopt.init(params, tcfg.adamw))
    metrics = []
    for tokens in t["batches"]:
        *state, m = jstep(*state, {"tokens": jnp.asarray(tokens)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["train"] = {"metrics": metrics, "master": host(state[1]["master"])}
    with open(f"{tmp}/ref_out.pkl", "wb") as f:
        pickle.dump(out, f)
""")


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _serve_inputs(arch: str) -> dict:
    cfg = get_config(arch).reduced()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    if arch not in BF16_ARCHS:  # fp32 copies of the seed-0 draws
        params = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                          else t, params)
    batch = prompts(cfg, B, P, 0, "cpu")
    batch["tokens"] = batch["tokens"].to(torch.int32)
    Pt = prefix_len(batch)
    T = -(-(Pt + STEPS + 1) // 4) * 4  # slots the model axis divides
    feed = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32))
    return {"params": params, "batch": batch, "feed": feed, "T": T,
            "B": B, "Pt": Pt}


def _plain_serve(arch: str, d: dict) -> dict:
    """The mesh of one: the plain model's prefill and decode steps."""
    model = api.get_model(get_config(arch).reduced())
    with torch.no_grad():
        logits, cache = model.prefill(d["params"], d["batch"],
                                      cache_len=d["T"])
        got = [logits]
        for i, tok in enumerate(d["feed"]):
            logits, cache = model.decode_step(d["params"], cache, tok,
                                              d["Pt"] + i)
            got.append(logits.clone())
    return {"logits": got, "cache": cache}


def _plain_train(t: dict) -> dict:
    cfg = get_config("llama32_1b").reduced()
    step = build_train_step(cfg, MeshRules(_Mesh1()), TCFG)[0]
    state, metrics = (t["params"], t["opt"]), []
    for tokens in t["batches"]:
        *state, m = step(*state, {"tokens": tokens})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "master": state[1]["master"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    serve = {arch: _serve_inputs(arch) for arch in ARCHS}
    cfg = get_config("llama32_1b").reduced()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    corpus = tdata.SyntheticCorpus(tdata.DataConfig(
        seq_len=TRAIN_S, global_batch=TRAIN_B, vocab_size=cfg.vocab_size))
    batches = [torch.from_numpy(corpus.batch(s)["tokens"])
               for s in range(TRAIN_STEPS)]
    rng = np.random.default_rng(7)
    opt_state = topt.init(params, TCFG.adamw)
    # an Adam state a few steps in, and gradients whose norm clips
    update = {"opt": dict(opt_state, step=torch.tensor(3, dtype=torch.int32),
                          m=tree_map(lambda p: topt._quantize(
                              torch.from_numpy(rng.normal(
                                  0, 0.01, p.shape).astype(np.float32))),
                              params),
                          v=tree_map(lambda p: torch.from_numpy(np.abs(
                              rng.normal(0, 1e-4, p.shape)).astype(
                              np.float32)).to(torch.bfloat16), params)),
              "grads": tree_map(lambda p: torch.from_numpy(rng.normal(
                  0, 0.05, p.shape).astype(np.float32)).to(torch.bfloat16),
                  params)}
    train = {"params": params, "opt": opt_state, "batches": batches,
             "B": TRAIN_B, "S": TRAIN_S, "steps": TRAIN_STEPS}
    torch.save({"serve": serve, "train": train, "update": update,
                "layouts": LAYOUTS, "lr": LR}, tmp / "port_in.pt")
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"serve": {a: {k: tree_map(_host, v) if k in (
            "params", "batch", "feed") else v for k, v in d.items()}
            for a, d in serve.items()},
            "train": {"params": tree_map(_host, params), "lr": LR,
                      "batches": [b.numpy() for b in batches]}}, f)
    argvs = [[sys.executable, "-c", _RANK, str(tmp), str(r)]
             for r in range(4)]
    argvs.append([sys.executable, "-c", _REFERENCE, str(tmp)])
    with Children(argvs) as children, one_thread():
        # the mesh of one, in this process while the ranks run
        plain = {"serve": {a: _plain_serve(a, d) for a, d in serve.items()},
                 "train": _plain_train(train)}
        plain["update"] = dict(zip(("opt", "params"), topt.apply(
            update["opt"], update["grads"], TCFG.adamw)))
        plain["update"]["grad_norm"] = float(topt._global_norm(
            update["grads"]))
        exits = children.wait(240)
    assert not (failed := failures(exits)), failed
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(4)]
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"ranks": ranks, "plain": plain, "ref": ref, "inputs": serve}


# ----------------------------------------------------------- the bounds ---
def _share(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = _f32(got), _f32(want)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)) \
        if isinstance(x, np.ndarray) else x.float()


def _hold_serve(got: dict, want: dict, arch: str) -> None:
    """Logits a step and every cache leaf, by the module's bounds."""
    bf16 = arch in BF16_ARCHS
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        tol = SERVE_GATE if bf16 else (FP32_PREFILL if i == 0
                                       else FP32_DECODE)
        assert _share(_f32(g), _f32(w)) <= tol, (arch, i)
    assert sorted(got["cache"]) == sorted(want["cache"])
    for name, w in want["cache"].items():
        g, w = _f32(got["cache"][name]), _f32(w)
        assert g.shape == w.shape, name
        if bf16:
            assert _share(g, w) <= SERVE_GATE, (arch, name)
        elif name in ("h", "conv"):  # the fp32 SSM state
            assert _share(g, w) <= STATE_TOL, (arch, name)
        else:  # bf16 slots: an ulp of each entry, and the decode bound
            assert bool(((g - w).abs() <= BF16_ULP * w.abs()
                         + FP32_DECODE * w.abs().max()).all()), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_serve_on_four_ranks_matches_the_mesh_of_one(runs, layout, arch):
    for rank in runs["ranks"]:
        _hold_serve(rank["serve"][layout, arch], runs["plain"]["serve"][arch],
                    arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_four_ranks_matches_the_reference_gspmd(runs, arch):
    """The reference's jitted steps on its (2, 2) Auto mesh of forced
    devices against the port's every mesh: the same function."""
    ref = runs["ref"]["serve"][arch]
    assert _share(_f32(ref["logits"][0]), _f32(
        runs["plain"]["serve"][arch]["logits"][0])) <= (
        SERVE_GATE if arch in BF16_ARCHS else FP32_PREFILL)
    for layout in LAYOUTS:
        _hold_serve(runs["ranks"][0]["serve"][layout, arch], ref, arch)


def _hold_train(got: dict, want: dict) -> None:
    for (gl, gn), (wl, wn) in zip(got["metrics"], want["metrics"],
                                  strict=True):
        assert abs(gl - wl) <= LOSS_TOL * abs(wl), (gl, wl)
        assert abs(gn - wn) <= GNORM_TOL * abs(wn), (gn, wn)
    want_master = dict(flatten_with_path(want["master"]))
    for path, g in flatten_with_path(got["master"]):
        diff = float((_f32(g) - _f32(want_master[path])).abs().max())
        assert diff <= 2 * LR * TRAIN_STEPS, (path, diff)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_on_four_ranks_matches_the_mesh_of_one(runs, layout):
    for rank in runs["ranks"]:
        got = rank["train"][layout]
        _hold_train(got, runs["plain"]["train"])
        for path, p in flatten_with_path(got["params"]):  # bf16 of master
            assert torch.equal(p, dict(flatten_with_path(got["master"]))[
                path].to(torch.bfloat16)), path


def test_train_on_four_ranks_matches_the_reference_gspmd(runs):
    ref = runs["ref"]["train"]
    _hold_train({"metrics": runs["plain"]["train"]["metrics"],
                 "master": runs["plain"]["train"]["master"]}, ref)
    for layout in LAYOUTS:
        _hold_train(runs["ranks"][0]["train"][layout], ref)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_zero1_update_from_the_same_gradients(runs, layout):
    """ZeRO-1 slices, the int8 moment's blocks across ranks, the global
    norm over shards and the parameters' all-gather, against
    ``optimizer.apply`` on the whole tensors."""
    want = runs["plain"]["update"]
    for rank in runs["ranks"]:
        got = rank["update"][layout]
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-6)
        master = dict(flatten_with_path(want["opt"]["master"]))
        for path, g in flatten_with_path(got["opt"]["master"]):
            assert _share(g, master[path]) <= 1e-6, path
        v = dict(flatten_with_path(want["opt"]["v"]))
        for path, g in flatten_with_path(got["opt"]["v"]):
            w = v[path].float()
            assert bool(((g.float() - w).abs() <= BF16_ULP * w.abs()
                         ).all()), path
        gm = dict(flatten_with_path(got["opt"]["m"]))
        wm = dict(flatten_with_path(want["opt"]["m"]))
        for lead, w in master.items():  # int8: within a step of its block
            shape = w.shape
            g_m, w_m = (topt._dequantize({k: mm[lead + (k,)] for k in (
                "q", "scale")}, shape) for mm in (gm, wm))
            step = wm[lead + ("scale",)].repeat_interleave(
                topt.QBLOCK, dim=-1)[..., :shape[-1]]
            assert bool(((g_m - w_m).abs() <= 1.01 * step).all()), lead
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(got["params"]), flatten_with_path(
                tree_map(lambda t: t.to(torch.bfloat16),
                         got["opt"]["master"]))))


# ------------------------------------------- the dry run's fake trace ---
@pytest.fixture(scope="module")
def fake_group():
    """A fake process group of 4 ranks for the dry run's traces."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _traced(arch: str, layout: str, kind: str, d: dict) -> tuple:
    from torch.distributed.device_mesh import init_device_mesh
    shape, fsdp = LAYOUTS[layout]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = MeshRules(mesh, fsdp=fsdp)
    cfg = get_config(arch).reduced()
    serve = ShapeConfig("serve", d.get("T", 0), B, "decode")
    if kind == "train":
        step, in_sh = build_train_step(cfg, rules, TCFG)[:2]
        sc = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    elif kind == "prefill":  # the prompt, into a cache of T slots
        step, in_sh = build_prefill_step(cfg, rules, serve)[:2]
        sc = ShapeConfig("serve", P, B, "prefill")
    else:  # a cache of T slots (cache_specs adds a VLM's patches)
        step, in_sh = build_decode_step(cfg, rules, serve)[:2]
        sc = dataclasses.replace(serve, seq_len=d["T"] - cfg.n_patches)
    step.in_sh = in_sh  # as dryrun.build_cell gives it
    stats, _ = dryrun.trace_step(cfg, sc, step, "cpu", mesh)
    return dict(stats.coll_by_kind), stats.n_collectives, stats.coll_bytes


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dry_run_trace_counts_the_collectives_the_ranks_issued(
        runs, fake_group, layout):
    counts = runs["ranks"][0]["counts"]
    for arch, kind in TRACED:
        by_kind, n, nbytes = _traced(arch, layout, kind,
                                     runs["inputs"].get(arch, {}))
        real = counts[layout, arch, kind]
        assert n == real[1] > 0, (arch, kind)
        assert {k for k, b in by_kind.items() if b} == \
            {k for k, b in real[0].items() if b}, (arch, kind)
        if kind == "train" or arch in BF16_ARCHS:  # the configs' dtypes
            assert (by_kind, nbytes) == (real[0], real[2]), (arch, kind)


# ------------------------------------------------------ the launcher ---
def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_train_launcher_on_two_ranks_trains_data_parallel():
    """``launch/train.py --num-hosts 2``: a (2, 1) host mesh of two gloo
    ranks (ZeRO-1, int8 moments) prints the losses and grad norms of one
    rank's run within the train bounds."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama32_1b", "--tiny", "--device", "cpu", "--steps", "3",
            "--ckpt-every", "100", "--batch", "4", "--seq", "16",
            "--int8-moments"]
    coord = f"localhost:{_free_port()}"
    with Children([base + extra for extra in (
            [], *(["--coordinator", coord, "--num-hosts", "2", "--host-id",
                   str(r)] for r in range(2)))]) as children:
        exits = children.wait(180)
    assert not (failed := failures(exits)), failed

    def steps(out):
        return [(float(w[3]), float(w[5])) for w in map(str.split,
                out.splitlines()) if w[:1] == ["step"]]
    one, *ranks = (steps(e.out) for e in exits)
    assert len(one) == 3 and ranks[0] == ranks[1]
    for (gl, gn), (wl, wn) in zip(ranks[0], one, strict=True):
        assert abs(gl - wl) <= LOSS_TOL * wl and abs(gn - wn) <= GNORM_TOL * wn
