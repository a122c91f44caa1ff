"""The MoE, MLA and hybrid configs' steps on meshes of four CPU ranks,
against the reference's GSPMD steps on four forced devices and against
the port's mesh of one.

One module fixture runs, all at once:

* 4 gloo ranks (subprocesses over ``file://``, ``GLOO_SOCKET_IFNAME=lo``),
  each on the meshes of ``tests/test_torch_multirank.py``: (2, 2) with
  FSDP off (``2x2``) and on (``2x2_fsdp``), and (1, 4) (``1x4``).  On
  each they serve the reduced granite-moe-1b (experts over ``model``),
  deepseek-v2-236b (MLA: heads over ``model``, the latent cache's slots
  over ``model``; shared experts) and jamba-1.5-large (one group of its
  pattern: GQA, Mamba and MoE layers; its 2 KV heads shard by slots on
  (1, 4)) through
  ``build_prefill_step`` / ``build_decode_step`` (a prompt of 12 tokens,
  then 3 fed tokens), logging every MoE layer's routing (the step's
  ``model.moe_log``), and train each for 3 steps with int8 moments
  through ``build_train_step``.  A batch of 4 x 16 tokens is one group
  of 64, and a decode step's 4 tokens one group of 4: on (2, 2) both
  span the two data ranks.  On (2, 2) they also serve granite-moe-1b at
  ``capacity_factor=1.0``, where tokens drop, and run one MoE layer with
  the experts forced over the data plane and F over ``model`` (the
  layout of deepseek-v2's and jamba's 2.5 and 6.4 GB expert leaves at
  full width, which the reduced 256 KB leaves never take): forward and
  the gradients of ``x``, the router and the experts.  Each rank counts
  the collectives of its steps (``analysis.analyze_step``) and writes
  the ``full_tensor()`` of every output to a file;
* one JAX subprocess: the reference's jitted prefill, decode and (for
  granite-moe-1b and deepseek-v2-236b: jamba's costs a minute of
  compile) train steps with their shardings on ``jax.make_mesh((2, 2),
  ("data", "model"), axis_types=(AxisType.Auto,) * 2)`` over 4 forced
  CPU devices, on the same weights and inputs, and its serve of
  granite-moe-1b at capacity 1.0.

The mesh of one is the plain model and step, in this process.  The
serve weights are fp32 copies of the port's seed-0 draws, the train
weights the bf16 draws.  Bounds, ``tests/test_torch_multirank.py``'s:
prefill logits 1e-5 and decode logits 5e-3 of the largest |value|; each
bf16 cache entry within one bf16 ulp of its own |value| plus 5e-3 of the
largest; the fp32 SSM state 1e-5; train loss within 1e-3 and grad norm
within 5e-3 relative a step (``_hold_train`` says why the master copy
is not held entry by entry).
Every MoE layer's routing (``idx``, ``keep``) equals the mesh of one's
exactly, drops included.  The forced layer's output is within 1e-5 of
``repro.models.layers.moe`` and its gradients within 1e-5 of the mesh
of one's, of their largest |value|.

The dry run's trace of one MoE, one MLA and one hybrid step
(``TRACED``) on a fake 4-rank group counts the same collectives as the
ranks issued (kinds and number; the ranks' fp32 copies double the
bytes, so bytes are held on the bf16 train step).
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as jget_config
from repro.models import layers as JL
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline as tdata
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch import dryrun
from repro_torch.launch.serve import prompts
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepConfig, build_train_step
from repro_torch.tree import flatten_with_path, tree_map

from test_torch_multirank import (BF16_ULP, FP32_DECODE, FP32_PREFILL,
                                  GNORM_TOL, LOSS_TOL, STATE_TOL, _f32,
                                  _host, _Mesh1, _share)
from children import Children, failures, one_thread

ARCHS = ("granite_moe_1b", "deepseek_v2_236b", "jamba_15_large")
REF_TRAIN = ("granite_moe_1b", "deepseek_v2_236b")
LAYOUTS = {"2x2": ((2, 2), False), "2x2_fsdp": ((2, 2), True),
           "1x4": ((1, 4), False)}
B, P, STEPS, T = 4, 12, 3, 16
TRAIN_B, TRAIN_S, TRAIN_STEPS, LR = 4, 16, 3, 1e-3
TCFG = TrainStepConfig(remat=False, adamw=topt.AdamWConfig(
    lr=LR, moment_dtype="int8"))
DROP_ARCH, DROP_CAPACITY = "granite_moe_1b", 1.0
LAYER_TOL = 1e-5
# the forced layer: 4 x 8 tokens, one group spanning the data ranks
LAYER_B, LAYER_S = 4, 8
TRACED = (("granite_moe_1b", "decode"), ("deepseek_v2_236b", "decode"),
          ("jamba_15_large", "prefill"), ("granite_moe_1b", "train"))


def _cfg(arch: str, capacity: float | None = None):
    """The reduced config (a hybrid cut to one group of its pattern: one
    attention, seven Mamba, four MLP and four MoE layers)."""
    cfg = get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
    return cfg if capacity is None else dataclasses.replace(
        cfg, capacity_factor=capacity)


# ---------------------------------------------------------------- ranks ---
_RANK = textwrap.dedent("""
    import dataclasses, datetime, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.distributed.collectives import Par
    from repro_torch.distributed.sharding import MeshRules, shard_tree, sharded
    from repro_torch.launch import analysis
    from repro_torch.models import layers as L
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.train import optimizer as topt
    from repro_torch.train.step import TrainStepConfig, build_train_step
    from repro_torch.tree import tree_map

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

    def counted(fn, *args):
        res = []
        st = analysis.analyze_step(lambda: res.append(fn(*args)))
        return res[0], (dict(st.coll_by_kind), st.n_collectives,
                        st.coll_bytes)

    def cfg_of(arch, capacity=None):
        cfg = get_config(arch).reduced()
        if cfg.family == "hybrid":  # one group of its pattern
            cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
        return cfg if capacity is None else dataclasses.replace(
            cfg, capacity_factor=capacity)

    def serve(rules, arch, d, capacity=None):
        cfg = cfg_of(arch, capacity)
        sc = ShapeConfig("serve", d["T"], d["B"], "decode")
        prefill, (psh, bsh), _, _ = build_prefill_step(cfg, rules, sc)
        decode, in_sh, _, _ = build_decode_step(cfg, rules, sc)
        prefill.model.moe_log, decode.model.moe_log = [], []
        params = shard_tree(d["params"], psh)
        (logits, cache), n_pre = counted(prefill, params,
                                         shard_tree(d["batch"], bsh))
        got, n_dec = [logits.full_tensor()], None
        for i, tok in enumerate(d["feed"]):
            args = (params, cache, shard_tree(tok, in_sh[2]), d["P"] + i)
            if i == 0:
                (logits, cache), n_dec = counted(decode, *args)
            else:
                logits, cache = decode(*args)
            got.append(logits.full_tensor())
        log = [(i, k) for i, k, _ in prefill.model.moe_log
               + decode.model.moe_log]
        return {"logits": got, "cache": full(cache), "routing": log}, \\
            n_pre, n_dec

    def train(rules, arch, t):
        step_fn, in_sh, out_sh, _, _ = build_train_step(cfg_of(arch),
                                                        rules, tcfg)
        run = sharded(step_fn, out_sh, rules.mesh)
        state = (shard_tree(t["params"][arch], in_sh[0]),
                 shard_tree(t["opt"][arch], in_sh[1]))
        metrics, count = [], None
        for s, tokens in enumerate(t["batches"]):
            args = (*state, shard_tree({"tokens": tokens}, in_sh[2]))
            if s == 0:
                (*state, m), count = counted(run, *args)
            else:
                *state, m = run(*args)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return {"metrics": metrics,
                "master": full(state[1]["master"])}, count

    def forced_layer(par, lay):
        # experts over the data plane, F over model: rank (i, j) holds
        # the rows of data rank i, experts E/2 of chunk i, F/2 of slice j
        cfg = cfg_of(lay["arch"], lay["capacity"])
        di, mj = par.data.rank, par.model.rank
        rows = slice(di * lay["x"].shape[0] // 2,
                     (di + 1) * lay["x"].shape[0] // 2)
        E, F = cfg.n_experts, cfg.moe_d_ff
        e = slice(di * E // 2, (di + 1) * E // 2)
        f = slice(mj * F // 2, (mj + 1) * F // 2)
        p = lay["p"]
        live = {"router": p["router"][:, mj * E // 2:(mj + 1) * E // 2],
                "wg": p["wg"][e, :, f], "wu": p["wu"][e, :, f],
                "wd": p["wd"][e, f, :]}
        live = {k: v.clone().requires_grad_(True) for k, v in live.items()}
        x = lay["x"][rows].clone().requires_grad_(True)
        log = []
        y = L.moe(x, live, cfg, log, par=par,
                  layout=("data", None, "model"))
        (y.float() * lay["cot"][rows]).sum().backward()
        router = par.sum_over(live["router"].grad, "data")
        return {"y": y.detach(), "x": x.grad, "router": router,
                **{k: live[k].grad for k in ("wg", "wu", "wd")},
                "routing": log}

    out = {"serve": {}, "train": {}, "counts": {}}
    for layout, (shape, fsdp) in inp["layouts"].items():
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        rules = MeshRules(mesh, fsdp=fsdp)
        for arch, d in inp["serve"].items():
            res, n_pre, n_dec = serve(rules, arch, d)
            out["serve"][layout, arch] = res
            out["counts"][layout, arch, "prefill"] = n_pre
            out["counts"][layout, arch, "decode"] = n_dec
            res, count = train(rules, arch, inp["train"])
            out["train"][layout, arch] = res
            out["counts"][layout, arch, "train"] = count
        if layout == "2x2":
            out["drop"] = serve(rules, inp["drop"]["arch"],
                                inp["serve"][inp["drop"]["arch"]],
                                inp["drop"]["capacity"])[0]
            out["layer"] = forced_layer(Par(mesh), inp["layer"])
    torch.save(out, f"{tmp}/out{rank}.pt")
    dist.destroy_process_group()
""")

_REFERENCE = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
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

    def serve(cfg, d):
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
                                jnp.int32(d["P"] + i))
            got.append(np.asarray(logits))
        return {"logits": got, "cache": host(cache)}

    def cfg_of(arch):
        cfg = get_config(arch).reduced()
        if cfg.family == "hybrid":  # one group of its pattern
            cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
        return cfg

    out = {"serve": {}, "train": {}}
    for arch, d in inp["serve"].items():
        out["serve"][arch] = serve(cfg_of(arch), d)
    drop = inp["drop"]
    out["drop"] = serve(dataclasses.replace(
        cfg_of(drop["arch"]), capacity_factor=drop["capacity"]),
        inp["serve"][drop["arch"]])
    t = inp["train"]
    tcfg = TrainStepConfig(remat=False, adamw=jopt.AdamWConfig(
        lr=t["lr"], moment_dtype="int8"))
    for arch in t["archs"]:
        step, ish, osh, _, _ = build_train_step(cfg_of(arch), rules, tcfg)
        jstep = jax.jit(step, in_shardings=ish, out_shardings=osh)
        params = jax.tree.map(jnp.asarray, t["params"][arch])
        state = (params, jopt.init(params, tcfg.adamw))
        metrics = []
        for tokens in t["batches"]:
            *state, m = jstep(*state, {"tokens": jnp.asarray(tokens)})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out["train"][arch] = {"metrics": metrics,
                              "master": host(state[1]["master"])}
    with open(f"{tmp}/ref_out.pkl", "wb") as f:
        pickle.dump(out, f)
""")


def _serve_inputs(arch: str) -> dict:
    cfg = _cfg(arch)
    params = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                      else t, params)  # fp32 copies of the seed-0 draws
    batch = prompts(cfg, B, P, 0, "cpu")
    batch["tokens"] = batch["tokens"].to(torch.int32)
    feed = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32))
    return {"params": params, "batch": batch, "feed": feed, "T": T,
            "B": B, "P": P}


def _plain_serve(arch: str, d: dict, capacity: float | None = None
                 ) -> dict:
    """The mesh of one: the plain model's prefill and decode steps."""
    model = api.get_model(_cfg(arch, capacity))
    model.moe_log = []
    with torch.no_grad():
        logits, cache = model.prefill(d["params"], d["batch"],
                                      cache_len=d["T"])
        got = [logits]
        for i, tok in enumerate(d["feed"]):
            logits, cache = model.decode_step(d["params"], cache, tok,
                                              d["P"] + i)
            got.append(logits.clone())
    return {"logits": got, "cache": cache,
            "routing": [(i, k) for i, k, _ in model.moe_log]}


def _plain_train(arch: str, t: dict) -> dict:
    step = build_train_step(_cfg(arch), MeshRules(_Mesh1()), TCFG)[0]
    state, metrics = (t["params"][arch], t["opt"][arch]), []
    for tokens in t["batches"]:
        *state, m = step(*state, {"tokens": tokens})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "master": state[1]["master"]}


def _layer_inputs() -> dict:
    """One MoE layer of reduced deepseek-v2 at capacity 1.0, fp32, and a
    cotangent for its output."""
    cfg = _cfg("deepseek_v2_236b", DROP_CAPACITY)
    rng = np.random.default_rng(5)
    p = L.moe_init(torch.Generator().manual_seed(3), cfg)
    p = {k: v.float() for k, v in p.items() if k != "shared"}
    x = torch.from_numpy(rng.normal(size=(LAYER_B, LAYER_S, cfg.d_model))
                         .astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    return {"arch": "deepseek_v2_236b", "capacity": DROP_CAPACITY,
            "p": p, "x": x, "cot": cot}


def _plain_layer(lay: dict) -> dict:
    cfg = _cfg(lay["arch"], lay["capacity"])
    live = {k: v.clone().requires_grad_(True) for k, v in lay["p"].items()}
    x = lay["x"].clone().requires_grad_(True)
    log = []
    y = L.moe(x, live, cfg, log)
    (y.float() * lay["cot"]).sum().backward()
    return {"y": y.detach(), "x": x.grad, "routing": log,
            **{k: v.grad for k, v in live.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank_moe")
    serve = {arch: _serve_inputs(arch) for arch in ARCHS}
    corpus = tdata.SyntheticCorpus(tdata.DataConfig(
        seq_len=TRAIN_S, global_batch=TRAIN_B, vocab_size=512))
    batches = [torch.from_numpy(corpus.batch(s)["tokens"])
               for s in range(TRAIN_STEPS)]
    tparams = {arch: api.get_model(_cfg(arch)).init(
        torch.Generator().manual_seed(0)) for arch in ARCHS}
    train = {"params": tparams, "batches": batches,
             "opt": {a: topt.init(p, TCFG.adamw) for a, p in tparams.items()}}
    layer = _layer_inputs()
    drop = {"arch": DROP_ARCH, "capacity": DROP_CAPACITY}
    torch.save({"serve": serve, "train": train, "layouts": LAYOUTS,
                "lr": LR, "drop": drop, "layer": layer}, tmp / "port_in.pt")
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"serve": {a: {k: tree_map(_host, v) if k in (
            "params", "batch", "feed") else v for k, v in d.items()}
            for a, d in serve.items()}, "drop": drop,
            "train": {"archs": REF_TRAIN, "lr": LR,
                      "params": {a: tree_map(_host, tparams[a])
                                 for a in REF_TRAIN},
                      "batches": [b.numpy() for b in batches]}}, f)
    argvs = [[sys.executable, "-c", _RANK, str(tmp), str(r)]
             for r in range(4)]
    argvs.append([sys.executable, "-c", _REFERENCE, str(tmp)])
    with Children(argvs) as children, one_thread():
        # the mesh of one, in this process while the ranks run
        plain = {"serve": {a: _plain_serve(a, d) for a, d in serve.items()},
                 "train": {a: _plain_train(a, train) for a in ARCHS},
                 "drop": _plain_serve(DROP_ARCH, serve[DROP_ARCH],
                                      DROP_CAPACITY),
                 "layer": _plain_layer(layer)}
        exits = children.wait(240)
    assert not (failed := failures(exits)), failed
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(4)]
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"ranks": ranks, "plain": plain, "ref": ref, "inputs": serve,
            "layer": layer}


# ----------------------------------------------------------- the bounds ---
def _hold_serve(got: dict, want: dict) -> None:
    """Logits a step and every cache leaf, by the module's bounds."""
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"],
                                   strict=True)):
        tol = FP32_PREFILL if i == 0 else FP32_DECODE
        assert _share(_f32(g), _f32(w)) <= tol, i
    assert sorted(got["cache"]) == sorted(want["cache"])
    for name, w in want["cache"].items():
        g, w = _f32(got["cache"][name]), _f32(w)
        assert g.shape == w.shape, name
        if name in ("h", "conv"):  # the fp32 SSM state
            assert _share(g, w) <= STATE_TOL, name
        else:  # bf16 slots: an ulp of each entry, and the decode bound
            assert bool(((g - w).abs() <= BF16_ULP * w.abs()
                         + FP32_DECODE * w.abs().max()).all()), name


def _rows(layout: str, rank: int) -> slice:
    """The batch rows a rank holds: its data rank's share."""
    d = LAYOUTS[layout][0][0]
    b = B // d
    r = rank // (4 // d)
    return slice(r * b, (r + 1) * b)


def _hold_routing(got: list, want: list, rows: slice) -> None:
    """Each MoE layer's (idx, keep) of a rank's rows: the mesh of one's,
    exactly (a decode step's entries after the prefill's)."""
    assert len(got) == len(want) > 0
    for (gi, gk), (wi, wk) in zip(got, want):
        assert torch.equal(gi, wi[rows]) and torch.equal(gk, wk[rows])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_serve_on_four_ranks_matches_the_mesh_of_one(runs, layout, arch):
    want = runs["plain"]["serve"][arch]
    for rank, out in enumerate(runs["ranks"]):
        got = out["serve"][layout, arch]
        _hold_serve(got, want)
        _hold_routing(got["routing"], want["routing"], _rows(layout, rank))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_four_ranks_matches_the_reference_gspmd(runs, arch):
    """The reference's jitted steps on its (2, 2) Auto mesh of forced
    devices against the port's mesh of one and every mesh."""
    ref = runs["ref"]["serve"][arch]
    assert _share(_f32(ref["logits"][0]), _f32(
        runs["plain"]["serve"][arch]["logits"][0])) <= FP32_PREFILL
    for layout in LAYOUTS:
        _hold_serve(runs["ranks"][0]["serve"][layout, arch], ref)


def test_capacity_drops_route_as_the_mesh_of_one(runs):
    """At capacity 1.0 tokens drop, and on (2, 2) the prompt's group of
    48 and each decode step's group of 4 span the two data ranks: the
    capacity and the queue places come from the whole group, so every
    drop is the mesh of one's; the outputs hold the reference's too."""
    want = runs["plain"]["drop"]
    kept = [bool(k.all()) for _, k in want["routing"]]
    assert not all(kept)  # tokens drop
    for rank, out in enumerate(runs["ranks"]):
        _hold_serve(out["drop"], want)
        _hold_routing(out["drop"]["routing"], want["routing"],
                      _rows("2x2", rank))
    _hold_serve(runs["ranks"][0]["drop"], runs["ref"]["drop"])


def _hold_train(got: dict, want: dict) -> None:
    """Loss and grad norm a step; every master leaf of the same shape and
    finite (entry by entry it is not held: AdamW's normalised step moves
    an entry whose gradient is near 0 by about lr whichever way the two
    runs round it, and over several such steps further than the dense
    configs' 2 lr a step: the reduced jamba read 6.6e-3 of 6e-3)."""
    for (gl, gn), (wl, wn) in zip(got["metrics"], want["metrics"],
                                  strict=True):
        assert abs(gl - wl) <= LOSS_TOL * abs(wl), (gl, wl)
        assert abs(gn - wn) <= GNORM_TOL * abs(wn), (gn, wn)
    want_master = dict(flatten_with_path(want["master"]))
    for path, g in flatten_with_path(got["master"]):
        g = _f32(g)
        assert g.shape == tuple(want_master[path].shape), path
        assert bool(torch.isfinite(g).all()), path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_on_four_ranks_matches_the_mesh_of_one(runs, layout, arch):
    for out in runs["ranks"]:
        _hold_train(out["train"][layout, arch], runs["plain"]["train"][arch])


@pytest.mark.parametrize("arch", REF_TRAIN)
def test_train_on_four_ranks_matches_the_reference_gspmd(runs, arch):
    ref = runs["ref"]["train"][arch]
    _hold_train(runs["plain"]["train"][arch], ref)
    for layout in LAYOUTS:
        _hold_train(runs["ranks"][0]["train"][layout, arch], ref)


# ------------------------------------------- experts over the data plane --
def _layer_slices(rank: int, cfg) -> dict:
    """Rank (i, j) of (2, 2): data rank i's rows and expert chunk, model
    rank j's router columns and F slice."""
    i, j = divmod(rank, 2)
    E, F = cfg.n_experts, cfg.moe_d_ff
    e, f = slice(i * E // 2, (i + 1) * E // 2), slice(j * F // 2,
                                                      (j + 1) * F // 2)
    rows = slice(i * LAYER_B // 2, (i + 1) * LAYER_B // 2)
    return {"y": (rows,), "x": (rows,),
            "router": (slice(None), slice(j * E // 2, (j + 1) * E // 2)),
            "wg": (e, slice(None), f), "wu": (e, slice(None), f),
            "wd": (e, f)}


def test_forced_data_plane_experts_forward_matches_the_reference(runs):
    """Experts over the data plane and F over ``model`` (forced at the
    reduced width), one group spanning the data ranks at capacity 1.0:
    each rank's output rows equal ``repro.models.layers.moe``'s within
    1e-5, and its routing the mesh of one's."""
    lay = runs["layer"]
    cfg = _cfg(lay["arch"], lay["capacity"])
    jcfg = dataclasses.replace(jget_config(lay["arch"]).reduced(),
                               capacity_factor=lay["capacity"])
    want = np.asarray(JL.moe(jnp.asarray(lay["x"].numpy()), {
        k: jnp.asarray(v.numpy()) for k, v in lay["p"].items()}, jcfg))
    want = torch.from_numpy(want.copy())
    plain = runs["plain"]["layer"]
    assert not bool(plain["routing"][0][1].all())  # tokens drop
    assert _share(plain["y"], want) <= LAYER_TOL
    for rank, out in enumerate(runs["ranks"]):
        rows = _layer_slices(rank, cfg)["y"][0]
        assert _share(out["layer"]["y"], want[rows]) <= LAYER_TOL, rank
        (gi, gk, _), = out["layer"]["routing"]
        (wi, wk, _), = plain["routing"]
        assert torch.equal(gi, wi[rows]) and torch.equal(gk, wk[rows])


@pytest.mark.parametrize("leaf", ("x", "router", "wg", "wu", "wd"))
def test_forced_data_plane_experts_gradients_match_the_mesh_of_one(
        runs, leaf):
    """The gradient of each rank's shard, against its slice of the mesh
    of one's, within 1e-5 of the largest |value|: ``x``'s through the
    all-to-all's backward; the router's (summed over the data plane, as
    the train step sums it) neither lost nor counted twice over
    ``model``; the experts' holding both data ranks' tokens."""
    cfg = _cfg(runs["layer"]["arch"], runs["layer"]["capacity"])
    want = runs["plain"]["layer"][leaf]
    assert float(want.abs().max()) > 0
    for rank, out in enumerate(runs["ranks"]):
        got = out["layer"][leaf]
        w = want[_layer_slices(rank, cfg)[leaf]]
        assert got.shape == w.shape
        assert _share(got, w) <= LAYER_TOL, (leaf, rank)


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


def _traced(arch: str, layout: str, kind: str) -> tuple:
    from torch.distributed.device_mesh import init_device_mesh
    shape, fsdp = LAYOUTS[layout]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rules = MeshRules(mesh, fsdp=fsdp)
    cfg = _cfg(arch)
    serve = ShapeConfig("serve", T, B, "decode")
    if kind == "train":
        step, in_sh = build_train_step(cfg, rules, TCFG)[:2]
        sc = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    elif kind == "prefill":
        from repro_torch.serve.step import build_prefill_step
        step, in_sh = build_prefill_step(cfg, rules, serve)[:2]
        sc = ShapeConfig("serve", P, B, "prefill")
    else:  # a cache of T slots
        from repro_torch.serve.step import build_decode_step
        step, in_sh = build_decode_step(cfg, rules, serve)[:2]
        sc = serve
    step.in_sh = in_sh  # as dryrun.build_cell gives it
    stats, _ = dryrun.trace_step(cfg, sc, step, "cpu", mesh)
    return dict(stats.coll_by_kind), stats.n_collectives, stats.coll_bytes


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dry_run_trace_counts_the_collectives_the_ranks_issued(
        runs, fake_group, layout):
    counts = runs["ranks"][0]["counts"]
    for arch, kind in TRACED:
        by_kind, n, nbytes = _traced(arch, layout, kind)
        real = counts[layout, arch, kind]
        assert n == real[1] > 0, (arch, kind)
        assert {k for k, b in by_kind.items() if b} == \
            {k for k, b in real[0].items() if b}, (arch, kind)
        if kind == "train":  # the configs' own bf16 weights
            assert (by_kind, nbytes) == (real[0], real[2]), (arch, kind)


# ---------------------------------------------- the card's routing replay --
def test_rank_replay_routes_by_global_token_index():
    """``chip_smoke.rank_replay`` hands each ``layers.route_groups`` call
    of a rank the mesh of one's top-k sets of the rows it routes, found
    by their first token's global index (a rank's own group from token
    3; a group spanning the ranks from token 0, its two pad rows keeping
    their own choice), and counts the rows whose own choice was
    another."""
    import chip_smoke
    cfg = _cfg("granite_moe_1b")
    E, K = cfg.n_experts, cfg.experts_per_token
    gen = torch.Generator().manual_seed(0)
    served = [torch.randint(0, E, (2, 3, K), generator=gen)
              for _ in range(2)]  # (B, S, K): 6 tokens a pass
    logits = [torch.randn(1, 3, E, generator=gen),
              torch.randn(1, 8, E, generator=gen)]
    route = L.route_groups
    with chip_smoke.rank_replay(served) as replay:
        got = [L.route_groups(logits[0], cfg, first=3),
               L.route_groups(logits[1], cfg)]
    assert L.route_groups is route and replay["calls"] == 2
    own = [route(lg, cfg).idx.reshape(-1, K) for lg in logits]
    want = [served[0].reshape(-1, K)[3:], torch.cat(
        [served[1].reshape(-1, K), own[1][6:]])]
    flips = 0
    for g, w, o in zip(got, want, own):
        assert torch.equal(g.idx.reshape(-1, K), w)
        flips += int((o.sort(-1).values != w.sort(-1).values).any(-1).sum())
    assert replay["flips"] == flips > 0
