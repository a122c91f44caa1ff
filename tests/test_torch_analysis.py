"""The port's step analysis and dry run against the JAX reference's.

* ``analyze_step`` on the seven cases of ``tests/test_analysis.py``: a
  matmul and a batched einsum exact, a loop of L matmuls and a nested
  loop at L x the body (eager loops are unrolled), ``(x + 1) * 2``'s
  bytes within 2x-6x its size, a DTensor collective on a fake 4-rank mesh
  (and none on a mesh of one), ``torch.utils.checkpoint`` under autograd;
* its FLOPs on a reduced llama3.2-1b prefill and train step, from the
  reference's weights and tokens, against ``analyze_hlo`` over the
  jitted reference (dense only: the reference dispatches MoE tokens by
  one-hot einsums, which count as dots, the port by gathers);
* ``runnable_cells`` and the per-arch tables equal to the reference's;
* ``resident_gb_per_chip`` of every runnable cell on 16x16 and 2x16x16
  equal to the reference's ``analytical_memory_gb`` on its builders'
  shardings (on ``AbstractMesh`` es; ``repro.launch.dryrun`` is imported
  with ``XLA_FLAGS`` put back, since its first line rewrites it);
* ``lower_cell`` on whisper-tiny at each shape kind, on fake CPU tensors;
* the dry run's one-block trace of blockwise attention counts what the
  loops over every block count, with and without a gradient;
* ``_rope_inv`` never hands a fake tensor to the next fake mode or to a
  real run.

The meshes stand on one fake process group of 512 ranks
(``FakeStore``), made by a module fixture that destroys any group it
finds first and its own at the end.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import runnable_cells as jrunnable_cells
from repro.distributed.sharding import MeshRules as JRules
from repro.launch.analysis import analyze_hlo
from repro.models import api as japi
from repro.serve import step as jserve
from repro.train import optimizer as jopt
from repro.train import step as jtrain
from repro_torch.configs.base import ARCH_IDS, get_config, runnable_cells
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.analysis import Roofline, analyze_step
from repro_torch.models import api, layers
from repro_torch.train import optimizer as topt
from repro_torch.train import step as ttrain


@pytest.fixture(scope="module")
def group():
    """One fake process group of 512 ranks for the module."""
    if dist.is_initialized():  # another module's group: not ours to keep
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(group):
    return {False: dryrun.production_mesh(False, "cpu"),
            True: dryrun.production_mesh(True, "cpu")}


# ------------------------------------------- the reference's seven cases ---
def test_single_matmul_flops():
    stats = analyze_step(lambda x, y: x @ y, torch.randn(128, 256),
                         torch.randn(256, 512))
    assert stats.flops == 2 * 128 * 256 * 512
    assert stats.unknown_loops == 0


def test_loop_multiplies_flops_by_trip_count():
    L = 7

    def fn(ws, x):
        for i in range(L):
            x = x @ ws[i]
        return x

    stats = analyze_step(fn, torch.randn(L, 64, 64), torch.randn(8, 64))
    assert stats.flops == L * 2 * 8 * 64 * 64
    assert stats.unknown_loops == 0


def test_nested_loop_weights_multiply():
    Lo, Li = 3, 5

    def fn(ws, x):
        for o in range(Lo):
            for i in range(Li):
                x = x @ ws[o, i]
        return x

    stats = analyze_step(fn, torch.randn(Lo, Li, 32, 32), torch.randn(4, 32))
    assert stats.flops == Lo * Li * 2 * 4 * 32 * 32


def test_batched_dot_flops():
    stats = analyze_step(lambda x, y: torch.einsum("bik,bkj->bij", x, y),
                         torch.randn(4, 16, 32), torch.randn(4, 32, 8))
    assert stats.flops == 2 * 4 * 16 * 32 * 8


def test_bytes_traffic_nonzero_and_sane():
    stats = analyze_step(lambda x: (x + 1.0) * 2.0, torch.randn(1024, 1024))
    nbytes = 1024 * 1024 * 4
    # read input + write output per op, two ops: in [2x, 6x]
    assert 2 * nbytes <= stats.bytes_traffic <= 6 * nbytes


@pytest.mark.parametrize("ranks", [4, 1])
def test_collectives_counted_under_mesh(group, ranks):
    """A sharded DTensor made whole: an all-gather of its local shard on a
    fake 4-rank mesh; nothing to gather on a mesh of one."""
    mesh = DeviceMesh("cpu", torch.arange(ranks), mesh_dim_names=("d",))
    x = DTensor.from_local(torch.randn(8, 8), mesh, [Shard(0)],
                           run_check=False)
    stats = analyze_step(
        lambda v: v.redistribute(mesh, [Replicate()]).to_local(), x)
    if ranks == 1:
        assert stats.coll_bytes == 0 and stats.n_collectives == 0
    else:
        assert stats.coll_by_kind["all-gather"] == 8 * 8 * 4 > 0
        assert stats.coll_bytes == 8 * 8 * 4 and stats.n_collectives == 1
    assert set(stats.coll_by_kind) == set(analysis.COLLECTIVES)


def test_checkpoint_under_autograd_still_counted():
    """Remat under autograd: the recompute adds dot FLOPs."""
    L = 4
    w = torch.randn(L, 64, 64, requires_grad=True)
    x0 = torch.randn(8, 64)

    def fn(ws, x):
        for i in range(L):
            x = checkpoint(lambda c, wi: torch.tanh(c @ wi), x, ws[i],
                           use_reentrant=False)
        return torch.autograd.grad(x.sum(), [ws])

    stats = analyze_step(fn, w, x0)
    base = L * 2 * 8 * 64 * 64
    # fwd + recompute + 2 bwd matmuls ~ 4x fwd; allow 3x..6x
    assert 3 * base <= stats.flops <= 6 * base, (stats.flops, base)


def test_roofline_with_unknown_collectives():
    roof = Roofline(flops=989e12, bytes_accessed=6.7e12, coll_bytes=None,
                    chips=1, model_flops=989e12)
    assert roof.t_collective is None
    assert roof.t_bound == roof.t_memory == pytest.approx(2.0)
    assert roof.bottleneck == "memory"
    d = roof.to_dict()
    assert d["coll_bytes"] is None and d["t_collective_s"] is None
    known = Roofline(989e12, 0.0, 450e9 * 3, 1, 0.0)
    assert known.bottleneck == "collective"
    assert known.t_collective == pytest.approx(3.0)
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == \
        (989e12, 3.35e12, 450e9)


# ------------------------------------------ the reference's analyze_hlo ---
def _llama_reduced():
    jcfg = jget_config("llama32_1b").reduced()
    jparams = japi.get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = api.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    return jcfg, get_config("llama32_1b").reduced(), jparams, tparams, tokens


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flops_match_reference_analyze_hlo(kind):
    """Reduced llama3.2-1b, the reference's weights and tokens: the
    counted FLOPs within 5% of ``analyze_hlo`` over the jitted reference
    (its train step on a (1, 1) mesh of Auto axes, remat on)."""
    jcfg, tcfg, jparams, tparams, tokens = _llama_reduced()
    S = tokens.shape[1]
    if kind == "prefill":
        jm = japi.get_model(jcfg)
        hlo = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=S)).lower(
            jparams, {"tokens": jnp.asarray(tokens)}).compile().as_text()
        tm = api.get_model(tcfg)
        with torch.no_grad():
            got = analyze_step(tm.prefill, tparams,
                               {"tokens": torch.from_numpy(tokens)},
                               cache_len=S)
    else:
        mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        jstep = jtrain.build_train_step(jcfg, JRules(mesh),
                                        jtrain.TrainStepConfig())[0]
        hlo = jax.jit(jstep).lower(
            jparams, jopt.init(jparams, jopt.AdamWConfig()),
            {"tokens": jnp.asarray(tokens)}).compile().as_text()
        tstep = ttrain.build_train_step(
            tcfg, MeshRules(_OneDeviceMesh()), ttrain.TrainStepConfig())[0]
        got = analyze_step(tstep, tparams,
                           topt.init(tparams, topt.AdamWConfig()),
                           {"tokens": torch.from_numpy(tokens)})
    want = analyze_hlo(hlo)
    print(f"{kind}: analyze_step {got.flops:.6e}, analyze_hlo "
          f"{want.flops:.6e}")
    assert want.unknown_loops == 0
    assert got.flops == pytest.approx(want.flops, rel=0.05)


@dataclasses.dataclass
class _OneDeviceMesh:
    """What ``MeshRules`` and ``build_train_step`` read of a mesh of one
    CPU device: its axis names and sizes, and its device type."""
    mesh_dim_names: tuple = ("data", "model")
    shape: tuple = (1, 1)
    device_type: str = "cpu"

    def size(self, dim: int | None = None) -> int:
        return 1


# ------------------------------------------------ cells and the tables ---
def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` put back: its
    first line sets 512 host devices for the process and its children."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def test_runnable_cells_and_tables_match_reference():
    assert runnable_cells() == jrunnable_cells()
    jdry = _reference_dryrun()
    assert dryrun.INT8_MOMENT_ARCHS == jdry.INT8_MOMENT_ARCHS
    assert dryrun.FSDP_ARCHS == jdry.FSDP_ARCHS
    assert dryrun.TRAIN_MICROBATCHES == jdry.TRAIN_MICROBATCHES


def _reference_resident_gb(jdry, arch: str, name: str, multi_pod: bool):
    """The reference ``lower_cell``'s ``resident_gb`` (before it lowers),
    on an ``AbstractMesh`` of the production shape."""
    mesh = AbstractMesh(*(((2, 16, 16), ("pod", "data", "model"))
                          if multi_pod else ((16, 16), ("data", "model"))))
    cfg, shape = jget_config(arch), JSHAPES[name]
    rules = JRules(mesh, fsdp=arch in jdry.FSDP_ARCHS)
    if shape.kind == "train":
        tcfg = jtrain.TrainStepConfig(
            microbatches=jdry.TRAIN_MICROBATCHES.get(arch, 4),
            adamw=jopt.AdamWConfig(moment_dtype=(
                "int8" if arch in jdry.INT8_MOMENT_ARCHS else "fp32")),
            remat_policy="nothing")
        _, in_sh, _, param_shapes, opt_shapes = jtrain.build_train_step(
            cfg, rules, tcfg)
        return jdry.analytical_memory_gb(
            (in_sh[0], in_sh[1]), (param_shapes, opt_shapes), mesh)
    if shape.kind == "prefill":
        _, in_sh, out_sh, param_shapes = jserve.build_prefill_step(
            cfg, rules, shape)
        return jdry.analytical_memory_gb(
            (in_sh[0], out_sh[1]),
            (param_shapes, japi.cache_specs(cfg, shape)), mesh)
    _, in_sh, _, cache_shapes = jserve.build_decode_step(cfg, rules, shape)
    return jdry.analytical_memory_gb(
        (in_sh[0], in_sh[1]),
        (japi.get_model(cfg).param_shapes(), cache_shapes), mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resident_bytes_match_reference(meshes, arch):
    jdry = _reference_dryrun()
    names = [s for a, s in runnable_cells() if a == arch]
    assert names
    for name in names:
        for multi_pod, mesh in meshes.items():
            got = dryrun.build_cell(arch, name, mesh)[0]
            want = _reference_resident_gb(jdry, arch, name, multi_pod)
            assert got == pytest.approx(want, rel=1e-9), (name, multi_pod)


# ------------------------------------------------------------ lower_cell ---
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lower_cell_whisper_tiny(meshes, shape):
    res = dryrun.lower_cell("whisper_tiny", shape, multi_pod=True,
                            verbose=False, device="cpu", mesh=meshes[True])
    assert (res["arch"], res["shape"], res["mesh"], res["chips"]) == \
        ("whisper_tiny", shape, "2x16x16", 512)
    for key in ("memory_analysis", "xla_cost_analysis"):
        assert res[key] is None, key
    assert "collectives_unknown" not in res  # every step shards
    # one rank's sharded step: its collectives, times the chips
    assert res["n_collectives"] > 0 and res["collectives"]["all-reduce"] > 0
    assert res["coll_bytes"] == res["coll_bytes_per_chip"] * 512 > 0
    assert sum(res["collectives"].values()) == res["coll_bytes_per_chip"]
    assert res["t_collective_s"] == pytest.approx(
        res["coll_bytes"] / (512 * analysis.ICI_BW))
    assert res["flops"] == res["flops_per_chip"] * 512
    assert res["unknown_loops"] == 0
    assert res["flops"] > 0 and res["bytes"] > 0 and res["trace_s"] >= 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    cfg = get_config("whisper_tiny")
    assert res["model_flops"] == analysis.model_flops(
        cfg, dryrun.SHAPES[shape])
    assert res["resident_gb_per_chip"] == round(dryrun.build_cell(
        "whisper_tiny", shape, meshes[True])[0], 3)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 700),
                                           (False, 0)])
def test_one_tile_blockwise_counts_equal_the_loops(dtype, causal, window,
                                                   grad):
    """On fake tensors of 3 x 2 tiles (both lengths padded), the dry
    run's one-block loops (``dryrun._one_tile_attention``) count the same
    FLOPs and bytes as ``layers._attention_blockwise`` running every
    tile, and give the same output shape and dtype.  Without a gradient
    they run one block; with one, every block, and the backward that
    ``torch.autograd.grad`` runs after the loops is counted in full."""
    S, T = 2 * layers.ATTN_BLOCK_Q + 300, layers.ATTN_BLOCK_KV + 500
    with FakeTensorMode(), torch.set_grad_enabled(grad):
        q = torch.empty((2, S, 4, 16), dtype=dtype, requires_grad=grad)
        k, v = (torch.empty((2, T, 2, 16), dtype=dtype, requires_grad=grad)
                for _ in "kv")
        kw = dict(q_pos=torch.arange(S) + (T - S), kv_pos=torch.arange(T),
                  window=window, causal=causal, scale=0.25)
        out = []

        def step():
            out.append(layers._attention_blockwise(q, k, v, **kw))
            if grad:
                torch.autograd.grad(out[-1].float().sum(), (q, k, v))

        loop = analyze_step(step)
        with dryrun._one_tile_attention():
            blocks = list(layers._blocks(3))
            tile = analyze_step(step)
    assert blocks == ([0, 1, 2] if grad else [0])
    assert loop.flops > 0 and loop.bytes_traffic > 0
    assert loop == tile
    assert (out[1].shape, out[1].dtype) == (out[0].shape, out[0].dtype)


def test_dryrun_main_fails_a_cell_and_exits_1():
    """``main`` reports a cell that fails and exits 1, as the reference's
    (in a subprocess: it makes and destroys its own fake group)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper_tiny", "--shape", "no_such_shape", "--device", "cpu"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "0 cells traced OK, 1 failed" in proc.stdout
    assert "FAILED" in proc.stdout


# ------------------------------------------------------------- _rope_inv ---
def _fake_prefill(arch: str):
    cfg = get_config(arch).reduced()
    model = api.get_model(cfg)
    with FakeTensorMode():
        params = dryrun._fake(model.param_shapes(), "cpu")
        with torch.no_grad():
            model.prefill(params, {"tokens": torch.zeros(
                (2, 16), dtype=torch.int32)}, cache_len=16)


def test_rope_memo_never_keeps_a_fake_tensor():
    """granite-moe-1b traced under one fake mode, deepseek-v2 under a
    second, then granite-moe-1b run for real with the same (d, theta,
    device) key: its logits equal a run with the memo cleared, bit for
    bit."""
    cfg = get_config("granite_moe_1b").reduced()
    model = api.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))}
    _clear_rope_memo()
    _fake_prefill("granite_moe_1b")
    _fake_prefill("deepseek_v2_236b")
    with torch.no_grad():
        got = model.prefill(params, batch, cache_len=16)[0]
    _clear_rope_memo()
    with torch.no_grad():
        want = model.prefill(params, batch, cache_len=16)[0]
    assert not isinstance(got, torch._subclasses.FakeTensor)
    assert torch.equal(got, want)


def _clear_rope_memo():
    for name in ("_rope_inv", "_rope_inv_on"):
        memo = getattr(layers, name, None)
        if hasattr(memo, "cache_clear"):
            memo.cache_clear()
