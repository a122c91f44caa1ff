"""The port's mesh rules against the JAX reference's, without devices.

The reference's side builds on ``jax.sharding.AbstractMesh`` meshes of
(16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod", "data",
"model")``; the port's on ``DeviceMesh`` es of the same shapes over a
fake process group of 512 ranks (``torch.testing``'s ``FakeStore``), in
one process.  Both sides' rules read only the axis names and sizes.
What is held, entry for entry (a spec's entries: ``None``, an axis
name, or a tuple of names):

* ``param_spec`` of every leaf of all ten configs at full width, on
  both meshes, with ``fsdp`` on and off;
* ``placements`` of hand-written specs, and of every spec above: the
  port's ``Sharding`` placements are those of its spec;
* at (2, 16, 16) with ``fsdp=True``, for every cell of the reference's
  ``runnable_cells()``: the decode builder's parameter, cache, token,
  position and logits shardings, the prefill builder's batch, cache and
  logits shardings, and ``cache_shardings`` / ``_logits_sharding`` /
  ``batch_shardings`` themselves; per config, the train builder's
  shardings with fp32 and int8 moments (ZeRO-1, the int8 ``q`` /
  ``scale`` leaves and ``_fit``'s drops);
* ``input_specs`` and ``cache_specs``: the reference's shapes and dtypes
  for every config x ``SHAPES`` entry; ``make_batch`` of a decode shape
  the reference's bits.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.checkpoint import serializer as jser
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import runnable_cells
from repro.distributed.sharding import MeshRules as JRules
from repro.models import api as japi
from repro.serve import step as jserve
from repro.train import optimizer as jopt
from repro.train import step as jtrain
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed.sharding import (MeshRules, P, Sharding,
                                              placements)
from repro_torch.models import api
from repro_torch.serve import step as tserve
from repro_torch.train import optimizer as topt
from repro_torch.train import step as ttrain
from repro_torch.tree import flatten_with_path

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    """The port's two meshes over one fake group of 512 ranks."""
    if dist.is_initialized():  # another module's group: not ours to keep
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {"2x16x16": init_device_mesh(
                   "cpu", (2, 16, 16), mesh_dim_names=("pod", "data",
                                                       "model")),
               "16x16": DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                                   mesh_dim_names=("data", "model"))}
    finally:
        dist.destroy_process_group()


def _jrules(name: str, fsdp: bool) -> JRules:
    return JRules(AbstractMesh(*MESHES[name]), fsdp=fsdp)


def _entries(spec) -> tuple:
    return tuple(spec)


def _jflat(tree) -> dict:
    """{path: spec entries} of a reference tree of NamedSharding or
    PartitionSpec."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jser._path_str(p): _entries(getattr(s, "spec", s))
            for p, s in flat}


def _tflat(tree, mesh) -> dict:
    """{path: spec entries} of a port tree of ``Sharding``; each leaf's
    placements must be its spec's, on ``mesh``."""
    out = {}
    for path, sh in flatten_with_path(tree):
        assert isinstance(sh, Sharding), path
        assert sh.mesh is mesh and sh.placements == placements(sh.spec,
                                                               mesh), path
        out["/".join(map(str, path))] = _entries(sh.spec)
    return out


# ------------------------------------------------------ parameter specs ---
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(meshes, arch):
    jshapes = japi.get_model(jget_config(arch)).param_shapes()
    tshapes = api.get_model(get_config(arch)).param_shapes()
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tflat = flatten_with_path(tshapes)
    assert [jser._path_str(p) for p, _ in jflat] == \
        ["/".join(p) for p, _ in tflat]
    for name, mesh in meshes.items():
        for fsdp in (False, True):
            jr, tr = _jrules(name, fsdp), MeshRules(mesh, fsdp=fsdp)
            for (jp, jleaf), (tp, tleaf) in zip(jflat, tflat):
                keys = tuple(getattr(k, "key", str(k)) for k in jp)
                want = jr.param_spec(keys, jleaf.shape)
                got = tr.param_spec(tp, tleaf.shape)
                assert tleaf.shape == jleaf.shape
                assert _entries(got) == _entries(want), (name, fsdp, tp)
            assert _tflat(tr.params_shardings(tshapes), mesh) == _jflat(
                jr.params_pspecs(jshapes)), (name, fsdp)


def test_placements_of_hand_written_specs(meshes):
    m2, m3 = meshes["16x16"], meshes["2x16x16"]
    assert placements(P("data", None), m2) == (Shard(0), Replicate())
    assert placements(P(None, None, "model"), m2) == (Replicate(), Shard(2))
    # a tuple shards one dim over both axes, pod first (mesh order)
    assert placements(P(None, ("pod", "data"), "model"), m3) == \
        (Shard(1), Shard(1), Shard(2))
    assert placements(P(), m3) == (Replicate(),) * 3
    assert P("data", None) == P("data", None) != P("data")
    assert tuple(P(("pod", "data"), None)) == tuple(JP(("pod", "data"),
                                                       None))


def test_act_spec_batch_spec_and_axes_match_reference(meshes):
    for name, mesh in meshes.items():
        jr, tr = _jrules(name, True), MeshRules(mesh, fsdp=True)
        assert tr.axis_names == jr.axis_names
        assert tr.data_axes == jr.data_axes
        assert [tr.axis_size(a) for a in tr.axis_names] == \
            [jr.axis_size(a) for a in jr.axis_names]
        assert _entries(tr.act_spec()) == _entries(jr.act_spec())
        assert _entries(tr.batch_spec()) == _entries(jr.batch_spec())
        for batch in (1, 8, 32, 128):
            for kv in (1, 8, 16, 48):
                assert _entries(tr.cache_spec(kv, batch, 2)) == \
                    _entries(jr.cache_spec(kv, batch, 2))
            for fn in ("latent_cache_spec", "ssm_state_spec",
                       "conv_state_spec"):
                assert _entries(getattr(tr, fn)(batch)) == \
                    _entries(getattr(jr, fn)(batch)), (fn, batch)


# ------------------------------------------------------ builder shardings ---
def _cells(arch) -> list[str]:
    return [shape for a, shape in runnable_cells() if a == arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_builder_shardings_match_reference(meshes, arch):
    mesh = meshes["2x16x16"]
    jr, tr = _jrules("2x16x16", True), MeshRules(mesh, fsdp=True)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    assert _tflat(ttrain.batch_shardings(tcfg, tr), mesh) == _jflat(
        jtrain.batch_shardings(jcfg, jr))
    for name in _cells(arch):
        shape, B = SHAPES[name], SHAPES[name].global_batch
        assert _tflat(tserve.cache_shardings(
            tcfg, api.cache_specs(tcfg, shape), tr, B), mesh) == _jflat(
            jserve.cache_shardings(jcfg, japi.cache_specs(jcfg, JSHAPES[name]),
                                   jr, B)), name
        assert _entries(tserve._logits_sharding(tcfg, tr, B).spec) == \
            _entries(jserve._logits_sharding(jcfg, jr, B).spec), name
        assert tserve.rules_dsize(tr) == jserve.rules_dsize(jr) == 32
        _, t_in, t_out, t_cache = tserve.build_decode_step(tcfg, tr, shape)
        _, j_in, j_out, j_cache = jserve.build_decode_step(jcfg, jr,
                                                           JSHAPES[name])
        for t, j in zip(t_in + t_out, j_in + j_out):  # params cache tok pos
            assert _tflat(t if isinstance(t, dict) else {"x": t}, mesh) \
                == _jflat(j if isinstance(j, dict) else {"x": j}), name
        _, (_, t_batch), (t_logits, t_cache_sh), _ = \
            tserve.build_prefill_step(tcfg, tr, shape)
        _, (_, j_batch), (j_logits, j_cache_sh), _ = \
            jserve.build_prefill_step(jcfg, jr, JSHAPES[name])
        assert _tflat(t_batch, mesh) == _jflat(j_batch)
        assert _tflat(t_cache_sh, mesh) == _jflat(j_cache_sh)
        assert _entries(t_logits.spec) == _entries(j_logits.spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_shardings_match_reference(meshes, arch):
    """The train builder's in/out shardings, ZeRO-1 optimizer state with
    fp32 and with int8 moments (``q`` / ``scale``, ``_fit``'s drops)."""
    mesh = meshes["2x16x16"]
    jr, tr = _jrules("2x16x16", True), MeshRules(mesh, fsdp=True)
    for moments in ("fp32", "int8"):
        jcfg = jtrain.TrainStepConfig(adamw=jopt.AdamWConfig(
            moment_dtype=moments))
        tcfg = ttrain.TrainStepConfig(adamw=topt.AdamWConfig(
            moment_dtype=moments))
        _, j_in, j_out, _, j_opt = jtrain.build_train_step(
            jget_config(arch), jr, jcfg)
        _, t_in, t_out, t_params, t_opt = ttrain.build_train_step(
            get_config(arch), tr, tcfg)
        for t, j in zip(t_in + t_out, j_in + j_out):
            assert _tflat(t, mesh) == _jflat(j), moments
        assert [tuple(s.shape) for _, s in flatten_with_path(t_opt)] == \
            [tuple(s.shape) for s in jax.tree.leaves(j_opt)]
        if moments == "int8":  # the scales' blocks drop what no longer fits
            m = _tflat(ttrain.opt_state_shardings(tr, t_params, t_opt),
                       mesh)
            assert any(k.endswith("/scale") and v != m[k[:-5] + "q"]
                       for k, v in m.items())


# ------------------------------------------------------------ shapes -----
def _shape_dtype(t) -> tuple:
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for name in SHAPES:
        for override in (None, 3):
            want = japi.input_specs(jcfg, JSHAPES[name], override)
            got = api.input_specs(tcfg, SHAPES[name], override)
            assert {k: _shape_dtype(v) for k, v in got.items()} == {
                k: (v.shape, np.dtype(v.dtype).name)
                for k, v in want.items()}, name
        want = japi.cache_specs(jcfg, JSHAPES[name])
        got = api.cache_specs(tcfg, SHAPES[name])
        assert {k: _shape_dtype(v) for k, v in got.items()} == {
            k: (v.shape, np.dtype(v.dtype).name) for k, v in want.items()}, \
            name


def test_make_batch_of_a_decode_shape_matches_reference():
    for arch in ("llama32_1b", "phi3_vision_4b", "whisper_tiny"):
        jcfg, tcfg = jget_config(arch), get_config(arch)
        want = japi.make_batch(jcfg, JSHAPES["decode_32k"],
                               np.random.default_rng(4), batch_override=5)
        got = api.make_batch(tcfg, SHAPES["decode_32k"],
                             np.random.default_rng(4), batch_override=5,
                             device="cpu")
        assert list(got) == list(want) == ["token"]
        assert got["token"].dtype == torch.int32
        assert np.array_equal(got["token"].numpy(), np.asarray(want["token"]))
    # the train shapes still draw as before
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16)
    assert api.make_batch(get_config("llama32_1b"), shape,
                          np.random.default_rng(0), 2, "cpu")["tokens"] \
        .shape == (2, 16)
