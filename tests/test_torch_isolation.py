"""The port stands alone: no JAX, no ``repro``, no silent host fallback.

The port, ``chip_smoke.py`` and ``examples/torch_*.py`` import under a
blocker of ``jax`` and ``repro``."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import engine as tengine
from repro_torch.kernels import (flash_attn, fused_ingest, gear_cdc, gf_matmul,
                                 ref, sha1)
from repro_torch.kernels.launches import KERNELS

ROOT = pathlib.Path(__file__).resolve().parents[1]

# A meta-path finder that refuses ``jax`` and ``repro`` (and everything
# under them) while ``repro_torch`` imports normally.
_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None
    sys.meta_path.insert(0, Block())
""")


def _run_blocked(body: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", _BLOCKER + body],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_and_chip_smoke_import_without_jax_or_repro():
    proc = _run_blocked(textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__,
                                         "repro_torch."):
            importlib.import_module(mod.name)
        sys.path.insert(0, ".")
        import chip_smoke
        sys.path.insert(0, "examples")
        import torch_checkpoint_restore, torch_quickstart, torch_serve_lm
        import torch_train_lm
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        for name in ("repro_torch.kernels.fused_ingest",
                     "repro_torch.core.workload",
                     "repro_torch.kernels.flash_attn",
                     "repro_torch.configs.llama32_1b",
                     "repro_torch.models.transformer",
                     "repro_torch.models.api",
                     "repro_torch.checkpoint.manager",
                     "repro_torch.launch.serve",
                     "repro_torch.data.pipeline",
                     "repro_torch.train.trainer",
                     "repro_torch.launch.train",
                     "repro_torch.core.radmad",
                     "repro_torch.distributed.sharding",
                     "repro_torch.serve.step",
                     "repro_torch.launch.mesh",
                     "repro_torch.launch.analysis",
                     "repro_torch.launch.dryrun"):
            assert name in sys.modules, name
        print("imported", len([m for m in sys.modules
                               if m.startswith("repro_torch")]))
    """))
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_blocker_really_blocks():
    proc = _run_blocked("import repro.core\n")
    assert proc.returncode != 0 and "blocked import" in proc.stderr


def test_torch_engine_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.TorchEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.make_engine("kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.make_engine("torch")
    assert tengine.TorchEngine(device="cpu").device.type == "cpu"
    assert isinstance(tengine.make_engine("numpy"), tengine.NumpyEngine)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.make_engine("fused")
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.TorchFusedEngine()
    fused = tengine.TorchFusedEngine(device="cpu")
    assert fused.supports_fused_ingest and fused.device.type == "cpu"


def _calls(monkeypatch, module, names):
    """Record calls of ``module.<name>`` for each name."""
    seen = []
    for name in names:
        orig = getattr(module, name)

        def rec(*a, _orig=orig, _name=name, **kw):
            seen.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(module, name, rec)
    return seen


def _wrapper_calls(dev) -> list:
    """One thunk per kernel wrapper, on tensors that lie on ``dev``."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.integers(0, 256, (2, 5, 600), dtype=np.uint8)).to(dev)
    stream = torch.from_numpy(
        rng.integers(0, 256, 9000, dtype=np.uint8)).to(dev)
    blocks = torch.zeros((2, 1, 16), dtype=torch.int32, device=dev)
    counts = torch.ones(2, dtype=torch.int32, device=dev)
    packed = torch.zeros((2, 5, 512), dtype=torch.uint8, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=dev)
    return [lambda: gf_matmul.gf_matmul(np.eye(5, dtype=np.uint8), data),
            lambda: gear_cdc.gear_fire(stream, 0xFF),
            lambda: gear_cdc.gear_hash(stream),
            lambda: sha1.sha1_digest_words(blocks, counts),
            lambda: fused_ingest.fused_ingest(
                np.ones((10, 5), dtype=np.uint8), packed, lens, lens),
            lambda: flash_attn.flash_attention(q, kv, kv)]


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    seen = _calls(monkeypatch, ref,
                  ["gf_matmul_ref", "gear_hash_ref", "sha1_ref",
                   "fused_ingest_ref", "flash_attention_ref"])
    launched = _calls(monkeypatch, gf_matmul, ["launch"]) \
        + _calls(monkeypatch, gear_cdc, ["launch"]) \
        + _calls(monkeypatch, sha1, ["launch"]) \
        + _calls(monkeypatch, fused_ingest, ["launch"]) \
        + _calls(monkeypatch, flash_attn, ["launch"])
    before = dict(KERNELS)
    out = [call() for call in _wrapper_calls(torch.device("cpu"))]
    flat = [t for o in out for t in (o if isinstance(o, tuple) else (o,))]
    assert all(t.device.type == "cpu" for t in flat)
    assert seen == ["gf_matmul_ref", "gear_hash_ref", "gear_hash_ref",
                    "sha1_ref", "fused_ingest_ref", "sha1_ref",
                    "gf_matmul_ref", "flash_attention_ref"]
    assert launched == [] and KERNELS == before


def test_non_cpu_tensors_never_take_the_plain_versions(monkeypatch):
    """Off the CPU a wrapper goes to its kernel launch, which raises for
    anything but a CUDA tensor (here ``meta`` tensors); the plain
    versions are never called."""
    seen = _calls(monkeypatch, ref,
                  ["gf_matmul_ref", "gear_hash_ref", "sha1_ref",
                   "fused_ingest_ref", "flash_attention_ref"])
    for call in _wrapper_calls(torch.device("meta")):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert seen == []


def test_launch_checks_refuse_bad_inputs():
    cpu = torch.zeros((1, 5, 512), dtype=torch.uint8)
    M = torch.zeros((10, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        gf_matmul.launch(M, cpu, torch.empty((1, 10, 512), dtype=torch.uint8),
                         None)
    with pytest.raises(ValueError, match="CUDA"):
        gear_cdc.launch(torch.zeros(8192, dtype=torch.uint8), 0,
                        torch.empty(8192, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        sha1.launch(torch.zeros((1, 1, 16), dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32),
                    torch.empty((1, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        fused_ingest.launch(M, cpu, torch.ones(1, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32),
                            torch.empty((1, 5), dtype=torch.int32),
                            torch.empty((1, 10, 512), dtype=torch.uint8),
                            None)
    q = torch.zeros((1, 64, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.launch(q, q[:, :, :2], q[:, :, :2], torch.empty_like(q),
                          scale=0.125, causal=True, window=0)
