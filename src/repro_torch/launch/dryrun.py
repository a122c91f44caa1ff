"""Multi-pod dry run of the port: prove the distribution config is coherent.

Port of the JAX reference's ``repro/launch/dryrun.py``.  For every
(architecture x input shape) cell it builds the step (train step,
prefill step or serve step) through the port's builders on the
production mesh -- 16x16 single pod and 2x16x16 multi-pod -- and records
the resident bytes per chip and the roofline terms to JSON.  One process
stands for the mesh: the meshes are ``DeviceMesh`` es over a fake
process group of 512 ranks (``torch.testing``'s ``FakeStore``), made at
the first call when there is no group (the 16x16 mesh takes the first
256 ranks), and the tensors are fake (``FakeTensorMode``) on ``--device``
(``cuda`` by default, as every entry point of the port), so a step of
256 x 4096 tokens costs no memory.

Per cell:

* ``resident_gb_per_chip``: the params, optimizer state and caches under
  the builders' shardings on the mesh (``analytical_memory_gb``, the
  reference's arithmetic);
* the roofline terms (``analysis.Roofline``) from one rank's counts
  (``analysis.analyze_step`` on fake tensors) times the chips, as the
  reference scales its per-device post-SPMD HLO counts: one rank's
  *sharded* step at its local shapes, its collectives included
  (``collectives``: operand bytes by kind, the MoE layers'
  all-to-alls among them, ``n_collectives``, ``coll_bytes``, the
  collective term at 450 GB/s), with the redundant work of replicated
  ops counted on every chip; a train cell's microbatch body traced once
  and weighted by the microbatch count, as ``analyze_hlo`` weights a
  while body by its trip count, and the update once; and the blockwise
  attention's loops over blocks traced for one block each and weighted
  by the blocks where no gradient is taken (``_one_block``: on fake
  tensors every block runs the same ops on the same shapes), so a
  32k-token serve cell traces as fast as a 4k one;
  ``flops_per_chip``, ``bytes_per_chip`` and ``coll_bytes_per_chip``
  are that rank's (on a mesh of one device, the plain step at the
  cell's global shapes, and these ``null``);
* ``trace_s``: the trace's host seconds;
* ``memory_analysis`` and ``xla_cost_analysis``: ``null``; XLA's
  compiled-artifact analyses have no torch twin.

Importing this module touches no process group and no environment
variable.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama32_1b \\
      --shape train_4k [--multi-pod] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --out results/dryrun_torch.json
``--arch`` and ``--shape`` also take comma-separated lists (every pair
runs), which the reference's take one name each.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config, runnable_cells
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch import analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api, layers
from repro_torch.serve.step import build_decode_step, build_prefill_step
from repro_torch.train import optimizer as opt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainStepConfig, build_train_step
from repro_torch.models.layers import Spec
from repro_torch.tree import at, flatten_with_path, map_with_path, tree_map

# archs whose fp32 optimizer state cannot fit one pod: 8-bit moments
INT8_MOMENT_ARCHS = {"jamba_15_large", "deepseek_v2_236b"}
# archs whose bf16 params alone exceed HBM under model-axis TP: ZeRO-3/
# FSDP param sharding over the data axes.  (coder/internlm are handled by
# ZeRO-1 opt-state sharding + the non-divisible-heads data-plane fallback
# -- full FSDP on them triggered GSPMD involuntary-remat pathologies, see
# EXPERIMENTS.md SSPerf iteration log.)
FSDP_ARCHS = {"jamba_15_large", "deepseek_v2_236b"}
# per-arch microbatch counts for the train_4k global batch of 256
# (jamba/dsv2 tuned down from 16 in SSPerf iterations)
TRAIN_MICROBATCHES = {
    "jamba_15_large": 8, "deepseek_v2_236b": 8, "deepseek_coder_33b": 8,
    "internlm2_20b": 8, "falcon_mamba_7b": 8, "phi3_vision_4b": 4,
    "whisper_tiny": 1, "gemma3_1b": 2, "llama32_1b": 2, "granite_moe_1b": 2,
}


def production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """The production mesh over the default process group; with none, a
    fake group of 512 ranks is made first (and kept for the next cell).
    On a group of 512 the 16x16 mesh takes its first 256 ranks."""
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512)
    if multi_pod or dist.get_world_size() != 512:
        return make_production_mesh(multi_pod=multi_pod, device=device)
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device, torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"))


def _step_config(arch: str, overrides: dict) -> TrainStepConfig:
    return TrainStepConfig(
        microbatches=overrides.get(
            "microbatches", TRAIN_MICROBATCHES.get(arch, 4)),
        adamw=AdamWConfig(moment_dtype=(
            "int8" if arch in INT8_MOMENT_ARCHS else "fp32")),
        remat=overrides.get("remat", True),
        remat_policy=overrides.get(
            "remat_policy",
            # jamba: saving dot outputs beat full remat (SSPerf cell 2)
            "dots" if arch == "jamba_15_large" else "nothing"))


def build_cell(arch: str, shape_name: str, mesh,
               overrides: dict | None = None) -> tuple[float, object]:
    """(resident GB per chip, the step) of a cell: the builders'
    shardings on ``mesh``, as the reference's ``lower_cell`` builds them
    before it lowers.  The step carries its input shardings
    (``step.in_sh``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    overrides = overrides or {}
    rules = MeshRules(mesh, fsdp=overrides.get("fsdp", arch in FSDP_ARCHS))
    if shape.kind == "train":
        step, in_sh, _, param_shapes, opt_shapes = build_train_step(
            cfg, rules, _step_config(arch, overrides))
        resident_gb = analytical_memory_gb(
            (in_sh[0], in_sh[1]), (param_shapes, opt_shapes), mesh)
    elif shape.kind == "prefill":
        step, in_sh, out_sh, param_shapes = build_prefill_step(cfg, rules,
                                                               shape)
        resident_gb = analytical_memory_gb(
            (in_sh[0], out_sh[1]), (param_shapes, api.cache_specs(cfg, shape)),
            mesh)
    else:  # decode
        step, in_sh, _, cache_shapes = build_decode_step(cfg, rules, shape)
        param_shapes = api.get_model(cfg).param_shapes()
        resident_gb = analytical_memory_gb(
            (in_sh[0], in_sh[1]), (param_shapes, cache_shapes), mesh)
    step.in_sh = in_sh
    return resident_gb, step


def _fake(specs, device):
    """Fake tensors of a tree of ``Spec``; call under a ``FakeTensorMode``."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device), specs)


def local_specs(specs, shardings):
    """The tree of ``Spec`` of one rank's shards (the first rank's, the
    largest under ``torch.chunk``'s split) of the leaves of ``specs`` on
    their ``Sharding`` in ``shardings``."""
    def local(path, spec):
        sh = at(shardings, path)
        names = list(sh.mesh.mesh_dim_names)
        shape = list(spec.shape)
        for d, entry in enumerate(sh.spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    shape[d] = -(-shape[d] // sh.mesh.size(
                        names.index(axis)))
        return Spec(tuple(shape), spec.dtype)
    return map_with_path(local, specs)


def shards_on(mesh) -> bool:
    """Does a step compute on ``mesh``'s shards (a mesh of more than one
    device)?"""
    return mesh is not None and mesh.size() > 1


def trace_cell(arch: str, shape_name: str, step, device: str = "cuda",
               mesh=None) -> tuple[analysis.StepStats, float]:
    """``trace_step`` of a cell of ``SHAPES``."""
    return trace_step(get_config(arch), SHAPES[shape_name], step, device,
                      mesh)


def trace_step(cfg, shape, step, device: str = "cuda", mesh=None
               ) -> tuple[analysis.StepStats, float]:
    """The counts of a step on fake ``device`` tensors, and the host
    seconds the trace took.  ``step``: ``build_cell``'s (or a builder's,
    with ``step.in_sh``).  Where it computes on ``mesh``'s shards
    (``shards_on``): one rank's sharded step at its local shapes, its
    collectives included (the meshes' process group must be there: the
    dry run's fake one).  Else the plain model at the global shapes: a
    train cell traces the plain step (its microbatch body once), a serve
    cell the plain model's ``prefill`` or ``decode_step``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sharded = shards_on(mesh)
    model = api.get_model(cfg)
    param_shapes = model.param_shapes()

    def specs(tree, i):  # a tree of Spec, local where the step shards
        return local_specs(tree, step.in_sh[i]) if sharded else tree
    t0 = time.perf_counter()
    with FakeTensorMode(), _one_tile_attention():
        params = _fake(specs(param_shapes, 0), device)
        if shape.kind == "train":
            nmb = step.microbatches
            opt_state = _fake(specs(opt.state_shapes(param_shapes,
                                                     step.adamw), 1), device)
            mb = _fake(specs(api.input_specs(
                cfg, shape, batch_override=shape.global_batch // nmb), 2),
                device)
            if nmb == 1:
                stats = analysis.analyze_step(step, params, opt_state, mb)
            else:
                acc, loss_sum = step.accumulator(params)
                body = analysis.analyze_step(step.microbatch, params, acc,
                                             loss_sum, mb)
                rest = analysis.analyze_step(
                    lambda: step.update(opt_state, *step.mean_grads(
                        params, *step.accumulator(params))))
                stats = body.scaled(nmb) + rest
        elif shape.kind == "prefill":
            batch = _fake(specs(api.input_specs(cfg, shape), 1), device)
            fn = step.local if sharded else functools.partial(
                _no_grad(model.prefill), cache_len=shape.seq_len)
            stats = analysis.analyze_step(fn, params, batch)
        else:  # decode: one token at the cache's last slot
            cache = _fake(specs(api.cache_specs(cfg, shape), 1), device)
            token = _fake({"token": specs(api.input_specs(
                cfg, shape)["token"], 2)} if sharded else
                api.input_specs(cfg, shape), device)["token"]
            fn = step.local if sharded else _no_grad(model.decode_step)
            stats = analysis.analyze_step(fn, params, cache, token,
                                          shape.seq_len - 1)
    return stats, time.perf_counter() - t0


@contextlib.contextmanager
def _one_tile_attention():
    """``layers._blocks`` as ``_one_block`` while the dry run traces."""
    blocks = layers._blocks
    layers._blocks = _one_block
    try:
        yield
    finally:
        layers._blocks = blocks


def _one_block(n: int):
    """Block 0 alone, counted ``n`` times (``analysis.repeated``): on
    fake tensors every block runs the same ops on the same shapes, and
    nested loops multiply their weights.  Where a gradient is taken, every
    block: the backward runs after the loop, outside ``repeated``."""
    if torch.is_grad_enabled():
        yield from range(n)
        return
    with analysis.repeated(n):
        yield 0


def _no_grad(fn):
    def call(*args, **kw):
        with torch.no_grad():
            return fn(*args, **kw)
    return call


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               verbose: bool = True, overrides: dict | None = None,
               device: str = "cuda", mesh=None, traces: dict | None = None
               ) -> dict:
    """The cell's result (module docstring).  ``mesh``: the production
    mesh (default ``production_mesh(multi_pod, device)``).  ``traces``:
    a dict that keeps ``trace_cell``'s results across calls with the same
    overrides, by (arch, shape), and by mesh too where the step shards
    over it."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else production_mesh(multi_pod, device)
    t0 = time.perf_counter()
    resident_gb, step = build_cell(arch, shape_name, mesh, overrides)
    t_build = time.perf_counter() - t0
    traces = {} if traces is None else traces
    sharded = shards_on(mesh)
    key = (arch, shape_name) + ((tuple(mesh.shape),) if sharded else ())
    if key not in traces:
        traces[key] = trace_cell(arch, shape_name, step, device, mesh)
    stats, trace_s = traces[key]
    chips = mesh.size()
    # a rank's counts times the chips; the plain step's are the mesh's
    per_chip = chips if sharded else 1
    roof = analysis.Roofline(
        flops=stats.flops * per_chip,
        bytes_accessed=stats.bytes_traffic * per_chip,
        coll_bytes=stats.coll_bytes * chips if sharded else None,
        chips=chips, model_flops=analysis.model_flops(cfg, shape))

    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "device": device,
        "lower_s": round(t_build, 1), "trace_s": round(trace_s, 1),
        "collectives": stats.coll_by_kind if sharded else None,
        "n_collectives": stats.n_collectives if sharded else None,
        "flops_per_chip": stats.flops if sharded else None,
        "bytes_per_chip": stats.bytes_traffic if sharded else None,
        "coll_bytes_per_chip": stats.coll_bytes if sharded else None,
        "unknown_loops": stats.unknown_loops,
        "resident_gb_per_chip": round(resident_gb, 3),
        "xla_cost_analysis": None,
        "memory_analysis": None,
        **roof.to_dict(),
    }
    if verbose:
        print(f"== {arch} x {shape_name} on {result['mesh']} "
              f"({chips} chips, fake {device} tensors) ==")
        print("resident GB/chip (params+state+cache, sharded): "
              f"{resident_gb:.2f}")
        if sharded:
            print("one rank's sharded step: flops/chip=%.3e bytes/chip=%.3e"
                  " coll/chip=%.3e (%d collectives; traced in %.1fs)"
                  % (stats.flops, stats.bytes_traffic, stats.coll_bytes,
                     stats.n_collectives, trace_s))
            print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs "
                  "bottleneck=%s useful=%.2f roofline_frac=%.3f" %
                  (roof.t_compute, roof.t_memory, roof.t_collective,
                   roof.bottleneck, roof.useful_flops_ratio,
                   roof.roofline_fraction))
        else:
            print("plain step: flops=%.3e bytes=%.3e (a mesh of one; traced "
                  "in %.1fs)" % (stats.flops, stats.bytes_traffic, trace_s))
            print("roofline: compute=%.4fs memory=%.4fs collective=unknown "
                  "bottleneck=%s useful=%.2f roofline_frac=%.3f" %
                  (roof.t_compute, roof.t_memory, roof.bottleneck,
                   roof.useful_flops_ratio, roof.roofline_fraction))
    return result


def analytical_memory_gb(shardings_trees, shapes_trees, mesh) -> float:
    """Per-device resident bytes of the step's persistent arrays
    (params/opt-state/caches) under their actual shardings -- the
    'does it fit' number."""
    names = list(mesh.mesh_dim_names)
    total = 0
    for sh_tree, shp_tree in zip(shardings_trees, shapes_trees):
        shs = [sh for _, sh in flatten_with_path(sh_tree)]
        shps = [shp for _, shp in flatten_with_path(shp_tree)]
        for sh, shp in zip(shs, shps):
            n_shards = 1
            for entry in sh.spec:
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                for a in axes:
                    n_shards *= mesh.size(names.index(a))
            total += math.prod(shp.shape) * shp.dtype.itemsize / n_shards
    return total / 2**30


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="an arch, or a comma-separated list")
    ap.add_argument("--shape", help="a shape, or a comma-separated list")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat-policy", default="")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh")
    args = ap.parse_args(argv)

    overrides = {}
    if args.microbatches:
        overrides["microbatches"] = args.microbatches
    if args.no_fsdp:
        overrides["fsdp"] = False
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy

    if args.all:
        cells = runnable_cells()
    else:  # comma-separated lists: every pair
        cells = [(a, s) for a in args.arch.split(",")
                 for s in args.shape.split(",")]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], []
    try:
        built = {mp: production_mesh(mp, args.device) for mp in meshes}
        traces = {}  # a plain trace serves both meshes
        for arch, shape in cells:
            for mp in meshes:
                try:
                    results.append(lower_cell(
                        arch, shape, multi_pod=mp, overrides=overrides,
                        device=args.device, mesh=built[mp], traces=traces))
                except Exception as e:  # noqa: BLE001 -- report, keep going
                    traceback.print_exc()
                    failures.append({"arch": arch, "shape": shape,
                                     "multi_pod": mp, "error": repr(e)})
    finally:
        dist.destroy_process_group()
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f).get("results", [])
        keyf = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
        seen = {keyf(r) for r in results}
        merged = results + [r for r in existing if keyf(r) not in seen]
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": merged, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} cells traced OK, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("FAILED:", f_)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
