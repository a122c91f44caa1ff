"""Fault-tolerance drill on the PyTorch/CUDA port: checkpoint a model into
SEARS, lose storage nodes AND add stragglers, then restore bit-exact onto
fresh shardings.

The twin of ``checkpoint_restore.py`` on ``repro_torch``.  The restore
puts each leaf straight onto the parameter shardings of the host mesh
(``restore(shardings=)``).  It runs on the card (the store's CUDA
kernels); ``--device cpu`` runs it on the host (the ``"numpy"`` engine).

Run:  PYTHONPATH=src python examples/torch_checkpoint_restore.py \
          [--device cpu]
"""

import argparse

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import SEARSCheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.train.trainer import store_engine
from repro_torch.tree import flatten_with_path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this example runs on the card and found no "
                           "CUDA device; pass --device cpu")
    cfg = get_config("granite_moe_1b").reduced()
    model = api.get_model(cfg, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(42))
    n_bytes = sum(t.numel() * t.element_size()
                  for _, t in flatten_with_path(params))
    print(f"model: {cfg.name} on {device}, {n_bytes/2**20:.1f} MiB of "
          f"parameters")

    mgr = SEARSCheckpointManager(run="drill", node_capacity=4 << 30,
                                 engine=store_engine(device))
    stats = mgr.save(100, params)
    print(f"saved step 100: {stats['bytes']/2**20:.1f} MiB logical, "
          f"{stats['bytes_after_dedup']/2**20:.1f} MiB uploaded")

    stats = mgr.save(200, params)  # unchanged -> full dedup
    print(f"saved step 200 (unchanged): {stats['bytes_after_dedup']} bytes "
          f"uploaded ({stats['dedup_saving']:.0%} dedup saving)")

    # catastrophe: every cluster loses 5 of 10 nodes (= n-k budget),
    # and two survivors become 10x stragglers
    for c in mgr.store.clusters:
        c.kill_nodes([0, 2, 4, 6, 8])
        c.set_stragglers([1, 3], 10.0)
    print("killed 5/10 nodes per cluster + 2 stragglers")

    # fresh shardings: the parameters' placements on the host mesh
    try:
        mesh = make_host_mesh(device.type)
        shapes = model.param_shapes()
        restored = mgr.restore(shapes, shardings=MeshRules(
            mesh).params_shardings(shapes))
        ok = all(torch.equal(a, b.full_tensor()) for (_, a), (_, b) in zip(
            flatten_with_path(params), flatten_with_path(restored)))
    finally:  # the one-rank group make_host_mesh made
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"restore bit-exact onto a {tuple(mesh.shape)} mesh: {ok}; "
          f"modeled k-of-n restore time {mgr.last_restore_time:.2f}s "
          f"(stragglers dodged by k-of-n reads)")
    assert ok


if __name__ == "__main__":
    main()
