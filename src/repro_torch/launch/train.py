"""Training launcher of the port.

On the card, at full width:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama32_1b \
      --steps 20

On the CPU, at the reduced config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama32_1b \
      --tiny --device cpu --steps 6 --ckpt-every 3

Production submission, one process per card of every host:
  python -m repro_torch.launch.train --arch jamba_15_large \
      --production-mesh --coordinator <host:port> --num-hosts 256 \
      --host-id $RANK ...

Port of the JAX reference's ``repro/launch/train.py``: it builds the
mesh (the host mesh, or with ``--production-mesh`` the 16x16 one, 2x16x16
with ``--multi-pod``), the SEARS-checkpointed ``Trainer`` on it, and runs
it, resuming from the latest checkpoint of its manager, whose nodes hold
16 GiB each, as the reference's.  ``--coordinator host:port`` joins a
``torch.distributed`` process group of ``--num-hosts`` ranks as rank
``--host-id`` (nccl on the card, gloo on the CPU) where the reference
calls ``jax.distributed.initialize``; the port runs one rank per card
where JAX runs one process per host.  The store's data plane runs where
the trainer runs: the CUDA kernels on the card, the ``"numpy"`` engine
with ``--device cpu``.  It runs on CUDA unless ``--device cpu`` is
given, and fails without a card.  On a group of n ranks the host mesh
is (n, 1): data parallelism with the optimizer state ZeRO-1 over the
ranks (an MoE layer's groups and, where they are large, its experts
over them too).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.manager import SEARSCheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           store_engine)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train runs on the card and found no CUDA "
                           "device; pass --device cpu to run on the host")
    if args.coordinator:
        import torch.distributed as dist
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_hosts, rank=args.host_id)

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.reduced()
    mesh = (make_production_mesh(multi_pod=args.multi_pod,
                                 device=device.type)
            if args.production_mesh else make_host_mesh(device.type))
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        async_checkpoint=args.async_ckpt,
        step_cfg=TrainStepConfig(
            microbatches=args.microbatches,
            adamw=AdamWConfig(lr=args.lr, moment_dtype=(
                "int8" if args.int8_moments else "fp32"))))
    manager = SEARSCheckpointManager(run=cfg.name, node_capacity=16 << 30,
                                     engine=store_engine(device))
    trainer = Trainer(cfg, dcfg, tcfg, mesh=mesh, manager=manager)
    trainer.run(on_step=lambda s, m: print(
        f"step {s:6d}  loss {m['loss']:.4f}  gnorm {m['grad_norm']:.3f}"))
    print("final metrics:", trainer.metrics[-1] if trainer.metrics else None)


if __name__ == "__main__":
    main()
