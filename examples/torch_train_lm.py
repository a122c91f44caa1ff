"""End-to-end training on the PyTorch/CUDA port: train an LM with SEARS
checkpointing.

The twin of ``train_lm.py`` on ``repro_torch``: trains a ~100M-param
llama-style model (default; override with --arch) on the synthetic
corpus on the card, checkpointing into SEARS (the store's CUDA kernels)
and surviving a simulated crash.  ``--device cpu`` trains on the host,
the store on its ``"numpy"`` engine.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
Fast smoke: PYTHONPATH=src python examples/torch_train_lm.py --steps 8 \
          --tiny [--device cpu]
"""

import argparse
import dataclasses

import torch

from repro_torch.checkpoint.manager import SEARSCheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, store_engine


def build_cfg(args):
    cfg = get_config(args.arch)
    if args.tiny:
        return cfg.reduced()
    # ~100M-param variant of the chosen family
    return dataclasses.replace(
        cfg.reduced(), name=cfg.name + "-100m",
        n_layers=max(10, cfg.n_layers // 4), d_model=640,
        n_heads=10, n_kv_heads=5, head_dim=64,
        d_ff=2560 if cfg.d_ff else 0,
        vocab_size=32_000,
        d_inner=1280 if cfg.ssm_state else 0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a crash+restart at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this example trains on the card and found no "
                           "CUDA device; pass --device cpu")
    cfg = build_cfg(args)
    if args.tiny:
        args.batch, args.seq = 4, 64
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)
    manager = SEARSCheckpointManager(run=cfg.name, node_capacity=8 << 30,
                                     engine=store_engine(device))
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every, log_every=10,
        step_cfg=TrainStepConfig(microbatches=1, remat=not args.tiny,
                                 adamw=AdamWConfig(lr=3e-4)))

    def run(until):
        t = Trainer(cfg, dcfg, dataclasses.replace(tcfg, total_steps=until),
                    manager=manager, device=device.type)
        t.run(on_step=lambda s, m: print(
            f"step {s:5d}  loss {m['loss']:.4f}  "
            f"gnorm {m['grad_norm']:.3f}  {m['wall_s']:.0f}s"))
        return t

    n = cfg.param_count()
    print(f"{cfg.name} on {device}: {n/1e6:.1f}M params, batch {args.batch} "
          f"x seq {args.seq}, {args.steps} steps")
    if args.crash_at:
        run(args.crash_at)
        print(f"-- simulated crash at step {args.crash_at}; killing 3 "
              f"storage nodes per cluster and restarting --")
        for c in manager.store.clusters:
            c.kill_nodes([1, 4, 7])
        run(args.steps)  # resumes from the latest SEARS checkpoint
    else:
        run(args.steps)
    st = manager.store.stats()
    print(f"checkpoint store: {st.n_unique_chunks} chunks, dedup ratio "
          f"{st.dedup_ratio:.2f}")


if __name__ == "__main__":
    main()
