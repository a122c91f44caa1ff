"""Training loop with SEARS checkpoint/restart fault tolerance.

Port of the JAX reference's ``repro/train/trainer.py``.  The trainer owns
the train step, the data pipeline (step-indexed, restart-deterministic)
and a ``SEARSCheckpointManager``.  ``run()`` resumes from the latest
complete checkpoint automatically: a crashed run re-executes from the
last saved step and reproduces the same stream (the step index is part
of the checkpoint through ``opt_state["step"]``).

It runs on the CUDA device unless the caller passes ``device="cpu"``,
and raises without CUDA otherwise.  The default manager's store is the
reference's, on the engine of ``store_engine``: the CUDA kernels
(``engine="kernel"``) on the card, the host's ``"numpy"`` engine on the
CPU.  The reference's mesh and shardings are not ported (ROADMAP.md,
Queue 1 F).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import SEARSCheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainStepConfig, build_train_step
from repro_torch.tree import tree_map


def store_engine(device: torch.device) -> str:
    """The checkpoint store's engine for a trainer on ``device``."""
    return "kernel" if device.type == "cuda" else "numpy"


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 20
    ckpt_every: int = 5
    log_every: int = 1
    seed: int = 0
    step_cfg: TrainStepConfig = dataclasses.field(
        default_factory=TrainStepConfig)
    async_checkpoint: bool = False


class Trainer:
    def __init__(self, model_cfg, data_cfg: DataConfig,
                 tcfg: TrainerConfig | None = None,
                 manager: SEARSCheckpointManager | None = None,
                 corpus=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer runs on the CUDA device and CUDA is not "
                "available; pass device='cpu' to train on the host")
        self.model_cfg = model_cfg
        self.tcfg = tcfg or TrainerConfig()
        self.data = corpus or SyntheticCorpus(data_cfg)
        self.manager = manager or SEARSCheckpointManager(
            node_capacity=1 << 30, engine=store_engine(self.device))

        scfg = self.tcfg.step_cfg
        self.step_fn = build_train_step(model_cfg, scfg, self.device)
        self.param_shapes = api.get_model(model_cfg).param_shapes()
        self.opt_shapes = opt.state_shapes(self.param_shapes, scfg.adamw)
        self.metrics: list[dict[str, float]] = []

    # ------------------------------------------------------------------
    def init_state(self):
        model = api.get_model(self.model_cfg,
                              remat=self.tcfg.step_cfg.remat)
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = model.init(gen)
        return params, opt.init(params, self.tcfg.step_cfg.adamw)

    def restore_or_init(self):
        latest = self.manager.latest_step()
        if latest is None:
            return self.init_state(), 0
        # leaves of ``Spec`` restore on the host, each at its manifest's
        # dtype; then one copy to the device
        like = {"params": self.param_shapes, "opt": self.opt_shapes}
        tree = tree_map(lambda t: t.to(self.device),
                        self.manager.restore(like))
        return (tree["params"], tree["opt"]), latest

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """The data pipeline's batch of ``step``, on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step).items()}

    # ------------------------------------------------------------------
    def run(self, on_step: Callable[[int, dict], None] | None = None
            ) -> list[dict[str, Any]]:
        (params, opt_state), start = self.restore_or_init()
        t0 = time.time()
        for step in range(start, self.tcfg.total_steps):
            params, opt_state, metrics = self.step_fn(
                params, opt_state, self.batch(step))
            if (step + 1) % self.tcfg.log_every == 0:
                rec = {"step": step + 1,
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "wall_s": time.time() - t0}
                self.metrics.append(rec)
                if on_step:
                    on_step(step + 1, rec)
            if (step + 1) % self.tcfg.ckpt_every == 0:
                state = {"params": params, "opt": opt_state}
                if self.tcfg.async_checkpoint:
                    self.manager.save_async(step + 1, state,
                                            timestamp=float(step + 1))
                else:
                    stats = self.manager.save(step + 1, state,
                                              timestamp=float(step + 1))
                    self.metrics.append(
                        {"step": step + 1, "ckpt_dedup_saving":
                         stats["dedup_saving"], "ckpt_bytes": stats["bytes"],
                         "ckpt_bytes_after_dedup":
                         stats["bytes_after_dedup"]})
        self.manager.wait()
        self.final_state = (params, opt_state)
        return self.metrics
