"""Training loop with SEARS checkpoint/restart fault tolerance.

Port of the JAX reference's ``repro/train/trainer.py``.  The trainer owns
the train step, the data pipeline (step-indexed, restart-deterministic)
and a ``SEARSCheckpointManager``.  ``run()`` resumes from the latest
complete checkpoint automatically: a crashed run re-executes from the
last saved step and reproduces the same stream (the step index is part
of the checkpoint through ``opt_state["step"]``).

The train step is sharded by ``MeshRules`` over the trainer's mesh, as
the reference's: the state lives as DTensors in the step's in-placements
(``init_state``), a restore puts each leaf straight onto them
(``restore(shardings=)``), and the step runs through
``sharding.sharded`` (the twin of the reference's ``jax.jit`` with
shardings): on a mesh of more than one device each rank computes on its
shards with the step's collectives (``train/step.py``).  The mesh defaults
to ``default_mesh(device)``: the CUDA device unless the caller passes
``device="cpu"``; it raises without CUDA otherwise.  The default
manager's store is the reference's, on the engine of ``store_engine``:
the CUDA kernels (``engine="kernel"``) on the card, the host's
``"numpy"`` engine on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import SEARSCheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.distributed.sharding import MeshRules, shard_tree, sharded
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainStepConfig, build_train_step


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


def default_mesh(device="cuda"):
    """This host's devices as a (n, 1) ``("data", "model")`` mesh on
    ``device`` (``launch.mesh.make_host_mesh``)."""
    return make_host_mesh(device)


class Trainer:
    def __init__(self, model_cfg, data_cfg: DataConfig,
                 tcfg: TrainerConfig | None = None, mesh=None,
                 manager: SEARSCheckpointManager | None = None,
                 corpus=None, device="cuda"):
        self.model_cfg = model_cfg
        self.tcfg = tcfg or TrainerConfig()
        self.mesh = mesh or default_mesh(device)
        self.device = torch.device(self.mesh.device_type)
        self.rules = MeshRules(self.mesh)
        self.data = corpus or SyntheticCorpus(data_cfg)
        self.manager = manager or SEARSCheckpointManager(
            node_capacity=1 << 30, engine=store_engine(self.device))

        (self.step_fn, self.in_sh, self.out_sh, self.param_shapes,
         self.opt_shapes) = build_train_step(model_cfg, self.rules,
                                             self.tcfg.step_cfg)
        self.sharded_step = sharded(self.step_fn, self.out_sh, self.mesh)
        self.metrics: list[dict[str, float]] = []

    # ------------------------------------------------------------------
    def init_state(self):
        """Params and optimizer state from the seed, laid out on the
        step's in-placements."""
        model = api.get_model(self.model_cfg,
                              remat=self.tcfg.step_cfg.remat)
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = model.init(gen)
        opt_state = opt.init(params, self.tcfg.step_cfg.adamw)
        return (shard_tree(params, self.in_sh[0]),
                shard_tree(opt_state, self.in_sh[1]))

    def restore_or_init(self):
        latest = self.manager.latest_step()
        if latest is None:
            return self.init_state(), 0
        # each leaf from its bytes straight onto its placements
        state_like = {"params": self.param_shapes, "opt": self.opt_shapes}
        shardings = {"params": self.in_sh[0], "opt": self.in_sh[1]}
        tree = self.manager.restore(state_like, shardings=shardings)
        return (tree["params"], tree["opt"]), latest

    def batch(self, step: int) -> dict:
        """The data pipeline's batch of ``step``, on the batch's
        placements."""
        return shard_tree({k: torch.from_numpy(v).to(self.device)
                           for k, v in self.data.batch(step).items()},
                          self.in_sh[2])

    # ------------------------------------------------------------------
    def run(self, on_step: Callable[[int, dict], None] | None = None
            ) -> list[dict[str, Any]]:
        (params, opt_state), start = self.restore_or_init()
        t0 = time.time()
        for step in range(start, self.tcfg.total_steps):
            params, opt_state, metrics = self.sharded_step(
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
