"""Train-step builder: microbatch accumulation + AdamW update.

Port of the JAX reference's ``repro/train/step.py``.  ``build_train_step``
returns the ``(params, opt_state, batch) -> (params, opt_state,
metrics)`` step the trainer runs, on explicit tensors:

* gradients by autograd (``torch.autograd.grad``) of ``model.loss``,
  with each layer rematerialized under ``remat``;
* microbatch gradient accumulation in fp32 (a Python loop in place of
  the reference's ``lax.scan``), optionally through an int8 accumulator
  requantized after every microbatch (``int8_grad_accum``; 4x less
  accumulator memory);
* the AdamW update of ``optimizer.apply``.

The reference's shardings (``MeshRules``, the in/out shardings it hands
``jax.jit``) and donation are not ported: the port runs on one device
(ROADMAP.md, Queue 1 F).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.tree import flatten_with_path, map_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    int8_grad_accum: bool = False
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)


def value_and_grad(model, params, batch) -> tuple[torch.Tensor, dict]:
    """(loss, grads): the gradient tree has the params' structure and
    dtypes, as ``jax.value_and_grad`` gives."""
    leaves = flatten_with_path(params)
    live = {path: t.detach().requires_grad_(True) for path, t in leaves}
    with torch.enable_grad():
        loss = model.loss(map_with_path(lambda path, _: live[path], params),
                          batch)
        grads = torch.autograd.grad(loss, list(live.values()))
    by_path = dict(zip(live, grads))
    return loss.detach(), map_with_path(lambda path, _: by_path[path], params)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n batches of (B/n, ...), in row order."""
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def build_train_step(cfg, tcfg: TrainStepConfig, device):
    """Returns the step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)`` for params on ``device`` (where the microbatch
    accumulators live)."""
    model = api.get_model(cfg, remat=tcfg.remat,
                          remat_policy=tcfg.remat_policy)
    acfg = tcfg.adamw

    def step_fn(params, opt_state, batch):
        nmb = tcfg.microbatches
        if nmb == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=device), params)
            if tcfg.int8_grad_accum:
                acc = tree_map(opt._quantize, acc)
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for mb in _split_microbatches(batch, nmb):
                l, g = value_and_grad(model, params, mb)
                with torch.no_grad():
                    if tcfg.int8_grad_accum:
                        acc = map_with_path(
                            lambda path, p: opt._quantize(
                                opt._dequantize(opt._at(acc, path), p.shape)
                                + opt._at(g, path).to(torch.float32)),
                            params)
                    else:
                        acc = map_with_path(
                            lambda path, a: a + opt._at(g, path).to(
                                torch.float32), acc)
                loss_sum = loss_sum + l
            with torch.no_grad():
                if tcfg.int8_grad_accum:
                    grads = map_with_path(
                        lambda path, p: opt._dequantize(
                            opt._at(acc, path), p.shape) / nmb, params)
                else:
                    grads = tree_map(lambda a: a / nmb, acc)
            loss = loss_sum / nmb

        new_opt, new_params = opt.apply(opt_state, grads, acfg)
        with torch.no_grad():
            gnorm = opt._global_norm(grads)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "step": new_opt["step"]}
        return new_params, new_opt, metrics

    return step_fn
