"""Sharded train-step builder: microbatch accumulation + AdamW update.

Port of the JAX reference's ``repro/train/step.py``.  ``build_train_step``
returns the ``(params, opt_state, batch) -> (params, opt_state,
metrics)`` step on plain tensors, with the in/out shardings of the
state and the batch (``Sharding`` trees: mesh, DTensor placements,
spec), as the reference returns the function and the shardings it hands
``jax.jit``.  The trainer runs it through ``sharding.sharded``: on the
DTensors' local tensors, on a mesh of one.  The step:

* gradients by autograd (``torch.autograd.grad``) of ``model.loss``,
  with each layer rematerialized under ``remat``;
* microbatch gradient accumulation in fp32 (a Python loop in place of
  the reference's ``lax.scan``), optionally through an int8 accumulator
  requantized after every microbatch (``int8_grad_accum``; 4x less
  accumulator memory);
* the AdamW update of ``optimizer.apply``.

The state's shardings are the reference's: the parameters by
``MeshRules``, the optimizer state ZeRO-1 over the data plane
(``opt_state_shardings``), the batch over the data plane.  On a mesh of
more than one device (``_MeshStep``) the model computes on this rank's
shards with its collectives; FSDP leaves are all-gathered over the data
plane before the step's first layer (per step) and their gradients
reduce-scattered back; each rank's loss is its share of the global
mean, so the other gradients and the loss are summed over the data
plane once, after the microbatches, but for the routed experts over the
data plane (their all-to-all brings every data rank's tokens to their
gradients already); the global norm counts every shard once; each rank
updates its ZeRO-1 slice of master, m and v (int8 moments in the whole
tensor's blocks: ``optimizer.Int8Blocks``) and the new parameters are
all-gathered over the data plane.  Donation is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.collectives import Par
from repro_torch.distributed.sharding import MeshRules, P, Sharding
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.tree import at, flatten_with_path, map_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    int8_grad_accum: bool = False
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)


def value_and_grad(model, params, batch, loss_fn=None
                   ) -> tuple[torch.Tensor, dict]:
    """(loss, grads): the gradient tree has the params' structure and
    dtypes, as ``jax.value_and_grad`` gives.  ``loss_fn(params, batch)``
    in place of ``model.loss`` where given."""
    leaves = flatten_with_path(params)
    live = {path: t.detach().requires_grad_(True) for path, t in leaves}
    with torch.enable_grad():
        loss = (loss_fn or model.loss)(
            map_with_path(lambda path, _: live[path], params), batch)
        grads = torch.autograd.grad(loss, list(live.values()))
    by_path = dict(zip(live, grads))
    return loss.detach(), map_with_path(lambda path, _: by_path[path], params)


def _split_microbatches(batch: dict, n: int, rules: MeshRules
                        ) -> list[dict]:
    """(B, ...) -> n batches of (B/n, ...), in row order.  ``rules`` as
    the reference's, which pins each microbatch to the data plane; the
    port splits the local batch, which needs no pin."""
    del rules
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def build_train_step(cfg, rules: MeshRules, tcfg: TrainStepConfig):
    """Returns (step_fn, in_shardings, out_shardings, param_shapes,
    opt_shapes).  ``step_fn`` takes plain tensors on the mesh's device
    (where the microbatch accumulators live): this rank's local shards
    on a mesh of more than one device."""
    device = torch.device(rules.mesh.device_type)
    par = Par.of(rules.mesh)
    model = api.get_model(cfg, remat=tcfg.remat,
                          shard_act=rules.act_sharder(),
                          remat_policy=tcfg.remat_policy, par=par)
    acfg = tcfg.adamw
    param_shapes = model.param_shapes()
    opt_shapes = opt.state_shapes(param_shapes, acfg)
    opt_sh = opt_state_shardings(rules, param_shapes, opt_shapes)
    mesh_step = None if par is None else _MeshStep(
        par, rules, param_shapes, opt_sh, acfg)
    loss_fn = None if mesh_step is None else mesh_step.loss_fn(model)

    def accumulator(params):
        """The zero fp32 (or int8) gradient accumulator and loss sum."""
        acc = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=device), params)
        if tcfg.int8_grad_accum:
            acc = tree_map(opt._quantize, acc)
        return acc, torch.zeros((), dtype=torch.float32, device=device)

    def microbatch(params, acc, loss_sum, mb):
        """One microbatch's gradients added into the accumulator: the
        body of the reference's ``lax.scan``."""
        l, g = value_and_grad(model, params, mb, loss_fn)
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
        return acc, loss_sum + l

    def reduce(loss, grads):
        """The loss and gradients summed over the data plane (on a mesh
        of more than one device)."""
        if mesh_step is None:
            return loss, grads
        return mesh_step.reduce(loss, grads)

    def mean_grads(params, acc, loss_sum):
        """(loss, grads): the accumulator's means over the microbatches,
        summed over the data plane."""
        nmb = tcfg.microbatches
        with torch.no_grad():
            if tcfg.int8_grad_accum:
                grads = map_with_path(
                    lambda path, p: opt._dequantize(
                        opt._at(acc, path), p.shape) / nmb, params)
            else:
                grads = tree_map(lambda a: a / nmb, acc)
        return reduce(loss_sum / nmb, grads)

    def update(opt_state, loss, grads):
        """The AdamW update and the step's metrics."""
        if mesh_step is None:
            new_opt, new_params = opt.apply(opt_state, grads, acfg)
            with torch.no_grad():
                gnorm = opt._global_norm(grads)
        else:
            new_opt, new_params, gnorm = mesh_step.update(opt_state, grads)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "step": new_opt["step"]}
        return new_params, new_opt, metrics

    def step_fn(params, opt_state, batch):
        if tcfg.microbatches == 1:
            loss, grads = reduce(*value_and_grad(model, params, batch,
                                                 loss_fn))
        else:
            acc, loss_sum = accumulator(params)
            for mb in _split_microbatches(batch, tcfg.microbatches, rules):
                acc, loss_sum = microbatch(params, acc, loss_sum, mb)
            loss, grads = mean_grads(params, acc, loss_sum)
        return update(opt_state, loss, grads)

    # the parts, for the dry run to count the loop body once
    step_fn.microbatches, step_fn.adamw = tcfg.microbatches, acfg
    step_fn.model, step_fn.accumulator = model, accumulator
    step_fn.microbatch, step_fn.mean_grads = microbatch, mean_grads
    step_fn.update = update

    # ---------------- shardings ----------------
    param_sh = rules.params_shardings(param_shapes)
    batch_sh = batch_shardings(cfg, rules)
    scalar = Sharding.of(rules.mesh, P())
    metrics_sh = {"loss": scalar, "grad_norm": scalar, "step": scalar}
    in_shardings = (param_sh, opt_sh, batch_sh)
    out_shardings = (param_sh, opt_sh, metrics_sh)
    return step_fn, in_shardings, out_shardings, param_shapes, opt_shapes


class _MeshStep:
    """What the train step adds on a mesh of more than one device
    (module docstring): the loss's share and the FSDP gathers, the
    reductions over the data plane, the global norm and the ZeRO-1
    update."""

    def __init__(self, par: Par, rules: MeshRules, param_shapes, opt_sh,
                 acfg: opt.AdamWConfig) -> None:
        self.par, self.acfg = par, acfg
        self.specs = rules.params_pspecs(param_shapes)
        self.fsdp_specs = rules.fsdp_pspecs(param_shapes)
        self.daxis = rules.data_axis()

        def zero1(path, spec):  # the dim ZeRO-1 adds the data plane on
            master = at(opt_sh["master"], path).spec
            dims = [d for d, (p, m) in enumerate(zip(spec, master))
                    if p is None and m is not None]
            return dims[0] if dims else None
        self.zero1 = map_with_path(zero1, self.specs)
        self.blocks = None
        if acfg.moment_dtype == "int8":
            self.blocks = map_with_path(
                lambda path, s: opt.Int8Blocks(
                    s.shape[-1], at(opt_sh["master"], path).spec[-1],
                    at(opt_sh["m"], path)["q"].spec[-1],
                    at(opt_sh["m"], path)["scale"].spec[-1], par),
                param_shapes)

    def loss_fn(self, model):
        """This rank's share of the global mean loss (its batch's mean
        over the data plane's size), on the FSDP-gathered parameters."""
        par, specs = self.par, self.fsdp_specs

        def loss(params, batch):
            return model.loss(par.gather_fsdp(params, specs),
                              batch) / par.data_size
        return loss

    @torch.no_grad()
    def reduce(self, loss, grads):
        """The loss, and every gradient but those of the leaves over the
        data plane, summed over it: the FSDP leaves' gradients are summed
        by their gathers' backward, the expert-parallel leaves' hold
        every data rank's tokens through the all-to-all's backward."""
        par, daxis = self.par, self.daxis

        def grad(path, g):
            if any(par.is_data(e) for e in at(self.specs, path)):
                return g
            return par.sum_over(g, daxis)
        return par.sum_over(loss, daxis), map_with_path(grad, grads)

    @torch.no_grad()
    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradients: each rank's squares over the
        ranks that hold the same shard, summed over the mesh."""
        total = sum(torch.sum(torch.square(g.to(torch.float32)))
                    / self.par.replicas(at(self.specs, path))
                    for path, g in flatten_with_path(grads))
        return torch.sqrt(self.par.sum_over_mesh(total))

    @torch.no_grad()
    def update(self, opt_state, grads):
        """(new optimizer state, new parameters, global norm): AdamW on
        this rank's ZeRO-1 slices, the new parameters all-gathered over
        the data plane."""
        par, daxis = self.par, self.daxis
        gnorm = self.global_norm(grads)
        sliced = map_with_path(
            lambda path, g: g if at(self.zero1, path) is None
            else par.shard(g, at(self.zero1, path), daxis), grads)
        new_opt, new_params = opt.apply(opt_state, sliced, self.acfg,
                                        gnorm=gnorm, blocks=self.blocks)
        new_params = map_with_path(
            lambda path, p: p if at(self.zero1, path) is None
            else par.gather(p, at(self.zero1, path), daxis), new_params)
        return new_opt, new_params, gnorm


# ---------------------------------------------------------------------------
def batch_shardings(cfg, rules: MeshRules) -> dict:
    """Batch leaves shard over the data plane on dim 0."""
    def mk(ndim):
        return Sharding.of(rules.mesh,
                           P(rules.data_axis(), *(None,) * (ndim - 1)))
    out = {"tokens": mk(2)}
    if cfg.family == "vlm":
        out["patches"] = mk(3)
    if cfg.family == "encdec":
        out["frames"] = mk(3)
    return out


def opt_state_shardings(rules: MeshRules, param_shapes, opt_shapes) -> dict:
    """Mirror param specs onto master/m/v (incl. int8 q/scale leaves).

    With ``rules.zero1`` the optimizer state is additionally sharded over
    the data plane (ZeRO-1): on the biggest free dim that divides it,
    unless the parameter's spec already uses the data plane.
    """
    param_specs = rules.params_pspecs(param_shapes)
    if rules.zero1:
        dsize, daxis = rules.data_size(), rules.data_axis()

        def zero1(path, spec):
            shape = tuple(opt._at(param_shapes, path).shape)
            entries = list(spec) + [None] * (len(shape) - len(spec))
            used = set()
            for e in entries:
                if e is not None:
                    used.update(e if isinstance(e, tuple) else (e,))
            if used & set(rules.data_axes):
                return P(*entries)  # data plane already in use
            cands = [i for i, s in enumerate(entries) if s is None
                     and shape[i] >= dsize and shape[i] % dsize == 0]
            if cands:
                entries[max(cands, key=lambda j: shape[j])] = daxis
            return P(*entries)
        param_specs = map_with_path(zero1, param_specs)
    return {"step": Sharding.of(rules.mesh, P()),
            **{name: spec_for_tree(param_specs, opt_shapes[name], rules)
               for name in ("master", "m", "v")}}


def spec_for_tree(param_specs, sub_shapes, rules: MeshRules):
    """The tree of ``Sharding`` of an optimizer subtree (master, m or v)
    whose leaf at each parameter's path is a ``Spec`` or an int8
    ``{"q", "scale"}`` pair: the parameter's spec fitted to each."""
    def fit(path, spec):
        leaf = opt._at(sub_shapes, path)
        if isinstance(leaf, dict) and "q" in leaf:
            return {name: Sharding.of(rules.mesh,
                                      _fit(spec, leaf[name].shape, rules))
                    for name in ("q", "scale")}
        return Sharding.of(rules.mesh, _fit(spec, leaf.shape, rules))
    return map_with_path(fit, param_specs)


def _fit(spec: P, shape, rules: MeshRules) -> P:
    """Clip a spec to a (possibly different-rank) shape, dropping axes
    that no longer divide."""
    entries = (list(spec) + [None] * (len(shape) - len(spec)))[:len(shape)]
    out = []
    for dim, s in zip(shape, entries):
        if s is None:
            out.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        size = int(np.prod([rules.axis_size(a) for a in axes]))
        out.append(s if dim >= size and dim % size == 0 else None)
    return P(*out)
