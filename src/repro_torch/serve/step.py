"""Sharded prefill / decode step builders.

Port of the JAX reference's ``repro/serve/step.py``.  ``decode_*`` cells
build the serve step -- one new token against a cache of ``seq_len`` --
and ``prefill_*`` cells the prompt pass that fills that cache.

Cache policy, as the reference's: batch over the data plane when it
divides; KV heads over ``model`` when they divide, else the sequence dim
over ``model`` (flash-decoding layout); SSM/conv states shard d_inner
over ``model``.

The builders return the reference's tuples, with ``Sharding`` trees
(mesh, DTensor placements, spec) in place of ``NamedSharding`` ones, and
build at any mesh size.  Their ``fn`` takes DTensors in their input
placements, runs the model on the local tensors and wraps the outputs in
their output placements (``sharding.sharded``).  On a mesh of more than
one device the model holds this rank's place on it
(``distributed.collectives.Par``): it computes on its shards with
explicit collectives, and FSDP leaves are all-gathered over the data
plane at the start of each step (a routed-expert leaf over the data
plane stays sharded: the MoE layer's all-to-all computes on it).  Where
the data plane does not divide a serve batch, every data rank holds the
whole batch (``LM.batch_sharded``).  Decode writes the cache in place,
as the port's models do.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.collectives import Par
from repro_torch.distributed.sharding import (MeshRules, P, Sharding,
                                              sharded)
from repro_torch.models import api
from repro_torch.train.step import batch_shardings
from repro_torch.tree import map_with_path


def cache_shardings(cfg, cache_shapes, rules: MeshRules, batch: int):
    """The tree of ``Sharding`` of a decode-cache tree, by leaf name."""
    def per_leaf(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if name in ("k", "v", "ek", "ev"):
            kv = leaf.shape[-2]
            spec = rules.cache_spec(kv, batch, stacked_dims=nd - 4)
        elif name in ("c", "kr"):
            spec = rules.latent_cache_spec(batch, stacked_dims=nd - 3)
        elif name == "h":
            spec = rules.ssm_state_spec(batch, stacked_dims=nd - 3)
        elif name == "conv":
            spec = rules.conv_state_spec(batch, stacked_dims=nd - 3)
        else:
            spec = P()
        return Sharding.of(rules.mesh, spec)
    return map_with_path(per_leaf, cache_shapes)


def build_prefill_step(cfg, rules: MeshRules, shape):
    """Returns (fn, in_shardings, out_shardings, param_shapes).

    fn(params, batch) -> (last-token logits (B, V), cache).  The cache
    has ``seq_len`` slots, or as many as the prompt fills if more (a
    VLM's patches come on top of its tokens), as the reference's.
    ``fn.model`` is the model it runs (its ``moe_log``).
    """
    B, S = shape.global_batch, shape.seq_len
    model, gather = _mesh_model(cfg, rules, B)

    def prefill(params, batch):
        with torch.no_grad():
            return model.prefill(gather(params), batch, cache_len=S)

    param_shapes = model.param_shapes()
    param_sh = rules.params_shardings(param_shapes)
    batch_sh = batch_shardings(cfg, rules)
    cache_sh = cache_shardings(cfg, api.cache_specs(cfg, shape), rules, B)
    out_sh = (_logits_sharding(cfg, rules, B), cache_sh)
    fn = sharded(prefill, out_sh, rules.mesh)
    fn.model = model
    return fn, (param_sh, batch_sh), out_sh, param_shapes


def _mesh_model(cfg, rules: MeshRules, batch: int):
    """(the model, the FSDP gather of its parameters): on a mesh of more
    than one device the model computes on this rank's shards of a batch
    of ``batch`` rows."""
    par = Par.of(rules.mesh)
    model = api.get_model(cfg, shard_act=rules.act_sharder(), par=par)
    if par is None:
        return model, lambda params: params
    model.batch_sharded = rules._batch_entry(batch) is not None
    specs = rules.fsdp_pspecs(model.param_shapes())
    return model, lambda params: par.gather_fsdp(params, specs)


def _logits_sharding(cfg, rules: MeshRules, batch: int) -> Sharding:
    """(B, V) logits: batch over data if divisible, V over model if
    divisible (embedding is V-sharded only when that divides)."""
    dsize = rules_dsize(rules)
    b = rules.data_axis() if batch >= dsize and batch % dsize == 0 \
        else None
    m = rules.model_axis
    v = m if cfg.vocab_size % rules.axis_size(m) == 0 else None
    return Sharding.of(rules.mesh, P(b, v))


def build_decode_step(cfg, rules: MeshRules, shape):
    """Returns (fn, in_shardings, out_shardings, cache_shapes).

    fn(params, cache, token, pos) -> (logits (B, V), cache), the new
    entries written into ``cache`` in place.  ``fn.model`` is the model
    it runs.
    """
    B = shape.global_batch
    model, gather = _mesh_model(cfg, rules, B)

    def decode(params, cache, token, pos):
        with torch.no_grad():
            return model.decode_step(gather(params), cache, token, pos)

    param_sh = rules.params_shardings(model.param_shapes())
    cache_shapes = api.cache_specs(cfg, shape)
    cache_sh = cache_shardings(cfg, cache_shapes, rules, B)
    tok_sh = Sharding.of(rules.mesh, P(
        rules.data_axis() if B % rules_dsize(rules) == 0 else None, None))
    pos_sh = Sharding.of(rules.mesh, P())
    out_sh = (_logits_sharding(cfg, rules, B), cache_sh)
    in_sh = (param_sh, cache_sh, tok_sh, pos_sh)
    fn = sharded(decode, out_sh, rules.mesh)
    fn.model = model
    return fn, in_sh, out_sh, cache_shapes


def rules_dsize(rules: MeshRules) -> int:
    return rules.data_size()
