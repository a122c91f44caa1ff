"""AdamW with mixed-precision master weights and quantized moments.

Port of the JAX reference's ``repro/train/optimizer.py``, on explicit
tensors.  The memory layout:

* model params: bf16 (what the forward pass consumes)
* master copy:  fp32
* moments m/v:  fp32 by default; ``moment_dtype='int8'`` switches to a
  block-wise 8-bit first moment (``{"q": int8, "scale": fp32}``) and a
  bf16 second moment (8-bit-Adam style; a pure-int8 v underflows inside
  absmax blocks and explodes the update).

The optimizer is a pure transform of nested dicts: ``init(params) ->
state``, ``apply(state, grads) -> (state, new_bf16_params)``.  The state's
``step`` is a 0-d int32 tensor; the bias corrections ``b ** t`` are taken
in fp32, and the int8 quantizer rounds half to even, as the reference's
``jnp.round`` does, so both packages quantize the same moments to the
same bytes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Spec
from repro_torch.tree import flatten_with_path, map_with_path, tree_map

QBLOCK = 256  # block size for int8 moment quantization


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "fp32"  # fp32 | int8
    grad_clip: float = 1.0


# ----------------------------------------------------- int8 block quant ----
# Shape-preserving block quantization along the last axis: ``q`` keeps the
# (padded) parameter shape; ``scale`` is the per-block fp32 maximum / 127.

def _quantize(x: torch.Tensor) -> dict[str, torch.Tensor]:
    lead, last = tuple(x.shape[:-1]), x.shape[-1]
    pad = (-last) % QBLOCK
    xp = F.pad(x, (0, pad))
    blocks = xp.reshape(*lead, -1, QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0  # (*lead, nblk)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return {"q": q.reshape(*lead, last + pad).to(torch.int8),
            "scale": scale.to(torch.float32)}


def _dequantize(d: dict[str, torch.Tensor], shape) -> torch.Tensor:
    lead, last = tuple(shape[:-1]), shape[-1]
    qb = d["q"].reshape(*lead, -1, QBLOCK).to(torch.float32)
    full = (qb * d["scale"][..., None]).reshape(*lead, -1)
    return full[..., :last]


# ------------------------------------------------------------- optimizer ---
def init(params, cfg: AdamWConfig):
    """params: bf16 model params. Returns the optimizer state tree, on
    the params' device."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)

    def zeros_m(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if cfg.moment_dtype == "int8" else z

    def zeros_v(p):
        dt = torch.bfloat16 if cfg.moment_dtype == "int8" else torch.float32
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "step": torch.zeros((), dtype=torch.int32,
                            device=flatten_with_path(params)[0][1].device),
        "master": master,
        "m": tree_map(zeros_m, params),
        "v": tree_map(zeros_v, params),
    }


def state_shapes(param_shapes, cfg: AdamWConfig):
    """The state tree with a ``Spec`` at every leaf, for ``param_shapes``
    (a tree of ``Spec``); nothing is allocated."""
    meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), param_shapes)
    return tree_map(lambda t: Spec(tuple(t.shape), t.dtype), init(meta, cfg))


class Int8Blocks:
    """The int8 first moment of one leaf on a mesh, quantized in the
    whole tensor's blocks of ``QBLOCK`` along the last dim.

    The optimizer state's shardings are the reference's: the master
    copy's last dim may shard over a plane (``m_entry``) in slices that
    are not whole blocks, the padded ``q`` over the same plane or none
    (``q_entry``), and ``scale`` over it only where its block count
    divides (``s_entry``: else replicated).  Where all three agree and a
    slice is whole blocks, a rank quantizes its slice alone; elsewhere
    it gathers ``q`` and ``scale`` to dequantize, and the updated moment
    to quantize, along the last dim, and keeps its own slices, so that
    every block's scale is the maximum over the whole block."""

    def __init__(self, n: int, m_entry, q_entry, s_entry, par) -> None:
        self.n, self.par = n, par
        self.entries = (m_entry, q_entry, s_entry)
        self.aligned = m_entry == q_entry == s_entry and (
            m_entry is None
            or n % (QBLOCK * par.plane(m_entry).size) == 0)

    def dequantize(self, d: dict, shape) -> torch.Tensor:
        """The fp32 moment of this rank's master slice (``shape``)."""
        if self.aligned:
            return _dequantize(d, shape)
        m_entry, q_entry, s_entry = self.entries
        # int8 crosses as bf16 (exact for |q| <= 127)
        q = self.par.gather(d["q"].to(torch.bfloat16), -1, q_entry)
        scale = self.par.gather(d["scale"], -1, s_entry)
        full = _dequantize({"q": q.to(torch.int8), "scale": scale},
                           tuple(shape[:-1]) + (self.n,))
        return self.par.shard(full, -1, m_entry)

    def quantize(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """``_quantize`` of the whole moment, this rank's slices of it."""
        if self.aligned:
            return _quantize(x)
        m_entry, q_entry, s_entry = self.entries
        d = _quantize(self.par.gather(x, -1, m_entry))
        return {"q": self.par.shard(d["q"], -1, q_entry).contiguous(),
                "scale": self.par.shard(d["scale"], -1, s_entry)
                .contiguous()}


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for _, g in flatten_with_path(grads)))


def _at(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def apply(state, grads, cfg: AdamWConfig, gnorm=None, blocks=None):
    """One AdamW update.  Returns (new_state, new bf16 params).

    On a mesh (the train step's): ``state`` and ``grads`` are this
    rank's slices of them, ``gnorm`` the global norm of the whole
    gradients, and ``blocks`` a tree of ``Int8Blocks`` at the
    parameters' paths for int8 moments (None: each slice is whole
    blocks)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    if gnorm is None:
        gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                       max=1.0)

    def upd(path, master):
        m, v = _at(state["m"], path), _at(state["v"], path)
        g = _at(grads, path).to(torch.float32) * clip
        quant = (_quantize, _dequantize) if blocks is None else (
            _at(blocks, path).quantize, _at(blocks, path).dequantize)
        if cfg.moment_dtype == "int8":
            m_f = quant[1](m, master.shape)
        else:
            m_f = m
        v_f = v.to(torch.float32)
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        mhat = m_f / (1 - cfg.b1 ** t)
        vhat = v_f / (1 - cfg.b2 ** t)
        new_master = master - cfg.lr * (
            mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * master)
        if cfg.moment_dtype == "int8":
            m_out, v_out = quant[0](m_f), v_f.to(torch.bfloat16)
        else:
            m_out, v_out = m_f, v_f
        return new_master, m_out, v_out

    out = {path: upd(path, master)
           for path, master in flatten_with_path(state["master"])}
    new_master, new_m, new_v = (
        map_with_path(lambda path, _, i=i: out[path][i], state["master"])
        for i in range(3))
    new_params = tree_map(lambda p: p.to(torch.bfloat16), new_master)
    new_state = {"step": step, "master": new_master, "m": new_m, "v": new_v}
    return new_state, new_params
