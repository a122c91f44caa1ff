"""Step analysis: FLOPs, bytes and collectives of one eager step, and its
roofline terms on an NVIDIA H100 SXM.

Port of the JAX reference's ``repro/launch/analysis.py``.  The reference
parses the optimized post-SPMD HLO text (``analyze_hlo``) and weights
every instruction by its enclosing loops' trip counts.  Torch has no such
text: ``analyze_step`` runs the step once under a ``TorchDispatchMode``
and counts every aten op as it runs.  An eager run unrolls every Python
loop, so nothing needs weighting (``unknown_loops`` is always 0); a
caller that knows a loop's iterations to be alike may run one of them
under ``repeated(n)`` instead, as the dry run does for attention's
tiles.  It counts, as the reference does:

  1. FLOPs of dots only: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and the
     fused attention ops where they appear, by
     ``torch.utils.flop_counter``'s formulas (2 * M * N * K for a
     matmul).  Elementwise and transcendental work is excluded, and so
     are convolutions, which the reference's docstring also leaves out
     (the Mamba layers' depthwise conv would count on one side only);
  2. bytes: the input and output bytes of every op that is neither a view
     nor a pure metadata op, each tensor once per op -- the eager twin of
     "every top-level non-fused instruction".  Every eager op's inputs
     and outputs are taken as HBM traffic, so where they stay in the
     card's 50 MB L2 the term is an overstatement;
  3. collective bytes: the operand bytes of every ``_c10d_functional`` /
     ``c10d`` collective op, by the reference's kind names.

It runs on real tensors (the card's or the CPU's) and on fake ones
(``torch._subclasses.FakeTensorMode``), where a step of 256 x 4096
tokens costs no memory.

Roofline terms (one H100 SXM, NVIDIA's data sheet, at its 700 W limit):
  compute    = FLOPs / (chips * 989 TF/s bf16 dense, tensor cores)
  memory     = bytes / (chips * 3.35 TB/s HBM3)
  collective = collective_bytes / (chips * 450 GB/s NVLink 4 per
               direction: 18 links x 25 GB/s)
The collective term is ``None`` where the collective bytes are unknown.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12  # bf16 dense per card
HBM_BW = 3.35e12  # bytes/s per card
ICI_BW = 450e9  # bytes/s per card and direction (NVLink 4)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# aten overload packets whose FLOPs are counted: the dots
_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm",
            "_scaled_dot_product_efficient_attention",
            "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_cudnn_attention",
            "_scaled_dot_product_efficient_attention_backward",
            "_scaled_dot_product_flash_attention_backward",
            "_scaled_dot_product_cudnn_attention_backward",
            "_flash_attention_forward", "_efficient_attention_forward",
            "_flash_attention_backward", "_efficient_attention_backward")

# collective ops (namespace, op name) -> the reference's kind
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced_"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
}

# ops that move no bytes: allocation, aliasing and metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "detach_", "alias",
               "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "is_same_size", "set_", "resize_", "wait_tensor",
               "_unsafe_view", "_reshape_alias", "as_strided",
               "record_stream", "is_nonzero",
               "_has_compatible_shallow_copy_type"}


@dataclasses.dataclass
class StepStats:
    """``HloStats``' fields, for one eager run of a step."""
    flops: float
    bytes_traffic: float
    coll_bytes: float
    coll_by_kind: dict[str, int]
    n_collectives: int
    unknown_loops: int = 0

    def scaled(self, w: float) -> "StepStats":
        """These counts ``w`` times over (a loop body run ``w`` times)."""
        return StepStats(self.flops * w, self.bytes_traffic * w,
                         self.coll_bytes * w,
                         {k: int(v * w) for k, v in self.coll_by_kind.items()},
                         int(self.n_collectives * w), self.unknown_loops)

    def __add__(self, other: "StepStats") -> "StepStats":
        return StepStats(
            self.flops + other.flops,
            self.bytes_traffic + other.bytes_traffic,
            self.coll_bytes + other.coll_bytes,
            {k: self.coll_by_kind[k] + other.coll_by_kind[k]
             for k in COLLECTIVES},
            self.n_collectives + other.n_collectives,
            self.unknown_loops + other.unknown_loops)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _dot_formulas() -> dict:
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    return {getattr(aten, name): flop_registry[getattr(aten, name)]
            for name in _DOT_OPS
            if hasattr(aten, name) and getattr(aten, name) in flop_registry}


class _Counter(TorchDispatchMode):
    """Counts each aten op as it runs (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.dots = _dot_formulas()
        self.stats = StepStats(0.0, 0.0, 0.0, {k: 0 for k in COLLECTIVES}, 0)
        self.weight = 1  # each op counts this many times (``repeated``)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first and lower to ops on its local tensors
            # (the collectives among them), which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        st, w = self.stats, self.weight
        formula = self.dots.get(packet)
        if formula is not None:
            st.flops += float(formula(*args, **kwargs, out_val=out)) * w
        ns = func.namespace
        name = packet.__name__
        kind = _COLLECTIVE_OPS.get((ns, name))
        if kind is not None:
            b = sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor)) * w
            st.coll_bytes += b
            st.coll_by_kind[kind] += b
            st.n_collectives += w
            st.bytes_traffic += b
            return out
        if func.is_view or name in _NO_TRAFFIC or ns not in ("aten",
                                                              "prims"):
            return out
        seen = set()
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                st.bytes_traffic += _nbytes(t) * w
        return out


_ACTIVE: list[_Counter] = []  # the counters of the running analyze_steps


@contextlib.contextmanager
def repeated(times: int):
    """Count the ops run inside ``times`` times over: one iteration of a
    loop whose iterations all run the same ops on the same shapes stands
    for all of them.  Outside ``analyze_step`` it changes nothing."""
    for c in _ACTIVE:
        c.weight *= times
    try:
        yield
    finally:
        for c in _ACTIVE:
            c.weight //= times


def analyze_step(fn, *args, **kw) -> StepStats:
    """Run ``fn(*args, **kw)`` once and count its dots' FLOPs, its ops'
    bytes and its collectives (module docstring).  ``fn`` runs as it
    would: on real tensors it computes, on fake tensors it only
    propagates shapes."""
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            fn(*args, **kw)
    finally:
        _ACTIVE.remove(counter)
    return counter.stats


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    flops: float  # whole-mesh FLOPs per step (sum over chips)
    bytes_accessed: float  # whole-mesh HBM traffic per step
    coll_bytes: float | None  # whole-mesh collective operand bytes per step
    chips: int
    model_flops: float

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float | None:
        if self.coll_bytes is None:
            return None
        return self.coll_bytes / (self.chips * ICI_BW)

    def _terms(self) -> dict:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful FLOPs / bound-time compute budget."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / self.t_bound

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D for training, 2*N*D for inference (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
