"""Data-plane launch counting, dependency-free.

Lives apart from ``ops`` so batching layers (``core.scheduler``,
benchmarks) can read the counters without importing torch and the CUDA
kernel modules — a NumpyEngine store never pays that import just to
snapshot counts that stay zero on its path.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LaunchCounter:
    """Data-plane dispatch counts (one increment per device launch)."""

    gf: int = 0  # GF(256) matmul launches (encode + decode buckets)
    sha1: int = 0  # SHA-1 batch launches
    gear: int = 0  # gear CDC rolling-hash launches (chunking stream)
    fused: int = 0  # fused SHA-1+GF ingest launches (one per bucket)

    @property
    def total(self) -> int:
        return self.gf + self.sha1 + self.gear + self.fused

    def snapshot(self) -> "LaunchCounter":
        return dataclasses.replace(self)

    def delta(self, since: "LaunchCounter") -> "LaunchCounter":
        return LaunchCounter(gf=self.gf - since.gf,
                             sha1=self.sha1 - since.sha1,
                             gear=self.gear - since.gear,
                             fused=self.fused - since.fused)

    def reset(self) -> None:
        self.gf = self.sha1 = self.gear = self.fused = 0


LAUNCHES = LaunchCounter()

# Shape counts: PyTorch runs eagerly and traces nothing, so the dispatch
# layer (``kernels.ops``) increments these once per *newly seen* (family,
# padded launch shape), from a memo set.  A counter that keeps growing
# across same-bucket calls means the bucketed padding broke -- the same
# signal as a jit-cache miss in the JAX reference.
TRACES = LaunchCounter()


def reset_all() -> None:
    """Zero both counter families together.

    Resetting only one family skews any assertion that reads a launch
    delta against a trace count from an earlier phase (or vice versa),
    so benches and tests go through this instead of ``LAUNCHES.reset()``
    — the ``counter-family-reset`` lint rule enforces it.
    """
    LAUNCHES.reset()
    TRACES.reset()


def snapshot_all() -> dict[str, LaunchCounter]:
    """Point-in-time snapshot of both families, keyed 'launches'/'traces'."""
    return {"launches": LAUNCHES.snapshot(), "traces": TRACES.snapshot()}


def delta_all(since: dict[str, LaunchCounter]) -> dict[str, LaunchCounter]:
    """Per-family deltas against a :func:`snapshot_all` result."""
    return {"launches": LAUNCHES.delta(since["launches"]),
            "traces": TRACES.delta(since["traces"])}


# CUDA kernel launches, one plain integer per kernel wrapper.  A wrapper
# adds one right where it launches its kernel and nowhere else -- never
# on the plain (CPU) path -- so a run that reads these after zeroing
# them proves which kernels its path really went through.
# K6 has two: ``flash_attn`` (bf16, tensor cores) and ``flash_attn_fp32``
# (fp32, CUDA cores).
KERNELS: dict[str, int] = {"gf_matmul": 0, "gear_fire": 0, "gear_hash": 0,
                           "sha1": 0, "fused_ingest": 0, "flash_attn": 0,
                           "flash_attn_fp32": 0}


def reset_kernels() -> None:
    """Zero every kernel wrapper's launch count."""
    for name in KERNELS:
        KERNELS[name] = 0
