#!/usr/bin/env python3
"""Time one checkout's storage kernels (K1-K5) on one GPU, alone.

    python3 time_kernels.py [--src DIR] [--flash]

Builds the CUDA kernels of the ``repro_torch`` under ``DIR`` (default:
this checkout's ``src``) and runs ``chip_smoke.kernels`` on them: each
kernel against its plain version at the main path's shapes, exactly,
timed per wrapper call (``ms``) and on the device alone (``device_ms``)
beside its bound.  It drives no main path, so its rows carry no launch
counts.  Prints one JSON line; exits non-zero without a card or when a
kernel differs from its plain version.

To compare two commits on one card, unpack the other into a git-ignored
directory and time both in one command, in the order other, this, this,
other::

    git archive <commit> | tar -x -C build/parent
    python3 time_kernels.py --src build/parent/src; python3 time_kernels.py
    python3 time_kernels.py; python3 time_kernels.py --src build/parent/src

The other checkout's wrappers must take the arguments ``chip_smoke``
gives them (true of every commit since the port's first device timer).

``--flash`` times K6 instead: ``chip_smoke.flash_phase`` (both dtypes at
every shape, held to their gates, timed beside SDPA) on a random layer 0
of the serve shape in place of the model's, then the fp32 kernel and
its fp32 plain version with q and k scaled x1, x2 and x4 (scores of std
1, 4 and 16), each read against the same function in float64 as a share
of the 2e-5 gate.  Prints the flash line, the K6 rows and the scaled
readings; exits non-zero when a shape leaves its gate.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

import chip_smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(chip_smoke.SRC),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--flash", action="store_true",
                    help="time K6 (flash attention) instead of K1-K5")
    args = ap.parse_args(argv)
    src = pathlib.Path(args.src).resolve()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"time_kernels: no repro_torch sources under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    _build.library()
    device = torch.device("cuda")
    if args.flash:
        return flash(device, src)
    rows = chip_smoke.kernels(chip_smoke.Sizes(), device,
                              collections.defaultdict(lambda: None))
    for e in rows:
        del e["launches"]
    chip_smoke.emit({"src": str(src), "card": chip_smoke.nvidia_smi(),
                     "int_peak": chip_smoke.int_peak(device),
                     "kernels": rows})
    bad = [e["name"] for e in rows if e["max_abs_err"] != 0]
    if bad:
        print(f"time_kernels: {bad} differ from their plain versions",
              file=sys.stderr)
        return 1
    return 0


def flash(device, src: pathlib.Path) -> int:
    """K6 alone (``--flash``); the flash phase raises on a gate."""
    import torch
    from repro_torch.kernels import ops, ref
    sizes = chip_smoke.Sizes()
    g = torch.Generator(device=device).manual_seed(0)
    B, P = sizes.serve_batch, sizes.prompt_len
    layer0 = tuple(torch.randn(shape, generator=g, device=device,
                               dtype=torch.bfloat16)
                   for shape in ((B, P, 32, 64), (B, P, 8, 64),
                                 (B, P, 8, 64)))
    line, rows = chip_smoke.flash_phase(sizes, device, layer0, sizes.reps)
    tol = chip_smoke.FLASH_TOL["float32"]

    def use(got, want):
        return float(((got.double() - want).abs()
                      / (tol + tol * want.abs())).max())

    def causal_f64(q, k, v):  # the same function in float64, S = T
        q, k, v = (x.double() for x in (q, k, v))
        G = q.shape[2] // k.shape[2]
        k, v = (x.repeat_interleave(G, dim=2) for x in (k, v))
        s = torch.einsum("bshd,bthd->bhst", q, k) / q.shape[-1] ** 0.5
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                     device=s.device).triu(1), -torch.inf)
        return torch.einsum("bhst,bthd->bshd", s.softmax(-1), v)
    scaled = []
    for hd in (32, 64, 96, 128, 256):
        for x in (1.0, 2.0, 4.0):
            q, k, v = (torch.randn(shape, generator=g, device=device)
                       for shape in ((1, 512, 8, hd), (1, 512, 2, hd),
                                     (1, 512, 2, hd)))
            q, k = q * x, k * x  # scores of std x^2
            with torch.no_grad():
                got = ops.flash_attention(q, k, v)
                plain = ref.flash_attention_ref(q, k, v)
                f64 = causal_f64(q, k, v)
            scaled.append({"hd": hd, "scale": x,
                           "kernel_vs_f64": use(got, f64),
                           "plain_vs_f64": use(plain, f64),
                           "kernel_vs_plain": use(got, plain.double())})
    chip_smoke.emit({"src": str(src), "card": chip_smoke.nvidia_smi(),
                     "flash": line, "kernels": rows, "fp32_scaled": scaled})
    return 0


if __name__ == "__main__":
    sys.exit(main())
