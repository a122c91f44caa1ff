#!/usr/bin/env python3
"""Time one checkout's storage kernels (K1-K5) on one GPU, alone.

    python3 time_kernels.py [--src DIR]

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


if __name__ == "__main__":
    sys.exit(main())
