"""CLI: ``python -m repro_torch.lint src/repro_torch tests`` -- exit 1 on
any unwaived finding."""

from __future__ import annotations

import argparse
import sys

from repro_torch.lint import run_paths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="SEARS invariant static analysis of the PyTorch port: "
                    "begin-purity, dispatch hygiene, counter coverage, "
                    "plan determinism, cache discipline.")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to analyze")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings")
    args = ap.parse_args(argv)

    findings = run_paths(args.paths)
    live = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]
    for f in live:
        print(f.format())
    if args.show_waived:
        for f in waived:
            print(f"{f.format()} (waived)")
    if live:
        print(f"searslint: {len(live)} finding(s), {len(waived)} waived")
        return 1
    print(f"searslint: clean, {len(waived)} waived")
    return 0


if __name__ == "__main__":
    sys.exit(main())
