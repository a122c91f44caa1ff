"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of SEARS.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on and
prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``, then ``checks``:
each number compared with its limit (also the last lines of standard
error).  Exits non-zero, printing no result, without a card, when the
program cannot be imported, or when JAX or the JAX package was loaded.

``--control`` runs the cell's control instead of the program's timed
path (see ``bench/README.md``); its ``correct`` must come out false.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def query_card() -> subprocess.Popen | None:
    """Start ``nvidia-smi``'s query of the card's maximum SM clock and
    power limit; it runs beside the set-up (it takes seconds there)."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "-i", "0",
             "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def card_answer(proc: subprocess.Popen | None) -> tuple[float, str] | None:
    """(maximum SM MHz, power limit in W) from ``query_card``, waited for."""
    if proc is None:
        return None
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return None
    try:
        mhz, watts = (x.strip() for x in out.strip().split(","))
        return float(mhz), watts
    except ValueError:
        return None


def main(argv=None) -> int:
    args = parse(argv)
    smi = query_card()
    try:
        return measure(args, smi)
    finally:
        if smi is not None and smi.poll() is None:
            smi.kill()
            smi.wait()


def measure(args, smi) -> int:
    _paths()
    from bench.harness import runner, spec, yardstick

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.mix(cell["traffic"])

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = runner.execute(cell, cfg, mix, args.seed, args.seconds,
                         bool(args.trace), device, T_START,
                         control=args.control)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell["chips"],
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    card = card_answer(smi)
    if card is not None:
        info["power_limit_w"] = card[1]
        run.peak = yardstick.int_peak(
            torch.cuda.get_device_properties(device).multi_processor_count,
            card[0])
    result = runner.report(run, bench, info)
    found = runner.forbidden_modules()
    if found:
        print(f"bench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    runner.emit(result, run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
