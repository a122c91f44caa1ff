"""One run of one cell: set-up, the measured window, the check, the line.

``execute`` drives a cell on any device with any engine; ``bench/run.py``
calls it on the card with the program's fused engine after checking that
the card is there, and the CPU tests call it at small sizes.

The loop is closed: each round every user of the mix submits one request
to the store's ``BatchScheduler`` and then the round's ``flush()`` runs,
the switching node's coalesced window.  The window runs rounds back to
back until ``seconds`` have passed and ends with the round that crosses
them.  Every round's inputs are made before it opens; a run that would
need more rounds than the mix reserves fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys
import time

import numpy as np

from bench.harness import checks, spec, traffic
from bench.harness.spans import Spans

MiB = float(1 << 20)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ReserveExhausted(RuntimeError):
    pass


@dataclasses.dataclass
class Run:
    """What a loop and the metric readers see of one run."""

    cell: dict
    cfg: dict
    mix: dict
    trace: bool
    store: object
    sched: object
    gen: traffic.Generator
    rng: np.random.Generator  # the harness's own draws (samples, reads)
    spans: Spans | None = None
    timed: bool = False
    attempted: int = 0
    failed: int = 0
    put_bytes: int = 0
    get_bytes: int = 0
    put_ms: list = dataclasses.field(default_factory=list)
    get_ms: list = dataclasses.field(default_factory=list)
    acked: list = dataclasses.field(default_factory=list)  # (user, fn, data)
    setup_s: float = 0.0
    window_s: float = 0.0
    stored_before: int = 0
    stored_after: int = 0
    trace_result: object = None
    peak: dict | None = None
    state: dict = dataclasses.field(default_factory=dict)  # the loop's own

    @property
    def mib(self) -> float:
        return (self.put_bytes + self.get_bytes) / MiB

    def flush(self) -> None:
        if self.spans is not None:
            with self.spans.span("flush"):
                self.sched.flush()
        else:
            self.sched.flush()

    def put_round(self, files) -> None:
        """One put request per user with its files of the round, one flush."""
        by_user: dict[str, list] = {}
        for user, fn, data in files:
            by_user.setdefault(user, []).append((fn, data))
        cls = self.cfg["class"]["name"]
        futures = [(u, fs, time.perf_counter(),
                    self.sched.submit_put(u, fs, storage_class=cls))
                   for u, fs in by_user.items()]
        self.flush()
        t1 = time.perf_counter()
        for user, fs, t0, fut in futures:
            ok = fut.exception() is None
            if not self.timed:
                if not ok:
                    raise RuntimeError(f"set-up put failed: {fut.exception()}")
                continue
            self.attempted += 1
            self.put_ms.append((t1 - t0) * 1e3)
            if ok:
                self.put_bytes += sum(len(d) for _, d in fs)
                self.acked.extend((user, fn, d) for fn, d in fs)
            else:
                self.failed += 1

    def get_round(self, gets) -> list:
        """One get request per (user, filenames), one flush; the bytes
        returned per file, None where a request failed."""
        cls = self.cfg["class"]["name"]
        futures = [(names, time.perf_counter(),
                    self.sched.submit_get(u, names, storage_class=cls))
                   for u, names in gets]
        self.flush()
        t1 = time.perf_counter()
        out = []
        for names, t0, fut in futures:
            err = fut.exception()
            if err is not None and not self.timed:
                raise RuntimeError(f"set-up get failed: {err}")
            got = [None] * len(names) if err is not None \
                else [data for data, _ in fut.result()]
            out.extend(got)
            if self.timed:
                self.attempted += 1
                self.get_ms.append((t1 - t0) * 1e3)
                if err is None:
                    self.get_bytes += sum(len(d) for d in got)
                else:
                    self.failed += 1
        return out


def stored_bytes(store) -> int:
    """Bytes every node's pieces hold, summed here, plus the index."""
    pieces = sum(node.used for cl in store.clusters for node in cl.nodes)
    return pieces + store.stats().index_bytes


def make_store(cfg: dict, engine=None, **settings):
    """The configuration's store, every setting passed explicitly (so no
    ``SEARS_*`` variable changes it); ``engine`` replaces the configured
    one on the CPU, ``settings`` override the configuration's in a
    control run."""
    from repro_torch.core import SEARSStore, StorageClass
    settings = {**cfg["store"], **settings}
    if engine is not None:
        settings["engine"] = engine
    return SEARSStore(classes=[StorageClass(**cfg["class"])], **settings)


def _sync(device) -> None:
    import torch
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize()


def execute(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
            trace: bool, device, t_start: float, engine=None,
            control: bool = False) -> Run:
    """Set up and measure; returns the ``Run`` the readers take."""
    import torch

    loop = spec.loop(mix["loop"])
    ctl = loop.control() if control else {}
    store = make_store(cfg, engine, **ctl.get("store", {}))
    sched = store.scheduler(pipeline=True, **ctl.get("scheduler", {}))
    gen = traffic.Generator(traffic.Content.from_mix(mix), seed, device)
    run = Run(cell=cell, cfg=cfg, mix=mix, trace=trace, store=store,
              sched=sched, gen=gen,
              rng=np.random.default_rng(traffic.derive(seed, "harness")))
    marks = [("store", time.perf_counter())]
    loop.setup(run)
    marks.append(("loop setup", time.perf_counter()))
    rounds = loop.prepare(run)
    marks.append(("inputs", time.perf_counter()))
    for name, method in ctl.get("engine", {}).items():
        setattr(store.engine, name, method)
    gc.collect()
    _sync(device)
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run.stored_before = stored_bytes(store)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if getattr(device, "type", "cpu") == "cuda":
            acts.append(ProfilerActivity.CUDA)
        run.spans = Spans()
        run.spans.wrap_engine(store.engine)
        prof = profile(activities=acts)
        prof.__enter__()
    marks.append(("rest", time.perf_counter()))
    before = _host_counters()
    run.timed = True
    run.setup_s = time.perf_counter() - t_start
    run.state["setup_phases_s"] = {
        "start": marks[0][1] - t_start,
        **{b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}}
    t_open = time.perf_counter()
    exhausted = True
    with (run.spans.span("window") if run.spans is not None
          else contextlib.nullcontext()):
        ends = run.state["round_ends_s"] = []
        for inputs in rounds:
            loop.round(run, inputs)
            ends.append(time.perf_counter() - t_open)
            if ends[-1] >= seconds:
                exhausted = False
                break
        _sync(device)
    run.window_s = time.perf_counter() - t_open
    run.timed = False
    after = _host_counters()
    run.state["host_window"] = {k: after[k] - before[k] for k in after}
    if prof is not None:
        prof.__exit__(None, None, None)
    if exhausted:
        raise ReserveExhausted(
            f"the mix reserves {len(rounds)} rounds and the window needed "
            f"more; raise reserve_rounds in the mix")
    run.stored_after = stored_bytes(store)
    if prof is not None:
        from bench.harness.trace import reduce
        names = {n for n, _, _ in run.spans.records}
        run.trace_result = reduce(prof.events(), names)
    return run


def _host_counters() -> dict:
    """This process's CPU seconds: beside the window's wall time they
    tell host-bound work from waiting."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime}


def judge(run: Run) -> dict:
    """The numbers compared: each a count of disagreements, limit 0."""
    loop = spec.loop(run.mix["loop"])
    counts = {name: 0 for name in checks.NAMES}
    counts.update(loop.check(run))
    counts["failed"] = run.failed
    return counts


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def report(run: Run, bench: dict, device_info: dict) -> dict:
    """The result line (a dict; ``checks`` last) and the stderr lines."""
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, run.cell["name"], kind):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    t0 = time.perf_counter()
    counts = judge(run)
    run.state["check_s"] = time.perf_counter() - t0
    out = {"correct": all(v == 0 for v in counts.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dict(device_info)}
    if run.trace and run.trace_result is not None:
        out["device"]["busy_s"] = run.trace_result.busy_s
        out["device"]["window_s"] = run.trace_result.window_s
        out["breakdown"] = run.trace_result.breakdown()
    out["checks"] = {name: {"value": v, "limit": 0}
                     for name, v in counts.items()}
    return out


def emit(result: dict, run: Run | None = None) -> None:
    if run is not None:
        for key in ("setup_phases_s", "round_ends_s", "host_window",
                    "node_read_bytes", "check_s"):
            print(f"{key}: {json.dumps(run.state.get(key))}",
                  file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
