"""Pass 3 — counter coverage, in the port's idiom.

Three counter families make the port's launch contract observable:
``LAUNCHES`` (one tick per data-plane dispatch, where the reference's
``ops`` ticks), ``TRACES`` (one tick per newly seen launch shape, from
the ``_new_shape`` memo: the port's form of a retrace) and
``KERNELS[name]`` (one tick per kernel launch, read by ``chip_smoke.py``
and the sanitizer's launch model).  A dispatch that forgets its tick is
invisible to all of them.  Four rules:

- ``counter-launch``: a function in ``kernels/ops.py``/``gear_cdc.py``
  that reaches a storage kernel wrapper (a function that calls a
  ``_build.library()`` symbol) must increment ``LAUNCHES.<kind>``
  itself -- or every storage call site of it must sit inside a function
  that does.  The model's kernel (``flash_attn``, K6) is not a storage
  data-plane dispatch: a function that reaches only model kernels is
  counted by ``KERNELS`` alone (``ops.flash_attention``).
- ``counter-trace``: every ``LAUNCHES.<kind>`` tick has a
  ``TRACES.<kind>`` tick of the same kind under an ``if
  _new_shape(...)`` in the same function, so a broken bucketing (a new
  launch shape per call) is observable.
- ``counter-kernel``: every function that calls a ``_build.library()``
  symbol ticks ``KERNELS[...]`` after its ``_build.check(...)``, so only
  a launch that reported no error counts; and nothing else ticks
  ``KERNELS`` (a plain CPU path must not count as a launch).
- ``counter-family-reset``: outside ``launches.py`` nothing may call
  ``LAUNCHES.reset()`` / ``TRACES.reset()`` directly -- resetting one
  family while a bench/test reads the other skews cross-family
  assertions; use ``launches.reset_all()``.
"""

from __future__ import annotations

import ast

from repro_torch.lint.core import (Finding, FuncInfo, Module, Program,
                                   counter_increments, dotted, launch_calls)

LAUNCH_RULE = "counter-launch"
TRACE_RULE = "counter-trace"
KERNEL_RULE = "counter-kernel"
RESET_RULE = "counter-family-reset"

REPORT_STEMS = {"ops", "gear_cdc"}
TRACE_STEMS = {"ops", "gear_cdc", "gf_matmul", "sha1", "fused_ingest"}
MODEL_KERNEL_STEMS = {"flash_attn"}
KERNEL_STEMS = TRACE_STEMS | {"ref"} | MODEL_KERNEL_STEMS
SHAPE_MEMO = "_new_shape"
CHECK_FUNC = "check"  # _build.check


def _direct_callees(program: Program, fn: FuncInfo,
                    universe: set[int]) -> list[FuncInfo]:
    out = []
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            for callee in program.resolve_call(fn.module, node):
                if id(callee) in universe:
                    out.append(callee)
    return out


def _calls_by_name(program: Program
                   ) -> dict[str, list[tuple[Module, ast.Call, str]]]:
    """Every storage call site with a dotted callee, by its last segment."""
    out: dict[str, list[tuple[Module, ast.Call, str]]] = {}
    for m in program.storage_modules:
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call):
                name = dotted(node.func)
                if name:
                    out.setdefault(name.split(".")[-1], []).append(
                        (m, node, name))
    return out


def _call_sites(program: Program, fn: FuncInfo,
                calls: dict[str, list[tuple[Module, ast.Call, str]]]
                ) -> list[FuncInfo | None]:
    """Enclosing functions of every storage call site of ``fn``
    (None = module level)."""
    sites: list[FuncInfo | None] = []
    for m, node, name in calls.get(fn.name, []):
        if "." in name:
            if program.module_named(m, name.split(".")[0]) is not fn.module:
                continue
        elif m is not fn.module:
            continue
        sites.append(program.enclosing_func(node))
    return sites


def _check_launch(program: Program, kfuncs: list[FuncInfo]
                  ) -> list[Finding]:
    universe = {id(f) for f in kfuncs}
    # storage kernel wrappers; the model's kernels count in KERNELS only
    roots = {id(f) for f in kfuncs if f.launches
             and f.module.stem not in MODEL_KERNEL_STEMS}
    model_roots = {id(f) for f in kfuncs if f.launches} - roots
    counted = {id(f) for f in kfuncs
               if counter_increments(f.node, "LAUNCHES")}

    # a function "dispatches" if -- itself uncounted -- it directly calls
    # a storage kernel wrapper or another dispatching function
    callees = {id(f): _direct_callees(program, f, universe) for f in kfuncs}
    dispatching: set[int] = set()
    changed = True
    while changed:
        changed = False
        for f in kfuncs:
            if id(f) in dispatching | roots | model_roots | counted:
                continue
            if any(id(c) in roots or id(c) in dispatching
                   for c in callees[id(f)]):
                dispatching.add(id(f))
                changed = True

    # a dispatching function is covered if every storage call site sits
    # inside a counted or covered function (and it has >= 1 site)
    covered: set[int] = set()
    by_id = {id(f): f for f in kfuncs}
    calls = _calls_by_name(program)
    sites_of = {fid: _call_sites(program, by_id[fid], calls)
                for fid in dispatching}
    changed = True
    while changed:
        changed = False
        for fid in dispatching - covered:
            sites = sites_of[fid]
            if sites and all(owner is not None
                             and (id(owner) in counted
                                  or id(owner) in covered)
                             for owner in sites):
                covered.add(fid)
                changed = True

    findings = []
    for fid in sorted(dispatching - covered,
                      key=lambda i: (str(by_id[i].module.path),
                                     by_id[i].node.lineno)):
        f = by_id[fid]
        if f.module.stem not in REPORT_STEMS:
            continue
        findings.append(Finding(
            path=str(f.module.path), line=f.node.lineno, rule=LAUNCH_RULE,
            message=f"`{f.qualname}` dispatches a device launch but "
                    "neither it nor all of its call sites increment "
                    "`LAUNCHES.<kind>`"))
    return findings


def _shape_guarded_traces(fn: ast.AST) -> set[str]:
    """Kinds of the ``TRACES.<kind>`` ticks under ``if _new_shape(...)``."""
    kinds: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        if not any(isinstance(c, ast.Call) and dotted(c.func)
                   and dotted(c.func).split(".")[-1] == SHAPE_MEMO
                   for c in ast.walk(node.test)):
            continue
        for stmt in node.body:
            for inc in counter_increments(stmt, "TRACES"):
                if isinstance(inc.target, ast.Attribute):
                    kinds.add(inc.target.attr)
    return kinds


def _check_trace(kfuncs: list[FuncInfo]) -> list[Finding]:
    findings = []
    for f in kfuncs:
        if f.module.stem not in TRACE_STEMS:
            continue
        guarded = _shape_guarded_traces(f.node)
        for inc in counter_increments(f.node, "LAUNCHES"):
            kind = (inc.target.attr if isinstance(inc.target, ast.Attribute)
                    else "?")
            if kind not in guarded:
                findings.append(Finding(
                    path=str(f.module.path), line=inc.lineno,
                    rule=TRACE_RULE,
                    message=f"`{f.qualname}` ticks `LAUNCHES.{kind}` with "
                            f"no `TRACES.{kind}` tick under "
                            f"`if {SHAPE_MEMO}(...)`; new launch shapes "
                            "go unseen"))
    return findings


def _check_kernel(program: Program) -> list[Finding]:
    findings = []
    for f in program.storage_funcs():
        path = str(f.module.path)
        ticks = counter_increments(f.node, "KERNELS")
        if not f.launches:
            for inc in ticks:
                findings.append(Finding(
                    path=path, line=inc.lineno, rule=KERNEL_RULE,
                    message=f"`{f.qualname}` ticks `KERNELS` but launches "
                            "no kernel; a wrapper counts only where it "
                            "launches"))
            continue
        last_launch = max(c.lineno for c in launch_calls(f.node, f.module))
        checks = [c.lineno for c in ast.walk(f.node)
                  if isinstance(c, ast.Call) and dotted(c.func)
                  and dotted(c.func).split(".")[-1] == CHECK_FUNC
                  and c.lineno >= last_launch]
        if not any(checks and inc.lineno > min(checks) for inc in ticks):
            findings.append(Finding(
                path=path, line=f.node.lineno, rule=KERNEL_RULE,
                message=f"`{f.qualname}` launches a kernel but does not "
                        "tick `KERNELS[...]` after `_build.check(...)`"))
    return findings


def run(program: Program) -> list[Finding]:
    kfuncs = [f for f in program.storage_funcs()
              if f.module.stem in KERNEL_STEMS]
    findings = _check_launch(program, kfuncs)
    findings += _check_trace(kfuncs)
    findings += _check_kernel(program)

    # counter-family-reset: scans the full module set (tests/benchmarks)
    for mod in program.modules:
        if mod.stem == "launches":
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and dotted(node.func) in (
                    "LAUNCHES.reset", "TRACES.reset"):
                findings.append(Finding(
                    path=str(mod.path), line=node.lineno, rule=RESET_RULE,
                    message=f"`{dotted(node.func)}()` resets one counter "
                            "family; use `launches.reset_all()` so "
                            "LAUNCHES and TRACES stay in step"))
    return findings
