"""Pass 1 — begin-purity.

The pipelined put/get seams rely on ``*_begin`` phases being pure with
respect to control-plane state: window i+1's begin runs while window
i's finish is still mutating the store, so a begin that touches
store/cluster/dedup state breaks the byte-identity proof.  This pass
resolves the call graph reachable from every ``*_begin`` function in
``engine.py`` / ``chunking.py`` / ``ops.py`` / ``rs_code.py`` of the port
and flags:

- attribute/subscript assignment whose base is ``self`` or a module
  global;
- mutating container-method calls (``append``/``update``/``pop``/...)
  on receivers that are not function-locals;
- any call into the known-mutating store/cluster/dedup APIs
  (``add_ref``, ``store_chunks``, ``put_meta``, ...), however reached.

Sanctioned, because they are monotonic and never feed a plan: the
diagnostic counters ``LAUNCHES``, ``TRACES`` and ``KERNELS``, and the
launch-shape memo ``_SEEN_SHAPES`` (filled by ``ops._new_shape``), which
stands in for JAX's trace cache: a begin that issues a launch of a new
shape records it there, as a begin in the reference fills the jit cache.
"""

from __future__ import annotations

import ast

from repro_torch.lint.core import (Finding, FuncInfo, Program, calls_in,
                                   dotted, local_names, root_name)

RULE = "begin-purity"

ROOT_MODULES = {"engine", "chunking", "ops", "rs_code"}

# monotonic diagnostics and the launch-shape memo, explicitly exempt
# from the purity requirement
COUNTER_ROOTS = {"LAUNCHES", "TRACES", "KERNELS", "_SEEN_SHAPES"}

MUTATING_METHODS = {
    "append", "add", "clear", "discard", "extend", "insert", "pop",
    "popitem", "remove", "setdefault", "update", "write",
}

MUTATING_APIS = {
    "put_meta", "drop_meta", "add_ref", "release", "reserve",
    "release_reservation", "store_chunk", "store_chunks", "delete_chunk",
    "kill_nodes", "revive_nodes", "replace_nodes", "wipe", "hint",
    "_delete_now", "_rollback_files", "_execute_uploads", "_plan_put",
}


def _check_func(fn: FuncInfo, via: str) -> list[Finding]:
    findings: list[Finding] = []
    path = str(fn.module.path)
    locals_ = local_names(fn.node)
    suffix = "" if via == fn.qualname else f" (reachable from {via})"

    def flag(line: int, what: str) -> None:
        findings.append(Finding(
            path=path, line=line, rule=RULE,
            message=f"`{fn.qualname}`{suffix} {what}"))

    for node in ast.walk(fn.node):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if not isinstance(t, (ast.Attribute, ast.Subscript)):
                    continue
                root = root_name(t)
                if root is None or root in COUNTER_ROOTS:
                    continue
                if root == "self" or root not in locals_:
                    where = "self" if root == "self" else f"global `{root}`"
                    flag(node.lineno,
                         f"mutates {where} state in a begin-phase path")
        elif isinstance(node, ast.Call):
            name = dotted(node.func)
            last = name.split(".")[-1] if name else None
            if last in MUTATING_APIS:
                flag(node.lineno,
                     f"calls mutating storage API `{name}` in a "
                     "begin-phase path")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in MUTATING_METHODS):
                root = root_name(node.func.value)
                if root is not None and root not in COUNTER_ROOTS and (
                        root == "self" or root not in locals_):
                    where = "self" if root == "self" else f"`{root}`"
                    flag(node.lineno,
                         f"calls `.{node.func.attr}()` on non-local "
                         f"{where} in a begin-phase path")
    return findings


def run(program: Program) -> list[Finding]:
    roots = [f for f in program.storage_funcs()
             if f.name.endswith("_begin") and f.module.stem in ROOT_MODULES]
    findings: list[Finding] = []
    seen: set[int] = set()
    queue: list[tuple[FuncInfo, str]] = [(f, f.qualname) for f in roots]
    while queue:
        fn, via = queue.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        findings.extend(_check_func(fn, via))
        for call in calls_in(fn.node):
            # a sanctioned receiver's own methods (``_SEEN_SHAPES.add``)
            # are not the storage classes' methods of the same name
            if (isinstance(call.func, ast.Attribute)
                    and root_name(call.func.value) in COUNTER_ROOTS):
                continue
            for callee in program.resolve_call(fn.module, call):
                if id(callee) not in seen:
                    queue.append((callee, via))
    return findings
