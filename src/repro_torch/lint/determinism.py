"""Pass 4 — plan determinism: the reference's pass over the port's
storage modules (``repro_torch/core``, ``repro_torch/kernels``).

Placement, binding and window demux must be replayable: two runs over
the same trace must produce byte-identical plans, and the pipelined
differential proofs compare exactly that.  Iterating a ``set`` (hash
order) anywhere a plan is built breaks it silently.  This pass flags,
in ``store.py`` / ``scheduler.py`` / ``repair.py`` / ``shard.py``:

- ``for``/comprehension iteration over set literals, set
  comprehensions, ``set()``/``frozenset()`` calls, set-typed locals, or
  set algebra results;
- iteration over known set-returning storage APIs
  (``ChunkIndex.cluster_chunks``);
- iteration over shard-membership attributes (``.shards`` and its
  ``.keys()/.values()/.items()`` views): ``ShardMap.shards`` insertion
  order reflects add/drain history, not shard id order, so any
  ownership or window-demux decision built from it is non-replayable —
  route through ``live_ids()`` or wrap in ``sorted(...)``;

``sorted(...)`` around the source is the sanctioned fix (membership
tests are fine and not flagged).
"""

from __future__ import annotations

import ast

from repro_torch.lint.core import Finding, Module, Program, dotted

RULE = "plan-determinism"

STEMS = {"store", "scheduler", "repair", "shard"}
SET_BUILTINS = {"set", "frozenset"}
SET_APIS = {"cluster_chunks"}
SET_ATTRS = {"shards"}  # membership maps: insertion order != shard id order
PASSTHROUGH = {"list", "tuple", "iter", "reversed"}  # preserve (dis)order
SET_OPS = (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)


def _set_locals(fn: ast.AST) -> set[str]:
    """Names assigned (transitively) from set-producing expressions."""
    names: set[str] = set()
    for _ in range(8):  # small fixpoint: chains are short
        before = len(names)
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                if _is_setish(node.value, names):
                    names.add(node.targets[0].id)
            elif (isinstance(node, ast.AugAssign)
                  and isinstance(node.target, ast.Name)
                  and isinstance(node.op, SET_OPS)
                  and _is_setish(node.value, names)):
                names.add(node.target.id)
        if len(names) == before:
            break
    return names


def _is_setish(expr: ast.AST, set_names: set[str]) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in set_names
    if isinstance(expr, ast.Attribute):
        return expr.attr in SET_ATTRS
    if isinstance(expr, ast.Call):
        name = dotted(expr.func)
        if name is None:
            return False
        parts = name.split(".")
        last = parts[-1]
        if last in SET_BUILTINS or last in SET_APIS:
            return True
        if (last in {"keys", "values", "items"} and len(parts) >= 2
                and parts[-2] in SET_ATTRS):
            return True
        if last in PASSTHROUGH and expr.args:
            return _is_setish(expr.args[0], set_names)
        return False
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, SET_OPS):
        return (_is_setish(expr.left, set_names)
                or _is_setish(expr.right, set_names))
    return False


def _sorted_wrapped(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        name = dotted(expr.func)
        last = name.split(".")[-1] if name else None
        if last == "sorted":
            return True
        if last in PASSTHROUGH and expr.args:
            return _sorted_wrapped(expr.args[0])
    return False


def _describe(expr: ast.AST) -> str:
    name = dotted(expr if not isinstance(expr, ast.Call) else expr.func)
    return f"`{name}`" if name else "a set expression"


def _check_scope(mod: Module, fn: ast.AST,
                 findings: list[Finding]) -> None:
    set_names = _set_locals(fn)
    for node in ast.walk(fn):
        iters: list[ast.AST] = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters.extend(gen.iter for gen in node.generators)
        for it in iters:
            if _sorted_wrapped(it):
                continue
            if _is_setish(it, set_names):
                findings.append(Finding(
                    path=str(mod.path), line=it.lineno, rule=RULE,
                    message=f"iteration over unordered {_describe(it)} "
                            "feeds plan/placement order; wrap the source "
                            "in sorted(...)"))


def run(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for mod in program.storage_modules:
        if mod.stem not in STEMS:
            continue
        scopes: list[ast.AST] = [mod.tree]
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node)
        seen_lines: set[tuple[int, str]] = set()
        for scope in scopes:
            if isinstance(scope, ast.Module):
                continue  # function scopes carry the local type info
            _check_scope(mod, scope, findings)
        # dedupe (nested defs are walked from both enclosing scopes)
        unique: list[Finding] = []
        for f in findings:
            key = (f.line, f.path)
            if f.path == str(mod.path) and key in seen_lines:
                continue
            seen_lines.add(key)
            unique.append(f)
        findings = unique
    return findings
