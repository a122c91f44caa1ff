"""Pass 5 — cache discipline: the reference's pass over the port's
storage modules (``repro_torch/core``, ``repro_torch/kernels``).

The block cache (``repro_torch.core.cache.BlockCache``) is the one
sanctioned holder of hot decoded chunks, and its accounting is what the SLO
benchmarks and the sanitizer's cache ledger audit.  Two rules keep that
monopoly honest across the storage core:

- ``cache-unbounded`` -- a dict assigned to *persistent* state (an
  attribute or a module-level name) whose name says "cache" but that
  has no eviction path (``pop``/``popitem``/``clear``/``del x[...]``)
  anywhere in its module grows forever; route it through ``BlockCache``
  or give it an eviction policy.  Function locals are exempt: they die
  with the call and cannot leak across requests.
- ``cache-bypass`` -- in the store/scheduler hot paths every bulk
  cluster read must funnel through ``SEARSStore._read_cluster_pieces``
  (where hits have already been peeled off by ``_plan_get``); a direct
  ``.read_pieces``/``.read_pieces_batch`` call anywhere else in those
  modules silently skips hit/miss accounting.  Repair/scrub modules are
  exempt -- their reads are piece-level maintenance, not retrievals.

``# searslint: ignore[cache-bypass] -- reason`` waives a deliberate
side door (e.g. the local-device placeholder rebuild, which peeks the
cache first and charges no retrieval time).
"""

from __future__ import annotations

import ast

from repro_torch.lint.core import Finding, Module, Program, dotted

RULE_UNBOUNDED = "cache-unbounded"
RULE_BYPASS = "cache-bypass"
RULE = RULE_UNBOUNDED  # primary rule name (the pass reports both)

BYPASS_STEMS = {"store", "scheduler"}
READ_APIS = {"read_pieces", "read_pieces_batch"}
SANCTIONED_FUNC = "_read_cluster_pieces"
DICT_MAKERS = {"dict", "OrderedDict", "defaultdict"}
EVICT_METHODS = {"pop", "popitem", "clear"}


def _target_name(node: ast.AST) -> str | None:
    """'entries' for ``self.entries`` / ``entries``; None otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_dict_expr(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.Dict, ast.DictComp)):
        return True
    if isinstance(expr, ast.Call):
        name = dotted(expr.func)
        return name is not None and name.split(".")[-1] in DICT_MAKERS
    return False


def _evicted_names(mod: Module) -> set[str]:
    """Attribute/variable names with some eviction op in this module."""
    out: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in EVICT_METHODS:
            name = _target_name(node.func.value)
            if name:
                out.add(name)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    name = _target_name(tgt.value)
                    if name:
                        out.add(name)
    return out


def _check_unbounded(program: Program, mod: Module,
                     findings: list[Finding]) -> None:
    evicted = _evicted_names(mod)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not _is_dict_expr(value):
            continue
        for tgt in targets:
            name = _target_name(tgt)
            if name is None or "cache" not in name.lower():
                continue
            # persistent state only: attributes always, bare names only
            # at module level (function locals die with the call)
            if isinstance(tgt, ast.Name) and \
                    program.enclosing_func(node) is not None:
                continue
            if name in evicted:
                continue
            findings.append(Finding(
                path=str(mod.path), line=node.lineno, rule=RULE_UNBOUNDED,
                message=f"dict cache `{name}` has no eviction path "
                        "(pop/popitem/clear/del) in this module; it grows "
                        "unboundedly -- use "
                        "repro_torch.core.cache.BlockCache "
                        "or add an eviction policy"))


def _check_bypass(program: Program, mod: Module,
                  findings: list[Finding]) -> None:
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in READ_APIS):
            continue
        fi = program.enclosing_func(node)
        if fi is not None and fi.name == SANCTIONED_FUNC:
            continue
        findings.append(Finding(
            path=str(mod.path), line=node.lineno, rule=RULE_BYPASS,
            message=f"direct `.{node.func.attr}` call bypasses the block "
                    "cache's hit/miss accounting; funnel hot-path cluster "
                    f"reads through `{SANCTIONED_FUNC}`"))


def run(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for mod in program.storage_modules:
        _check_unbounded(program, mod, findings)
        if mod.stem in BYPASS_STEMS:
            _check_bypass(program, mod, findings)
    return findings
