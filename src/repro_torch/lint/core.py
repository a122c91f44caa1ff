"""searslint core for the port: module loading, findings, waivers,
call-graph utilities.

The five passes (begin-purity, dispatch hygiene, counter coverage, plan
determinism, cache discipline) share one cross-module view of the tree
built here:

- ``Module``: one parsed source file with its waiver comments.
- ``FuncInfo``: one top-level function or one-level class method, with
  its memo marker (``functools.lru_cache`` / ``functools.cache``) and
  whether it launches a kernel.
- ``Program``: the loaded module set plus name-resolution indexes.

A copy of the JAX reference's ``repro/lint/core.py`` in the port's
idiom.  Three things differ:

- **Storage scope.** A module is storage when a path part is
  ``repro_torch`` and its directory is ``core`` or ``kernels``; passes
  that reason about the data plane look only at those modules, even
  when tests are also on the command line.
- **Resolution stays inside a package.** Storage modules are indexed by
  (package, stem), and a dotted call resolves through the package its
  importing module names (or its own), so a run over a tree that holds
  both packages never resolves the port's ``ops.rs_apply`` into the
  reference's ``ops.py``.
- **Launch roots.** The port launches a kernel by calling a symbol of
  the ``ctypes`` library that ``_build.library()`` loads:
  ``_build.library().<symbol>(...)`` or ``getattr(_build.library(),
  name)(...)``.  Those calls take the place of ``pallas_call``.  There
  is no jit marker: PyTorch traces nothing.

Waivers: ``# searslint: ignore[rule]`` (comma-separated rules) on the
finding's line or the line directly above suppresses it; the comment
must carry a reason after the bracket or it is itself reported as a
``bad-waiver`` finding.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

WAIVER_RE = re.compile(r"#\s*searslint:\s*ignore\[([a-zA-Z0-9_,\- ]+)\]\s*(.*)")

MEMO_NAMES = {"functools.lru_cache", "lru_cache", "functools.cache", "cache"}

STORAGE_PACKAGE = "repro_torch"
STORAGE_DIRS = ("core", "kernels")

# the module that builds and loads the kernel library, and its loader
BUILD_STEM = "_build"
LIBRARY_FUNC = "library"
# library symbols that launch nothing
NON_LAUNCH_SYMBOLS = {"sears_error_string"}


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str
    waived: bool = False

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Module:
    path: pathlib.Path
    stem: str
    tree: ast.Module
    lines: list[str]
    waivers: dict[int, set[str]]          # 1-based line -> waived rules
    bad_waiver_lines: list[int]           # waivers missing a reason
    # local alias -> (package or None for a relative import, module stem)
    imports: dict[str, tuple[str | None, str]]

    @property
    def package(self) -> str:
        """The package directory above the module's own directory
        (``repro_torch`` for ``src/repro_torch/core/engine.py``)."""
        return self.path.parent.parent.name

    @property
    def is_storage(self) -> bool:
        return (STORAGE_PACKAGE in self.path.parts
                and self.path.parent.name in STORAGE_DIRS)


@dataclasses.dataclass
class FuncInfo:
    module: Module
    name: str
    qualname: str
    node: ast.AST                         # FunctionDef / AsyncFunctionDef
    cls: str | None = None
    memoized: bool = False                # lru_cache'd (builds once)
    launches: bool = False                # calls a kernel library symbol


def dotted(node: ast.AST) -> str | None:
    """'torch.compile' for Attribute chains, 'f' for Names, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> str | None:
    """Base Name of an Attribute/Subscript/Call chain ('self.x[i]' -> 'self')."""
    while True:
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def local_names(fn: ast.AST) -> set[str]:
    """Names bound inside a function: params, assignments, loop/with/
    comprehension targets, walrus bindings, and nested lambda/def params."""
    out: set[str] = set()

    def add_args(a: ast.arguments) -> None:
        for grp in (a.posonlyargs, a.args, a.kwonlyargs):
            for arg in grp:
                out.add(arg.arg)
        if a.vararg:
            out.add(a.vararg.arg)
        if a.kwarg:
            out.add(a.kwarg.arg)

    def add_target(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                add_target(el)
        elif isinstance(t, ast.Starred):
            add_target(t.value)

    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            add_args(node.args)
            if not isinstance(node, ast.Lambda):
                out.add(getattr(node, "name", ""))
        elif isinstance(node, (ast.Assign, ast.For, ast.AsyncFor)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                add_target(t)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            add_target(node.target)
        elif isinstance(node, ast.NamedExpr):
            add_target(node.target)
        elif isinstance(node, ast.comprehension):
            add_target(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            add_target(node.optional_vars)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
    return out


def is_memo_decorated(node: ast.AST) -> bool:
    for dec in getattr(node, "decorator_list", []):
        if dotted(dec) in MEMO_NAMES:
            return True
        if isinstance(dec, ast.Call) and dotted(dec.func) in MEMO_NAMES:
            return True
    return False


def is_library_call(node: ast.AST, mod: Module) -> bool:
    """True for ``_build.library()`` (bare ``library()`` inside
    ``_build`` itself)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    if name == LIBRARY_FUNC:
        return mod.stem == BUILD_STEM
    if name and name.count(".") == 1:
        alias, attr = name.split(".")
        stem = mod.imports.get(alias, (None, alias))[1]
        return attr == LIBRARY_FUNC and stem == BUILD_STEM
    return False


def launch_symbol(call: ast.Call, mod: Module) -> str | None:
    """The library symbol a call launches -- ``_build.library().<sym>(...)``
    or ``getattr(_build.library(), name)(...)`` -- else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and is_library_call(f.value, mod):
        return None if f.attr in NON_LAUNCH_SYMBOLS else f.attr
    if (isinstance(f, ast.Call) and dotted(f.func) == "getattr"
            and len(f.args) >= 2 and is_library_call(f.args[0], mod)):
        sym = f.args[1]
        if isinstance(sym, ast.Constant) and isinstance(sym.value, str):
            return None if sym.value in NON_LAUNCH_SYMBOLS else sym.value
        return "<getattr>"
    return None


def launch_calls(fn: ast.AST, mod: Module) -> list[ast.Call]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and launch_symbol(n, mod) is not None]


def counter_increments(fn: ast.AST, family: str) -> list[ast.AugAssign]:
    """``<family>.<kind> += n`` and ``<family>[<kind>] += n`` statements
    in the body (family is the root name: 'LAUNCHES', 'TRACES',
    'KERNELS')."""
    return [node for node in ast.walk(fn)
            if isinstance(node, ast.AugAssign)
            and isinstance(node.target, (ast.Attribute, ast.Subscript))
            and root_name(node.target) == family]


def calls_in(fn: ast.AST) -> list[ast.Call]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)]


def _parse_waivers(lines: list[str]) -> tuple[dict[int, set[str]], list[int]]:
    waivers: dict[int, set[str]] = {}
    bad: list[int] = []
    for i, ln in enumerate(lines, start=1):
        m = WAIVER_RE.search(ln)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = m.group(2).strip().lstrip("-— ").strip()
        if not reason:
            bad.append(i)
        waivers[i] = rules
    return waivers, bad


def _collect_imports(tree: ast.Module) -> dict[str, tuple[str | None, str]]:
    """alias -> (package, module stem), from Import/ImportFrom anywhere in
    the file; the package is None for a relative import."""
    out: dict[str, tuple[str | None, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                if alias.asname:
                    out[alias.asname] = (parts[0], parts[-1])
                else:
                    out[parts[0]] = (parts[0], parts[0])
        elif isinstance(node, ast.ImportFrom):
            pkg = (node.module.split(".")[0]
                   if node.module and not node.level else None)
            for alias in node.names:
                out[alias.asname or alias.name] = (pkg, alias.name)
    return out


def module_from_source(source: str, path: str | pathlib.Path) -> Module:
    path = pathlib.Path(path)
    tree = ast.parse(source, filename=str(path))
    lines = source.splitlines()
    waivers, bad = _parse_waivers(lines)
    return Module(path=path, stem=path.stem, tree=tree, lines=lines,
                  waivers=waivers, bad_waiver_lines=bad,
                  imports=_collect_imports(tree))


def load_paths(paths: list[str | pathlib.Path]) -> list[Module]:
    files: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    mods = []
    seen: set[pathlib.Path] = set()
    for f in files:
        if f in seen:
            continue
        seen.add(f)
        mods.append(module_from_source(f.read_text(), f))
    return mods


class Program:
    """Cross-module index over a loaded module set."""

    def __init__(self, modules: list[Module]):
        self.modules = modules
        self.by_path = {str(m.path): m for m in modules}
        self.storage_modules = [m for m in modules if m.is_storage]
        self.module_by_key: dict[tuple[str, str], Module] = {}
        for m in self.storage_modules:
            self.module_by_key.setdefault((m.package, m.stem), m)

        self.funcs: list[FuncInfo] = []
        self._by_module: dict[int, dict[str, list[FuncInfo]]] = {}
        self._by_name: dict[str, list[FuncInfo]] = {}

        for mod in modules:
            table: dict[str, list[FuncInfo]] = {}
            self._by_module[id(mod)] = table
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._add_func(mod, node, None, table)
                elif isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            self._add_func(mod, sub, node.name, table)
        # the passes ask for the enclosing function of storage nodes only
        self.node_owner: dict[int, FuncInfo] = {}
        for fi in self.storage_funcs():
            for sub in ast.walk(fi.node):
                self.node_owner.setdefault(id(sub), fi)

    def _add_func(self, mod: Module, node: ast.AST, cls: str | None,
                  table: dict[str, list[FuncInfo]]) -> None:
        fi = FuncInfo(module=mod, name=node.name, cls=cls,
                      qualname=f"{cls}.{node.name}" if cls else node.name,
                      node=node, memoized=is_memo_decorated(node),
                      launches=bool(launch_calls(node, mod)))
        self.funcs.append(fi)
        table.setdefault(node.name, []).append(fi)
        if mod.is_storage:
            self._by_name.setdefault(node.name, []).append(fi)

    def module_named(self, mod: Module, alias: str) -> Module | None:
        """The storage module that ``alias`` names in ``mod``: through its
        import's package, else ``mod``'s own package."""
        pkg, stem = mod.imports.get(alias, (None, alias))
        return self.module_by_key.get((pkg or mod.package, stem))

    def resolve_name(self, mod: Module, name: str | None) -> FuncInfo | None:
        """Resolve 'f' / 'modalias.f' to a single FuncInfo, else None."""
        if not name:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            hits = self._by_module[id(mod)].get(parts[0], [])
            top = [f for f in hits if f.cls is None]
            return top[0] if top else None
        if len(parts) == 2:
            other = self.module_named(mod, parts[0])
            if other is not None:
                hits = self._by_module[id(other)].get(parts[1], [])
                top = [f for f in hits if f.cls is None]
                return top[0] if top else None
        return None

    def functions_in(self, mod: Module) -> list[FuncInfo]:
        return [f for fs in self._by_module[id(mod)].values() for f in fs]

    def storage_funcs(self) -> list[FuncInfo]:
        return [f for f in self.funcs if f.module.is_storage]

    def resolve_call(self, mod: Module, call: ast.Call) -> list[FuncInfo]:
        """Resolve a call site to candidate FuncInfos within the storage
        module set.  'self.f'/'cls.f' and unknown receivers resolve by
        bare method name across all storage classes (over-approximation
        suited to invariant checking)."""
        name = dotted(call.func)
        if not name:
            return []
        parts = name.split(".")
        direct = self.resolve_name(mod, name)
        if direct is not None:
            return [direct]
        if len(parts) == 1:
            return []
        # receiver is an object (self.engine.f, cluster.f, ...):
        # match any storage-class method with that name
        return [f for f in self._by_name.get(parts[-1], []) if f.cls]

    def enclosing_func(self, node: ast.AST) -> FuncInfo | None:
        return self.node_owner.get(id(node))


def waiver_findings(program: Program, findings: list[Finding]) -> list[Finding]:
    """Mark waived findings in place; return bad-waiver findings."""
    for f in findings:
        mod = program.by_path.get(f.path)
        if mod is None:
            continue
        for line in (f.line, f.line - 1):
            if f.rule in mod.waivers.get(line, set()):
                f.waived = True
                break
    out = []
    for mod in program.modules:
        for line in mod.bad_waiver_lines:
            out.append(Finding(
                path=str(mod.path), line=line, rule="bad-waiver",
                message="searslint waiver has no reason; write "
                        "'# searslint: ignore[rule] -- why it is safe'"))
    return out
