"""Pass 2 — dispatch hygiene, in the port's idiom.

The reference's rules keep a traced callable from being rebuilt per
call and keep host syncs out of the phases that exist to overlap with
host work.  The port builds no traced callable: it builds and loads one
kernel library (``_build.library()``, ``lru_cache``d), so its rules are:

- ``dispatch-jit-scope``: a build or load -- ``ctypes.CDLL``,
  ``_build.build``, ``torch.utils.cpp_extension.load`` /
  ``load_inline``, ``torch.compile``, or ``_build.library()`` where
  ``library`` is not memoized -- in a function that is not memoized
  builds (or loads) the kernels per call.  Build once, under
  ``lru_cache``.
- ``dispatch-jit-loop``: the same calls inside a loop, once per
  iteration.
- ``dispatch-const-asarray``: ``torch.as_tensor`` / ``torch.tensor`` of
  an ALL_CAPS module constant, or ``torch.from_numpy(CONST).to(dev)``,
  in a function body copies the constant to the device per call;
  memoize the device copy (an ``lru_cache``d helper such as
  ``gf_matmul._device_matrix``) or hoist it to module scope.  Exempt
  when the enclosing function is memoized.
- ``dispatch-host-sync``: in data-plane hot paths (``*_begin`` /
  ``*_issue`` functions), ``.item()`` / ``.cpu()`` / ``.numpy()`` /
  ``.tolist()`` / ``torch.cuda.synchronize()`` / ``ops.words_to_host``
  -- and ``np.asarray`` / ``float()`` applied to values a device
  producer returned -- wait for the device in the phase that exists to
  overlap with host work.
"""

from __future__ import annotations

import ast
import re

from repro_torch.lint.core import (BUILD_STEM, Finding, Module, Program,
                                   dotted, is_library_call,
                                   is_memo_decorated)

SCOPE_RULE = "dispatch-jit-scope"
LOOP_RULE = "dispatch-jit-loop"
CONST_RULE = "dispatch-const-asarray"
SYNC_RULE = "dispatch-host-sync"

# calls that compile or load kernels
BUILD_CALLS = {"ctypes.CDLL", "CDLL", "torch.compile",
               "torch.utils.cpp_extension.load",
               "torch.utils.cpp_extension.load_inline",
               "cpp_extension.load", "cpp_extension.load_inline"}
BUILD_FUNC = "build"  # _build.build

TORCH_UPLOAD = {"torch.as_tensor", "torch.tensor"}
FROM_NUMPY = {"torch.from_numpy"}
TO_DEVICE_ATTRS = {"to", "cuda"}
NP_HOST = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
           "float", "int"}
SYNC_ATTRS = {"item", "cpu", "numpy", "tolist"}
SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
HOST_COPY_FUNCS = {"words_to_host"}
HOT_SUFFIXES = ("_begin", "_issue")

# functions whose return values live on the device: materializing them on
# the host inside a begin/issue phase is a forced sync
DEVICE_PRODUCERS = {
    "rs_apply", "gear_hash", "gear_fire", "gear_fire_issue",
    "sha1_digest_words", "gf_matmul", "fused_hash_encode_blobs",
    "flash_attention", "fused_ingest",
}

CONST_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _const_base_name(expr: ast.AST) -> str | None:
    """Final ALL_CAPS segment of e.g. ``hashing.SHA1_H0.astype(...)``."""
    while isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        expr = expr.func.value  # unwrap method chains (.astype/.reshape/...)
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    else:
        return None
    return name if CONST_RE.match(name) and len(name) > 1 else None


def _producer_map(fn: ast.AST) -> dict[str, str]:
    """var -> last segment of the callee it was assigned from."""
    out: dict[str, str] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            callee = dotted(node.value.func)
            if callee:
                out[node.targets[0].id] = callee.split(".")[-1]
    return out


class _Visitor(ast.NodeVisitor):
    def __init__(self, program: Program, mod: Module,
                 findings: list[Finding]):
        self.program = program
        self.mod = mod
        self.findings = findings
        self.func_stack: list[ast.AST] = []
        self.producer_stack: list[dict[str, str]] = []
        self.parents: dict[int, ast.AST] = {
            id(child): node for node in ast.walk(mod.tree)
            for child in ast.iter_child_nodes(node)}
        self.loop_depth = 0

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(path=str(self.mod.path),
                                     line=node.lineno, rule=rule,
                                     message=msg))

    # -- scope tracking -------------------------------------------------
    def _visit_func(self, node: ast.AST) -> None:
        self.func_stack.append(node)
        self.producer_stack.append(_producer_map(node))
        outer_depth, self.loop_depth = self.loop_depth, 0
        for child in ast.iter_child_nodes(node):
            if any(child is dec for dec in node.decorator_list):
                continue
            self.visit(child)
        self.loop_depth = outer_depth
        self.producer_stack.pop()
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _visit_loop(self, node: ast.AST) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    # -- the rules ------------------------------------------------------
    def _in_hot_func(self) -> bool:
        return any(getattr(f, "name", "").endswith(HOT_SUFFIXES)
                   for f in self.func_stack)

    def _in_memo(self) -> bool:
        """A build under an lru_cache'd function happens once per key."""
        return any(is_memo_decorated(f) for f in self.func_stack)

    def _build_call(self, node: ast.Call) -> str | None:
        """The name of a build or load this call makes, else None."""
        name = dotted(node.func)
        if name in BUILD_CALLS:
            return name
        if is_library_call(node, self.mod):
            lib = self.program.resolve_name(self.mod, name)
            # an unmemoized loader loads the library per call
            return name if lib is not None and not lib.memoized else None
        if name and name.split(".")[-1] == BUILD_FUNC:
            fi = self.program.resolve_name(self.mod, name)
            if fi is not None and fi.module.stem == BUILD_STEM:
                return name
        return None

    def _to_device(self, call: ast.Call) -> bool:
        """True if ``call``'s result is moved to a device right away:
        ``call.to(...)`` / ``call.cuda()``."""
        parent = self.parents.get(id(call))
        return (isinstance(parent, ast.Attribute)
                and parent.attr in TO_DEVICE_ATTRS
                and isinstance(self.parents.get(id(parent)), ast.Call))

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        built = self._build_call(node)
        if built is not None and self.func_stack and not self._in_memo():
            if self.loop_depth:
                self._flag(node, LOOP_RULE,
                           f"`{built}(...)` inside a loop builds or loads "
                           "the kernels every iteration; memoize it")
            else:
                self._flag(node, SCOPE_RULE,
                           f"`{built}(...)` in a function that is not "
                           "memoized builds or loads the kernels per "
                           "call; put it under lru_cache")
        elif (self.func_stack and node.args
              and (name in TORCH_UPLOAD
                   or (name in FROM_NUMPY and self._to_device(node)))):
            const = _const_base_name(node.args[0])
            if const is not None and not self._in_memo():
                self._flag(node, CONST_RULE,
                           f"`{name}({const}...)` copies a module constant "
                           "to the device per call; memoize the device "
                           "copy (lru_cache) or hoist to module scope")
        if self._in_hot_func():
            last = name.split(".")[-1] if name else None
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in SYNC_ATTRS and not node.args):
                self._flag(node, SYNC_RULE,
                           f"`.{node.func.attr}()` waits for the device "
                           "inside a begin/issue hot path")
            elif name in SYNC_CALLS or last in HOST_COPY_FUNCS:
                self._flag(node, SYNC_RULE,
                           f"`{name}(...)` waits for the device inside a "
                           "begin/issue hot path")
            elif (name in NP_HOST and node.args
                  and isinstance(node.args[0], ast.Name)):
                producers = self.producer_stack[-1] if self.producer_stack else {}
                src = producers.get(node.args[0].id)
                if src in DEVICE_PRODUCERS:
                    self._flag(node, SYNC_RULE,
                               f"`{name}({node.args[0].id})` materializes "
                               f"the device result of `{src}` inside a "
                               "begin/issue hot path")
        self.generic_visit(node)


def run(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for mod in program.storage_modules:
        _Visitor(program, mod, findings).visit(mod.tree)
    return findings
