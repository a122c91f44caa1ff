"""The port's searslint (``repro_torch.lint``): each rule catches its
seeded fault in a torch-idiom fixture (the twins of ``test_lint.py``'s
cases), the port's tree is clean, and seeded faults in copies of real
port files are caught, so the clean verdict is not vacuous.  Source is
parsed only; nothing is imported or run."""

import ast
import pathlib

import pytest

from repro_torch.lint import run_paths, run_program
from repro_torch.lint.core import Program, load_paths, module_from_source

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def lint_sources(sources: dict[str, str]):
    """Run the full pass suite over {virtual_path: source} fixtures."""
    prog = Program([module_from_source(src, path)
                    for path, src in sources.items()])
    return run_program(prog)


def live(findings, rule=None):
    return [f for f in findings if not f.waived
            and (rule is None or f.rule == rule)]


@pytest.fixture(scope="module")
def src_modules():
    """Every module under ``src`` (both packages), parsed once."""
    return load_paths([ROOT / "src"])


def port_only(mods):
    return [m for m in mods if PORT in m.path.parents]


def edited(mods, rel: str, old: str, new: str):
    """``mods`` with one real port file edited in memory."""
    out = []
    for m in mods:
        if m.path == PORT / rel:
            src = "\n".join(m.lines) + "\n"
            assert old in src, f"{rel} no longer holds {old!r}"
            m = module_from_source(src.replace(old, new, 1), m.path)
        out.append(m)
    return out


# ------------------------------------------------------- begin purity ----

def test_begin_purity_catches_attribute_mutation():
    findings = lint_sources({"src/repro_torch/core/engine.py": """
class TorchEngine:
    def chunk_blobs_multi_begin(self, jobs):
        self.last = jobs
        return jobs
"""})
    assert len(live(findings, "begin-purity")) == 1


def test_begin_purity_follows_call_graph_to_mutating_helper():
    findings = lint_sources({"src/repro_torch/core/engine.py": """
class TorchEngine:
    def _stash(self, jobs):
        self.table.append(jobs)

    def decode_blobs_multi_begin(self, jobs):
        self._stash(jobs)
        return jobs
"""})
    hits = live(findings, "begin-purity")
    assert hits and "_stash" in hits[0].message


def test_begin_purity_catches_mutating_api_across_modules():
    findings = lint_sources({
        "src/repro_torch/core/rs_code.py": """
from repro_torch.core import helpers

def batch_decode_blobs_begin(code, jobs, apply):
    helpers.record(jobs)
    return [apply(j) for j in jobs]
""",
        "src/repro_torch/core/helpers.py": """
DEVICE_COPIES = {}

def record(jobs):
    DEVICE_COPIES['last'] = jobs
"""})
    hits = live(findings, "begin-purity")
    assert hits and "DEVICE_COPIES" in hits[0].message


def test_begin_purity_allows_locals_and_counters():
    findings = lint_sources({"src/repro_torch/kernels/ops.py": """
import torch
from repro_torch.kernels import gear_cdc
from repro_torch.kernels.launches import KERNELS, LAUNCHES, TRACES

def chunk_blobs_begin(jobs, device):
    LAUNCHES.gear += 1
    TRACES.gear += 1
    KERNELS["gear_fire"] += 1
    groups = {}
    out = []
    for j in jobs:
        groups.setdefault(len(j), []).append(j)
        out.append(torch.from_numpy(j).to(device))
    return out
"""})
    assert not live(findings, "begin-purity")


def test_begin_purity_exempts_the_launch_shape_memo():
    """``_SEEN_SHAPES`` (filled by ``_new_shape``) stands in for the jit
    cache: a begin reaching it is pure; any other module set is not."""
    src = """
from repro_torch.kernels import gear_cdc
from repro_torch.kernels.launches import LAUNCHES, TRACES

{memo}: set = set()

def _new_shape(key):
    if key in {memo}:
        return False
    {memo}.add(key)
    return True

def gear_fire_issue(stream, mask, device):
    LAUNCHES.gear += 1
    if _new_shape(("gear", "fire", device.type, stream.shape[0])):
        TRACES.gear += 1
    return gear_cdc.gear_fire(stream, mask)

def chunk_window_begin(stream, mask, device):
    return gear_fire_issue(stream, mask, device)
"""
    exempt = {"src/repro_torch/kernels/ops.py": src.format(memo="_SEEN_SHAPES")}
    assert not live(lint_sources(exempt), "begin-purity")
    other = {"src/repro_torch/kernels/ops.py": src.format(memo="_SHAPES")}
    hits = live(lint_sources(other), "begin-purity")
    assert len(hits) == 1 and "_SHAPES" in hits[0].message


# --------------------------------------------------- dispatch hygiene ----

def test_dispatch_catches_library_load_in_loop():
    findings = lint_sources({"src/repro_torch/kernels/ops.py": """
import ctypes

def run(paths, x):
    outs = []
    for p in paths:
        outs.append(ctypes.CDLL(p).sears_gear(x))
    return outs
"""})
    assert len(live(findings, "dispatch-jit-loop")) == 1


@pytest.mark.parametrize("body", [
    "return torch.compile(helper)",
    "return ctypes.CDLL('libsears_kernels.so')",
    "return cpp_extension.load(name='k', sources=['k.cu'])",
])
def test_dispatch_catches_function_scope_build(body):
    findings = lint_sources({"src/repro_torch/kernels/ops.py": f"""
import ctypes
import torch
from torch.utils import cpp_extension

def helper(x):
    return x

def make():
    {body}
"""})
    assert len(live(findings, "dispatch-jit-scope")) == 1


def test_dispatch_memoized_or_module_scope_build_is_fine():
    findings = lint_sources({
        "src/repro_torch/kernels/_build.py": """
import ctypes
import functools

LIB0 = ctypes.CDLL("libc.so.6")

def build(out_dir):
    return out_dir

@functools.lru_cache(maxsize=1)
def library():
    build("out")
    return ctypes.CDLL("libsears_kernels.so")

def check(err, name):
    if err:
        raise RuntimeError(library().sears_error_string(err))
""",
        "src/repro_torch/kernels/sha1.py": """
from repro_torch.kernels import _build

def launch(x):
    for _ in range(2):
        _build.check(_build.library().sears_sha1(x), "sha1")
"""})
    assert not live(findings, "dispatch-jit-scope")
    assert not live(findings, "dispatch-jit-loop")


def test_dispatch_catches_unmemoized_loader():
    """``_build.library()`` loads per call once ``library`` loses its
    ``lru_cache``: every call site and the load inside it fire."""
    findings = lint_sources({
        "src/repro_torch/kernels/_build.py": """
import ctypes

def library():
    return ctypes.CDLL("libsears_kernels.so")
""",
        "src/repro_torch/kernels/sha1.py": """
from repro_torch.kernels import _build

def launch(x):
    return _build.library().sears_sha1(x)
"""})
    hits = live(findings, "dispatch-jit-scope")
    assert sorted(pathlib.Path(f.path).stem for f in hits) == [
        "_build", "sha1"]


def test_dispatch_catches_unmemoized_constant_upload():
    bad = {"src/repro_torch/kernels/ops.py": """
import torch

TABLE = [1, 2, 3]

def hot(x, dev):
    t = torch.as_tensor(TABLE, device=dev)
    u = torch.from_numpy(TABLE).to(dev)
    return t, u
"""}
    assert len(live(lint_sources(bad), "dispatch-const-asarray")) == 2
    memoized = {"src/repro_torch/kernels/ops.py": """
import functools
import torch

TABLE = [1, 2, 3]

@functools.lru_cache(maxsize=None)
def device_table(dev):
    return torch.from_numpy(TABLE).to(dev)

def host_view():
    return torch.from_numpy(TABLE)   # stays on the host: no upload
"""}
    assert not live(lint_sources(memoized), "dispatch-const-asarray")


def test_dispatch_catches_host_sync_in_begin_path():
    findings = lint_sources({"src/repro_torch/kernels/ops.py": """
import numpy as np
import torch

def words_to_host(words):
    return words.cpu().numpy()

def gear_fire_issue(data):
    return data

def chunk_window_begin(data):
    fire = gear_fire_issue(data)
    torch.cuda.synchronize()
    n = fire.sum().item()
    w = words_to_host(fire)
    return np.asarray(fire), n, w
"""})
    assert len(live(findings, "dispatch-host-sync")) == 4


# --------------------------------------------------- counter coverage ----

_WRAPPER = '''
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.launches import KERNELS

def launch(x, out):
    err = _build.library().sears_gf_matmul(x.data_ptr(), out.data_ptr())
    _build.check(err, "gf_matmul")
    KERNELS["gf_matmul"] += 1

def gf_matmul(M, x):
    out = torch.empty_like(x)
    launch(x, out)
    return out
'''


def test_counters_catch_uncounted_launch_site():
    findings = lint_sources({
        "src/repro_torch/kernels/gf_matmul.py": _WRAPPER,
        "src/repro_torch/kernels/ops.py": """
from repro_torch.kernels import gf_matmul

def rs_apply(M, x):
    return gf_matmul.gf_matmul(M, x)
"""})
    hits = live(findings, "counter-launch")
    assert hits and "rs_apply" in hits[0].message


def test_counters_accept_counted_call_sites():
    findings = lint_sources({
        "src/repro_torch/kernels/gf_matmul.py": _WRAPPER,
        "src/repro_torch/kernels/ops.py": """
from repro_torch.kernels import gf_matmul
from repro_torch.kernels.launches import LAUNCHES, TRACES

_SEEN_SHAPES: set = set()

def _new_shape(key):
    if key in _SEEN_SHAPES:
        return False
    _SEEN_SHAPES.add(key)
    return True

def rs_apply(M, x):
    LAUNCHES.gf += 1
    if _new_shape(("gf", x.device.type, M.shape, tuple(x.shape))):
        TRACES.gf += 1
    return gf_matmul.gf_matmul(M, x)

def rs_encode(M, x):
    return rs_apply(M, x)
"""})
    assert not live(findings)


def test_counters_exempt_the_model_kernel_by_rule():
    """A dispatch that reaches only the model's kernel (``flash_attn``)
    is counted by KERNELS alone; one that reaches a storage kernel is
    not exempt."""
    flash = """
from repro_torch.kernels import _build
from repro_torch.kernels.launches import KERNELS

def dispatch(q, out, name, counter):
    err = getattr(_build.library(), name)(q.data_ptr(), out.data_ptr())
    _build.check(err, name)
    KERNELS[counter] += 1

def flash_attention(q):
    out = q.clone()
    dispatch(q, out, "sears_flash_attn_bf16", "flash_attn")
    return out
"""
    ops = """
from repro_torch.kernels import flash_attn, gf_matmul

def flash_attention(q):
    return flash_attn.flash_attention(q)

def rs_apply(M, x):
    return gf_matmul.gf_matmul(M, x)
"""
    findings = lint_sources({"src/repro_torch/kernels/flash_attn.py": flash,
                             "src/repro_torch/kernels/gf_matmul.py": _WRAPPER,
                             "src/repro_torch/kernels/ops.py": ops})
    hits = live(findings, "counter-launch")
    assert [h.message.split("`")[1] for h in hits] == ["rs_apply"]
    assert not live(findings, "counter-kernel")


@pytest.mark.parametrize("trace", [
    "",                                   # no TRACES tick at all
    "    TRACES.gf += 1\n",               # not under _new_shape
    "    if _new_shape(key):\n        TRACES.sha1 += 1\n",  # another kind
])
def test_counters_catch_launch_without_shape_trace(trace):
    findings = lint_sources({"src/repro_torch/kernels/ops.py": f"""
from repro_torch.kernels import gf_matmul
from repro_torch.kernels.launches import LAUNCHES, TRACES

def _new_shape(key):
    return True

def rs_apply(M, x):
    key = ("gf", M.shape)
    LAUNCHES.gf += 1
{trace}    return gf_matmul.gf_matmul(M, x)
"""})
    hits = live(findings, "counter-trace")
    assert len(hits) == 1 and "LAUNCHES.gf" in hits[0].message


def test_counters_catch_single_family_reset():
    findings = lint_sources({"benchmarks/foo_bench.py": """
from repro_torch.kernels.launches import LAUNCHES

LAUNCHES.reset()
"""})
    hits = live(findings, "counter-family-reset")
    assert hits and "reset_all" in hits[0].message


@pytest.mark.parametrize("body,count", [
    # the tick is missing
    ('    _build.check(err, "sha1")\n', 1),
    # the tick comes before the check: a failed launch would count
    ('    KERNELS["sha1"] += 1\n    _build.check(err, "sha1")\n', 1),
    # the tick after the check: clean
    ('    _build.check(err, "sha1")\n    KERNELS["sha1"] += 1\n', 0),
])
def test_counters_kernel_tick_after_check(body, count):
    findings = lint_sources({"src/repro_torch/kernels/sha1.py": f"""
from repro_torch.kernels import _build
from repro_torch.kernels.launches import KERNELS

def launch(blocks, out):
    err = _build.library().sears_sha1(blocks.data_ptr(), out.data_ptr())
{body}"""})
    assert len(live(findings, "counter-kernel")) == count


def test_counters_kernel_tick_only_where_it_launches():
    """The plain (CPU) path must not count as a kernel launch."""
    findings = lint_sources({"src/repro_torch/kernels/sha1.py": """
from repro_torch.kernels import ref
from repro_torch.kernels.launches import KERNELS

def sha1_digest_words(blocks, counts):
    KERNELS["sha1"] += 1
    return ref.sha1_ref(blocks, counts)
"""})
    hits = live(findings, "counter-kernel")
    assert len(hits) == 1 and "launches no kernel" in hits[0].message


# -------------------------------------------------- plan determinism ----

@pytest.mark.parametrize("path,src,count", [
    # set iteration in placement
    ("core/store.py", """
def place(self, cluster_ids):
    for cl in set(cluster_ids):
        self.assign(cl)
""", 1),
    # a set-returning storage API and a set local
    ("core/repair.py", """
def scan(self, cluster_id):
    out = []
    pool = {1, 2, 3}
    for cid in self.store.index.cluster_chunks(cluster_id):
        out.append(cid)
    for cl in pool:
        out.append(cl)
    return out
""", 2),
    # shard membership, plain and through a dict view
    ("core/shard.py", """
def route(self):
    for sid in self.shard_map.shards:
        self.touch(sid)
    out = [sh for sh in self.shard_map.shards.values()]
    return out
""", 2),
    # sorted shard iteration and membership tests are clean
    ("core/store.py", """
def route(self):
    for sid in sorted(self.shard_map.shards):
        self.touch(sid)
    ok = 3 in self.shard_map.shards  # membership, not iteration
    return ok
""", 0),
    ("core/repair.py", """
def scan(self, cluster_id, scope):
    out = []
    for cid in sorted(self.store.index.cluster_chunks(cluster_id)):
        if cid in set(scope):
            out.append(cid)
    return out
""", 0),
])
def test_determinism_cases(path, src, count):
    findings = lint_sources({f"src/repro_torch/{path}": src})
    assert len(live(findings, "plan-determinism")) == count


# -------------------------------------------------- cache discipline ----

def test_cache_unbounded_catches_evictionless_attr_cache():
    findings = lint_sources({"src/repro_torch/core/store.py": """
class Store:
    def __init__(self):
        self._chunk_cache = {}

    def get(self, cid):
        if cid not in self._chunk_cache:
            self._chunk_cache[cid] = self.decode(cid)
        return self._chunk_cache[cid]
"""})
    hits = live(findings, "cache-unbounded")
    assert hits and "_chunk_cache" in hits[0].message


def test_cache_unbounded_catches_module_level_dict():
    findings = lint_sources({"src/repro_torch/kernels/gf_matmul.py": """
MATRIX_CACHE: dict = {}

def device_matrix(key, make):
    if key not in MATRIX_CACHE:
        MATRIX_CACHE[key] = make()
    return MATRIX_CACHE[key]
"""})
    assert len(live(findings, "cache-unbounded")) == 1


def test_cache_unbounded_allows_evicting_and_local_caches():
    findings = lint_sources({"src/repro_torch/core/store.py": """
from collections import OrderedDict

class Store:
    def __init__(self):
        self._blob_cache = OrderedDict()

    def fill(self, cid, blob):
        self._blob_cache[cid] = blob
        while len(self._blob_cache) > 64:
            self._blob_cache.popitem(last=False)

    def plan(self, cids):
        cached: dict = {}   # per-call local, dies with the request
        for cid in cids:
            cached[cid] = self.peek(cid)
        return cached
"""})
    assert not live(findings, "cache-unbounded")


@pytest.mark.parametrize("path", ["src/repro_torch/models/layers.py",
                                  "src/repro/core/store.py"])
def test_cache_unbounded_ignores_modules_outside_the_port_storage(path):
    findings = lint_sources({path: """
ACTIVATION_CACHE = {}
"""})
    assert not live(findings, "cache-unbounded")


def test_cache_bypass_catches_direct_read_in_store():
    findings = lint_sources({"src/repro_torch/core/store.py": """
def fetch(self, cluster, cids):
    return cluster.read_pieces_batch(cids, cluster.k)
"""})
    hits = live(findings, "cache-bypass")
    assert hits and "_read_cluster_pieces" in hits[0].message


def test_cache_bypass_allows_funnel_and_repair_modules():
    findings = lint_sources({
        "src/repro_torch/core/store.py": """
def _read_cluster_pieces(self, cluster_id, chunk_ids):
    cluster = self.clusters[cluster_id]
    return cluster.read_pieces_batch(chunk_ids, cluster.k)
""",
        "src/repro_torch/core/repair.py": """
def drain(self, cluster, cid):
    return cluster.read_pieces(cid, cluster.k)
"""})
    assert not live(findings, "cache-bypass")


def test_cache_bypass_waiver_with_reason_is_honored():
    findings = lint_sources({"src/repro_torch/core/scheduler.py": """
def rebuild(self, cluster, cid):
    # searslint: ignore[cache-bypass] -- local rebuild, no time charged
    return cluster.read_pieces(cid, cluster.k)
"""})
    assert not live(findings)
    assert any(f.waived for f in findings)


# ------------------------------------------------------------ waivers ----

def test_waiver_with_reason_suppresses_finding():
    findings = lint_sources({"src/repro_torch/kernels/sha1.py": """
from repro_torch.kernels import _build

# searslint: ignore[counter-kernel] -- counted by its caller
def launch(blocks, out):
    return _build.library().sears_sha1(blocks.data_ptr(), out.data_ptr())
"""})
    assert not live(findings)
    assert any(f.waived for f in findings)


def test_waiver_without_reason_is_a_finding():
    # Assemble the reasonless marker at runtime so the tree-wide scan of
    # this very file doesn't trip over the fixture text.
    marker = "# sears" + "lint: ignore[plan-determinism]"
    findings = lint_sources({"src/repro_torch/core/store.py": f"""
def place(self, cluster_ids):
    for cl in set(cluster_ids):  {marker}
        self.census(cl)
"""})
    assert live(findings, "bad-waiver")


# ------------------------------------------------------ name resolution --

def test_resolution_stays_inside_the_importing_package():
    """Both packages hold ``kernels/ops.py``; the reference's sorts first.
    The port's engine must resolve ``ops.rs_apply`` into the port's."""
    sources = {
        "src/repro/kernels/ops.py": "def rs_apply(M, x):\n    return x\n",
        "src/repro_torch/kernels/ops.py":
            "def rs_apply(M, x):\n    return x\n",
        "src/repro_torch/core/engine.py": """
from repro_torch.kernels import ops

def decode(M, x):
    return ops.rs_apply(M, x)
"""}
    prog = Program([module_from_source(s, p) for p, s in sources.items()])
    engine = next(m for m in prog.modules if m.stem == "engine")
    call = next(f for f in prog.functions_in(engine) if f.name == "decode")
    hits = [c for node in ast.walk(call.node) if isinstance(node, ast.Call)
            for c in prog.resolve_call(engine, node)]
    assert [str(h.module.path) for h in hits] == [
        "src/repro_torch/kernels/ops.py"]
    assert not any(m.is_storage for m in prog.modules
                   if "repro_torch" not in m.path.parts)


# --------------------------------------------------------- real tree ----

def test_port_tree_is_clean():
    findings = run_paths([PORT, ROOT / "tests"])
    assert not live(findings), "\n".join(
        f.format() for f in live(findings))


def test_run_over_src_gives_the_port_run_verdicts(src_modules):
    """Linting all of ``src`` (both packages, the reference's stems
    first) gives the same verdicts as the port alone: clean, with the
    same waived findings; and a seeded fault is caught in the port's
    file, not resolved away into the reference's ``ops.py``."""
    def verdicts(mods):
        return sorted((f.path, f.line, f.rule, f.waived)
                      for f in run_program(Program(mods)))
    assert verdicts(src_modules) == verdicts(port_only(src_modules))
    mutated = edited(src_modules, "kernels/ops.py", "    LAUNCHES.gf += 1\n",
                     "")
    hits = live(run_program(Program(mutated)), "counter-launch")
    assert "rs_apply" in {h.message.split("`")[1] for h in hits}
    assert {pathlib.Path(h.path) for h in hits} == {PORT / "kernels/ops.py"}


def test_seeded_begin_mutation_in_engine_is_caught(src_modules):
    findings = run_program(Program(edited(
        port_only(src_modules), "core/engine.py",
        "    def chunk_blobs_multi_begin(self, jobs",
        "    def chunk_blobs_multi_begin(self, jobs_, *, _x=None):\n"
        "        self._last_window = jobs_\n"
        "        jobs = jobs_\n"
        "        return self.chunk_blobs_multi_begin_real(jobs)\n\n"
        "    def chunk_blobs_multi_begin_real(self, jobs")))
    assert any("chunk_blobs_multi_begin" in f.message
               for f in live(findings, "begin-purity"))


def test_seeded_missing_launch_tick_in_ops_is_caught(src_modules):
    findings = run_program(Program(edited(
        port_only(src_modules), "kernels/ops.py", "    LAUNCHES.gf += 1\n",
        "")))
    hits = live(findings, "counter-launch")
    assert "rs_apply" in {h.message.split("`")[1] for h in hits}


def test_seeded_missing_kernel_tick_in_sha1_is_caught(src_modules):
    findings = run_program(Program(edited(
        port_only(src_modules), "kernels/sha1.py",
        '    KERNELS["sha1"] += 1\n', "")))
    hits = live(findings, "counter-kernel")
    assert len(hits) == 1 and hits[0].path.endswith("kernels/sha1.py")
