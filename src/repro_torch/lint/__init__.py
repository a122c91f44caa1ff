"""searslint for the port -- invariant static analysis of
``repro_torch``'s storage core.

The JAX reference's five passes (see each module's docstring) in the
port's idiom: begin-purity, dispatch hygiene, counter coverage, plan
determinism, cache discipline.  Their scope is the port's ``core`` and
``kernels``; their launch roots are the calls of the kernel library's
symbols (``_build.library().<symbol>(...)``).  Run as

    python -m repro_torch.lint src/repro_torch tests

Waive a finding with ``# searslint: ignore[rule] -- reason`` on the
finding's line or the line above; a waiver without a reason is itself a
``bad-waiver`` finding.
"""

from __future__ import annotations

import pathlib

from repro_torch.lint import (begin_purity, cache_discipline, counters,
                              determinism, dispatch)
from repro_torch.lint.core import (Finding, Module, Program, load_paths,
                                   module_from_source, waiver_findings)

ALL_PASSES = (begin_purity, dispatch, counters, determinism,
              cache_discipline)

__all__ = ["Finding", "Module", "Program", "ALL_PASSES", "load_paths",
           "module_from_source", "run_program", "run_paths"]


def run_program(program: Program) -> list[Finding]:
    findings: list[Finding] = []
    for pass_mod in ALL_PASSES:
        findings.extend(pass_mod.run(program))
    findings.extend(waiver_findings(program, findings))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_paths(paths: list[str | pathlib.Path]) -> list[Finding]:
    return run_program(Program(load_paths(paths)))
