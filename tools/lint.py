"""Minimal in-repo lint gate (no external linters in the image).

Checks, per Python file:
* F811-style duplicate definitions: a ``def``/``class`` name bound twice
  in the same scope silently shadows the first (a broken test that never
  runs is worse than no test).
* ``NotImplementedError``/bare TODO stubs inside the package (padding
  guard).

Exit code 1 on any finding.  Run via ``make check``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TARGETS = ["elemental_tpu", "tests", "examples", "bench.py",
           "chip_smoke.py", "__graft_entry__.py"]


def dup_defs(tree: ast.AST, path: Path):
    findings = []

    def scope(body, where):
        seen = {}
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                deco = {getattr(d, "attr", getattr(d, "id", ""))
                        for d in node.decorator_list}
                # property setters / overloads / dispatch registrations
                # legitimately rebind the name
                if deco & {"setter", "getter", "deleter", "overload",
                           "register"}:
                    continue
                if node.name in seen:
                    findings.append(
                        f"{path}:{node.lineno}: duplicate definition of "
                        f"'{node.name}' in {where} (first at line "
                        f"{seen[node.name]}) shadows the earlier one")
                seen[node.name] = node.lineno
                if isinstance(node, ast.ClassDef):
                    scope(node.body, f"class {node.name}")

    scope(tree.body, "module")
    return findings


def stub_raises(tree: ast.AST, path: Path):
    if "elemental_tpu" not in str(path):
        return []
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Raise) and node.exc is not None:
            name = ""
            exc = node.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            if isinstance(exc, ast.Name):
                name = exc.id
            if name == "NotImplementedError":
                findings.append(f"{path}:{node.lineno}: NotImplementedError "
                                f"stub in package code")
    return findings


def main() -> int:
    findings = []
    for tgt in TARGETS:
        p = ROOT / tgt
        files = [p] if p.suffix == ".py" else sorted(p.rglob("*.py"))
        for f in files:
            try:
                tree = ast.parse(f.read_text(), filename=str(f))
            except SyntaxError as e:
                findings.append(f"{f}: syntax error: {e}")
                continue
            findings += dup_defs(tree, f.relative_to(ROOT))
            findings += stub_raises(tree, f.relative_to(ROOT))
    for msg in findings:
        print(msg)
    if findings:
        print(f"lint: {len(findings)} finding(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
