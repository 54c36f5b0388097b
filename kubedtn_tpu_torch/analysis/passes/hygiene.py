"""Hygiene pass — the ruff-subset dtnlint enforces even where ruff is
not installed: unused imports, bare ``except:``, and stdlib →
third-party → first-party import-group ordering (ruff's F401, E722
and I families), with ``kubedtn_tpu_torch`` as the first party; this
pass keeps that floor where ruff is not installed.

Waiver: ``# dtnlint: hygiene-ok(reason)``.
"""

from __future__ import annotations

import ast
import sys

from kubedtn_tpu_torch.analysis.core import RULE_HYGIENE, Finding, Project

_FIRST_PARTY = "kubedtn_tpu_torch"
_STDLIB = set(sys.stdlib_module_names)
_GROUPS = {"future": 0, "stdlib": 1, "third": 2, "first": 3}


def _group(module: str) -> int:
    top = module.split(".")[0]
    if top == "__future__":
        return _GROUPS["future"]
    if top == _FIRST_PARTY or module.startswith("."):
        return _GROUPS["first"]
    if top in _STDLIB:
        return _GROUPS["stdlib"]
    return _GROUPS["third"]


def run(project: Project, graph: object = None) -> list[Finding]:
    findings: list[Finding] = []
    for src in project:
        findings.extend(_unused_imports(src))
        findings.extend(_bare_excepts(src))
        findings.extend(_import_order(src))
    return findings


def _unused_imports(src) -> list[Finding]:
    if src.rel.endswith("__init__.py"):
        return []  # re-export surface
    imported: dict[str, tuple[int, str]] = {}
    for node in src.nodes:
        if isinstance(node, ast.Import):
            for al in node.names:
                name = (al.asname or al.name).split(".")[0]
                imported[name] = (node.lineno, al.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for al in node.names:
                if al.name == "*":
                    continue
                imported[al.asname or al.name] = (node.lineno, al.name)
    if not imported:
        return []
    used: set[str] = set()
    for node in src.nodes:
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str):
            used.add(node.value)  # string annotations / __all__
    return [Finding(RULE_HYGIENE, src.rel, ln,
                    f"unused import `{name}`")
            for name, (ln, _orig) in sorted(imported.items(),
                                            key=lambda kv: kv[1][0])
            if name not in used]


def _bare_excepts(src) -> list[Finding]:
    out: list[Finding] = []
    for node in src.nodes:
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            out.append(Finding(
                RULE_HYGIENE, src.rel, node.lineno,
                "bare `except:` swallows KeyboardInterrupt/SystemExit "
                "— name the exceptions"))
    return out


def _import_order(src) -> list[Finding]:
    """Top-of-module import groups must not interleave (future <
    stdlib < third-party < first-party). Function-local imports are
    deliberate (lazy imports) and exempt."""
    out: list[Finding] = []
    last = -1
    last_name = ""
    for node in src.tree.body:
        if isinstance(node, ast.Import):
            mod = node.names[0].name
        elif isinstance(node, ast.ImportFrom):
            mod = ("." * node.level) + (node.module or "")
        else:
            continue
        g = _group(mod)
        if g < last:
            out.append(Finding(
                RULE_HYGIENE, src.rel, node.lineno,
                f"import `{mod}` out of group order (after "
                f"`{last_name}`): future < stdlib < third-party < "
                f"first-party"))
        else:
            last, last_name = g, mod
    return out
