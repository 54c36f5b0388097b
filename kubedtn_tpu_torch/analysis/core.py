"""dtnlint core: source model, waiver parsing, findings, project scan.

The port's own copy of kubedtn_tpu/analysis/core.py: the same waiver
grammar, the same finding model and the same artifact layout, with
``kubedtn_tpu_torch`` as the default package.

Every pass consumes a ``Project`` (the parsed package tree) and emits
``Finding``s. A finding is *waived* when the offending line — or the
``def``/``class`` header line of any enclosing scope — carries a
``# dtnlint: <rule>-ok(<reason>)`` comment for the finding's rule. The
reason is mandatory: a waiver without one does not parse, and the JSON
artifact carries every reason so that readers can audit each waiver.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import re
from pathlib import Path
from typing import Iterable, Iterator

# rule tags (the `<tag>-ok(...)` waiver vocabulary)
RULE_PURITY = "purity"
RULE_KEY = "key"
RULE_SYNC = "sync"
RULE_LOCK = "lock"
RULE_DTYPE = "dtype"
RULE_HYGIENE = "hygiene"
# meta-rule: a waiver comment whose line no longer triggers its rule
# (dead waivers rot the audit trail — the reason reads as if it
# justifies something, but nothing is being justified)
RULE_WAIVER = "waiver"
ALL_RULES = (RULE_PURITY, RULE_KEY, RULE_SYNC, RULE_LOCK, RULE_DTYPE,
             RULE_HYGIENE, RULE_WAIVER)
# the rule tags of the layers the port does not run yet (dtnverify's
# program-level rules and dtnscale's host-cost rules; ROADMAP.md says
# which slice brings each). The program-level rules are not waivable: a
# `<tag>-ok(...)` comment for one of them is dead by construction, and
# stale_waivers says so. `scost` is waivable, and its waivers are exempt
# from staleness while dtnscale does not run.
JAXPR_RULES = ("jops", "jkey", "jdtype", "jshard", "jtenant", "jcost")
RULE_SCOST = "scost"

# the artifact schema (kubedtn_tpu's ANALYSIS.json layout): v3 keeps the
# v1 top-level AST keys, so `--diff` reads artifacts of either package.
SCHEMA_VERSION = 3

# the reason may itself contain parens (`tick() re-reads...`): match
# lazily but only stop at a ')' followed by end-of-line, another
# comment, or another waiver — not at the first ')' inside the reason
_WAIVER_RE = re.compile(
    r"#\s*dtnlint:\s*([a-z]+)-ok\((.+?)\)(?=\s*(?:#|dtnlint:|$))")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str            # repo-relative, forward slashes
    line: int
    message: str
    waived: bool = False
    waiver_reason: str | None = None

    def format(self) -> str:
        tail = (f"  [waived: {self.waiver_reason}]"
                if self.waived else "")
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tail}"

    def to_json(self) -> dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "waived": self.waived,
            "waiver_reason": self.waiver_reason,
        }


class SourceFile:
    """One parsed module: source text, AST, waiver map, scope spans."""

    def __init__(self, root: Path, path: Path) -> None:
        self.abspath = path
        self.rel = path.relative_to(root).as_posix()
        self.module = self.rel[:-3].replace("/", ".")
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        # line -> {rule tag: reason}
        self.waivers: dict[int, dict[str, str]] = {}
        for i, ln in enumerate(self.lines, 1):
            if "dtnlint" not in ln:
                continue
            for m in _WAIVER_RE.finditer(ln):
                self.waivers.setdefault(i, {})[m.group(1)] = \
                    m.group(2).strip()
        # enclosing-scope spans for def-level waivers: (start, end, header)
        self._scopes: list[tuple[int, int, int]] = []
        for node in self.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                end = node.end_lineno or node.lineno
                self._scopes.append((node.lineno, end, node.lineno))

    @functools.cached_property
    def nodes(self) -> list[ast.AST]:
        """Every node of the module, in `ast.walk` order (walked once;
        the passes share it)."""
        return list(ast.walk(self.tree))

    @functools.cached_property
    def functions(self) -> list[tuple[str, ast.FunctionDef]]:
        """`iter_functions(self.tree)`, computed once."""
        return list(iter_functions(self.tree))

    def waiver_for(self, rule: str, line: int) -> str | None:
        """The waiver reason covering (rule, line), if any: the line
        itself, the line above it (comment-on-its-own-line style), or
        any enclosing def/class header line."""
        m = self.waiver_match(rule, line)
        return m[1] if m is not None else None

    def waiver_match(self, rule: str, line: int
                     ) -> tuple[int, str] | None:
        """Like `waiver_for`, but returns (waiver_line, reason) so
        callers can track WHICH waiver comment fired — the stale-waiver
        meta-rule reports the ones that never do."""
        for cand in (line, line - 1):
            reason = self.waivers.get(cand, {}).get(rule)
            if reason is not None and (cand == line
                                       or self._is_comment_line(cand)):
                return cand, reason
        for start, end, header in self._scopes:
            if start <= line <= end:
                for cand in (header, header - 1):
                    reason = self.waivers.get(cand, {}).get(rule)
                    if reason is not None and (
                            cand == header
                            or self._is_comment_line(cand)):
                        return cand, reason
        return None

    def _is_comment_line(self, line: int) -> bool:
        if not 1 <= line <= len(self.lines):
            return False
        return self.lines[line - 1].lstrip().startswith("#")


class Project:
    """The analyzed tree: every ``*.py`` under the package roots."""

    def __init__(self, root: Path,
                 packages: Iterable[str] = ("kubedtn_tpu_torch",),
                 exclude: Iterable[str] = ()) -> None:
        self.root = root
        self.files: dict[str, SourceFile] = {}
        excl = tuple(exclude)
        for pkg in packages:
            base = root / pkg
            paths = (sorted(base.rglob("*.py")) if base.is_dir()
                     else [base] if base.is_file() else [])
            for p in paths:
                rel = p.relative_to(root).as_posix()
                if any(rel.startswith(e) for e in excl):
                    continue
                self.files[rel] = SourceFile(root, p)

    def __iter__(self) -> Iterator[SourceFile]:
        return iter(self.files.values())

    def by_module(self, module: str) -> SourceFile | None:
        for f in self.files.values():
            if f.module == module or f.module == module + ".__init__":
                return f
        return None


def apply_waivers(project: Project, findings: list[Finding],
                  used: set | None = None) -> list[Finding]:
    """Mark each finding waived when its file carries a matching
    ``<rule>-ok(reason)`` waiver in scope. `used` (when given)
    collects the ``(path, waiver_line, rule)`` triples that actually
    fired, for stale-waiver detection."""
    for f in findings:
        src = project.files.get(f.path)
        if src is None:
            continue
        m = src.waiver_match(f.rule, f.line)
        if m is not None:
            f.waived = True
            f.waiver_reason = m[1]
            if used is not None:
                used.add((f.path, m[0], f.rule))
    return findings


def stale_waivers(project: Project, used: set,
                  skip_rules: Iterable[str] = ()) -> list[Finding]:
    """The waiver meta-rule: every ``<rule>-ok(reason)`` comment that
    matched NO finding is itself a finding — the rule stopped
    triggering (code moved, bug fixed, rule refined) and the dead
    waiver now documents a justification for nothing. Only meaningful
    after a FULL pass run: a subset run would see every other rule's
    waivers as stale. `skip_rules` names rules that did NOT run this
    invocation (e.g. ``scost`` when the dtnscale layer was off) —
    their waivers cannot be judged and are left alone."""
    skip = set(skip_rules)
    out: list[Finding] = []
    for src in project:
        for line, rules in sorted(src.waivers.items()):
            for rule, reason in sorted(rules.items()):
                if rule == RULE_WAIVER:
                    continue  # waiving stale-waiver reports is circular
                if rule in skip:
                    continue  # layer not run: staleness unjudgeable
                if (src.rel, line, rule) in used:
                    continue
                if rule in JAXPR_RULES:
                    out.append(Finding(
                        RULE_WAIVER, src.rel, line,
                        f"waiver `{rule}-ok({reason})` targets a "
                        f"jaxpr-layer rule — dtnverify findings are "
                        f"not waivable; fix the program, extend the "
                        f"vetted allowlist, or re-baseline with "
                        f"--update-budgets"))
                else:
                    out.append(Finding(
                        RULE_WAIVER, src.rel, line,
                        f"stale waiver `{rule}-ok({reason})` — no "
                        f"`{rule}` finding triggers here anymore; "
                        f"drop the comment (dead waivers rot the "
                        f"audit trail)"))
    return out


def summarize(findings: list[Finding]) -> dict[str, object]:
    counts: dict[str, int] = {}
    waived = 0
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
        waived += int(f.waived)
    return {
        "total": len(findings),
        "waived": waived,
        "unwaivered": len(findings) - waived,
        "by_rule": dict(sorted(counts.items())),
    }


def write_json(path: Path, findings: list[Finding], root: Path) -> None:
    """The machine-readable artifact (schema v3): stable ordering, no
    timestamps, so diffs track the findings-count trajectory. Only the
    AST layer runs in the port; the `jaxpr` and `scale` sections of an
    artifact already at `path` are kept as they were."""
    findings = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    old: dict = {}
    if path.exists():
        try:
            old = json.loads(path.read_text())
        except (OSError, ValueError):
            old = {}
    doc = {
        "tool": "dtnlint",
        "schema_version": SCHEMA_VERSION,
        "root": root.name,
        "summary": summarize(findings),
        "findings": [f.to_json() for f in findings],
    }
    for section in ("jaxpr", "scale"):
        if isinstance(old, dict) and old.get(section) is not None:
            doc[section] = old[section]
    path.write_text(json.dumps(doc, indent=2) + "\n")


# ---- shared AST helpers ------------------------------------------------

def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted(node.func)


def iter_functions(
        tree: ast.AST) -> Iterator[tuple[str, ast.FunctionDef]]:
    """(qualname, node) for every function/method, including nested
    ones (qualified parent.<locals>.child, matching CPython)."""

    def walk(node: ast.AST, prefix: str) -> Iterator[
            tuple[str, ast.FunctionDef]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, f"{q}.<locals>.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")


def local_bindings(fn: ast.FunctionDef) -> set[str]:
    """Names bound inside `fn` proper (params, assignments, loop/with
    targets, comprehension targets, nested defs) — NOT those of nested
    functions, whose bodies have their own scope."""
    bound: set[str] = set()
    args = fn.args
    for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
        bound.add(a.arg)
    if args.vararg:
        bound.add(args.vararg.arg)
    if args.kwarg:
        bound.add(args.kwarg.arg)

    def collect_target(t: ast.AST) -> None:
        for n in ast.walk(t):
            if isinstance(n, ast.Name) and isinstance(
                    n.ctx, (ast.Store, ast.Del)):
                bound.add(n.id)

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.add(child.name)
                continue  # separate scope
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                  ast.For, ast.AsyncFor)):
                tgt = (child.targets if isinstance(child, ast.Assign)
                       else [child.target])
                for t in tgt:
                    collect_target(t)
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    if item.optional_vars is not None:
                        collect_target(item.optional_vars)
            if isinstance(child, (ast.ListComp, ast.SetComp, ast.DictComp,
                                  ast.GeneratorExp)):
                # comprehension targets live in their own scope in py3,
                # but treating them as local is the safe direction here
                for gen in child.generators:
                    collect_target(gen.target)
            if isinstance(child, ast.ExceptHandler) and child.name:
                bound.add(child.name)
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                for al in child.names:
                    bound.add((al.asname or al.name).split(".")[0])
            walk(child)

    walk(fn)
    return bound
