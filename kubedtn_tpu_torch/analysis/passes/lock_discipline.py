"""Pass 4 — lock-discipline: guarded attributes stay under their lock.

Classes declare ownership with ``@guarded_by("_lock", "attr", ...)``
(kubedtn_tpu_torch.contracts, which records the same map as the class's
``__dtnlint_guarded__``). This pass re-reads the declaration from the
AST and flags every ``self.attr`` load/store in a method body that
is not lexically inside ``with self.<lock>`` — unless the method is
``__init__`` (construction precedes publication) or is decorated
``@requires_lock("<lock>")`` (the caller holds it). Nested functions
defined inside a method are checked against the with-blocks visible at
their definition site only if they are *immediately* called; otherwise
(thread bodies, callbacks) accesses inside them are flagged for an
explicit ``requires_lock``/waiver decision.

The runtime half (lock ordering, cycle detection) lives in
``kubedtn_tpu_torch.contracts.InstrumentedLock``.
Waiver: ``# dtnlint: lock-ok(reason)``.
"""

from __future__ import annotations

import ast

from kubedtn_tpu_torch.analysis.core import (
    RULE_LOCK,
    Finding,
    Project,
    call_name,
    dotted,
)


def run(project: Project, graph: object = None) -> list[Finding]:
    findings: list[Finding] = []
    for src in project:
        for node in src.nodes:
            if isinstance(node, ast.ClassDef):
                guarded = _guarded_map(node)
                if guarded:
                    findings.extend(_check_class(src.rel, node, guarded))
    return findings


def _guarded_map(cls: ast.ClassDef) -> dict[str, str]:
    """attr -> lock from @guarded_by("lock", "attr", ...) decorators."""
    out: dict[str, str] = {}
    for dec in cls.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        cn = call_name(dec)
        if cn is None or cn.split(".")[-1] != "guarded_by":
            continue
        args = [a.value for a in dec.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        if len(args) >= 2:
            lock, attrs = args[0], args[1:]
            for a in attrs:
                out[a] = lock
    return out


def _requires(fn: ast.FunctionDef) -> set[str]:
    held: set[str] = set()
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            cn = call_name(dec)
            if cn and cn.split(".")[-1] == "requires_lock":
                for a in dec.args:
                    if isinstance(a, ast.Constant) and \
                            isinstance(a.value, str):
                        held.add(a.value)
    return held


def _check_class(path: str, cls: ast.ClassDef,
                 guarded: dict[str, str]) -> list[Finding]:
    out: list[Finding] = []
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name == "__init__":
            continue
        held0 = _requires(item)
        out.extend(_walk_body(path, cls.name, item, item.body,
                              guarded, held0))
    return out


def _with_locks(node: ast.With) -> set[str]:
    """Lock names this `with self.<name>` statement acquires."""
    locks: set[str] = set()
    for it in node.items:
        d = dotted(it.context_expr)
        if d and d.startswith("self."):
            locks.add(d.split(".", 1)[1])
    return locks


def _walk_body(path: str, clsname: str, method: ast.FunctionDef,
               body: list[ast.stmt], guarded: dict[str, str],
               held: set[str]) -> list[Finding]:
    out: list[Finding] = []
    for stmt in body:
        out.extend(_walk_stmt(path, clsname, method, stmt, guarded, held))
    return out


def _walk_stmt(path: str, clsname: str, method: ast.FunctionDef,
               stmt: ast.stmt, guarded: dict[str, str],
               held: set[str]) -> list[Finding]:
    out: list[Finding] = []
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        newly = _with_locks(stmt) if isinstance(stmt, ast.With) else set()
        inner = held | newly
        out.extend(_walk_body(path, clsname, method, stmt.body,
                              guarded, inner))
        return out
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
        # nested def (thread body / callback): lock state at call time
        # is unknown — require an explicit requires_lock or waiver for
        # guarded accesses inside
        nested_held = _requires(stmt)
        out.extend(_walk_body(path, clsname, method, stmt.body, guarded,
                              nested_held))
        return out
    # expressions & simple statements: scan for self.<guarded attr>
    for node in _shallow_walk(stmt):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and node.attr in guarded:
            lock = guarded[node.attr]
            if lock not in held:
                kind = ("write" if isinstance(node.ctx,
                                              (ast.Store, ast.Del))
                        else "read")
            else:
                continue
            out.append(Finding(
                RULE_LOCK, path, node.lineno,
                f"{kind} of `{clsname}.{node.attr}` (guarded by "
                f"`self.{lock}`) outside the lock in "
                f"`{method.name}`"))
    # recurse into nested statement bodies (if/for/try/...)
    for field in ("body", "orelse", "finalbody"):
        sub = getattr(stmt, field, None)
        if isinstance(sub, list):
            for s in sub:
                if isinstance(s, ast.stmt):
                    out.extend(_walk_stmt(path, clsname, method, s,
                                          guarded, held))
    for h in getattr(stmt, "handlers", []) or []:
        for s in h.body:
            out.extend(_walk_stmt(path, clsname, method, s, guarded,
                                  held))
    return out


def _shallow_walk(stmt: ast.stmt):
    """Expressions belonging to this statement only — child statements
    (and nested defs/withs) are handled by the recursive walk."""
    skip_fields = {"body", "orelse", "finalbody", "handlers"}
    stack: list[ast.AST] = []
    for field, value in ast.iter_fields(stmt):
        if field in skip_fields:
            continue
        if isinstance(value, ast.AST):
            stack.append(value)
        elif isinstance(value, list):
            stack.extend(v for v in value if isinstance(v, ast.AST))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.stmt)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
    return
