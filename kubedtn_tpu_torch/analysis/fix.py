"""dtnlint ``--fix`` — mechanical repair of the hygiene findings.

Two fixers, both conservative enough to run unattended on the tree:

- **unused imports**: every `unused import `name`` finding's alias is
  removed from its import statement; a statement left with no aliases
  is deleted outright. Multi-alias (`import a, b`) and parenthesized
  from-imports are handled by rebuilding the statement from its
  surviving aliases. Lines carrying a dtnlint waiver are left alone —
  a waived finding is a decision, not a chore.
- **import-group order**: the LEADING import block of a module (after
  the docstring, up to the first non-import statement) is stably
  re-sorted into future < stdlib < third-party < first-party groups,
  one blank line between groups. Comment lines directly above an
  import travel with it (the isort convention). Imports below the
  first non-import statement are deliberate (lazy imports) and untouched.

Every rewritten file is re-parsed before it is written back; a fixer
that would produce a syntax error or change the imported-name set
leaves the file untouched and reports failure instead. The fixed tree
is re-linted by the caller — hygiene findings go to zero without
waivers, which is the point.
"""

from __future__ import annotations

import ast
from pathlib import Path

from kubedtn_tpu_torch.analysis.core import RULE_HYGIENE, Finding
from kubedtn_tpu_torch.analysis.passes.hygiene import _group


def _import_names(tree: ast.AST) -> set[tuple]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                out.add(("import", al.name, al.asname))
        elif isinstance(node, ast.ImportFrom):
            for al in node.names:
                out.add(("from", node.level, node.module, al.name,
                         al.asname))
    return out


def _rebuild_import(node, keep: list) -> str:
    """The statement's source with only the `keep` aliases (ast
    round-trip — comment-free, which is acceptable for a line being
    shrunk; full-line deletes preserve neighbors untouched)."""
    clone = ast.Import(names=keep) if isinstance(node, ast.Import) \
        else ast.ImportFrom(module=node.module, names=keep,
                            level=node.level)
    return ast.unparse(ast.fix_missing_locations(ast.Module(
        body=[clone], type_ignores=[])))


def fix_unused_imports(path: Path, findings: list[Finding]) -> bool:
    """Drop the aliases named by this file's `unused import` findings.
    Returns True when the file changed."""
    names = set()
    for f in findings:
        if f.rule == RULE_HYGIENE and not f.waived \
                and f.message.startswith("unused import `"):
            names.add(f.message.split("`")[1])
    if not names:
        return False
    text = path.read_text()
    lines = text.splitlines(keepends=True)
    tree = ast.parse(text)
    edits: list[tuple[int, int, str | None]] = []  # (start, end, repl)
    for node in tree.body:
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.ImportFrom) and (
                node.module == "__future__"
                or any(al.name == "*" for al in node.names)):
            continue
        is_from = isinstance(node, ast.ImportFrom)
        bound = (lambda al: (al.asname or al.name) if is_from
                 else (al.asname or al.name).split(".")[0])
        keep = [al for al in node.names if bound(al) not in names]
        if len(keep) == len(node.names):
            continue
        start, end = node.lineno - 1, node.end_lineno
        if keep:
            edits.append((start, end, _rebuild_import(node, keep) + "\n"))
        else:
            edits.append((start, end, None))
    if not edits:
        return False
    for start, end, repl in reversed(edits):
        lines[start:end] = [repl] if repl is not None else []
    new_text = "".join(lines)
    try:
        new_tree = ast.parse(new_text)
    except SyntaxError:
        return False
    # safety: exactly the targeted aliases vanished, nothing else moved
    removed = _import_names(tree) - _import_names(new_tree)
    removed_names = {(t[4] or t[3]) if t[0] == "from"
                     else (t[2] or t[1]).split(".")[0] for t in removed}
    if not removed_names <= names:
        return False
    path.write_text(new_text)
    return True


def fix_import_order(path: Path) -> bool:
    """Stably regroup the leading import block. Returns True when the
    file changed."""
    text = path.read_text()
    tree = ast.parse(text)
    lines = text.splitlines(keepends=True)

    # the leading block: import statements (with any directly-attached
    # comment lines above) from after the docstring to the first
    # non-import statement
    body = list(tree.body)
    i = 0
    if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant) and isinstance(
            body[0].value.value, str):
        i = 1
    imports = []
    while i < len(body) and isinstance(body[i],
                                       (ast.Import, ast.ImportFrom)):
        imports.append(body[i])
        i += 1
    if len(imports) < 2:
        return False

    units = []  # (group, original_idx, [lines])
    block_start = None
    prev_end = None
    captured: set[int] = set()
    for idx, node in enumerate(imports):
        start = node.lineno - 1
        # attach contiguous comment lines directly above
        while start > 0 and lines[start - 1].lstrip().startswith("#") \
                and (prev_end is None or start - 1 >= prev_end):
            start -= 1
        if block_start is None:
            block_start = start
        mod = (node.names[0].name if isinstance(node, ast.Import)
               else "." * node.level + (node.module or ""))
        units.append((_group(mod), idx, lines[start:node.end_lineno]))
        captured.update(range(start, node.end_lineno))
        prev_end = node.end_lineno
    block_end = prev_end
    # a line in the block belonging to NO unit (a free-standing comment
    # separated from the next import by a blank line) would be silently
    # dropped by the rebuild — refuse to reorder rather than eat it
    for i in range(block_start, block_end):
        if i not in captured and lines[i].strip():
            return False

    ordered = sorted(units, key=lambda u: (u[0], u[1]))
    if [u[1] for u in ordered] == list(range(len(units))):
        return False
    out: list[str] = []
    last_group = None
    for g, _idx, chunk in ordered:
        if last_group is not None and g != last_group:
            out.append("\n")
        out.extend(chunk)
        last_group = g
    new_lines = lines[:block_start] + out + lines[block_end:]
    new_text = "".join(new_lines)
    try:
        new_tree = ast.parse(new_text)
    except SyntaxError:
        return False
    if _import_names(tree) != _import_names(new_tree):
        return False
    path.write_text(new_text)
    return True


def fix_tree(root: Path, project, findings: list[Finding]) -> list[str]:
    """Apply both fixers across the project; returns the repo-relative
    paths that changed."""
    by_file: dict[str, list[Finding]] = {}
    for f in findings:
        if f.rule == RULE_HYGIENE:
            by_file.setdefault(f.path, []).append(f)
    changed: list[str] = []
    for rel, fs in sorted(by_file.items()):
        p = root / rel
        did = fix_unused_imports(p, fs)
        if any("out of group order" in f.message for f in fs
               if not f.waived):
            did = fix_import_order(p) or did
        if did:
            changed.append(rel)
    return changed
