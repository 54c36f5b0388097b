"""``--diff OLD.json`` — the delta between two ANALYSIS artifacts.

Findings are keyed by ``(layer, rule, path, message)`` — line numbers
shift with unrelated edits, so they are display detail, not identity.
The report buckets: **new** (in the current run only), **fixed** (in
the old artifact only), and **waiver changes** (same finding, waived
flag flipped). Works across schema versions: a v1 artifact (no
``schema_version``, no ``jaxpr`` section) is an AST-only doc.
"""

from __future__ import annotations

import json
from pathlib import Path


def _load(path: Path) -> dict:
    doc = json.loads(Path(path).read_text())
    if "findings" not in doc:
        raise ValueError(f"{path}: not an ANALYSIS artifact "
                         f"(no `findings` key)")
    return doc


def _index(doc: dict) -> dict[tuple, dict]:
    out: dict[tuple, dict] = {}
    for layer, findings in (("ast", doc.get("findings", [])),
                            ("jaxpr", (doc.get("jaxpr") or {})
                             .get("findings", [])),
                            ("scale", (doc.get("scale") or {})
                             .get("findings", []))):
        for f in findings:
            out[(layer, f["rule"], f["path"], f["message"])] = f
    return out


def diff_docs(old: dict, new: dict) -> dict:
    oi, ni = _index(old), _index(new)
    added = sorted(k for k in ni if k not in oi)
    fixed = sorted(k for k in oi if k not in ni)
    waiver_changes = sorted(
        k for k in ni
        if k in oi and bool(oi[k].get("waived")) != bool(
            ni[k].get("waived")))
    return {
        "old_schema": old.get("schema_version", 1),
        "new_schema": new.get("schema_version", 1),
        "new": [ni[k] for k in added],
        "fixed": [oi[k] for k in fixed],
        "waiver_changes": [
            {"finding": ni[k],
             "was_waived": bool(oi[k].get("waived")),
             "now_waived": bool(ni[k].get("waived"))}
            for k in waiver_changes],
    }


def _fmt(f: dict) -> str:
    tag = " [waived]" if f.get("waived") else ""
    return (f"  {f['path']}:{f.get('line', '?')}: [{f['rule']}] "
            f"{f['message']}{tag}")


def print_diff(d: dict) -> None:
    print(f"schema {d['old_schema']} → {d['new_schema']}")
    for title, key in (("new findings", "new"),
                       ("fixed findings", "fixed")):
        rows = d[key]
        print(f"{title}: {len(rows)}")
        for f in rows:
            print(_fmt(f))
    rows = d["waiver_changes"]
    print(f"waiver changes: {len(rows)}")
    for ch in rows:
        arrow = ("active → waived" if ch["now_waived"]
                 else "waived → ACTIVE")
        print(_fmt(ch["finding"]) + f"  ({arrow})")


def run_diff(old_path: Path, new_path: Path) -> int:
    """The CLI's entry: prints the delta; exit 1 iff new ACTIVE findings
    appeared (a gate on new findings, not a style opinion)."""
    d = diff_docs(_load(old_path), _load(new_path))
    print_diff(d)
    new_active = [f for f in d["new"] if not f.get("waived")]
    reactivated = [c for c in d["waiver_changes"]
                   if not c["now_waived"]]
    return 1 if new_active or reactivated else 0
