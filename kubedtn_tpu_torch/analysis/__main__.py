"""``python -m kubedtn_tpu_torch.analysis`` — run dtnlint over the port.

Exit 0 iff every finding is waived (``# dtnlint: <rule>-ok(reason)``),
1 when any is active, 2 on a usage error. ``--json PATH`` writes the
machine-readable artifact (schema v3, the JAX package's layout) there
and nowhere else; ``--diff OLD.json`` compares it with an older
artifact (new / fixed / waiver flips; exit 1 on a new active finding);
``--fix`` mechanically repairs hygiene findings (unused imports,
import-group order) in place and re-lints.

The JAX package's other two layers are not ported yet: ``--verify``
(dtnverify), ``--scale`` (dtnscale), ``--cached`` and
``--update-budgets`` exit 2 saying so, and never pass silently.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from kubedtn_tpu_torch.analysis import (
    PASSES,
    default_root,
    run_suite,
    summarize,
    write_json,
)

# options of the layers the port does not run yet
NOT_PORTED = {
    "--verify": "dtnverify (the program-level contracts)",
    "--scale": "dtnscale (the host-cost bounds and the scaling probe)",
    "--cached": "the cached dtnverify / dtnscale results",
    "--update-budgets": "the dtnverify / dtnscale budget files",
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubedtn_tpu_torch.analysis",
        description="dtnlint: contract checking of kubedtn_tpu_torch for "
                    "the determinism / key / host-sync / lock / dtype "
                    "invariants")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: the installed package's "
                         "parent)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of: "
                         + ",".join(PASSES))
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="write the machine-readable findings artifact")
    ap.add_argument("--show-waived", action="store_true",
                    help="print waived findings too")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary line only")
    ap.add_argument("--fix", action="store_true",
                    help="mechanically repair hygiene findings "
                         "(unused imports, import-group order)")
    ap.add_argument("--diff", type=Path, default=None, metavar="OLD",
                    help="compare OLD artifact against --json PATH and "
                         "exit")
    for flag, what in NOT_PORTED.items():
        ap.add_argument(flag, action="store_true",
                        help=f"not ported yet: {what}")
    args = ap.parse_args(argv)

    for flag, what in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")):
            ap.error(f"{flag} is not ported yet ({what}); see ROADMAP.md")
    if args.diff is not None and args.json is None:
        ap.error("--diff needs --json PATH (the artifact to compare "
                 "against)")

    rules = None
    if args.rules:
        rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
        unknown = [r for r in rules if r not in PASSES]
        if unknown:
            ap.error(f"unknown rule(s): {', '.join(unknown)} "
                     f"(have: {', '.join(PASSES)})")

    root = args.root if args.root is not None else default_root()
    project, findings = run_suite(root=root, rules=rules)

    if args.fix:
        from kubedtn_tpu_torch.analysis.fix import fix_tree

        for rel in fix_tree(root, project, findings):
            print(f"fixed: {rel}")
        # re-lint the repaired tree so the report reflects reality
        project, findings = run_suite(root=root, rules=rules)

    if args.json is not None:
        write_json(args.json, findings, root)

    if args.diff is not None:
        from kubedtn_tpu_torch.analysis.diff import run_diff

        return run_diff(args.diff, args.json)

    active = [f for f in findings if not f.waived]
    if not args.quiet:
        shown = findings if args.show_waived else active
        for f in shown:
            print(f.format())
    s = summarize(findings)
    by_rule = ", ".join(f"{k}={v}" for k, v in s["by_rule"].items())
    print(f"dtnlint: {s['total']} finding(s), {s['waived']} waived, "
          f"{s['unwaivered']} active ({by_rule or 'clean tree'})")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
