"""dtnlint for the port — contract-checking static analysis of
``kubedtn_tpu_torch``.

The port's own copy of kubedtn_tpu/analysis's AST layer: the same six
passes, the same waiver grammar, stale-waiver detection, ``--fix`` and
``--diff``, run as ``python -m kubedtn_tpu_torch.analysis`` and in
tier-1 via ``tests/test_torch_analysis.py``. Four passes read torch
where the JAX package's read jax (see each pass):

========  ==============================================================
rule      contract (waiver tag is ``<rule>-ok(reason)``)
========  ==============================================================
purity    no host effects (time/random/print/closure mutation) inside
          the device programs (explicit roots: the port traces nothing)
key       every Philox draw consumes a fresh ``split`` product; no key
          feeds two draws; every torch draw passes ``generator=``; no
          process-wide reseeding
sync      no implicit device→host syncs (``.item()`` / ``.cpu()`` /
          ``.numpy()`` / ``float()`` / data-dependent shapes / explicit
          synchronize) on the fused-tick/dispatch/complete hot paths
lock      ``@guarded_by`` attributes only under ``with self.<lock>``
dtype     f32 casts on f64 clock anchors, f64 leaks into the f32 SoA
hygiene   unused imports, bare excepts, import-group order
========  ==============================================================

The program-level layer (dtnverify) and the host-cost layer (dtnscale)
are not ported yet; the runtime half of dtnverify's dispatch contract
is (``analysis/verify/dispatch.py``).
"""

from __future__ import annotations

from pathlib import Path

from kubedtn_tpu_torch.analysis.callgraph import CallGraph
from kubedtn_tpu_torch.analysis.core import (
    ALL_RULES,
    RULE_SCOST,
    Finding,
    Project,
    apply_waivers,
    stale_waivers,
    summarize,
    write_json,
)
from kubedtn_tpu_torch.analysis.passes import PASSES

__all__ = ["ALL_RULES", "Finding", "Project", "CallGraph", "PASSES",
           "run_suite", "summarize", "write_json", "default_root"]


def default_root() -> Path:
    """The repo root (parent of the ``kubedtn_tpu_torch`` package)."""
    return Path(__file__).resolve().parent.parent.parent


def run_suite(root: Path | None = None,
              rules: tuple[str, ...] | None = None,
              packages: tuple[str, ...] = ("kubedtn_tpu_torch",),
              ) -> tuple[Project, list[Finding]]:
    """Parse the tree, run the selected passes, apply waivers. A full
    run (rules=None) additionally reports STALE waivers — `<rule>-ok`
    comments no finding matches anymore; a subset run cannot judge
    staleness (the un-run rules' waivers would all look dead). `scost`
    waivers are exempt: dtnscale does not run in the port."""
    root = root if root is not None else default_root()
    project = Project(root, packages=packages)
    graph = CallGraph(project)
    findings: list[Finding] = []
    for rule in (rules if rules is not None else tuple(PASSES)):
        findings.extend(PASSES[rule](project, graph))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    used: set = set()
    findings = apply_waivers(project, findings, used=used)
    if rules is None:
        findings.extend(stale_waivers(project, used,
                                      skip_rules=(RULE_SCOST,)))
        findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return project, findings
