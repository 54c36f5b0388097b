"""dtnlint for the port (kubedtn_tpu_torch/analysis) held against the
JAX package's (kubedtn_tpu/analysis):

- on the JAX package's own fixtures (tests/fixtures/dtnlint), copied
  with `kubedtn_tpu` renamed `kubedtn_tpu_torch`, both give the same
  (rule, line, message) findings, package names normalised, and the same
  `--fix` and `--diff` output;
- on the torch fixtures (tests/fixtures/dtnlint_torch) each pass fires on
  exactly the lines marked `# expect: <rule>` and is silent on the clean
  twin;
- the port's purity roots and hot roots cover every JAX traced function
  and hot root with a counterpart in the port;
- the real tree is clean, every JAX waiver with a counterpart is matched,
  and the CLI keeps the JAX exit codes (2 for the layers not ported).

The fixtures and trees are parsed, never imported."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kubedtn_tpu.analysis import CallGraph as JCallGraph
from kubedtn_tpu.analysis import Project as JProject
from kubedtn_tpu.analysis import run_suite as j_run_suite
from kubedtn_tpu.analysis.core import apply_waivers as j_apply_waivers
from kubedtn_tpu.analysis.core import iter_functions
from kubedtn_tpu.analysis.core import write_json as j_write_json
from kubedtn_tpu.analysis.diff import diff_docs as j_diff_docs
from kubedtn_tpu.analysis.diff import print_diff as j_print_diff
from kubedtn_tpu.analysis.fix import fix_tree as j_fix_tree
from kubedtn_tpu.analysis.passes import PASSES as J_PASSES
from kubedtn_tpu.analysis.passes import host_sync as j_host_sync
from kubedtn_tpu_torch.analysis import CallGraph, Project, run_suite
from kubedtn_tpu_torch.analysis.__main__ import NOT_PORTED, main
from kubedtn_tpu_torch.analysis.callgraph import FuncRef
from kubedtn_tpu_torch.analysis.core import apply_waivers, write_json
from kubedtn_tpu_torch.analysis.diff import diff_docs, print_diff
from kubedtn_tpu_torch.analysis.fix import fix_tree
from kubedtn_tpu_torch.analysis.passes import PASSES, host_sync, traced_purity

ROOT = Path(__file__).resolve().parent.parent
JFIX = ROOT / "tests" / "fixtures" / "dtnlint"
TFIX = ROOT / "tests" / "fixtures" / "dtnlint_torch"
_PKG_RE = re.compile(r"\bkubedtn_tpu\b")
_MARK = re.compile(r"#\s*expect:\s*(\w+)$")

# JAX fixture -> the pass it exercises (None: the whole suite)
PARITY = {
    "lock_bad.py": "lock", "lock_clean.py": "lock",
    "hygiene_bad.py": "hygiene", "hygiene_clean.py": "hygiene",
    "sync_bad.py": "sync", "sync_clean.py": "sync",
    "waivered.py": None, "stale_waiver.py": None,
}


def norm(text: str) -> str:
    return text.replace("kubedtn_tpu_torch", "kubedtn_tpu")


def renamed_copy(name: str, dst: Path) -> Path:
    """The JAX fixture `name` in `dst`, with the package renamed."""
    dst.mkdir(parents=True, exist_ok=True)
    p = dst / name
    p.write_text(_PKG_RE.sub("kubedtn_tpu_torch", (JFIX / name).read_text()))
    return p


def keyed(findings) -> list[tuple]:
    return [(f.rule, f.line, norm(f.message), f.waived,
             f.waiver_reason) for f in findings]


def jax_findings(name: str, root: Path = JFIX):
    rule = PARITY[name]
    if rule is None:
        return j_run_suite(root=root, packages=(name,))[1]
    project = JProject(root, packages=(name,))
    graph = JCallGraph(project)
    if rule == "sync":
        found = j_host_sync.run(project, graph, hot_roots=((name,
                                                            "hot_tick"),))
    else:
        found = J_PASSES[rule](project, graph)
    return j_apply_waivers(project, found)


def port_findings(name: str, root: Path):
    rule = PARITY[name]
    if rule is None:
        return run_suite(root=root, packages=(name,))[1]
    project = Project(root, packages=(name,))
    graph = CallGraph(project)
    if rule == "sync":
        found = host_sync.run(project, graph, hot_roots=((name,
                                                          "hot_tick"),))
    else:
        found = PASSES[rule](project, graph)
    return apply_waivers(project, found)


# ---- parity on the JAX package's fixtures ---------------------------------

@pytest.mark.parametrize("name", sorted(PARITY))
def test_findings_equal_jax_on_its_fixtures(name, tmp_path):
    renamed_copy(name, tmp_path)
    want = keyed(jax_findings(name))
    got = keyed(port_findings(name, tmp_path))
    assert got == want
    if name.endswith("_bad.py") or name in ("waivered.py",
                                            "stale_waiver.py"):
        assert want   # the fixture exercises its rule


@pytest.mark.parametrize("name", sorted(PARITY))
def test_fix_equals_jax_on_its_fixtures(name, tmp_path):
    """--fix on each fixture: the JAX fixer on a copy of the original and
    the port's on the renamed copy leave the same text (names
    normalised) and report the same changed files."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    shutil.copy(JFIX / name, jdir / name)
    renamed_copy(name, tdir)
    jp = JProject(jdir, packages=(name,))
    jf = j_run_suite(root=jdir, packages=(name,))[1]
    tp = Project(tdir, packages=(name,))
    tf = run_suite(root=tdir, packages=(name,))[1]
    assert j_fix_tree(jdir, jp, jf) == fix_tree(tdir, tp, tf)
    assert norm((tdir / name).read_text()) == (jdir / name).read_text()


@pytest.mark.parametrize("name", sorted(PARITY))
def test_diff_equals_jax_on_its_fixtures(name, tmp_path, capsys):
    """--diff of an empty artifact against each fixture's full-run
    artifact, written by each package: the same delta and the same
    report, names normalised."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    shutil.copy(JFIX / name, jdir / name)
    renamed_copy(name, tdir)
    empty = {"schema_version": 3, "findings": []}
    j_write_json(jdir / "a.json", j_run_suite(root=jdir,
                                              packages=(name,))[1], jdir)
    write_json(tdir / "a.json", run_suite(root=tdir, packages=(name,))[1],
               tdir)
    jdoc = json.loads((jdir / "a.json").read_text())
    tdoc = json.loads((tdir / "a.json").read_text())
    assert json.loads(norm(json.dumps({k: v for k, v in tdoc.items()
                                       if k != "root"}))) == \
        {k: v for k, v in jdoc.items() if k != "root"}
    jd, td = j_diff_docs(empty, jdoc), diff_docs(empty, tdoc)
    assert json.loads(norm(json.dumps(td))) == jd
    j_print_diff(jd)
    jout = capsys.readouterr().out
    print_diff(td)
    assert norm(capsys.readouterr().out) == jout


# ---- the torch fixtures ---------------------------------------------------

def run_torch_fixture(rule: str, name: str):
    project = Project(TFIX, packages=(name,))
    graph = CallGraph(project)
    src = project.files[name]
    tops = [q for q, _fn in src.functions if "." not in q]
    if rule == "sync":
        found = host_sync.run(project, graph,
                              hot_roots=tuple((name, q) for q in tops))
    elif rule == "purity":
        found = traced_purity.run(project, graph, traced_roots=[
            FuncRef(name, q) for q in tops if not q.startswith("_")])
    else:
        found = PASSES[rule](project, graph)
    return apply_waivers(project, found), src


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", ["sync", "key", "purity", "dtype"])
def test_torch_fixture_fires_on_marked_lines(rule, kind):
    found, src = run_torch_fixture(rule, f"{rule}_{kind}.py")
    want = {i for i, ln in enumerate(src.lines, 1)
            if (m := _MARK.search(ln.rstrip())) and m.group(1) == rule}
    got = {f.line for f in found}
    assert got == want, "\n".join(f.format() for f in found)
    assert all(f.rule == rule and not f.waived for f in found)
    assert bool(want) == (kind == "bad")


def test_torch_fixture_sync_messages_name_the_sink():
    found, _src = run_torch_fixture("sync", "sync_bad.py")
    msgs = "\n".join(f.message for f in found)
    for what in ("`np.asarray`", "`float()`", "bool coercion", "`.item()`",
                 "`.tolist()`", "`.cpu()`", "`.numpy()`", '`.to("cpu")`',
                 "`torch.cuda.synchronize()`", "`.synchronize()`",
                 "`.nonzero`", "`torch.nonzero`", "`torch.where`",
                 "`torch.masked_select`", "boolean-mask indexing",
                 "`torch.unique`", "`torch.repeat_interleave`",
                 "`.repeat_interleave`"):
        assert what in msgs, what


def test_torch_fixture_key_messages_name_the_rule():
    found, _src = run_torch_fixture("key", "key_bad.py")
    msgs = "\n".join(f.message for f in found)
    for what in ("second sampling call", "raw `tick_key(...)`",
                 "passed directly into `shape`", "loop-invariant",
                 "samples from root key", "neither a parameter",
                 "`torch.rand`", "`.uniform_`", "`.exponential_`",
                 "`torch.manual_seed`", "`torch.cuda.manual_seed_all`",
                 "`numpy.random.seed`"):
        assert what in msgs, what


def test_dtype_f64_request_in_kernel_module(tmp_path):
    """A float64 dtype request inside a device-kernel module is a
    finding there, and the same line in another module is not."""
    for rel in ("kubedtn_tpu_torch/ops/netem.py",
                "kubedtn_tpu_torch/other.py"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text('"""m."""\n\nimport torch\n\n\n'
                     "def f(n):\n"
                     "    return torch.zeros(n, dtype=torch.float64)\n")
    project = Project(tmp_path)
    found = PASSES["dtype"](project, CallGraph(project))
    assert [(f.path, f.line) for f in found] == [
        ("kubedtn_tpu_torch/ops/netem.py", 7)]
    assert "float64 dtype request in kernel module" in found[0].message


# ---- coverage of the JAX package's roots ----------------------------------

def counterpart(path: str, qual: str, functions: set) -> tuple | None:
    """The port's (path, qualname) of a JAX function: the same module
    path under the package and the same qualname, or the qualname with
    a leading underscore the port dropped."""
    p = "kubedtn_tpu_torch/" + path[len("kubedtn_tpu/"):]
    bare = ".".join(x[1:] if x.startswith("_") and not x.startswith("__")
                    else x for x in qual.split("."))
    for q in (qual, bare):
        if (p, q) in functions:
            return p, q
    return None


@pytest.fixture(scope="module")
def port_functions():
    project = Project(ROOT)
    return {(src.rel, q) for src in project for q, _fn in src.functions}


@pytest.fixture(scope="module")
def jax_traced():
    project = JProject(ROOT, packages=("kubedtn_tpu",))
    graph = JCallGraph(project)
    return graph.closure(graph.traced_roots())


def test_purity_roots_cover_jax_traced(jax_traced, port_functions):
    roots = {(r.path, r.qual) for r in traced_purity.roots()}
    want = {c for r in jax_traced
            if (c := counterpart(r.path, r.qual, port_functions))}
    assert len(want) >= 60
    assert want - roots == set()
    assert roots <= port_functions   # no root names a missing function


def test_hot_roots_cover_jax_hot_roots(port_functions):
    roots = set(host_sync.HOT_ROOTS)
    want = {c for p, q in j_host_sync.HOT_ROOTS
            if (c := counterpart(p, q, port_functions))}
    assert len(want) == len(j_host_sync.HOT_ROOTS)
    assert want <= roots
    assert roots <= port_functions


# ---- the real tree --------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One in-process CLI run over the repo, its artifact written to a
    temp dir: (exit code, stdout lines, artifact)."""
    out = tmp_path_factory.mktemp("dtnlint") / "ANALYSIS.json"
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["-q", "--root", str(ROOT), "--json", str(out)])
    return rc, buf.getvalue().splitlines(), json.loads(out.read_text())


def test_real_tree_exits_zero_with_no_active_finding(tree):
    rc, lines, doc = tree
    active = [f for f in doc["findings"] if not f["waived"]]
    assert rc == 0 and active == [], "\n".join(lines)
    assert doc["summary"]["unwaivered"] == 0
    assert lines[-1].startswith("dtnlint: ") and " 0 active" in lines[-1]


def test_real_tree_waivers_have_reasons_and_none_is_stale(tree):
    _rc, _lines, doc = tree
    assert doc["findings"], "the tree's waived findings are reported"
    assert all(f["waiver_reason"] for f in doc["findings"] if f["waived"])
    assert [f for f in doc["findings"] if f["rule"] == "waiver"] == []


def test_real_tree_lock_reads_waived(tree):
    """The nine torn-read gauge snapshots and advisory peeks of
    WireDataPlane (stage_breakdown, health, the runner loop in start)
    are lock findings, each waived with its reason."""
    _rc, _lines, doc = tree
    lock = [f for f in doc["findings"] if f["rule"] == "lock"]
    assert len(lock) == 9
    assert all(f["path"] == "kubedtn_tpu_torch/runtime.py" and f["waived"]
               for f in lock)
    where = {m.group(1) for f in lock
             if (m := re.search(r"outside the lock in `(\w+)`",
                                f["message"]))}
    assert where == {"stage_breakdown", "health", "start"}


def test_artifact_written_only_where_asked(tree):
    assert not (ROOT / "kubedtn_tpu_torch" / "ANALYSIS.json").exists()
    _rc, _lines, doc = tree
    assert doc["tool"] == "dtnlint" and doc["schema_version"] == 3


def waiver_sites(root: Path, package: str) -> set:
    """(path, enclosing function qualname, rule) of every waiver comment
    in `package`: the function whose span holds the comment, or whose
    header it sits on or just above (a def-level waiver)."""
    from kubedtn_tpu.analysis.core import SourceFile

    out = set()
    for p in sorted((root / package).rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        if rel.startswith(f"{package}/analysis/") or \
                "dtnlint:" not in p.read_text():
            continue
        src = SourceFile(root, p)
        spans = [(fn.lineno, fn.end_lineno, q)
                 for q, fn in iter_functions(src.tree)]
        for line, rules in src.waivers.items():
            inner = [s for s in spans if s[0] - 1 <= line <= s[1]]
            qual = max(inner)[2] if inner else "<module>"
            for rule in rules:
                out.add((rel, qual, rule))
    return out


# a JAX waiver whose counterpart has nothing to waive, and why
SILENT = {
    ("kubedtn_tpu_torch/runtime.py", "WireDataPlane._release", "sync"):
        "the port's plane keeps its cumulative counters in host arrays, "
        "so its release stage copies nothing from the card",
}


def test_every_jax_waiver_with_a_counterpart_is_matched(tree,
                                                        port_functions):
    jax_sites = waiver_sites(ROOT, "kubedtn_tpu")
    port_sites = waiver_sites(ROOT, "kubedtn_tpu_torch")
    assert len(jax_sites) >= 6
    _rc, _lines, doc = tree
    missing = []
    for path, qual, rule in sorted(jax_sites):
        c = counterpart(path, qual, port_functions)
        if c is None:
            continue
        key = (*c, rule)
        if key in SILENT:
            # nothing of that rule fires in the counterpart at all
            fn = dict(Project(ROOT, packages=(c[0],)).files[c[0]]
                      .functions)[c[1]]
            fired = [f for f in doc["findings"]
                     if f["path"] == c[0] and f["rule"] == rule
                     and fn.lineno <= f["line"] <= fn.end_lineno]
            assert fired == [], (key, fired)
        elif key not in port_sites:
            missing.append(key)
    assert missing == []


# ---- the CLI --------------------------------------------------------------

@pytest.mark.parametrize("flag", sorted(NOT_PORTED))
def test_cli_layers_not_ported_exit_2(flag, capsys):
    with pytest.raises(SystemExit) as e:
        main([flag])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--rules", "nope"],
                                  ["--diff", "old.json"]])
def test_cli_usage_errors_exit_2(argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2


def small_tree(root: Path, body: str) -> Path:
    p = root / "kubedtn_tpu_torch" / "m.py"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(body)
    return p


BAD_MODULE = ('"""m."""\n'
              "from kubedtn_tpu_torch import contracts\n"
              "import os\n"
              "import sys\n\n\n"
              "def f():\n"
              "    return os.getpid() + id(contracts)\n")


def test_cli_exit_codes_and_fix_on_a_small_tree(tmp_path, capsys):
    """An active finding exits 1; --fix repairs the hygiene findings in
    place (the unused import goes, the groups are sorted) and the re-lint
    exits 0; the artifact lands where --json says."""
    p = small_tree(tmp_path, BAD_MODULE)
    assert main(["--root", str(tmp_path)]) == 1
    assert "unused import `sys`" in capsys.readouterr().out
    art = tmp_path / "out" / "a.json"
    art.parent.mkdir()
    assert main(["--root", str(tmp_path), "--fix", "--json",
                 str(art)]) == 0
    out = capsys.readouterr().out
    assert "fixed: kubedtn_tpu_torch/m.py" in out
    text = p.read_text()
    assert "import sys" not in text
    assert text.index("import os") < text.index("from kubedtn_tpu_torch")
    assert json.loads(art.read_text())["summary"]["total"] == 0


def test_cli_diff_on_a_small_tree(tmp_path, capsys):
    small_tree(tmp_path, BAD_MODULE)
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    assert main(["-q", "--root", str(tmp_path), "--json", str(old)]) == 1
    assert main(["--root", str(tmp_path), "--json", str(new),
                 "--diff", str(old)]) == 0
    out = capsys.readouterr().out
    assert "new findings: 0" in out and "fixed findings: 0" in out
    old.write_text(json.dumps({"findings": []}))
    assert main(["--root", str(tmp_path), "--json", str(new),
                 "--diff", str(old)]) == 1


def test_python_m_runs_in_a_fresh_process(tmp_path):
    """`python -m kubedtn_tpu_torch.analysis` as a user runs it, on a
    small tree: exit 1 with an active finding, and neither jax nor the
    JAX package loaded."""
    small_tree(tmp_path, BAD_MODULE)
    code = ("import runpy, sys\n"
            f"sys.argv = ['x', '-q', '--root', {str(tmp_path)!r}]\n"
            "try:\n"
            "    runpy.run_module('kubedtn_tpu_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'kubedtn_tpu'))\n"
            "print('RC', rc, 'BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "RC 1 BAD []", out.stdout
