"""Pass 5 — dtype-drift: f32 casts on f64 anchors, f64 leaks into f32
columns.

The ``clock_us`` freeze class: a wall-clock anchor kept as float32
stops advancing once ``dt * ulp`` rounds to zero (~2.4 h of uptime at
µs resolution), so host-side anchors stay float64. The inverse leak
also bites: a float64 value written into an f32 SoA column silently
downcasts (fine) *per element* but drifts when it is an accumulator.
Rules:

- **anchor-f32**: a configured f64 anchor name (``clock_us`` et al.)
  cast or constructed as float32 — ``np.float32(x)``,
  ``torch.tensor(x, dtype=torch.float32)``, ``x.float()``,
  ``x.to(torch.float32)``, ``x.astype(np.float32)``, or an anchor
  keyword built as float32 (module-level aliases such as
  ``F32 = torch.float32`` are resolved);
- **column-f64**: an ``EdgeState`` column written from a float64 value
  (``torch.float64`` / ``.double()`` / ``np.float64(...)`` / a
  ``time.*()`` read) without an explicit f32 cast: a column keyword
  (``dataclasses.replace(state, tokens=...)``), a subscript store, or
  an in-place ``index_copy_`` / ``index_put_`` / ``copy_`` / ... on the
  column;
- **f64-dtype-in-kernel**: a ``float64`` dtype request inside the
  device-kernel modules (the SoA is f32 by contract).

Waiver: ``# dtnlint: dtype-ok(reason)``.
"""

from __future__ import annotations

import ast

from kubedtn_tpu_torch.analysis.core import (
    RULE_DTYPE,
    Finding,
    Project,
    call_name,
    dotted,
)

# host-side wall-clock anchors that must stay float64
ANCHOR_NAMES = {"clock_us", "clock0_us", "origin_us", "anchor_us"}

# modules whose tensors are the f32 device SoA: float64 dtype requests
# there are a host leak
KERNEL_MODULES = (
    "kubedtn_tpu_torch/ops/edge_state.py",
    "kubedtn_tpu_torch/ops/netem.py",
    "kubedtn_tpu_torch/ops/queues.py",
    "kubedtn_tpu_torch/ops/routing.py",
    "kubedtn_tpu_torch/ops/cuda/shaping.py",
)

# the f32 SoA's columns (ops/edge_state.EdgeState)
EDGE_COLUMNS = {"uid", "src", "dst", "active", "props", "tokens", "t_last",
                "corr", "pkt_count", "backlog_until"}

_F32_NAMES = {"np.float32", "numpy.float32", "torch.float32",
              "torch.float"}
_F32_CASTS = {"np.float32", "numpy.float32"}
_F64_NAMES = {"np.float64", "numpy.float64", "torch.float64",
              "torch.double"}
_F64_MAKERS = {"np.float64", "numpy.float64"}
_TIME_CALLS = {"time.time", "time.monotonic", "time.perf_counter"}
# in-place writes of a column tensor: method -> position of the payload
_INPLACE_WRITES = {"index_copy_": 2, "index_put_": 1, "copy_": 0,
                   "index_add_": 2, "scatter_": 2, "index_fill_": 2,
                   "masked_scatter_": 1, "fill_": 0}


def run(project: Project, graph: object = None) -> list[Finding]:
    findings: list[Finding] = []
    for src in project:
        findings.extend(_Checker(src).run())
    return findings


def _mentions_anchor(node: ast.AST) -> str | None:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in ANCHOR_NAMES:
            return n.id
        if isinstance(n, ast.Attribute) and n.attr in ANCHOR_NAMES:
            return n.attr
    return None


def _column_of(node: ast.AST) -> str | None:
    """The EdgeState column an attribute chain ends in (`state.tokens`)."""
    if isinstance(node, ast.Attribute) and node.attr in EDGE_COLUMNS:
        return node.attr
    return None


class _Checker:
    def __init__(self, src) -> None:
        self.src = src
        self.f32 = set(_F32_NAMES)
        self.f64 = set(_F64_NAMES)
        # module-level dtype aliases: F32 = torch.float32,
        # F32, I32 = torch.float32, torch.int32
        for node in src.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = ([(t, node.value)] if isinstance(t, ast.Name)
                         else list(zip(t.elts, node.value.elts))
                         if isinstance(t, ast.Tuple) and
                         isinstance(node.value, ast.Tuple) else [])
                for name, val in pairs:
                    if not isinstance(name, ast.Name):
                        continue
                    d = dotted(val)
                    if d in _F32_NAMES:
                        self.f32.add(name.id)
                    elif d in _F64_NAMES:
                        self.f64.add(name.id)

    def names_f32(self, node: ast.AST) -> bool:
        return dotted(node) in self.f32 or (
            isinstance(node, ast.Constant) and node.value == "float32")

    def names_f64(self, node: ast.AST) -> bool:
        return dotted(node) in self.f64 or (
            isinstance(node, ast.Constant) and node.value == "float64")

    def is_f32_expr(self, node: ast.AST) -> bool:
        """An explicit float32 cast or construction?"""
        if not isinstance(node, ast.Call):
            return False
        cn = call_name(node)
        if cn in _F32_CASTS:
            return True
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "float" and not node.args:
                return True
            if attr in ("astype", "to", "type"):
                targets = [*node.args, *(kw.value for kw in node.keywords
                                         if kw.arg == "dtype")]
                return any(self.names_f32(a) for a in targets)
        # np.asarray(x, np.float32) / torch.zeros(shape, dtype=F32)
        for arg in [*node.args[1:], *(kw.value for kw in node.keywords
                                      if kw.arg == "dtype")]:
            if self.names_f32(arg):
                return True
        return False

    def f64_source(self, node: ast.AST) -> str | None:
        """What makes `node` a float64 value (None when it is not one, or
        is cast to f32 explicitly at its top)."""
        if self.is_f32_expr(node):
            return None
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                cn = call_name(n)
                if cn in _F64_MAKERS or cn in _TIME_CALLS:
                    return cn
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "double" and not n.args:
                    return ".double()"
            elif isinstance(n, (ast.Attribute, ast.Name)) and \
                    self.names_f64(n):
                return dotted(n)
        return None

    def run(self) -> list[Finding]:
        out: list[Finding] = []
        rel = self.src.rel
        in_kernel = rel in KERNEL_MODULES
        for node in self.src.nodes:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    col = (_column_of(t.value)
                           if isinstance(t, ast.Subscript) else None)
                    what = col and self.f64_source(node.value)
                    if what:
                        out.append(self._column(node.lineno, what, col))
                continue
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node)
            # anchor-f32: float32 cast whose payload or binding mentions
            # a clock anchor
            if self.is_f32_expr(node):
                anchor = _mentions_anchor(node)
                if anchor is not None:
                    out.append(Finding(
                        RULE_DTYPE, rel, node.lineno,
                        f"f32 cast/construction touching f64 clock "
                        f"anchor `{anchor}` — the `clock_us` freeze "
                        f"bug class (anchors stop advancing once "
                        f"dt < ulp/2)"))
            if cn is not None:
                for kw in node.keywords:
                    # anchor passed as keyword into a constructor while
                    # cast f32
                    if kw.arg in ANCHOR_NAMES and \
                            self.is_f32_expr(kw.value):
                        out.append(Finding(
                            RULE_DTYPE, rel, kw.value.lineno,
                            f"`{kw.arg}=` constructed as float32 in "
                            f"`{cn}(...)` — f64 anchor contract"))
                    # column-f64 through a column keyword
                    elif kw.arg in EDGE_COLUMNS:
                        what = self.f64_source(kw.value)
                        if what:
                            out.append(self._column(kw.value.lineno, what,
                                                    kw.arg))
            attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)
            # column-f64: an in-place write of a column tensor
            if attr in _INPLACE_WRITES:
                col = _column_of(node.func.value)
                pos = _INPLACE_WRITES[attr]
                payload = (node.args[pos] if len(node.args) > pos
                           else None)
                what = (col and payload is not None
                        and self.f64_source(payload))
                if what:
                    out.append(self._column(node.lineno, what, col))
            # f64 dtype requests inside kernel modules
            if in_kernel and cn is not None:
                f64 = (cn in _F64_MAKERS or attr == "double"
                       or any(self.names_f64(kw.value)
                              for kw in node.keywords if kw.arg == "dtype")
                       or any(self.names_f64(a) for a in node.args[1:])
                       or (attr in ("to", "astype", "type") and
                           any(self.names_f64(a) for a in node.args)))
                if f64:
                    out.append(Finding(
                        RULE_DTYPE, rel, node.lineno,
                        f"float64 dtype request in kernel module "
                        f"(`{cn}`): the SoA contract is f32 — the "
                        f"request is a host leak"))
        return out

    def _column(self, line: int, what: str, col: str) -> Finding:
        return Finding(
            RULE_DTYPE, self.src.rel, line,
            f"`{what}` written into EdgeState column `{col}` — f64 in "
            f"the f32 SoA; cast to float32 explicitly or keep it "
            f"host-side")
