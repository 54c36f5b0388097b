"""Pass 3 — host-sync leaks: no implicit device→host syncs on hot paths.

The plane's dispatch side must stay asynchronous: at pipeline depth 2 a
tick's device program is still running while the next tick drains and
packs, and any call that makes the host wait for the card (a copy to
the host, a scalar read, a data-dependent output shape) silently turns
the pipeline back into depth 1. The completion side (``_complete``,
whose event wait is the pipeline's one sync point) and the release
stage carry def-level waivers saying so — everything else must stay
future-shaped.

Mechanics: the pass seeds from the configured hot-path roots, takes the
same-module call closure, and runs a light device taint over each
function: parameters with device-ish names, attributes that hold device
tensors, and the results of ``torch.*`` calls and of tensor methods on
tainted values are device values. The sinks on a device value are

- ``np.asarray`` / ``np.array``, and ``float()`` / ``int()`` /
  ``bool()`` coercions, and ``if`` / ``while`` tests on it;
- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``;
- the ops whose output shape depends on the data, which read a size
  back from the card: ``nonzero``, ``torch.where(cond)`` with one
  argument, ``masked_select``, boolean-mask indexing, ``unique``, and
  ``repeat_interleave`` with tensor repeats and no ``output_size``;

and, whatever their operand, ``torch.cuda.synchronize()`` and every
``.synchronize()`` of an event or a stream. None of them syncs anything
on the CPU, so no CPU test sees them; on the card
``torch.cuda.set_sync_debug_mode`` does (analysis/verify/dispatch.py).
Untainted arguments (host lists, numpy mirrors, byte counts) pass.

Waiver: ``# dtnlint: sync-ok(reason)`` — line-level or on the ``def``.
"""

from __future__ import annotations

import ast

from kubedtn_tpu_torch.analysis.callgraph import CallGraph, FuncRef
from kubedtn_tpu_torch.analysis.core import (
    RULE_SYNC,
    Finding,
    Project,
    call_name,
)

# (file rel path, qualname) roots of the fused-tick / dispatch /
# complete hot paths (kubedtn_tpu/analysis/passes/host_sync.py's roots;
# the JAX package's `_fused_tick` / `_class_tick` are `fused_tick` /
# `class_tick` here). The closure over same-module resolvable calls
# extends each root.
HOT_ROOTS: tuple[tuple[str, str], ...] = (
    ("kubedtn_tpu_torch/runtime.py", "fused_tick"),
    ("kubedtn_tpu_torch/runtime.py", "class_tick"),
    ("kubedtn_tpu_torch/runtime.py", "_shape_class"),
    ("kubedtn_tpu_torch/runtime.py", "_tel_class"),
    ("kubedtn_tpu_torch/runtime.py", "_roll_clocks"),
    ("kubedtn_tpu_torch/runtime.py", "WireDataPlane._tick_inner"),
    ("kubedtn_tpu_torch/runtime.py", "WireDataPlane._dispatch"),
    ("kubedtn_tpu_torch/runtime.py", "WireDataPlane._dispatch_inner"),
    ("kubedtn_tpu_torch/runtime.py", "WireDataPlane._complete"),
    ("kubedtn_tpu_torch/runtime.py", "WireDataPlane._complete_or_requeue"),
    ("kubedtn_tpu_torch/runtime.py", "WireDataPlane._release"),
    ("kubedtn_tpu_torch/telemetry.py", "tel_matrix"),
    ("kubedtn_tpu_torch/telemetry.py", "tel_accumulate"),
)

# parameter names that carry device values on the hot paths
_DEVICE_PARAMS = {"state", "dyn", "key", "sub", "tel", "acc", "res",
                  "sim", "edges"}
# attribute names that hold device values wherever they appear
# (engine.state, self._pipe_state, job.outs, state.props, ...); the
# JAX pass's `counters` / `dropped_ring` are host numpy arrays in the
# port's plane (runtime._zero_counters), so they are not listed
_DEVICE_ATTRS = {"state", "_state", "_pipe_state", "props", "outs",
                 "tokens", "t_last", "backlog_until", "corr",
                 "pkt_count"}
_DEVICE_CALL_PREFIXES = ("torch.",)
# torch calls that return host objects (devices, streams, events,
# generators, dtype info, context managers)
_HOST_TORCH_PREFIXES = (
    "torch.cuda.", "torch.device", "torch.Size", "torch.is_tensor",
    "torch.finfo", "torch.iinfo", "torch.Generator", "torch.no_grad",
    "torch.inference_mode", "torch.profiler.", "torch.get_",
    "torch.set_", "torch.backends.", "torch.distributed.",
    "torch.utils.")
# tensor methods that move the value to the host (each is a sync on a
# device operand)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_MATERIALIZERS = {"np.asarray", "np.array", "numpy.asarray",
                  "numpy.array", "np.ascontiguousarray"}
_COERCIONS = {"float", "int", "bool"}
# array metadata: reading these never transfers
_META_ATTRS = {"shape", "dtype", "ndim", "size", "capacity", "device",
               "is_cuda", "layout"}
_META_METHODS = {"size", "dim", "numel", "element_size", "data_ptr",
                 "stride", "is_contiguous", "get_device", "nelement"}
# ops whose output size is read back from the card
_SHAPE_OPS = {"nonzero", "argwhere", "masked_select", "unique",
              "unique_consecutive"}
# producers of boolean tensors, for boolean-mask indexing
_MASK_METHODS = {"bool", "isfinite", "isnan", "isinf", "logical_and",
                 "logical_or", "logical_not", "logical_xor", "eq", "ne",
                 "lt", "le", "gt", "ge", "isin"}


def run(project: Project, graph: CallGraph,
        hot_roots: tuple[tuple[str, str], ...] | None = None,
        ) -> list[Finding]:
    findings: list[Finding] = []
    roots = [FuncRef(p, q) for p, q in (hot_roots if hot_roots is not None
                                        else HOT_ROOTS)
             if FuncRef(p, q) in graph.functions]
    hot = {ref for ref in graph.closure(roots)
           if any(ref.path == r.path for r in roots)}
    for ref in sorted(hot, key=lambda r: (r.path, r.qual)):
        findings.extend(_check_function(graph.functions[ref], ref))
    return findings


def _is_device_call(cn: str | None) -> bool:
    return bool(cn) and cn.startswith(_DEVICE_CALL_PREFIXES) and \
        not cn.startswith(_HOST_TORCH_PREFIXES)


def _is_cpu(node: ast.AST) -> bool:
    """The host as a `.to` target: "cpu" or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and call_name(node) == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _to_cpu(call: ast.Call) -> bool:
    """`x.to("cpu")` / `x.to(device="cpu")` / `x.to(torch.device("cpu"))`."""
    if not (isinstance(call.func, ast.Attribute) and
            call.func.attr == "to"):
        return False
    return (bool(call.args) and _is_cpu(call.args[0])) or any(
        kw.arg == "device" and _is_cpu(kw.value) for kw in call.keywords)


def _check_function(fn: ast.FunctionDef, ref: FuncRef) -> list[Finding]:
    out: list[Finding] = []
    tainted: set[str] = set()
    masks: set[str] = set()
    for a in (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs):
        if a.arg in _DEVICE_PARAMS:
            tainted.add(a.arg)

    def expr_tainted(node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in tainted:
                return True
            if isinstance(n, ast.Attribute) and n.attr in _DEVICE_ATTRS:
                return True
            if isinstance(n, ast.Call) and _is_device_call(call_name(n)):
                return True
        return False

    def materializes(value: ast.AST) -> bool:
        """RHS that yields host data even from a device operand: an
        explicit materializer/coercion/transfer call (the sync is
        flagged at its own line; downstream is free), array *metadata*
        (shape/capacity/dtype/size() — no transfer), or an identity/
        membership test (a host bool)."""
        if isinstance(value, ast.Call):
            cn = call_name(value)
            if cn in _MATERIALIZERS or cn in _COERCIONS:
                return True
            if isinstance(value.func, ast.Attribute) and (
                    value.func.attr in _SYNC_METHODS
                    or value.func.attr in _META_METHODS
                    or _to_cpu(value)):
                return True
        if isinstance(value, ast.Attribute) and \
                value.attr in _META_ATTRS:
            return True
        if isinstance(value, ast.Subscript) and \
                isinstance(value.value, ast.Attribute) and \
                value.value.attr in _META_ATTRS:
            return True  # state.props.shape[0]
        if isinstance(value, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in value.ops):
            return True
        if isinstance(value, (ast.ListComp, ast.GeneratorExp)):
            return materializes(value.elt)   # [x.cpu() for x in outs]
        if isinstance(value, (ast.Tuple, ast.List)) and value.elts:
            return all(materializes(e) for e in value.elts)
        return False

    def is_mask(node: ast.AST) -> bool:
        """A boolean device tensor: a comparison, a logical op or a
        named mask over device values."""
        if isinstance(node, ast.Name):
            return node.id in masks
        if not expr_tainted(node) or materializes(node):
            return False
        if isinstance(node, ast.Compare):
            return not any(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops)
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, ast.Invert):
            return is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return is_mask(node.left) or is_mask(node.right)
        if isinstance(node, ast.Call):
            cn = call_name(node) or ""
            tail = cn.rsplit(".", 1)[-1]
            return tail in _MASK_METHODS
        return False

    def bind(target: ast.AST, device: bool, mask: bool = False) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                (tainted.add if device else tainted.discard)(n.id)
                (masks.add if mask else masks.discard)(n.id)

    # forward pass in source order: propagate taint through assignments
    # and through loops / comprehensions over device values
    for node in _own_nodes_ordered(fn):
        if isinstance(node, (ast.For, ast.comprehension)):
            bind(node.target, expr_tainted(node.iter)
                 and not materializes(node.iter))
            continue
        if not isinstance(node, ast.Assign):
            continue
        goes_device = expr_tainted(node.value) and \
            not materializes(node.value)
        mask = goes_device and is_mask(node.value)
        for t in node.targets:
            bind(t, goes_device, mask)

    def find(line: int, what: str) -> None:
        out.append(Finding(RULE_SYNC, ref.path, line,
                           f"{what} in hot `{ref.qual}` — implicit "
                           f"device→host sync"))

    for node in _own_nodes_ordered(fn):
        if isinstance(node, ast.Call):
            cn = call_name(node)
            attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)
            recv = node.func.value if attr is not None else None
            arg0 = node.args[0] if node.args else None
            host_arg = arg0 is None or not expr_tainted(arg0) or \
                materializes(arg0)
            if cn in _MATERIALIZERS and not host_arg:
                out.append(Finding(
                    RULE_SYNC, ref.path, node.lineno,
                    f"`{cn}` on a device value in hot `{ref.qual}` — "
                    f"blocks the host on the dispatch"))
            elif cn in _COERCIONS and not host_arg:
                find(node.lineno, f"`{cn}()` coerces a device value")
            elif cn == "torch.cuda.synchronize" or attr == "synchronize":
                find(node.lineno, f"`{cn or '.synchronize'}()` waits "
                                  f"for the card")
            elif attr in _SYNC_METHODS and expr_tainted(recv) and \
                    not materializes(recv):
                find(node.lineno, f"`.{attr}()` on a device value")
            elif _to_cpu(node) and expr_tainted(recv) and \
                    not materializes(recv):
                find(node.lineno, "`.to(\"cpu\")` on a device value")
            elif _shape_op(node, cn, attr, expr_tainted):
                op = (cn if cn is not None and cn.startswith("torch.")
                      else f".{attr}")
                find(node.lineno, f"`{op}` sizes its output from device "
                                  f"data")
        elif isinstance(node, ast.Subscript) and is_mask(node.slice) and \
                expr_tainted(node.value):
            find(node.lineno, "boolean-mask indexing of a device value "
                              "(a data-dependent shape)")
        elif isinstance(node, (ast.If, ast.While)):
            test = node.test
            if expr_tainted(test) and _is_bare_device_test(
                    test, tainted, materializes):
                out.append(Finding(
                    RULE_SYNC, ref.path, test.lineno,
                    f"branching on a device value in hot "
                    f"`{ref.qual}` — bool coercion syncs the host"))
    return out


def _shape_op(node: ast.Call, cn: str | None, attr: str | None,
              expr_tainted) -> bool:
    """A data-dependent-shape op on a device operand (see the module
    docstring)."""
    tail = (cn or attr or "").rsplit(".", 1)[-1]
    is_fn = cn is not None and cn.startswith("torch.")
    operands = (list(node.args) if is_fn
                else [node.func.value] if attr is not None else [])
    if not operands or not any(expr_tainted(a) for a in operands):
        return False
    if tail in _SHAPE_OPS:
        return True
    if tail == "where" and is_fn:
        return len(node.args) == 1 and not node.keywords
    if tail == "repeat_interleave":
        if any(kw.arg == "output_size" for kw in node.keywords):
            return False
        # torch.repeat_interleave(repeats) / (x, repeats), x.r_i(repeats):
        # a sync only when the repeats are a device tensor
        reps = (node.args[-1] if is_fn and node.args
                else node.args[0] if node.args else None)
        if reps is None:
            kw = [k.value for k in node.keywords if k.arg == "repeats"]
            reps = kw[0] if kw else None
        return reps is not None and expr_tainted(reps)
    return False


def _is_bare_device_test(test: ast.AST, tainted: set[str],
                         materializes) -> bool:
    """Only flag direct truthiness of a tainted NAME (or `not name` /
    comparison against one), or of a tensor method's result
    (`if x.any():`) — `if rows is None` style identity tests never
    sync."""
    if isinstance(test, ast.Name):
        return test.id in tainted
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_bare_device_test(test.operand, tainted, materializes)
    if isinstance(test, ast.BoolOp):
        return any(_is_bare_device_test(v, tainted, materializes)
                   for v in test.values)
    if isinstance(test, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in test.ops):
            return False
        return any(isinstance(n, ast.Name) and n.id in tainted
                   for n in [test.left, *test.comparators])
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute) \
            and not materializes(test):
        recv = test.func.value
        return isinstance(recv, ast.Name) and recv.id in tainted
    return False


def _own_nodes_ordered(fn: ast.FunctionDef):
    stack = list(reversed(list(ast.iter_child_nodes(fn))))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(reversed(list(ast.iter_child_nodes(node))))
