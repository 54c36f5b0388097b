"""Pass 1 — traced-purity: no host-side effects in the device programs.

In the JAX package the device programs (the tick, the simulator step,
the router, the routing kernels) run under ``jax.jit`` / ``vmap`` /
``lax.scan`` / ``shard_map``, whose Python bodies execute once, at
trace time: a host effect there (a wall-clock read, a host RNG draw, a
print, a mutation of a closed-over container) either bakes a
trace-time value into the compiled program or fires on a schedule
unrelated to execution. The port runs the same programs eagerly, and
keeps them free of the same effects, so that they stay functions of
their inputs (the byte-identical-delivery contract) and can be captured
or compiled later without changing behaviour. The port traces nothing,
so the roots are listed: `TRACED_ROOTS` holds the counterpart of every
function the JAX pass treats as traced (same module path under the
package, same qualname, or the qualname without a leading underscore
the port dropped). This pass walks the call-graph closure of the roots
and flags the banned effects. Waiver: ``# dtnlint: purity-ok(reason)``.
"""

from __future__ import annotations

import ast

from kubedtn_tpu_torch.analysis.callgraph import CallGraph, FuncRef
from kubedtn_tpu_torch.analysis.core import (
    RULE_PURITY,
    Finding,
    Project,
    call_name,
    local_bindings,
)

TRACED_ROOTS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("kubedtn_tpu_torch/models/traffic.py", (
        "generate",
    )),
    ("kubedtn_tpu_torch/ops/edge_state.py", (
        "_update_links_contiguous", "apply_links", "burst_bytes",
        "compact_state", "delete_links", "init_state", "update_links",
    )),
    ("kubedtn_tpu_torch/ops/netem.py", (
        "_shape_step_from_u", "crandom", "netem_packet", "roll_epoch",
        "row_keys", "shape_rows_indep", "shape_rows_seq",
        "shape_rows_tbf", "shape_slots_indep_nodonate",
        "shape_slots_nodonate", "shape_slots_tbf_nodonate", "shape_step",
        "uniform_rows",
    )),
    ("kubedtn_tpu_torch/ops/queues.py", (
        "insert_inflight", "pop_due", "shape_packets",
    )),
    ("kubedtn_tpu_torch/ops/routing.py", (
        "_apply_up_inval_dense", "_fix_block", "_fix_loop",
        "_fix_rows_block", "_improve_block", "_improve_candidates",
        "_minplus_outer", "_nh_block", "_nh_rows_block",
        "_per_edge_up_flags", "_scatter_cols", "_scatter_rows",
        "_up_inval_cols", "_up_inval_rows", "adjacency", "all_pairs_dist",
        "all_pairs_dist.<locals>.relax_chunk", "ecmp_next_hop_edges",
        "ecmp_next_hop_edges.<locals>.chunk_fn", "edge_weights_latency",
        "reachability", "refine_dist",
    )),
    ("kubedtn_tpu_torch/parallel/router.py", (
        "_bucket_by_shard",
    )),
    ("kubedtn_tpu_torch/parallel/sharded.py", (
        "make_sharded_step.<locals>.step",
    )),
    ("kubedtn_tpu_torch/router.py", (
        "_finish_router_step", "_group_into_lanes", "router_step",
    )),
    ("kubedtn_tpu_torch/runtime.py", (
        "_dyn_of", "_roll_clocks", "_row_counts", "_shape_class",
        "_tel_class", "_with_dyn", "class_tick", "fused_tick",
        "make_sharded_fused.<locals>.fused",
        "make_sharded_fused.<locals>.tel_local",
    )),
    ("kubedtn_tpu_torch/scenarios.py", (
        "scale_1m.<locals>.run_shape", "scale_1m.<locals>.run_updates",
    )),
    ("kubedtn_tpu_torch/sim.py", (
        "_add", "_finish_step", "_step_parts", "sim_step",
    )),
    ("kubedtn_tpu_torch/telemetry.py", (
        "tel_accumulate", "tel_matrix",
    )),
    ("kubedtn_tpu_torch/twin/engine.py", (
        "_apply_edits",
    )),
)

# dotted-prefix -> human reason
_BANNED_PREFIXES = {
    "time.": "wall-clock read: the result depends on when it runs",
    "random.": "host RNG draw outside the keyed draws",
    "np.random.": "host RNG draw outside the keyed draws",
    "numpy.random.": "host RNG draw outside the keyed draws",
    "os.urandom": "host RNG draw outside the keyed draws",
    "torch.manual_seed": "reseeds the process-wide generator",
    "torch.seed": "reseeds the process-wide generator",
    "torch.random.": "touches the process-wide generator",
}
_BANNED_CALLS = {
    "print": "host I/O inside a device program",
    "open": "host I/O inside a device program",
    "input": "host I/O inside a device program",
}
_MUTATORS = {"append", "extend", "insert", "update", "setdefault",
             "pop", "popleft", "appendleft", "clear", "remove",
             "add", "discard"}


def roots() -> list[FuncRef]:
    return [FuncRef(path, q) for path, quals in TRACED_ROOTS
            for q in quals]


def run(project: Project, graph: CallGraph,
        traced_roots: list[FuncRef] | None = None) -> list[Finding]:
    findings: list[Finding] = []
    traced = graph.closure(roots() if traced_roots is None
                           else traced_roots)
    for ref in sorted(traced, key=lambda r: (r.path, r.qual)):
        src = project.files[ref.path]
        fn = graph.functions[ref]
        local = local_bindings(fn)
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                cn = call_name(node)
                if cn is None:
                    continue
                reason = _BANNED_CALLS.get(cn)
                if reason is None:
                    for pref, why in _BANNED_PREFIXES.items():
                        if cn == pref.rstrip(".") or cn.startswith(pref):
                            reason = why
                            break
                if reason is not None:
                    findings.append(Finding(
                        RULE_PURITY, ref.path, node.lineno,
                        f"`{cn}` in device-program `{ref.qual}`: "
                        f"{reason}"))
                    continue
                # mutation of a closed-over / global container
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in _MUTATORS and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id not in local:
                    findings.append(Finding(
                        RULE_PURITY, ref.path, node.lineno,
                        f"`{f.value.id}.{f.attr}(...)` mutates a "
                        f"closed-over container inside device-program "
                        f"`{ref.qual}` — the program is no longer a "
                        f"function of its inputs"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id not in local:
                        findings.append(Finding(
                            RULE_PURITY, ref.path, node.lineno,
                            f"subscript store into closed-over "
                            f"`{t.value.id}` inside device-program "
                            f"`{ref.qual}` — the program is no longer "
                            f"a function of its inputs"))
    return findings


def _own_nodes(fn: ast.FunctionDef):
    """Walk `fn` without descending into nested defs (those are scopes
    of their own and get their own findings)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
