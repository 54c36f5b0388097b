"""Best-effort package-local call graph.

The purity and host-sync passes need the functions reachable from
their roots: the device programs of the tick and the simulator (the
port's counterparts of what the JAX package traces; the port traces
nothing, so its roots are listed, passes/traced_purity.py) and the
configured hot paths. Resolution is intentionally conservative and
package-local:

- bare names resolve to functions of the same module or explicit
  ``from kubedtn_tpu_torch.x import f`` imports;
- dotted names resolve through ``import kubedtn_tpu_torch.x as alias``
  module aliases (one attribute hop);
- ``self.method`` resolves to methods of the lexically enclosing class;
- a trailing ``.__wrapped__`` (an unwrap idiom) is stripped before
  resolution.

Unresolvable calls are simply not followed — a static pass that guesses
would drown the tree in false positives. Waivers cover the residue.
"""

from __future__ import annotations

import ast
import dataclasses
from collections import deque
from typing import Iterable

from kubedtn_tpu_torch.analysis.core import (
    Project,
    SourceFile,
    call_name,
)

_FIRST_PARTY = "kubedtn_tpu_torch"


@dataclasses.dataclass(frozen=True)
class FuncRef:
    """A function occurrence: (file rel path, qualname)."""
    path: str
    qual: str


class CallGraph:
    def __init__(self, project: Project) -> None:
        self.project = project
        # (path, qualname) -> FunctionDef
        self.functions: dict[FuncRef, ast.FunctionDef] = {}
        # per file: alias -> module ("np" -> "numpy",
        # "netem" -> "kubedtn_tpu_torch.ops.netem") and
        # name -> imported qualname ("shape_packets" ->
        # "kubedtn_tpu_torch.ops.queues.shape_packets")
        self.module_aliases: dict[str, dict[str, str]] = {}
        self.from_imports: dict[str, dict[str, str]] = {}
        # per file: its functions, for the nested-def walk of closure()
        self._by_path: dict[str, list[FuncRef]] = {}
        for src in project:
            self.module_aliases[src.rel] = {}
            self.from_imports[src.rel] = {}
            self._index_imports(src)
            refs = self._by_path[src.rel] = []
            for qual, fn in src.functions:
                ref = FuncRef(src.rel, qual)
                self.functions[ref] = fn
                refs.append(ref)

    # -- imports -------------------------------------------------------

    def _index_imports(self, src: SourceFile) -> None:
        for node in src.nodes:
            if isinstance(node, ast.Import):
                for al in node.names:
                    alias = al.asname or al.name.split(".")[0]
                    self.module_aliases[src.rel][alias] = (
                        al.name if al.asname else al.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                mod = node.module
                if node.level:  # relative import: anchor at the package
                    base = src.module.rsplit(".", node.level)[0]
                    mod = f"{base}.{mod}" if mod else base
                for al in node.names:
                    if al.name == "*":
                        continue
                    local = al.asname or al.name
                    self.from_imports[src.rel][local] = f"{mod}.{al.name}"

    def _module_file(self, module: str) -> SourceFile | None:
        if not module.startswith(_FIRST_PARTY):
            return None
        return self.project.by_module(module)

    # -- resolution ----------------------------------------------------

    def resolve(self, src: SourceFile, scope_qual: str,
                name: str) -> FuncRef | None:
        """Resolve a (possibly dotted) callee name seen inside
        ``scope_qual`` of ``src`` to a package function."""
        if name.endswith(".__wrapped__"):
            name = name[: -len(".__wrapped__")]
        parts = name.split(".")
        # self.method -> method of the enclosing class
        if parts[0] == "self" and len(parts) == 2:
            cls = scope_qual.split(".")[0]
            ref = FuncRef(src.rel, f"{cls}.{parts[1]}")
            return ref if ref in self.functions else None
        if len(parts) == 1:
            # the current scope's own nested defs first, then sibling
            # nested functions, then module-level, then a from-import
            ref = FuncRef(src.rel, f"{scope_qual}.<locals>.{parts[0]}")
            if ref in self.functions:
                return ref
            if "." in scope_qual:
                parent = scope_qual.rsplit(".", 1)[0]
                ref = FuncRef(src.rel, f"{parent}.{parts[0]}")
                if ref in self.functions:
                    return ref
            ref = FuncRef(src.rel, parts[0])
            if ref in self.functions:
                return ref
            target = self.from_imports[src.rel].get(parts[0])
            if target:
                mod, _, fn = target.rpartition(".")
                f = self._module_file(mod)
                if f is not None:
                    ref = FuncRef(f.rel, fn)
                    return ref if ref in self.functions else None
            return None
        # module_alias.func  (one attribute hop)
        mod = self.module_aliases[src.rel].get(parts[0])
        if mod is None:
            target = self.from_imports[src.rel].get(parts[0])
            if target:  # `from kubedtn_tpu_torch.ops import netem` style
                mod = target
        if mod is not None and len(parts) == 2:
            f = self._module_file(mod)
            if f is not None:
                ref = FuncRef(f.rel, parts[1])
                return ref if ref in self.functions else None
        return None

    # -- closure -------------------------------------------------------

    def closure(self, roots: Iterable[FuncRef],
                max_depth: int = 6) -> set[FuncRef]:
        """Roots plus everything reachable through resolvable calls and
        lexically nested defs (a nested function runs with its parent)."""
        seen: set[FuncRef] = set()
        work: deque[tuple[FuncRef, int]] = deque(
            (r, 0) for r in roots if r in self.functions)
        while work:
            ref, depth = work.popleft()
            if ref in seen:
                continue
            seen.add(ref)
            # nested defs belong to their parent's scope
            prefix = f"{ref.qual}.<locals>."
            for other in self._by_path[ref.path]:
                if other.qual.startswith(prefix) and other not in seen:
                    work.append((other, depth))
            if depth >= max_depth:
                continue
            src = self.project.files[ref.path]
            fn = self.functions[ref]
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    cn = call_name(node)
                    if cn is None:
                        continue
                    tgt = self.resolve(src, ref.qual, cn)
                    if tgt is not None and tgt not in seen:
                        work.append((tgt, depth + 1))
        return seen
