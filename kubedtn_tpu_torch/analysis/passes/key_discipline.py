"""Pass 2 — key-discipline: every draw comes off a fresh key.

The port's keyed draws are counter-based Philox4x32-10 under a key of
two uint32 words: the plane's tick key comes from ``runtime.tick_key``
and each tick ``runtime.split(key)`` yields the next tick key and the
tick's sub-key, which ``ops/netem.uniform_rows`` / ``ops/cuda/philox``
turn into bits. A key that feeds two draws (or a root key handed
straight into a sampling path) produces correlated draws: replicas that
should be independent share entropy, and a replayed schedule silently
diverges from the reference program. Contract, per function:

- a draw's key must be a ``split`` product, a key parameter (the
  leaf-kernel idiom — the caller did the split), or key state split in
  place;
- no key name feeds two draws without a rebinding between;
- a draw inside a loop must not reuse a loop-invariant key;
- a root key (``tick_key(...)``) must pass through ``split`` before any
  other call consumes it.

The same rules hold for the ``jax.random``-style vocabulary (samplers,
``split`` / ``fold_in``, ``key`` / ``PRNGKey`` roots), which the pass
keeps so that it reads the JAX package's fixtures as the JAX pass does.

The rest of the port draws from ``torch.Generator`` objects, and two
rules keep that reproducible:

- every ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
  ``bernoulli`` / ``multinomial`` / ``normal`` call and every
  ``Tensor.uniform_`` / ``exponential_`` (and the other in-place
  samplers) passes ``generator=`` — the global generator's state is
  shared by every caller in the process;
- no ``torch.manual_seed``, ``torch.cuda.manual_seed*`` or
  ``np.random.seed`` appears outside a function that builds its own
  ``torch.Generator``.

Waiver: ``# dtnlint: key-ok(reason)``.
"""

from __future__ import annotations

import ast

from kubedtn_tpu_torch.analysis.core import (
    RULE_KEY,
    Finding,
    Project,
    call_name,
)

_SAMPLERS = {
    "uniform", "normal", "bernoulli", "poisson", "randint", "choice",
    "categorical", "gamma", "beta", "exponential", "truncated_normal",
    "gumbel", "laplace", "cauchy", "dirichlet", "permutation",
    "shuffle", "bits", "rademacher", "t", "loggamma", "multivariate_normal",
}
_KEY_OPS = {"split", "fold_in", "clone"}
_KEY_ROOTS = {"key", "PRNGKey"}

# the port's Philox key API: fully qualified name -> (kind, position of
# the key argument)
_PORT = "kubedtn_tpu_torch"
_PHILOX = {
    f"{_PORT}.runtime.split": ("keyop", 0),
    f"{_PORT}.runtime.tick_key": ("root", 0),
    f"{_PORT}.ops.netem.uniform_rows": ("sampler", 0),
    f"{_PORT}.ops.cuda.philox.philox4x32": ("sampler", 1),
    f"{_PORT}.ops.cuda.philox.philox4x32_words": ("sampler", 1),
}

# torch draws that take a `generator=`
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli",
                "multinomial", "normal", "poisson", "rand_like",
                "randn_like", "randint_like"}
_TENSOR_DRAWS = {"uniform_", "exponential_", "normal_", "random_",
                 "bernoulli_", "geometric_", "cauchy_", "log_normal_"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.random.manual_seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "np.random.seed", "numpy.random.seed"}


def _jax_kind(cn: str | None) -> str | None:
    """'sampler' | 'keyop' | 'root' for a jax.random-style call name."""
    if cn is None:
        return None
    parts = cn.split(".")
    tail = parts[-1]
    if len(parts) >= 2 and parts[-2] == "random" or \
            (len(parts) == 2 and parts[0] in ("jrandom", "jr")):
        if tail in _SAMPLERS:
            return "sampler"
        if tail in _KEY_OPS:
            return "keyop"
        if tail in _KEY_ROOTS:
            return "root"
    return None


class _Names:
    """Fully qualified names of the calls of one module: its own
    module-level functions, its ``from x import y`` names and its
    ``import x as y`` aliases (one attribute hop)."""

    def __init__(self, src) -> None:
        self.module = src.module
        self.own = {q for q, _fn in src.functions if "." not in q}
        self.aliases: dict[str, str] = {}
        for node in src.nodes:
            if isinstance(node, ast.Import):
                for al in node.names:
                    if al.asname:
                        self.aliases[al.asname] = al.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                mod = node.module
                if node.level:
                    base = src.module.rsplit(".", node.level)[0]
                    mod = f"{base}.{mod}"
                for al in node.names:
                    self.aliases[al.asname or al.name] = \
                        f"{mod}.{al.name}"

    def full(self, cn: str | None) -> str | None:
        if cn is None:
            return None
        head, _, rest = cn.partition(".")
        if head in self.aliases:
            return self.aliases[head] + (f".{rest}" if rest else "")
        if not rest and head in self.own:
            return f"{self.module}.{head}"
        return cn


def run(project: Project, graph: object = None) -> list[Finding]:
    findings: list[Finding] = []
    for src in project:
        names = _Names(src)
        for qual, fn in src.functions:
            findings.extend(_check_function(src.rel, qual, fn, names))
    return findings


def _kind(cn: str | None, names: _Names) -> tuple[str | None, int]:
    """(kind, key argument position) of a call."""
    kind = _jax_kind(cn)
    if kind is not None:
        return kind, 0
    return _PHILOX.get(names.full(cn) or "", (None, 0))


def _check_function(path: str, qual: str, fn: ast.FunctionDef,
                    names: _Names) -> list[Finding]:
    out: list[Finding] = []
    params = {a.arg for a in (*fn.args.posonlyargs, *fn.args.args,
                              *fn.args.kwonlyargs)}

    # name -> list of (lineno, origin) bindings in source order, where
    # origin is 'derived' (split/fold_in product), 'root' (a root key),
    # or 'other'
    binds: dict[str, list[tuple[int, str]]] = {}
    sampler_uses: dict[str, list[int]] = {}
    loop_spans: list[tuple[int, int, set[str]]] = []  # start, end, rebound
    builds_generator = False

    def origin_of(value: ast.AST) -> str:
        # split(key)[0] / split(key)[1] are products too
        while isinstance(value, ast.Subscript):
            value = value.value
        if isinstance(value, ast.Call):
            kind, _pos = _kind(call_name(value), names)
            if kind == "keyop":
                return "derived"
            if kind == "root":
                return "root"
        return "other"

    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign):
            org = origin_of(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    binds.setdefault(t.id, []).append((node.lineno, org))
                elif isinstance(t, ast.Tuple):
                    # k1, k2 = split(key): every element is derived
                    for el in t.elts:
                        if isinstance(el, ast.Name):
                            binds.setdefault(el.id, []).append(
                                (node.lineno, org))
        elif isinstance(node, (ast.For, ast.While)):
            rebound: set[str] = set()
            if isinstance(node, ast.For):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        rebound.add(n.id)
            for n in ast.walk(node):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    rebound.add(n.id)
            loop_spans.append((node.lineno, node.end_lineno or node.lineno,
                               rebound))
        elif isinstance(node, ast.Call) and \
                (names.full(call_name(node)) or "") == "torch.Generator":
            builds_generator = True

    def key_arg(call: ast.Call, pos: int) -> ast.AST | None:
        for kw in call.keywords:
            if kw.arg == "key":
                return kw.value
        return call.args[pos] if len(call.args) > pos else None

    seeds: list[tuple[int, str]] = []
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        cn = call_name(node)
        kind, pos = _kind(cn, names)
        full = names.full(cn) or ""
        if full in _GLOBAL_SEEDS:
            seeds.append((node.lineno, full))
        elif _draws_without_generator(node, full):
            what = (full if full.startswith("torch.")
                    else f".{node.func.attr}")
            out.append(Finding(
                RULE_KEY, path, node.lineno,
                f"`{what}` in `{qual}` draws from the process-wide "
                f"generator — pass `generator=` (a torch.Generator the "
                f"caller seeded)"))
        if kind == "sampler":
            k = key_arg(node, pos)
            if k is None:
                continue
            if isinstance(k, ast.Call):
                kk, _ = _kind(call_name(k), names)
                if kk == "root":
                    out.append(Finding(
                        RULE_KEY, path, node.lineno,
                        f"`{cn}` in `{qual}` consumes a raw "
                        f"`{_root_name(k, names)}` — fold a purpose in "
                        f"(`fold_in`/`split`) before sampling"))
                # keyop call inline: derived, fine
                continue
            name = k.id if isinstance(k, ast.Name) else None
            if name is None:
                continue  # attribute/subscript keys: trust the carrier
            sampler_uses.setdefault(name, []).append(node.lineno)
            last = _last_bind(binds.get(name, []), node.lineno)
            if last == "root":
                out.append(Finding(
                    RULE_KEY, path, node.lineno,
                    f"`{cn}` in `{qual}` samples from root key "
                    f"`{name}` — derive a subkey via `split`/"
                    f"`fold_in` first"))
            elif last is None and name not in params:
                out.append(Finding(
                    RULE_KEY, path, node.lineno,
                    f"`{cn}` in `{qual}` samples from `{name}`, which "
                    f"is neither a parameter nor a `split`/`fold_in` "
                    f"product in this scope"))
            # loop-invariant reuse
            for start, end, rebound in loop_spans:
                if start <= node.lineno <= end and name not in rebound:
                    out.append(Finding(
                        RULE_KEY, path, node.lineno,
                        f"`{cn}` in `{qual}` reuses loop-invariant "
                        f"key `{name}` across iterations — every pass "
                        f"draws the same bits"))
                    break
        elif kind is None and cn is not None:
            # raw root key passed into an arbitrary call (the sampling
            # path continues inside)
            for arg in [*node.args, *(kw.value for kw in node.keywords)]:
                if isinstance(arg, ast.Call) and \
                        _kind(call_name(arg), names)[0] == "root":
                    out.append(Finding(
                        RULE_KEY, path, node.lineno,
                        f"raw `{_root_name(arg, names)}` passed directly "
                        f"into `{cn}` in `{qual}` — two call sites "
                        f"with the same seed collide; `fold_in` a "
                        f"purpose first"))

    if not builds_generator:
        for line, full in seeds:
            out.append(Finding(
                RULE_KEY, path, line,
                f"`{full}` in `{qual}` reseeds a process-wide generator "
                f"— build a `torch.Generator` and seed that"))

    # a key name feeding two samplers with no rebinding in between
    for name, uses in sampler_uses.items():
        if len(uses) < 2:
            continue
        uses = sorted(uses)
        rebinds = sorted(ln for ln, _ in binds.get(name, []))
        for a, b in zip(uses, uses[1:]):
            if not any(a < r <= b for r in rebinds):
                out.append(Finding(
                    RULE_KEY, path, b,
                    f"key `{name}` feeds a second sampling call in "
                    f"`{qual}` (first at line {a}) without an "
                    f"intervening `split`/`fold_in` rebinding — "
                    f"identical draws"))
    return out


def _root_name(call: ast.Call, names: _Names) -> str:
    """How a root-key call reads in a message."""
    if _jax_kind(call_name(call)) == "root":
        return "jax.random.key(...)"
    return "tick_key(...)"


def _draws_without_generator(node: ast.Call, full: str) -> bool:
    if any(kw.arg == "generator" for kw in node.keywords):
        return False
    if full.startswith("torch."):
        return full[len("torch."):] in _TORCH_DRAWS
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in _TENSOR_DRAWS


def _last_bind(bindings: list[tuple[int, str]],
               before: int) -> str | None:
    last: str | None = None
    for ln, org in sorted(bindings):
        if ln <= before:
            last = org
    return last


def _own_nodes(fn: ast.FunctionDef):
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
