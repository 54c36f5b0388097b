"""Update planner — topology-delta → ordered multi-round schedule.

"The Augmentation-Speed Tradeoff for Consistent Network Updates"
(PAPERS.md, arxiv 2211.03716) frames a consistent update as an ordered
sequence of rounds such that no intermediate state routes traffic into
a transient loop or blackhole; extra transient capacity (augmentation)
buys fewer rounds. This planner applies that decomposition to the
reconciler's `calc_diff` output:

- **make-before-break ordering**: every round of ADDS lands first (the
  augmentation — new capacity exists before anything is torn down),
  property CHANGES next (they never alter connectivity), DELETES last.
  Every intermediate topology is therefore a superset of the END state,
  so any node pair connected in both the old and new topologies stays
  connected through every round — transient-blackhole freedom by
  construction, not by luck.
- **static check**: `check_plan` re-derives that guarantee instead of
  trusting it — per intermediate round it runs a reachability
  (blackhole) check, plus a MIXED-STATE loop check across each round
  TRANSITION: a round is atomic per node (each daemon applies it at
  its own flush barrier), not per fabric, so until every node crosses
  the barrier some nodes forward on round k-1's routes while others
  already use round k's. For every demand destination the union of
  both rounds' next-hop choices must stay acyclic — the transient-loop
  freedom condition of the consistent-updates literature. The check is
  what rejects a hand-built or future-planner schedule that breaks
  either invariant (`PlanError`).
- rounds reuse the twin's delta vocabulary: a CHANGE is exactly a
  `degrade` perturbation (update_links qdisc-reinstall semantics), a
  DELETE a `fail` — so the verification gate (updates.gate) can replay
  the schedule cumulatively against a live snapshot with zero
  translation loss.

The planner is pure host code over `api.types.Link` lists; nothing here
touches a device. Quality regressions (a change that technically keeps
the graph connected but degrades it into uselessness) are the GATE's
job, not the planner's — the planner guards topology, the gate guards
service.

Port of kubedtn_tpu/updates/planner.py, unchanged: the same rounds and
the same static-check reports for the same link sets.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from kubedtn_tpu_torch.api.types import Link
from kubedtn_tpu_torch.topology.reconciler import _identity, calc_diff


class PlanError(ValueError):
    """No consistent schedule — a round would create a transient
    loop/blackhole (or the delta itself is malformed)."""


@dataclasses.dataclass(frozen=True)
class UpdateRound:
    """One atomic edit batch: applied between two ticks at the plane's
    flush barrier, so no tick ever shapes against a half-applied round.

    `changes` carry the NEW properties; `changes_old` the same links
    with their pre-plan properties (the link-level half of the rollback
    journal — the stager additionally checkpoints row-level images).
    `dels` are the OLD links (identity + old properties), which makes
    the inverse round trivially constructible."""

    index: int
    adds: tuple = ()
    changes: tuple = ()
    dels: tuple = ()
    changes_old: tuple = ()

    @property
    def n_edits(self) -> int:
        return len(self.adds) + len(self.changes) + len(self.dels)

    def summary(self) -> dict:
        return {"index": self.index, "adds": len(self.adds),
                "changes": len(self.changes), "dels": len(self.dels)}


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """An ordered, statically-checked schedule for one topology's
    delta. Empty `rounds` means the diff was empty (a noop)."""

    namespace: str
    name: str
    rounds: tuple = ()
    old_links: tuple = ()
    new_links: tuple = ()
    checked: bool = False

    @property
    def key(self) -> str:
        return f"{self.namespace or 'default'}/{self.name}"

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def n_edits(self) -> int:
        return sum(r.n_edits for r in self.rounds)

    def summary(self) -> dict:
        return {"topology": self.key, "rounds": [r.summary()
                                                 for r in self.rounds],
                "edits": self.n_edits, "checked": self.checked}


def inverse_round(rnd: UpdateRound) -> UpdateRound:
    """The round that undoes `rnd`: re-add what it deleted (old
    properties), delete what it added, restore changed links' old
    properties. Same index so rollback logs read naturally."""
    return UpdateRound(index=rnd.index, adds=rnd.dels,
                       changes=rnd.changes_old, dels=rnd.adds,
                       changes_old=rnd.changes)


def _chunks(seq: list, n: int | None):
    if not seq:
        return
    if n is None or n <= 0:
        yield tuple(seq)
        return
    for i in range(0, len(seq), n):
        yield tuple(seq[i:i + n])


def plan_update(old_links, new_links, *, namespace: str = "default",
                name: str = "topology",
                max_round_edits: int | None = None,
                fabric_edges=(), check: bool = True,
                diff=None) -> UpdatePlan:
    """Build the ordered schedule for `old_links → new_links`.

    `max_round_edits` bounds each round's batch (None = one round per
    phase — the fastest consistent schedule; smaller rounds trade speed
    for a finer-grained watch/rollback granularity, the paper's
    augmentation-speed dial). `fabric_edges` is an optional iterable of
    (node, node) pairs for the surrounding realized fabric (other
    topologies' links), so the static check sees detours the delta
    topology alone wouldn't show. Raises `PlanError` when the static
    check finds a transient loop/blackhole (cannot happen for the
    make-before-break order unless the inputs are inconsistent).
    `diff` accepts a precomputed `calc_diff(old, new)` triple — the
    reconciler already holds one for the same lists; recomputing the
    identity-map join twice per delta is measurable at 100k links."""
    old = list(old_links or [])
    new = list(new_links or [])
    add, delete, changed = diff if diff is not None \
        else calc_diff(old, new)
    old_by_id = {_identity(l): l for l in old}
    rounds: list[UpdateRound] = []
    by_uid = lambda l: (l.uid, l.peer_pod, l.local_intf)  # noqa: E731
    for batch in _chunks(sorted(add, key=by_uid), max_round_edits):
        rounds.append(UpdateRound(index=len(rounds), adds=batch))
    for batch in _chunks(sorted(changed, key=by_uid), max_round_edits):
        olds = tuple(old_by_id[_identity(l)] for l in batch)
        rounds.append(UpdateRound(index=len(rounds), changes=batch,
                                  changes_old=olds))
    for batch in _chunks(sorted(delete, key=by_uid), max_round_edits):
        rounds.append(UpdateRound(index=len(rounds), dels=batch))
    plan = UpdatePlan(namespace=namespace or "default", name=name,
                      rounds=tuple(rounds), old_links=tuple(old),
                      new_links=tuple(new))
    if check and rounds:
        check_plan(plan, fabric_edges=fabric_edges)
        plan = dataclasses.replace(plan, checked=True)
    return plan


# -- static loop/blackhole check ---------------------------------------

def _link_edge(key: str, namespace: str, link: Link):
    """(u, v, uid) undirected graph edge of one pod-to-pod link, or
    None for macvlan/physical links (they terminate outside the pod
    graph and cannot carry transit demands)."""
    if link.is_macvlan() or link.is_physical():
        return None
    return (key, f"{namespace or 'default'}/{link.peer_pod}", link.uid)


def _edges_of(key: str, namespace: str, links) -> set:
    out = set()
    for l in links:
        e = _link_edge(key, namespace, l)
        if e is not None:
            out.add(e)
    return out


def _adjacency(edges) -> dict:
    adj: dict = {}
    for u, v, uid in edges:
        adj.setdefault(u, set()).add((v, uid))
        adj.setdefault(v, set()).add((u, uid))
    return adj


def _bfs_dist(adj: dict, target) -> dict:
    """Hop distance of every node to `target` — the routed topology's
    shortest-path metric for the walk check."""
    dist = {target: 0}
    q = deque([target])
    while q:
        u = q.popleft()
        for v, _uid in adj.get(u, ()):
            if v not in dist:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def _next_hop(adj: dict, dist: dict, node):
    """The routed next hop toward the BFS target `dist` was computed
    for: lowest-distance neighbor, ties by (uid, node) — reproducible
    like `next_hop_edges`' lowest-edge-row tie break. None when the
    node has no descending neighbor (unreachable or the target)."""
    dn = dist.get(node)
    if dn is None or dn == 0:
        return None
    best = None
    # str() the tie-break key: link uids are ints, fabric edge ids
    # tuples — a mixed sort must stay total
    for v, uid in sorted(adj.get(node, ()),
                         key=lambda t: (str(t[1]), str(t[0]))):
        dv = dist.get(v)
        if dv is not None and dv < dn and best is None:
            best = v
    return best


def _mixed_state_loop(prev_adj: dict, cur_adj: dict, dst,
                      prev_dist: dict | None = None,
                      cur_dist: dict | None = None) -> list | None:
    """Transient-loop detection for one round transition and one
    destination: a round applies atomically per NODE (each daemon's
    flush barrier), not per fabric, so mid-transition some nodes
    forward on the previous round's next hops while others already use
    the new ones. Build the union functional graph {prev_nh(n),
    cur_nh(n)} toward `dst` and return a cycle as a node list if one
    exists (the consistent-updates loop-freedom condition), else None.
    `prev_dist`/`cur_dist` accept the caller's cached BFS results (one
    BFS per destination per state, not per call)."""
    if prev_dist is None:
        prev_dist = _bfs_dist(prev_adj, dst)
    if cur_dist is None:
        cur_dist = _bfs_dist(cur_adj, dst)
    succ: dict = {}
    for node in set(prev_adj) | set(cur_adj):
        if node == dst:
            continue
        hops = set()
        for adj, dist in ((prev_adj, prev_dist), (cur_adj, cur_dist)):
            nh = _next_hop(adj, dist, node)
            if nh is not None:
                hops.add(nh)
        if hops:
            succ[node] = hops
    # iterative DFS cycle detection over the union graph
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in succ}
    for start in succ:
        if color[start] != WHITE:
            continue
        stack = [(start, iter(succ.get(start, ())))]
        color[start] = GRAY
        path = [start]
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if nxt == dst or nxt not in succ:
                    continue
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    return path[path.index(nxt):] + [nxt]
                if c == WHITE:
                    color[nxt] = GRAY
                    stack.append((nxt, iter(succ.get(nxt, ()))))
                    path.append(nxt)
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
                path.pop()
    return None


def check_plan(plan: UpdatePlan, fabric_edges=(),
               rounds=None) -> list[dict]:
    """Verify the schedule is blackhole-free in every intermediate
    topology AND transient-loop-free across every round transition,
    for the demand pairs connected in BOTH endpoints.

    Blackhole: each demand stays reachable in each intermediate state.
    Loop: per transition (state k-1 → state k) and demand destination,
    the union of both states' next-hop choices must be acyclic — nodes
    cross the round barrier independently (per-daemon), so that union
    is exactly the set of forwarding states the fabric can transit.

    `rounds` overrides the plan's own schedule (the tests drive a
    deliberately-broken order through here). Returns one report dict
    per round; raises `PlanError` on the first violation."""
    key = plan.key
    ns = plan.namespace
    fabric = set()
    for i, pair in enumerate(fabric_edges):
        u, v = pair[0], pair[1]
        uid = pair[2] if len(pair) > 2 else ("fabric", i)
        fabric.add((str(u), str(v), uid))
    old_edges = _edges_of(key, ns, plan.old_links) | fabric
    new_edges = _edges_of(key, ns, plan.new_links) | fabric

    # demand pairs: endpoints the delta touches, restricted to pairs
    # connected in both the old and the new topology (a pair the END
    # state disconnects is the operator's stated intent, not a
    # transient fault)
    schedule = plan.rounds if rounds is None else tuple(rounds)
    touched: set = set()
    for rnd in schedule:
        for l in (*rnd.adds, *rnd.dels):
            e = _link_edge(key, ns, l)
            if e is not None:
                touched.update((e[0], e[1]))
    adj_old, adj_new = _adjacency(old_edges), _adjacency(new_edges)
    demands = []
    nodes = sorted(touched)
    for i, u in enumerate(nodes):
        du = _bfs_dist(adj_old, u)
        dn = _bfs_dist(adj_new, u)
        for v in nodes[i + 1:]:
            if v in du and v in dn:
                demands.append((u, v))

    cur = set(old_edges)
    prev_adj = _adjacency(cur)
    dsts = sorted({v for _u, v in demands} | {u for u, _v in demands})
    # group demands by destination: ONE BFS per destination per round
    # serves every pair aimed at it (and the same cached distances feed
    # the mixed-state check) — per-pair BFS would make a 20-endpoint
    # delta over a big fabric run ~190 traversals per round
    by_dst: dict = {}
    for u, v in demands:
        by_dst.setdefault(v, []).append(u)
    prev_dists = {v: _bfs_dist(prev_adj, v) for v in dsts}
    reports: list[dict] = []
    for rnd in schedule:
        for l in rnd.adds:
            e = _link_edge(key, ns, l)
            if e is not None:
                cur.add(e)
        for l in rnd.dels:
            e = _link_edge(key, ns, l)
            if e is not None:
                cur.discard(e)
        adj = _adjacency(cur)
        cur_dists = {v: _bfs_dist(adj, v) for v in dsts}
        for v, sources in by_dst.items():
            dist = cur_dists[v]
            for u in sources:
                if u not in dist:
                    raise PlanError(
                        f"round {rnd.index + 1}/{len(schedule)} "
                        f"blackholes {u} -> {v}: connected in both "
                        f"endpoints but not in this intermediate state "
                        f"(schedule is not make-before-break)")
        for v in dsts:
            cycle = _mixed_state_loop(prev_adj, adj, v,
                                      prev_dist=prev_dists[v],
                                      cur_dist=cur_dists[v])
            if cycle is not None:
                raise PlanError(
                    f"round {rnd.index + 1}/{len(schedule)}: transient "
                    f"loop toward {v} while nodes straddle the round "
                    f"barrier: {' -> '.join(str(n) for n in cycle)}")
        prev_adj, prev_dists = adj, cur_dists
        reports.append({"index": rnd.index, "edges": len(cur),
                        "demands_checked": len(demands)})
    return reports
