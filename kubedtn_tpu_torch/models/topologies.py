"""Topology model families — generators for the scenario ladder.

Port of kubedtn_tpu/models/topologies.py: the generators are numpy and
copied whole; only load_edge_list_into_state builds torch tensors.

The reference ships hand-written YAML topologies (reference
config/samples/3node.yml, config/samples/tc/*.yaml); at device scale the
topologies in BASELINE.md's ladder (64-node fat-tree → 100k-link Clos) are
generated. Generators emit an array-native EdgeList (structure-of-arrays,
ready for the device) plus converters to Topology CRs for the control-plane
path, so the same model drives both the batched fast path and the full
reconcile pipeline.

Conventions match the reference sample format: per-node Topology with one
Link per incident edge, shared uid on both endpoint views, eth<i> interface
naming, 10.x.y.z/24 point-to-point addressing where applicable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kubedtn_tpu_torch.api.types import (Link, LinkProperties, Topology,
                                         TopologySpec)
from kubedtn_tpu_torch.ops import edge_state as es


@dataclasses.dataclass
class EdgeList:
    """Undirected p2p links in array form (one row per link, not per
    direction — the engine/device layer expands to directed rows)."""

    node_names: list[str]
    a: np.ndarray        # int32[L] endpoint A node index
    b: np.ndarray        # int32[L] endpoint B node index
    uid: np.ndarray      # int32[L] unique link id (1-based like the samples)
    props: np.ndarray    # float32[L, NPROP] shared link properties

    @property
    def n_links(self) -> int:
        return len(self.uid)

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    def directed(self):
        """Expand to directed rows: (src, dst, uid, props), 2L entries —
        each endpoint's egress, the device-array representation."""
        src = np.concatenate([self.a, self.b]).astype(np.int32)
        dst = np.concatenate([self.b, self.a]).astype(np.int32)
        uid = np.concatenate([self.uid, self.uid]).astype(np.int32)
        props = np.concatenate([self.props, self.props]).astype(np.float32)
        return src, dst, uid, props

    def to_topologies(self, namespace: str = "default") -> list[Topology]:
        """Materialize per-node Topology CRs (sample-file format)."""
        links_by_node: dict[int, list[Link]] = {i: [] for i in
                                                range(self.n_nodes)}
        numeric_names = es.PROP_NAMES
        for i in range(self.n_links):
            a, b, uid = int(self.a[i]), int(self.b[i]), int(self.uid[i])
            props = _props_to_strings(self.props[i], numeric_names)
            ia = len(links_by_node[a]) + 1
            ib = len(links_by_node[b]) + 1
            links_by_node[a].append(Link(
                local_intf=f"eth{ia}", peer_intf=f"eth{ib}",
                peer_pod=self.node_names[b], uid=uid, properties=props))
            links_by_node[b].append(Link(
                local_intf=f"eth{ib}", peer_intf=f"eth{ia}",
                peer_pod=self.node_names[a], uid=uid, properties=props))
        return [
            Topology(name=self.node_names[i], namespace=namespace,
                     spec=TopologySpec(links=links_by_node[i]))
            for i in range(self.n_nodes)
        ]


def _props_to_strings(row: np.ndarray, names) -> LinkProperties:
    """Invert props_row: numeric row back to string-typed LinkProperties."""
    d = {n: float(v) for n, v in zip(names, row)}

    def us(v):
        # integer microseconds: never scientific notation, always matches
        # the CRD duration pattern
        return "" if v == 0 else f"{int(v)}us"

    def pc(v):
        if v == 0:
            return ""
        s = f"{v:.8f}".rstrip("0").rstrip(".")
        return s if s else "0"

    return LinkProperties(
        latency=us(d["latency_us"]),
        latency_corr=pc(d["latency_corr"]),
        jitter=us(d["jitter_us"]),
        loss=pc(d["loss"]),
        loss_corr=pc(d["loss_corr"]),
        rate="" if d["rate_bps"] == 0 else f"{int(d['rate_bps'])}bit",
        gap=int(d["gap"]),
        duplicate=pc(d["duplicate"]),
        duplicate_corr=pc(d["duplicate_corr"]),
        reorder_prob=pc(d["reorder_prob"]),
        reorder_corr=pc(d["reorder_corr"]),
        corrupt_prob=pc(d["corrupt_prob"]),
        corrupt_corr=pc(d["corrupt_corr"]),
    )


def _mk(node_names, pairs, props: LinkProperties | None = None,
        prop_rows: np.ndarray | None = None) -> EdgeList:
    pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
    L = len(pairs)
    if prop_rows is None:
        row = np.asarray(es.props_row(
            (props or LinkProperties()).to_numeric()), np.float32)
        prop_rows = np.broadcast_to(row, (L, es.NPROP)).copy()
    return EdgeList(
        node_names=list(node_names),
        a=pairs[:, 0].copy(),
        b=pairs[:, 1].copy(),
        uid=np.arange(1, L + 1, dtype=np.int32),
        props=prop_rows.astype(np.float32),
    )


def line(n: int, props: LinkProperties | None = None) -> EdgeList:
    names = [f"n{i}" for i in range(n)]
    return _mk(names, [(i, i + 1) for i in range(n - 1)], props)


def ring(n: int, props: LinkProperties | None = None) -> EdgeList:
    names = [f"n{i}" for i in range(n)]
    return _mk(names, [(i, (i + 1) % n) for i in range(n)], props)


def star(n_leaves: int, props: LinkProperties | None = None) -> EdgeList:
    names = ["hub"] + [f"leaf{i}" for i in range(n_leaves)]
    return _mk(names, [(0, i + 1) for i in range(n_leaves)], props)


def full_mesh(n: int, props: LinkProperties | None = None) -> EdgeList:
    names = [f"r{i + 1}" for i in range(n)]
    return _mk(names, [(i, j) for i in range(n) for j in range(i + 1, n)],
               props)


def random_mesh(n_nodes: int, n_links: int, seed: int = 0,
                props: LinkProperties | None = None) -> EdgeList:
    """Random connected-ish mesh: a spanning backbone plus random extra
    links (no self-loops; parallel links allowed, distinct uids — matching
    the reference's model where uid, not endpoints, identifies a link)."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(n_nodes)]
    backbone = [(i, rng.integers(0, i)) for i in range(1, min(n_nodes,
                                                              n_links + 1))]
    extra = n_links - len(backbone)
    pairs = list(backbone)
    if extra > 0:
        a = rng.integers(0, n_nodes, extra)
        off = rng.integers(1, n_nodes, extra)
        b = (a + off) % n_nodes
        pairs += list(zip(a.tolist(), b.tolist()))
    return _mk(names, pairs, props)


def three_tier(pods: int = 100, leaves_per_pod: int = 96,
               aggs_per_pod: int = 4, cores: int = 40,
               uplinks_per_leaf: int = 2, cores_per_agg: int = 10,
               seed: int = 0,
               props: LinkProperties | None = None) -> EdgeList:
    """Three-tier DC fabric at cluster scale: `pods` pods of
    leaves + aggs, a shared core layer — the 10k-node structured
    topology for the flap-reconvergence rung (a k8s cluster network's
    shape, unlike random_mesh's high-betweenness sparse graph). Each
    leaf uplinks to `uplinks_per_leaf` of its pod's aggs, each agg to
    `cores_per_agg` cores. Per-link latencies get a deterministic ±10%
    spread (seeded) so shortest paths are mostly unique — the
    realistic-reconvergence regime rather than the all-ties one.

    Defaults: 100*(96+4)+40 = 10_040 nodes, 100*96*2 + 100*4*10 =
    23_200 links."""
    rng = np.random.default_rng(seed)
    names = [f"core{c}" for c in range(cores)]
    names += [f"p{p}-agg{a}" for p in range(pods)
              for a in range(aggs_per_pod)]
    names += [f"p{p}-leaf{i}" for p in range(pods)
              for i in range(leaves_per_pod)]
    agg0 = cores
    leaf0 = cores + pods * aggs_per_pod
    pairs = []
    for p in range(pods):
        for i in range(leaves_per_pod):
            leaf = leaf0 + p * leaves_per_pod + i
            for u in range(uplinks_per_leaf):
                agg = agg0 + p * aggs_per_pod + (i + u) % aggs_per_pod
                pairs.append((leaf, agg))
        for a in range(aggs_per_pod):
            agg = agg0 + p * aggs_per_pod + a
            for c in range(cores_per_agg):
                core = (a * cores_per_agg + c + p) % cores
                pairs.append((agg, core))
    el = _mk(names, pairs, props)
    base = el.props[:, es.P_LATENCY_US].copy()
    base = np.where(base > 0, base, 1000.0)
    el.props[:, es.P_LATENCY_US] = base * rng.uniform(0.9, 1.1,
                                                      el.n_links)
    return el


def fat_tree(k: int, props: LinkProperties | None = None) -> EdgeList:
    """Standard k-ary fat-tree (k even): (k/2)² cores, k pods of k/2 agg +
    k/2 edge switches, k²/4 core-agg links per pod side, agg-edge full
    bipartite within pods. k=8 → 80 switches, 256 links (the 64-node-scale
    scenario of BASELINE.md's ladder)."""
    assert k % 2 == 0, "fat-tree arity must be even"
    half = k // 2
    cores = [f"core{i}" for i in range(half * half)]
    aggs = [f"pod{p}-agg{i}" for p in range(k) for i in range(half)]
    edges = [f"pod{p}-edge{i}" for p in range(k) for i in range(half)]
    names = cores + aggs + edges
    idx = {n: i for i, n in enumerate(names)}
    pairs = []
    for p in range(k):
        for i in range(half):
            agg = idx[f"pod{p}-agg{i}"]
            # each agg connects to half cores: core group i*half..i*half+half
            for j in range(half):
                pairs.append((idx[f"core{i * half + j}"], agg))
            # full bipartite agg-edge inside the pod
            for e in range(half):
                pairs.append((agg, idx[f"pod{p}-edge{e}"]))
    return _mk(names, pairs, props)


def clos(n_spine: int, n_leaf: int, hosts_per_leaf: int = 0,
         props: LinkProperties | None = None,
         links_per_pair: int = 1) -> EdgeList:
    """2-tier spine-leaf Clos: every leaf connects to every spine
    (`links_per_pair` parallel links each), plus optional hosts per leaf.
    clos(100, 500, 0, links_per_pair=2) = 100_000 fabric links — the
    100k-link BASELINE scenario bench.py runs."""
    spines = [f"spine{i}" for i in range(n_spine)]
    leaves = [f"leaf{i}" for i in range(n_leaf)]
    hosts = [f"leaf{i}-h{j}" for i in range(n_leaf)
             for j in range(hosts_per_leaf)]
    names = spines + leaves + hosts
    pairs = []
    for li in range(n_leaf):
        leaf = n_spine + li
        for si in range(n_spine):
            for _ in range(links_per_pair):
                pairs.append((si, leaf))
        for j in range(hosts_per_leaf):
            pairs.append((leaf, n_spine + n_leaf + li * hosts_per_leaf + j))
    return _mk(names, pairs, props)


def torus(dims: tuple[int, ...] | list[int],
          props: LinkProperties | None = None) -> EdgeList:
    """k-ary n-dimensional torus (wraparound grid) — the ICI topology of a
    TPU pod itself, and a standard HPC interconnect. torus((4, 4)) = 16
    nodes, 32 links; torus((4, 4, 4)) = 64 nodes, 192 links."""
    dims = tuple(int(d) for d in dims)
    assert all(d >= 2 for d in dims), "each torus dimension needs >= 2 nodes"
    shape = np.array(dims)
    n = int(shape.prod())
    coords = np.stack(np.unravel_index(np.arange(n), dims), axis=1)
    names = ["t" + "-".join(str(c) for c in row) for row in coords]
    pairs = []
    for axis, d in enumerate(dims):
        nxt = coords.copy()
        nxt[:, axis] = (nxt[:, axis] + 1) % d
        nbr = np.ravel_multi_index(tuple(nxt.T), dims)
        for i in range(n):
            j = int(nbr[i])
            # a dimension of size 2 has a single link per pair, not two
            if d == 2 and j < i:
                continue
            pairs.append((i, j))
    return _mk(names, pairs, props)


def hypercube(d: int, props: LinkProperties | None = None) -> EdgeList:
    """d-dimensional binary hypercube: 2^d nodes, d·2^(d-1) links."""
    n = 1 << d
    names = [f"h{i:0{max(d, 1)}b}" for i in range(n)]
    pairs = [(i, i ^ (1 << bit)) for i in range(n) for bit in range(d)
             if i < (i ^ (1 << bit))]
    return _mk(names, pairs, props)


def dragonfly(groups: int, routers_per_group: int,
              global_links_per_router: int = 1,
              props: LinkProperties | None = None) -> EdgeList:
    """Dragonfly: fully-meshed groups joined by global links spread
    round-robin over the routers of each group (the Cray/Slingshot-style
    hierarchical low-diameter fabric)."""
    g, a, h = groups, routers_per_group, global_links_per_router
    assert g >= 2 and a >= 1 and h >= 1
    names = [f"g{gi}-r{ri}" for gi in range(g) for ri in range(a)]
    pairs = []
    for gi in range(g):
        base = gi * a
        pairs.extend((base + i, base + j)
                     for i in range(a) for j in range(i + 1, a))
    # global channels: g·(g-1)/2 group pairs, each realized h times,
    # endpoints rotated through the group's routers
    counter = [0] * g
    for gi in range(g):
        for gj in range(gi + 1, g):
            for _ in range(h):
                ri = counter[gi] % a
                rj = counter[gj] % a
                counter[gi] += 1
                counter[gj] += 1
                pairs.append((gi * a + ri, gj * a + rj))
    return _mk(names, pairs, props)


def barabasi_albert(n: int, m: int = 2, seed: int = 0,
                    props: LinkProperties | None = None) -> EdgeList:
    """Scale-free preferential-attachment graph (Barabási–Albert): each
    new node attaches to m existing nodes with probability proportional
    to degree — heavy-tailed AS-/internet-like topologies."""
    assert 1 <= m < n
    rng = np.random.default_rng(seed)
    names = [f"as{i}" for i in range(n)]
    pairs: list[tuple[int, int]] = []
    # attachment pool: every edge endpoint once (degree-proportional draw)
    pool: list[int] = []
    for new in range(m, n):
        if not pool:
            targets = list(range(new))[:m]
        else:
            targets = []
            seen: set[int] = set()
            while len(targets) < m:
                t = int(pool[rng.integers(0, len(pool))])
                if t not in seen and t != new:
                    seen.add(t)
                    targets.append(t)
        for t in targets:
            pairs.append((new, t))
            pool.extend((new, t))
    return _mk(names, pairs, props)


def watts_strogatz(n: int, k: int = 4, beta: float = 0.1, seed: int = 0,
                   props: LinkProperties | None = None) -> EdgeList:
    """Small-world ring lattice with rewiring (Watts–Strogatz): each node
    starts linked to its k nearest ring neighbors; each link's far end is
    rewired with probability beta."""
    assert k % 2 == 0 and k < n
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(n)]
    existing: set[tuple[int, int]] = set()
    pairs = []
    for i in range(n):
        for off in range(1, k // 2 + 1):
            j = (i + off) % n
            key = (min(i, j), max(i, j))
            if key in existing:
                continue
            if rng.random() < beta:
                for _ in range(8):  # bounded retries
                    cand = int(rng.integers(0, n))
                    ck = (min(i, cand), max(i, cand))
                    if cand != i and ck not in existing:
                        key = ck
                        break
            existing.add(key)
            pairs.append(key)
    return _mk(names, pairs, props)


def geo_wan(n: int, degree: int = 3, seed: int = 0,
            rate: str = "10Gbit") -> EdgeList:
    """Geographic WAN: n sites at random plane coordinates (km), each
    linked to its `degree` nearest neighbors, with per-link latency from
    fiber distance (~5 µs/km — the c/1.5 rule of thumb). Unlike the other
    families every link gets its own property row, exercising the
    heterogeneous-props path end to end."""
    assert n >= 2 and 1 <= degree < n, "need n >= 2 and 1 <= degree < n"
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 5000.0, (n, 2))  # continental scale, km
    names = [f"site{i}" for i in range(n)]
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    pairs = []
    seen: set[tuple[int, int]] = set()
    # spanning backbone first (like random_mesh): each site links to its
    # geographically nearest already-placed site, so the WAN is connected
    # regardless of how the k-NN extras fall
    for i in range(1, n):
        j = int(np.argmin(d2[i, :i]))
        seen.add((j, i))
        pairs.append((j, i))
    order = np.argsort(d2, axis=1)
    for i in range(n):
        for j in order[i, :degree]:
            key = (min(i, int(j)), max(i, int(j)))
            if key not in seen:
                seen.add(key)
                pairs.append(key)
    pairs_arr = np.asarray(pairs, np.int32)
    km = np.sqrt(d2[pairs_arr[:, 0], pairs_arr[:, 1]])
    base = es.props_row(LinkProperties(rate=rate).to_numeric())
    prop_rows = np.broadcast_to(np.asarray(base, np.float32),
                                (len(pairs), es.NPROP)).copy()
    lat_col = es.PROP_NAMES.index("latency_us")
    prop_rows[:, lat_col] = np.maximum(1.0, np.round(km * 5.0))
    return _mk(names, pairs, prop_rows=prop_rows)


FAMILIES = {
    "line": line, "ring": ring, "star": star, "full_mesh": full_mesh,
    "random_mesh": random_mesh, "fat_tree": fat_tree, "clos": clos,
    "torus": torus, "hypercube": hypercube, "dragonfly": dragonfly,
    "barabasi_albert": barabasi_albert, "watts_strogatz": watts_strogatz,
    "geo_wan": geo_wan,
}


def random_link_props(n: int, seed: int,
                      rates=(20e6, 50e6, 100e6, 1e9, 10e9)) -> np.ndarray:
    """n random-but-valid numeric property rows — the shared benchmark
    workload (bench.py's headline and the scale_1m rung must draw from
    the SAME distribution so their updates/sec numbers stay comparable):
    latency 1-100ms, jitter 0-5ms, loss 0-2%, rate drawn from `rates`."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n, es.NPROP), np.float32)
    base[:, es.P_LATENCY_US] = rng.integers(1_000, 100_000, n)
    base[:, es.P_JITTER_US] = rng.integers(0, 5_000, n)
    base[:, es.P_LOSS] = rng.uniform(0, 2, n)
    base[:, es.P_RATE_BPS] = rng.choice(np.asarray(rates), n)
    return base


def load_edge_list_into_state(el: EdgeList, capacity: int | None = None,
                              device=None):
    """Fast path: place a generated topology directly into a fresh
    EdgeState on `device` (None = the CUDA card), bypassing the per-link
    control plane. Returns (state, rows) where rows[i] is the row of
    directed edge i (a host array)."""
    src, dst, uid, props = el.directed()
    n = len(src)
    if capacity is None:
        capacity = max(8, int(2 ** np.ceil(np.log2(n + 1))))
    state = es.init_state(capacity, device)
    rows = np.arange(n, dtype=np.int32)
    state = es.apply_links(state, rows, uid, src, dst, props,
                           np.ones(n, dtype=bool))
    return state, rows
