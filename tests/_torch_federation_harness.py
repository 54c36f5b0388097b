"""Two federated planes and a lockstep tick loop for the migration
tests, built the same way from either package's modules.

The shape is tests/test_federation.py's: each plane hosts its tenants'
`PAIRS` pod pairs (one link each, the tenant's props), a background
tenant keeps every plane dispatching on every tick (the per-tick key
chains of the reference, src and dst planes stay aligned), and the
migrated tenant's feed pauses for the ticks [GAP_START, GAP_END) so the
migration lands inside a feed gap. `reference` is the never-migrated
stream; `run_migrated` moves the tenant from plane A to plane B through
the package's FederationController, optionally with a chaos fault at one
step followed by resume or rollback.

Imports neither jax nor the JAX package at import time: the card tests
(tests/test_torch_cuda.py, run without tests/conftest.py) use it with
the port's modules.
"""

from __future__ import annotations

import importlib
import tempfile

from _torch_tenant_harness import mods, wire_def

PAIRS = 2
DT = 0.002
FPT = 3            # frames per migrated-tenant ingress wire and fed tick
T_TOTAL, GAP_START, GAP_END = 60, 20, 35
TAIL = 60
# mig draws (jitter + loss: the keyed uniforms must move with the link);
# bg / bg2 keep both planes dispatching every tick
PROPS = {"mig": dict(latency="2ms", jitter="1ms", loss="10"),
         "bg": dict(latency="1ms"), "bg2": dict(latency="1ms")}
# deterministic links only, for the cross-package comparisons (threefry
# and Philox draw different bits); the TBF rate keeps the dynamic
# columns busy (tokens below burst, backlog in the future at the fork)
DET_PROPS = {"mig": dict(latency="2ms", rate="9Mbit"),
             "bg": dict(latency="1ms"), "bg2": dict(latency="1ms")}


def fmods(pkg: str):
    """mods(pkg) plus the package's federation, journal and chaos
    modules."""
    m = mods(pkg)
    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    m.fed = importlib.import_module(f"{root}.federation")
    m.journal = importlib.import_module(f"{root}.federation.journal")
    m.chaos = importlib.import_module(f"{root}.chaos")
    return m


def build_plane(m, tenants, depth: int = 1, seed: int = 0,
                addr: str = "10.0.0.1", props=None, device="cpu",
                capacity: int | None = None, telemetry: bool = False):
    """(daemon, plane, registry) over package `m` hosting `tenants`'
    topologies: PAIRS pod pairs a tenant, uids index(tenant in the sorted
    props) * PAIRS + i + 1, wires on both ends of each link; with
    `telemetry`, the plane's window ring on (one 10 s window)."""
    props = props or PROPS
    names = sorted(props)
    store = m.st.TopologyStore()
    kw = {"device": device} if m.pkg == "torch" else {}
    engine = m.eng.SimEngine(
        store, capacity=capacity or 4 * PAIRS * len(names) + 8,
        node_ip=addr, **kw)
    registry = m.ten.TenantRegistry(engine)
    for ns in tenants:
        registry.create(ns)
        lp = m.ty.LinkProperties(**props[ns])
        base = names.index(ns) * PAIRS
        for i in range(PAIRS):
            uid = base + i + 1
            a, b = f"{ns}-a{i}", f"{ns}-b{i}"
            for x, y in ((a, b), (b, a)):
                store.create(m.ty.Topology(
                    name=x, namespace=ns, spec=m.ty.TopologySpec(links=[
                        m.ty.Link(local_intf="eth1", peer_intf="eth1",
                                  peer_pod=y, uid=uid, properties=lp)])))
            engine.setup_pod(a, ns)
            engine.setup_pod(b, ns)
    m.rec.Reconciler(store, engine).drain()
    daemon = m.srv.Daemon(engine)
    if m.pkg == "jax":
        from _torch_native_guard import ensure_jax_native

        ensure_jax_native()
    plane = m.rt.WireDataPlane(daemon, dt_us=DT * 1e6,
                               pipeline_depth=depth, seed=seed)
    if m.pkg == "jax":
        from _torch_native_guard import assert_jax_wheel

        assert_jax_wheel(plane)
    plane.pipeline_explicit_clock = True
    plane.attach_tenancy(registry)
    if telemetry:
        plane.enable_telemetry(window_s=10.0, sample_period=4)
    for ns in tenants:
        base = names.index(ns) * PAIRS
        for i in range(PAIRS):
            for side in "ab":
                daemon._add_wire(wire_def(f"{ns}-{side}{i}", ns,
                                          base + i + 1))
    return daemon, plane, registry


def tagged(ns: str, wire_i: int, j: int, size: int = 64) -> bytes:
    tag = f"{ns}/{wire_i}".encode()
    return tag + j.to_bytes(4, "big") + b"\x00" * (size - len(tag) - 4)


def wire(daemon, ns: str, side: str, i: int, props=None):
    base = sorted(props or PROPS).index(ns) * PAIRS
    return daemon.wires.get_by_key(f"{ns}/{ns}-{side}{i}", base + i + 1)


class Harness:
    """Lockstep ticks over one or two planes; the tick index
    drives the clocks and the frame tags, so two harnesses on one feed
    schedule give comparable streams, one of them with a migration in
    the middle."""

    def __init__(self, planes, bg_map, props=None, frame_bytes: int = 64):
        self.planes = planes          # [(daemon, plane)]
        self.bg_map = bg_map          # id(daemon) -> background tenant
        self.props = props or PROPS
        self.frame_bytes = frame_bytes
        self.k = 0
        self.deliv = [[] for _ in range(PAIRS)]
        # the tick each delivered frame came out on: byte identity alone
        # misses a rate-limited row that restarted from a full bucket
        self.ticks = [[] for _ in range(PAIRS)]
        self.fed = 0

    @property
    def t(self) -> float:
        return 100.0 + self.k * DT

    def feed_mig(self, daemon) -> None:
        for i in range(PAIRS):
            w = wire(daemon, "mig", "a", i, self.props)
            for n in range(FPT):
                w.ingress.append(tagged("mig", i, self.k * FPT + n,
                                        self.frame_bytes))
        self.fed += FPT * PAIRS

    def drain(self) -> None:
        for d, _p in self.planes:
            for i in range(PAIRS):
                w = wire(d, "mig", "b", i, self.props)
                if w is None:
                    continue
                while True:
                    try:
                        self.deliv[i].append(w.egress.popleft())
                    except IndexError:
                        break
                    self.ticks[i].append(self.k)

    def tick(self) -> None:
        self.k += 1
        for d, p in self.planes:
            bg = self.bg_map[id(d)]
            for i in range(PAIRS):
                wire(d, bg, "a", i, self.props).ingress.extend(
                    tagged(bg, i, self.k * 2 + n) for n in range(2))
            p.tick(now_s=self.t)
        self.drain()

    def finish(self) -> None:
        for _ in range(TAIL):
            self.tick()
        for _d, p in self.planes:
            p.flush()
        self.k += 5000
        for _d, p in self.planes:
            p.tick(now_s=self.t)
        self.drain()
        for _d, p in self.planes:
            assert p.tick_errors == 0


def reference(m, depth: int = 1, props=None, frame_bytes: int = 64,
              device="cpu"):
    """The never-migrated stream: one plane hosting mig + bg on the same
    schedule. Returns (per-wire deliveries, fed, mig's tenant_counters,
    per-wire delivery ticks)."""
    d, p, r = build_plane(m, ["bg", "mig"], depth=depth, props=props,
                          device=device)
    h = Harness([(d, p)], {id(d): "bg"}, props, frame_bytes)
    while h.k < T_TOTAL:
        if h.k < GAP_START or h.k >= GAP_END:
            h.feed_mig(d)
        h.tick()
    h.finish()
    return h.deliv, h.fed, r.tenant_counters(p, "mig"), h.ticks


def federation(m, depth: int = 1, props=None, root=None, chaos=None,
               stats=None, device="cpu", telemetry: bool = False,
               capacity: int | None = None, shards: int | None = None):
    """Planes A (bg + mig, 10.0.0.1; on `shards` virtual shards when
    given) and B (bg2, 10.0.0.2), one seed, registered with a
    FederationController over `root` (a new temp dir when None).
    Returns (fed, (d_s, p_s, r_s), (d_d, p_d, r_d), root)."""
    kw = dict(depth=depth, props=props, device=device,
              telemetry=telemetry, capacity=capacity)
    src = build_plane(m, ["bg", "mig"], addr="10.0.0.1", **kw)
    dst = build_plane(m, ["bg2"], addr="10.0.0.2", **kw)
    if shards:
        src[1].enable_sharding(n_devices=shards)
    root = root or tempfile.mkdtemp(prefix="kdt-fed-test-")
    fed = m.fed.FederationController(
        root, stats=stats or m.fed.MigrationStats(), chaos=chaos)
    fed.register(m.fed.PlaneHandle("A", *src))
    fed.register(m.fed.PlaneHandle("B", *dst))
    return fed, src, dst, root


def run_migrated(m, depth: int = 1, fail_step=None, do: str = "resume",
                 restart_controller: bool = False,
                 neighbor_wire: bool = False, props=None,
                 frame_bytes: int = 64, device="cpu", on_fork=None,
                 telemetry: bool = False, stop_after_fault: bool = False,
                 capacity: int | None = None, shards: int | None = None):
    """Two federated planes in lockstep; the migration runs inside the
    feed gap (settle = harness ticks). `on_fork(arrays)` sees the fork's
    arrays. With `stop_after_fault`, returns right after the injected
    fault (the journal holds the steps committed before it) as (None,
    harness, None, stats, controller). Returns (record, harness,
    accounting, stats, controller)."""
    stats = m.fed.MigrationStats()
    chaos = m.chaos.ChaosInjector(seed=1)
    if fail_step:
        chaos.fail_migration_step(fail_step)
    fed, src, dst, root = federation(m, depth, props, chaos=chaos,
                                     stats=stats, device=device,
                                     telemetry=telemetry,
                                     capacity=capacity, shards=shards)
    (d_s, p_s, r_s), (d_d, p_d, r_d) = src, dst
    if neighbor_wire:
        # a dst wire in the tenant's namespace that the migration did
        # NOT create: the undo must leave it alone
        d_d._add_wire(wire_def("neighbor", "mig", 9999))
    h = Harness([(d_s, p_s), (d_d, p_d)], {id(d_s): "bg", id(d_d): "bg2"},
                props, frame_bytes)
    while h.k < GAP_START:
        h.feed_mig(d_s)
        h.tick()
    rolled = False
    if on_fork is not None:
        real = m.fed.MigrationCoordinator._step_fork

        def step_fork(co):
            real(co)
            on_fork(co._fork_arrays, co)

        m.fed.MigrationCoordinator._step_fork = step_fork
    try:
        rec = fed.migrate("mig", "A", "B", settle=h.tick,
                          reconcile_timeout_s=10.0)
        mid = rec["migration_id"]
    except m.chaos.ChaosError:
        if stop_after_fault:
            return None, h, None, stats, fed
        mid = fed.status(tenant="mig")[-1]["migration_id"]
        if restart_controller:
            # a daemon restart: a FRESH controller over the same journal
            # root rebuilds the coordinator from disk
            fed = m.fed.FederationController(root, stats=stats)
            fed.register(m.fed.PlaneHandle("A", d_s, p_s, r_s))
            fed.register(m.fed.PlaneHandle("B", d_d, p_d, r_d))
        co = fed.coordinator(mid)
        co.settle = h.tick
        if do == "resume":
            rec = co.resume()
        else:
            rec = co.rollback()
            rolled = True
    finally:
        if on_fork is not None:
            m.fed.MigrationCoordinator._step_fork = real
    assert h.k < GAP_END, f"migration overran the feed gap: k={h.k}"
    while h.k < GAP_END:
        h.tick()
    target = d_s if rolled else d_d
    while h.k < T_TOTAL:
        h.feed_mig(target)
        h.tick()
    h.finish()
    acct = None
    if not rolled:
        acct = fed.coordinator(mid).check_accounting(h.fed)
    return rec, h, acct, stats, fed
