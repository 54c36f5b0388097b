"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 1-4,19  # some phases (1 always runs;
                                           # 3 and 4, 10, 11, 14, 22 and
                                           # 25 bring 2 and 3; 6, 7 and
                                           # 8 go together)
    python3 chip_smoke.py --phases 20 --daemon-rate  # + the daemon's rate

Drives kubedtn_tpu_torch's main path at the BASELINE size — the
100k-link Clos (200,000 directed rows in capacity 2^18), churned by
batched UpdateLinks and shaped through netem -> TBF by the drop-in step
(kernel K1) and the fused steady-state steps (kernels K2 and K3) — then
the live tick's device program on the same Clos, unsharded and sharded
(its mailbox ring steps are kernel K4), then the K-slot simulator and
the routed fabric (each shaping slot one launch of K1), and holds every
kernel against its plain torch version on the card at those shapes and
times both.

Phases, each fatal on failure:
  1. the card (nvidia-smi) and the kernels' build (set-up time);
  2. the Clos on the card;
  3. the main path, with the launch counts set to 0 just before it and
     read just after: UpdateLinks (contiguous and scattered), drop-in
     steps, fused steps with given and with in-kernel uniforms;
  4. K1 and K2 against their plain versions; K3 bit for bit against K2
     fed the same Philox draws, its loss share against the configured
     loss, flag_counts against a host count; K3 timed at S = 10 and 1;
  5. the fat-tree entry step against known one-way delays;
  6. the live tick, unsharded: a fresh Clos reshaped into the three
     kernel classes, 4,000 busy rows per class (padded to 4,096), K = 64
     slots; 2 chained ticks through fused_tick and the same 2 through
     the per-class ladder, bit for bit equal (8 until phase 21 joined,
     PERF.md §4);
  7. the sharded tick on S = 2 and 4 virtual shards of the one card,
     with the launch counts set to 0 just before and read just after:
     bit for bit the unsharded tick; K4 must have launched;
  8. the sharded tick over two cards when there are two or more (a line
     says so when there are not);
  9. K4 alone against its plain version, bit for bit, at R = 4,096 and
     32,768, one launch per ring step on the card, timed against its byte
     bound and torch.roll;
 10. the K-slot simulator (sim.run) on the churned Clos, CBR on all
     200,000 rows, 4 slots and a 128-slot delay line per edge, 200 steps
     of 1 ms, the launch counts set to 0 just before: K1 launched once
     per slot and step; per edge the books close exactly (offered +
     duplicates == delivered + lost + queue-dropped + ring-dropped + in
     flight); the same run over the plain step is bit for bit the same
     state; 10 steps equal the port's CPU run on the same draws; every
     drop class is raised; wall and device time per step, K1's share;
 11. the routed fabric: recompute_routes and its ECMP form equal the
     port's CPU result bit for bit, every next hop realises its
     distance, leaves reach leaves; an event on the 10 links that carry
     the most routes (down, then up again) through
     update_routes_incremental equals a full recompute and restores the
     first distances; run_routed for 50 steps (each
     leaf's uplink rows bound for another leaf), the launch counts set
     to 0 just before: K1 once per slot and step, the per-edge books and
     the fabric's transit balance close, no packet without a route, a
     rerun gives the same bits, and so does the same run over the plain
     step (K1 on 12 slots a step, pending lanes included);
 12. the host live plane, with the launch counts set to 0 just before:
     (a) 600 Topology CRs through the store, the reconciler and the
     SimEngine on the card (reconcile-to-steady timed), the realized
     columns == a CPU engine's from the same CRs, then one 1,000-link
     UpdateLinks through the Daemon's Local handler (state == the CPU
     engine's again); (d) ping on a 10 ms link (K1): one-way == 10 ms and
     == the plain step; (b) 3 x 4,096 links re-shaped into the three
     kernel classes by UpdateLinks, wires on both ends, 1-64 tagged
     frames per ingress wire and tick for 2 ticks of 10 ms (16 until
     phase 16, then 10; 6 since a whole run with phase 19 took 948.8 s
     against the script's 898 s bound; 4 since phase 20, 2 since phase
     21, PERF.md §4),
     drained:
     depth 1 (telemetry off) == depth 2 (telemetry on), byte for byte
     per wire (digests),
     the books close per edge, the window totals == the counters, the
     TBF fallback ran; wall and device time per tick, the busy share,
     frames shaped per second; (c) the same on 2 virtual shards (K4) and
     on two cards where there are two: == unsharded; (e) where grpc and
     protobuf import: the real-time runner behind a gRPC server, 8 pairs
     at 5 ms, 20,000 frames per wire over SendToBulk from a client
     process, all delivered in order, median frames/s of 3 rounds;
 13. two daemons in this process, each behind a real gRPC server on
     127.0.0.1, both engines on the card, the launch counts set to 0
     just before: (a) the Clos's 600 CRs with leaves 0-61 placed on node
     B and every other pod on node A (12,400 cross-node links); each
     node's reconciler realizes its own pods, the far ends through
     Remote.Update (reconcile-to-steady timed), both nodes' realized
     columns == two CPU nodes' from the same CRs; (b) the first 3 x
     4,096 cross-node links re-shaped into phase 12's three classes, B's
     wire ends by AddGRPCWireRemote, A's ends pointing at them; phase
     12's feed for 3 ticks at depth 1 through A's plane, whose released
     frames stage in the 4 MiB remote ring and cross to B over
     SendToBulk: the books close (per edge; released == staged +
     ring-dropped, charged per row; staged == sent + queue-dropped +
     forwarding errors; sent == arrived at B's pod side), the ring-drop
     share, wall ms per tick and frames/s arrived at B reported; (c) 1
     frame per wire and tick for 16 ticks (fits the ring: 0 ring and
     queue drops): B's pod-side egress per wire is the same at depth 1,
     at depth 2 with telemetry and at depth 2 under a 50 ms / 50 % flap
     of B (breaker opened, retried, no forwarding error); on 4 ticks of
     it, B answering SendToBulk UNIMPLEMENTED (the per-frame
     SendToStream fallback) == the bulk transport;
 14. the what-if twin and the planned-update path, K1's launches counted
     from 0 around each measured run: (a) snapshot_from_engine of the
     Clos through the control plane (200,000 rows in 2^18, Q = 32) and
     15 scenarios (degrades, failures, a spine and a leaf blackholed by
     name, offered load x 1.5 and x 0.5) swept as 15 x 262,144 replica
     rows for 20 steps of 1 ms (cut from the WhatIf default of 1,000;
     200 until that run went over the bound, 100 until phase 20, 50
     until phase 21, PERF.md §4),
     each shaping slot ONE K1 launch over all rows, the uniforms shared:
     per replica and edge the books close; replica 0 == sim.run; the
     first 8 scenarios alone == their lanes; 2 steps through K1 == the
     plain version, bit for bit; K1 at 3,932,160 rows timed against its
     bound; ms per step, replica-steps/s, busy share, peak memory;
     (b) a 4-lane routed sweep of 10 steps (50 until phase 21, 20
     until phase 24) on the
     Clos with its routes:
     replica 0 == run_routed bit for bit; (c) phase 12's daemon and
     classes, its plane in the real-time runner at depth 2 behind a gRPC
     server: a WhatIf of 4 scenarios x 50 ticks (100 until phase 24)
     while phase 12's feed
     flows, every frame fed shaped or queue-dropped and delivered; the
     snapshot barrier's cost; (d) a latency change on 64 links of one
     leaf through the planned reconciler (plan, the twin gate at full
     capacity, staged rounds) while the plane ticks: the engine's
     configuration columns == the change applied directly to a copy,
     byte for byte;
 15. checkpoint and restart, K1's launches counted from 0 around the
     phase: phase 12's daemon with its Prometheus exporter and a tenancy
     registry (the "default" tenant owns all 200,000 rows), its classes
     and wires, at depth 1 on an explicit clock; (a) 2 feed ticks (4
     until phase 20, 3 until phase 21, PERF.md §4), the next tick's feed
     queued, save_live (seconds, the checkpoint_save pause, directory
     bytes, frames pending and ingress captured), then 2 more fed ticks
     (3 until phase 21) and the drain; (e) 2 scrapes of /metrics over
     HTTP (3 until phase 21):
     the interface_* sums and node totals == the plane's counters, the
     10,000-series cap and its truncation gauge, the request histogram
     counting the daemon's UpdateLinks calls; (b) entry.restore_daemon
     from the directory alone at the cut's clock: every EdgeState column,
     the wires, the counters and the registry (export_config,
     rows_of("default")) == the cut's, the same 3 fed ticks and
     the drain: the TBF-only and delay-only wires release the same bytes
     on the same ticks as the uninterrupted daemon, every frame pending
     at the cut delivered exactly once; (c) a truncated edge_state.npz:
     load_or_rebuild rebuilds from the store and logs the typed error; a
     crash between the renames (only <dir>.prev left): load restores that
     generation bit for bit; (d) save_snapshot / load_snapshot of phase
     14's fork base onto the card: a 2-lane sweep's replica 0 == the
     in-memory snapshot's, bit for bit; (f) kdt_ext's slice_frames ==
     the Python path on phase 12's feed (or the reason it is not built);
 16. tenancy and shared-memory ingest, K1's and K4's launches counted from
     0 around the phase: three tenant fabrics t0, t1, t2, each
     clos(100, 166) x 2 links (33,200 links, 66,400 rows) in its own
     namespace with disjoint uids, one kernel class each (t0 jitter +
     10 % loss, t1 a 2 Mbit TBF-only rate, t2 10 % loss with 25 %
     correlation); (a) the 798 CRs into one daemon of 2^18 rows (t1's
     rows packed into a reserved block of 70,000) and each tenant's CRs
     into a daemon of its own: reconcile-to-steady, rows_of(t1) inside
     its block, the ownership masks == a walk of the engine's rows,
     TenantList / TenantStats / Health over the Daemon; (b) each tenant's
     first 4,096 spine links wired on both ends and fed phase 12's feed
     for 3 ticks (6 until that run went over the bound, 5 until phase
     21, PERF.md §4)
     and the drain at depth 1: per tenant, the per-wire
     egress bytes, the telemetry and counter rows (by link identity) and
     tenant_counters of the cohabited plane == the tenant's own plane,
     bit for bit, the tenants' counters summing to the plane's; (c) the
     cohabited plane at depth 2 on 2 virtual shards (K4) == (b)'s depth
     1, K4 == plain on a ring step of this plane's mailbox; (d) t0's
     frame budget cut to 20 % of its fed rate for 2 fed ticks (4 until
     phase 21): admitted
     + queued == fed, typed frame-budget verdicts, t1 and t2 == alone;
     (e) tenant_snapshot(plane, "t1"): active rows == rows_of(t1); a
     4-lane x 50-step sweep of it (each slot one K1 launch over 4 x 2^18
     rows): replica 0 == sim.run, no packet outside t1, 2 steps through
     K1 == the plain version; WhatIf tenant=t1 served, tenant=nope
     refused; (f) 8 producer processes (python -m
     kubedtn_tpu_torch.shm.producer) x 50,000 indexed frames of 256 B
     into rings on t1's first 8 wires (re-shaped latency-only), the
     plane attached with attach_shm: every wire delivers 0..N-1 once, in
     order, frames/s from ring to egress; rings pre-filled with 8,192
     frames == the same frames through wire.ingress, tick for tick;
     admission parks over-budget frames in a ring, none dropped; (g) a
     scrape of /metrics: kubedtn_tenant_* == registry.stats,
     kubedtn_shm_* == ShmIngest.stats(); (h) the depth-1 drain share with
     tenancy against 12(b)'s without;
 17. the SLO plane and the autopilot, K1's launches counted from 0 around
     the phase: phase 16's t1 and t2 fabrics as bronze backfill tenants
     and g0, a gold tenant of 4 pod pairs at 2 ms (burn_recovery's
     shape), 132,808 rows in one daemon of 2^18, telemetry windows of
     0.5 s, an explicit clock of 0.05 s a tick, g0's wires fed 40
     frames of 200 B and 512 spine links of t1 and t2 1-8 frames of
     64-256 B per wire and tick; the evaluator and the autopilot driven
     from the phase's loop: (a) reconcile-to-steady, 12 fed ticks, a
     pass with no page, g0's objectives met, the tenants' slow-window
     tx / delivered == a direct sum over the active rows, evaluate()
     timed at 2^18 rows; (b) 25 % loss on g0's a-side links through
     the store and the reconciler: g0 pages within 30 polls of 5 fed
     ticks, t1 and t2 never; (e) a one-topology shape candidate through
     guardrails that reject it, and (f) the same in dry run: the SoA
     columns and the engine's registries unchanged; (c) one
     Autopilot.poll (seed 0, width 2, 50 steps, the gate cut to 50
     ticks; 200 and 200 until phase 21 joined, 100 and 100 until phase
     22 did): ONE sweep, K1 launches == steps x slots, each over (1 +
     candidates) x 2^18 rows; the same snapshot, seed and verdict rank
     the same; 2 steps of the grid's rows through K1 == the plain
     version; (d) one gate per touched topology, then the stage: rows
     outside g0 byte-identical, green within 40 polls, 40 idle, 20 fed
     and 40 idle ticks lose no frame; (g) ObserveSLO, AutopilotCtl and
     AutopilotStatus over gRPC == the in-process state, a scrape's
     kubedtn_slo_* / kubedtn_autopilot_* == the verdicts and the stats,
     the sidecars over 4 s of the real-time plane;
 18. live tenant migration, K1's and K4's launches counted from 0 around
     the phase: plane A holds phase 16's t0, t1, t2 (199,200 rows in
     2^18, t1 in its 70,000-row block) at depth 2 on 2 virtual shards
     (K4 on every dispatch), with telemetry; plane B holds b0 (4 pod
     pairs at 2 ms, phase 17's g0 shape) in 2^18 rows at depth 2; A'
     and B' are the same planes never migrated (A' unsharded); one
     seed, lockstep explicit-clock ticks of 10 ms; 2,048 spine links a
     tenant fed 1-16 frames of 64-256 B per wire and tick, b0's wires
     8 frames of 200 B, for 18 ticks; the planes registered with
     entry.build_federation over a temporary journal; each migration
     lands in a 2-tick feed gap of its tenant: (a) reconcile-to-steady
     of the four; (b) t0 (jitter + 10 % loss) A -> B: done, every step,
     A's registry without t0 and its 66,400 rows freed, B serving them,
     ObserveSLO on A serving t0's frozen slice; (c) t1 A -> B with a
     fault in RESTORE, then rollback(): rolled back, B without a trace
     of t1 (rows, block, wires, store records), resume() refused;
     (d) t2 A -> B with a fault after CUTOVER's side effects, then a
     NEW controller over the journal resumes it to done; after the feed
     and the drain, per wire t0's and t2's egress (A's, the egress
     handed off at RELEASE, then B's) and t1's == those of A', b0's ==
     those of B', bit for bit, check_accounting's mismatch 0 for t0 and
     t2 and the gauge 0; (e) MigrationStatus and MigrateTenant(resume)
     over gRPC on B's server == controller.status(), one scrape's
     kubedtn_migration_* == MigrationStats; K4 == plain on one ring
     step of A's mailbox. Per step: seconds, the barriers' tick-lock
     pauses, journal bytes and seconds per commit, frames transferred
     at cutover, egress handed off, settle ticks;
 19. the fleet supervisor, K1's and K4's launches counted from 0 around
     the phase, phases 16 and 18's sizes: plane A holds t0, t1, t2
     (199,200 rows in 2^18, phase 16's props: jitter and 10 % loss, a
     2 Mbit TBF, correlated loss) at depth 2 (phase 18's never-migrated
     A' as it stands at its end, and B' as B, where phase 18 ran in the
     same call: that saves their builds and their feeds; else built here
     the same way), B holds b0 (8 rows, 2 ms links) and C holds c0 (8
     rows on 1 ms latency-only links, as fleet_rolling_upgrade's
     tenants), C at depth 2 on 2 virtual shards, and C' a twin of C that
     no supervisor touches; every member behind a real gRPC server on
     127.0.0.1 with `grpc_probe` as its probe, lockstep explicit-clock
     ticks of 10 ms, b0 and c0 fed every tick so every plane dispatches;
     t0, t1, t2 fed as in phase 18 (2,048 spine links each, 1-16 frames
     of 64-256 B per wire and tick); the supervisor from
     entry.build_fleet (suspect after 2, dead after 4, healthy after 2):
     (a) the ledger adopts every registry's tenants, FleetStatus over
     gRPC == status(); (b) A fed 2 ticks (3 until phase 24) and
     drained (one t0 frame a
     tick keeps A dispatching), one save_live checkpoint (the
     autosave's stand-in), t1's move A -> C failed by a fault at RESTORE
     (the journal holds a running record with FORK committed), one
     tick's feed of each tenant queued on A (the gap frames), A killed
     (no flush, server stopped); sweeps until A turns suspect (sweep 2)
     and dead (sweep 4) over failed dials, the evacuation runs inside
     that sweep: t1 from the journal's fork, t0 and t2 from A's
     checkpoint (t0's pending frames with it), each on the plane
     choose_plane names on the healths the supervisor probed; the
     restored rows' columns == their source and A's own rows, bit for
     bit; every slice that landed on C restored on C' by hand from the
     same source (the journal's fork, or the evacuation's own read of
     A's checkpoint); whether a survivor grew is printed; 2 fed ticks
     (3 until phase 24) and the drain: every stream on C == C' per
     wire, bit for bit;
     check_failover_accounting exact per tenant (reported_lost == the
     gap frames, accounted + lost == fed, egress == delivered_src +
     delivered_dst), the mismatch gauge 0; K4 == plain on one ring step
     of C's mailbox; (c) B and C on their real-time runners, at depth 2,
     two paced feeders the whole time: c0's wires (128 frames of 64 B
     each every 20 ms) and every other tenant C serves at its own props
     (t1's 2,048 wires, one phase-16 feed tick every 0.5 s);
     FleetUpgrade(planes=[C]) over gRPC: C drained to B by live
     migration, restarted by its own save_live, teardown,
     entry.restore_daemon, a new server on the same port, warm_kernels
     (scenarios.restart_node, the restarter of fleet_rolling_upgrade
     too), verified, refilled: the report restarted and healthy,
     drained == refilled; per tenant, fed == the frames out of its
     egress wires + the drops counted by cause (netem loss, TBF queue,
     delay ring) in the counters of the rows the frames crossed, and
     the counters' delivered == the egress count; c0 fed == delivered;
     each move's src counters as RECONCILE froze them still so at
     RELEASE, RECONCILE's in-flight residue per move printed, the gauge
     0; B's own tenants (t0, t2, b0), idle in (c), keep their counters
     through it and their failover accounting stays exact, also where a
     drained tenant's block grows B's engine (the JAX plane zeroes every
     row's counters then; whether a plane grew is printed);
     Health(plane=C) through B's daemon answers with C's new plane;
     (d) a scrape's kubedtn_fleet_* == FleetStats.snapshot(),
     ObserveSLO(fleet=true) on C == the sweep's merge with t1's frozen
     slices, rebalance() takes the plan of the live healths and the next
     call returns []. Timed: sweeps and seconds from the kill to DEAD,
     the evacuation and each restore, fork_from_checkpoint, the failed
     move, each step of the upgrade and each barrier's pause. Cut: the
     two-plane `fleet_rolling_upgrade` (both planes upgraded in turn)
     stays a CPU test (tests/test_torch_fleet.py); here one plane is
     upgraded;
 20. the daemon process, driven only through what an operator has (the
     child process, its CLI, gRPC, /metrics and files): (a) the Clos
     through the control plane with a tenancy registry
     (entry.build_daemon, 200,000 rows in 2^18), saved cold with
     checkpoint.save: seconds and bytes; (b) `python -m
     kubedtn_tpu_torch.cli daemon --port 0 --metrics-port 0
     --checkpoint-dir D --shm-dir S --trace-out T --profile P
     --telemetry-window 0.5` as a child process, no --device (the
     card): its ready line parsed, boot-to-ready and each boot step's
     seconds (from its log), the child on the card (nvidia-smi's compute
     processes, or where their pids are another namespace's, one more
     process and the card's free memory down), Health serving, /metrics
     with the 200,000 rows and the checkpoint's tenants; (c) 4,096
     leaf -> spine links wired on both ends by AddGRPCWireLocal, fed for
     1 s (3 until phase 21, 2 until phase 24) over InjectBulk from a
     client process (1-4
     tagged frames of
     64-256 B a wire every 0.5 s) and by 8 ShmSender processes into S
     (2,500 frames each, 5,000 until phase 24; cut from a round every
     0.1 s and 20,000 frames, which the daemon drained too slowly,
     PERF.md §4 and §7); after the
     drain the books close from the
     scrape: per fed link its leaf end's tx == the frames fed into its
     wire, node-wide fed == delivered + netem loss + TBF queue + delay
     ring; each operator verb a `tpudtn-torch` process (python -m
     kubedtn_tpu_torch.cli; the first 9 started as the feed ends,
     while the books are read, top once the daemon has closed its first
     telemetry window and trace latest once its flight recorder has
     sampled a frame) with rc 0 and JSON: top, slo, pauses,
     tenant list / stats, autopilot status (attached, disabled), fleet
     status, migrate --status, trace latest, whatif --daemon (degrade,
     fail, spine0 blackholed, load x 1.5; 100 ticks, 200 until phase
     21), then plan of 64
     links of one leaf (verified) and apply --plan; (d) the fed links'
     leaf ends set to 2 s of latency by UpdateLinks, one frame on every
     fed wire and SIGTERM at once: exit 0 within 120 s, a new generation
     in D with the frames pending and queued at the stop (at least one),
     T a JSON array with checkpoint-load, checkpoint-save and pause:
     spans (the save's seconds), P a profiler trace (the profiler's
     start and export seconds from the daemon's log); (e) the restart
     from D, spawned once the first daemon has logged its save (its boot
     overlaps that daemon's profile export and exit; its own trace file):
     boot-to-ready, the rows and interface series as before, every fed
     link's counters continued by its one frame, the books closed again
     (every frame pending at the stop delivered once), SIGTERM again.
     The child's own kernel launches (logged at its shutdown) are
     printed on a line of their own, not in the kernels line;
 21. the Kubernetes-facing control plane and six BASELINE rungs, K1's
     launches counted from 0 around each part: (a) the Clos's 600 CRs,
     unplaced (the CNI has not run), on the port's fake apiserver
     (tests/_torch_fake_apiserver.py, loaded by path) on 127.0.0.1; one
     node's TopologyStore, SimEngine on the card (2^18 rows) and Daemon
     behind a real gRPC server; a K8sBridge over HttpKubeApi (LIST, then
     its watch); two ControllerManagers, manager-0 and manager-1 (32
     workers, leader election through KubeLeaseStore over HttpLeaseApi
     on the same apiserver, probes and metrics on port 0): exactly one
     leads, healthz 200 and readyz as the JAX semantics say for both;
     `cni.main` ADD for each of the 600 pods (CNI env and stdin, the
     daemon's port in the conf): rc 0, the prevResult echoed; 200,000
     rows realized (the first ADD to the rows on the card) and every
     CR's status steady in the store (reconcile-to-steady: the first ADD
     to that), equal per link end, bit for bit in every column, to an
     engine realized from the same CRs straight through store ->
     Reconciler (no kernel launched); every CR's status pushed back and
     read back by a LIST; a ping over a 10 ms link (K1) == 10 ms one
     way == the plain step; a leaf's links edited by a PUT to the
     apiserver reach the rows through the watch; the leader stopped: the
     standby holds the Lease within a lease duration plus a renew
     interval and reconciles a second leaf's edit; the leaders' /metrics
     carry the manager's series; `cni.main` DEL for every pod: 0 rows;
     K1 launched exactly twice on the node's engine (warm_kernels, the
     ping). Timed: the first ADD to the rows, reconcile-to-steady, the
     status push, ADD and DEL ms per pod (median), watch-to-rows, the
     takeover. (b) `python -m
     kubedtn_tpu_torch.cli manager --leader-elect --probe-port 0
     --metrics-port 0` as a child process, no --device (the card),
     spawned as (a) starts its status push (which moves no memory on
     the card) and checked after its LIST back: its
     ready line, healthz and readyz 200, /metrics, the child on the card
     (as 20(b)), SIGINT: exit 0; boot-to-ready. (c) scenarios.LADDER's
     3node, fat_tree_64, churn_1k, clos_100k, reconcile_100k and scale_1m
     in this process at their JAX defaults: each rung's own asserts, the
     JAX keys, tx >= rx, K1 launched once per ping, per slot and step,
     by warm_kernels and per shaping iteration; K1 over scale_1m's
     2^21-row state == the plain step bit for bit on the rung's keyed
     draws for 2 steps, and timed against its bound;
 22. the scale path, K1's launches counted from 0 around each part: (a)
     the sharded simulation step (parallel/sharded.py) on the churned
     Clos (200,000 rows in 2^18) at 2, 4 and 8 virtual shards of the
     card, 3 steps each of a 1,000-row scattered UpdateLinks batch and
     the drop-in step on every active row: state, ShapeResult and
     NodeStats == update_links + K1 + the node sums on the whole state
     on the same uniforms, bit for bit; tx_packets sums to the packets
     delivered; K1 S times a step; ms per step sharded and unsharded;
     (b) the sharded router (parallel/router.py) on phase 11's routed
     fabric (k_slots 4, k_fwd 8; built the same way when phase 11 did
     not run) on 4 virtual shards for 10 steps (20 before the phase's
     first card run, PERF.md §4), fed run_routed's draws
     sliced per shard, at a budget of 2^16 transit packets per shard
     pair and step: every leaf == run_routed's and == the same steps
     over the plain step, bit for bit; K1 4 x 12 x 10 times; the
     fabric's transit books close; packets through the all-to-all a
     step, ms per step sharded and unsharded; (c) JAX's default budget
     (64) for 5 steps: the overflow counted in fwd_dropped, the books
     closed; (d) entry.dryrun_multichip(8) on 8 virtual shards: its
     checks and JAX's OK line; (e) the routing rungs routes_10k, chaos_
     flaps and reconverge_10k at JAX's default widths, their events cut
     to 2 each (PERF.md §4): the JAX keys and
     "device", reconverge_10k's incremental routes == a full recompute,
     chaos_flaps' K1 launches == its slots x steps, routes_10k and
     reconverge_10k launch no kernel; (f) inside phase 12(c): the
     sharded plane's sampled exchange probe ran (exchange_seconds > 0),
     its output == the plain ring on a 4,096-row mailbox, bit for bit,
     one K4 launch a ring step; every sharded plane's K4 count (12(c),
     16(c), 18, 19) is its own launches plus its probes', a term of its
     own, each probe run (S - 1) x len(ring_plan) launches;
 23. the live-plane soaks, through scenarios.LADDER on the card at JAX's
     widths, only their durations cut (SOAK_CUTS, PERF.md §4): (a)
     live_plane, 8 pairs at 5 ms, 40,000 frames a wire from an injector
     child over InjectBulk (2 rounds of JAX's 5): every frame of the
     whole chunks delivered, none dropped, the median and best frames/s
     and the injector's; (b) live_plane_soak at 5 ms (chunk 1,024) and
     over 2 Gbit TBF wires (chunk 512), 3 s of 1 s windows (JAX's 20 s
     of 2.5 s; 5 s until phase 24) after a settle of at most 15 s (90):
     every window
     alive, nothing dropped; the windows, sustained rate, flatness,
     backlog, GC and steal seconds, the stage shares; (c) chaos_soak, 4
     pairs, 20,000 frames/s, the peer flapped at 1 Hz, 50 % down, for
     3 s (12; 4 until phase 24): zero frames lost, no buffer or shaping drop, a breaker
     cycle, a sampled trace ingress -> outage-buffered -> retried ->
     peer-sent -> received on both nodes; (d) staged_update_soak, 4
     pairs, 8,000 frames/s, 1.5 s steady and 1.5 s staging (3 and 3),
     gates of 60 ticks (120; 120 until phase 24): zero loss, the 4 clean plans verified and staged, the loss=70
     delta rejected with the props column untouched; (e)
     update_under_flap, 2 pairs, 6,000 frames/s, 3 s (5), gates of 50
     ticks (100; 100 until phase 24): zero loss,
     every stage clean, a breaker cycle; (f) K1's launches, counted
     from 0 around (d) and (e) == the gates that ran x their ticks x 4
     slots (5 x 60 + 2 x 50), and the regressing gate's own snapshot
     of (d)'s plane swept again through K1 and through the plain
     version on the same seed: every metric equal, bit for bit.
 24. the ladder's last nine scenarios, through scenarios.LADDER on the
     card at JAX's widths, only their durations cut (PROBE_CUTS, PERF.md
     §4), each with its JAX keys and "device": (a) telemetry_overhead,
     4 pairs at 2 ms, 20,000 frames a wire, 3 interleaved off / on
     rounds (5), windows of 0.01 s (0.25 s closes none on the probe's
     virtual clock): no tick error, frames sampled and recorded, a link
     row a pair, windows closed; the paired overhead, its best pair and
     the 5 % bar printed; (b) slo_overhead, two planes of 3 tenants
     of 1 pair at 2 ms, the evaluator's sidecar on one, 3 rounds (5):
     evaluations ran, every tenant evaluated and ok; the 1 % bar
     printed; (c) pause_observability, 2 rounds (4):
     the forced checkpoint_save, compact and staged_update barriers each
     in the ledger with count, seconds and rows, compact moved rows, the
     staged update ok, no dropped event; the 2 % bar printed; (d)
     whatif_sweep, 64 replicas of a random_mesh(32, 64) for 200 steps
     (10,000), K1's launches counted from 0 around it: delivery ratios
     in (0, 1] and the worst <= the baseline, K1 == steps x 2 slots, each
     launch over 64 x 256 rows; the recorded run_sweep call's snapshot
     and scenarios swept again for 20 steps through K1 and through the
     plain version: every metric equal, bit for bit; (e) sharded_soak,
     48 pairs, 6,000 frames a wire, 2 rounds (3), on 8 virtual shards
     (devices=8; JAX's devices=0 is the one card): mesh [8], no drop or
     tick error, cross-shard frames, the shard edges summing to the
     plane's rows, remote_dma and exchange_seconds; K4, counted from 0
     around it, == the sharded plane's dispatches x 7 ring steps x the
     ring plan's launches plus its exchange probes' (ProbeK4), and == the
     plain ring on one ring step of its mailbox, bit for bit; single and
     sharded frames/s; (f) noisy_neighbor over wire ingress for 2 s and
     over an shm ring for 1 s (4 s each): in guardrails, the victim lost
     nothing, the aggressor's admitted + queued == fed, nothing dropped,
     over shm the ring head's throttle verdicts; (g) shm_producer_crash
     at JAX's defaults: in guardrails (a contiguous prefix delivered, the
     torn tail skipped, the ring retired, a trace across the ring); (h)
     shm_soak at JAX's defaults: 200,000 frames audited exactly once, the
     producer's rc 0, shm >= 10 x the gRPC stream; (i) tenant_soak, 3
     tenants x 2 pairs behind the real-time runner, an injector child
     each, 3 s (8) after a settle of at most 15 s (60): every tenant's
     sustained rate and worst window > 0, nothing dropped.
 25. the scale path across processes: 2 child processes
     (kubedtn_tpu_torch.parallel.multihost, torch and the port only),
     each joining the run through init_distributed (a file rendezvous in
     a temporary directory) and make_multihost_mesh over 2 virtual shards
     of the card: 4 shards, host-major, the backend chosen from the
     layout (gloo for ranks that share a card, staged through pinned host
     memory) and printed; (a) 22(a)'s sharded step on the churned Clos, 3
     steps of a 1,000-row scattered batch, the uniforms drawn by every
     rank from one seeded generator on the card; (b) 22(b)'s sharded
     router on phase 11's routed fabric (built the same way when phase 11
     did not run), budget 2^16, 10 steps, each shard drawing from its own
     generator seeded by its global index; inputs and outputs through the
     temporary directory (torch.save); every child's shards, ShapeResults
     and NodeStats, and its router shards, == the same steps on one
     process's 4 virtual shards, bit for bit, NodeStats the same on every
     rank, no packet over the exchange budget (fwd_dropped, the same on
     every rank, is the receiving lanes' overflow, as run_routed counts
     it); K1 counted from 0 in each child around (a) and
     (b), summed == the one-process runs' launches; start-up seconds,
     ms per step against one process, bytes through the all-to-all a
     step. A child that fails or outlives 300 s fails the phase, its
     sibling killed.
 26. the dispatch probe (kubedtn_tpu_torch/analysis/verify/dispatch.py)
     on dtnlint's canonical probe plane (one link pair per kernel class,
     capacity 16, telemetry on; 8 frames a wire and tick on all three
     classes, 2 warm-up ticks, 1 counted, 8 idle): per counted tick (a)
     the calls into the hand-written-kernel wrappers by kernel, (b) the
     kernels' launch counters, (c) the CUDA kernels torch.profiler saw,
     (d) the host syncs `_dispatch` issued under
     torch.cuda.set_sync_debug_mode("warn"), each at the innermost frame
     of the package; (a) == (b) by kernel, every sync site under a
     `sync-ok` waiver of the static sync pass. (a) at depths 1 and 2,
     unsharded: delivered frames and counters equal across the depths;
     (b) on 4 virtual shards of the card at depth 1: K4's wrapper calls
     == its launches == the count the same probe gives on the CPU, frames
     and counters == (a)'s unsharded ones.

`--daemon-rate` (never in the default run; e.g. `--phases 20
--daemon-rate`) then measures the daemon process's shaping rate under a
saturating InjectBulk feed, booted with phase 20's flags, without
--profile, and without --profile and telemetry (run_daemon_rate).

The line before the last lists the kernels with their launches by path
(K1's sharded_step and sharded_router from phase 22, its rungs path
with chaos_flaps, its soaks path from 23(d) and (e), its whatif path
from 24(d), with 24(d)'s replay under compare_launches, its multiprocess
path from phase 25's children, with the one-process runs they are held
against under compare_launches; K4's probe path, the sharded planes'
exchange probes, its sharded_soak path from 24(e), and its
dispatch_probe path from 26(b)), errors, times and bounds (with
--phases, the kernels whose checks ran: K1-K3 with phase 4, K4 with
phase 9); the last line is {"ok": true, "device":
{...}}. It exits non-zero, printing neither, when there is no CUDA
device or the package is missing.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import logging
import os
import re
import statistics
import sys
import threading
import time
import traceback
import types

import numpy as np
import torch

# H100 SXM data-sheet peaks at its 700 W limit: HBM bandwidth and
# non-tensor-core float32 rate (integer work is counted against it too).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per edge: SASS instructions of csrc/shaping.cu as nvcc 12.9
# builds it (cuobjdump -sass, counted by kubedtn_tpu_torch/kernel_bench.py):
# K1's straight-line body to EXIT; for an active edge, K2's and K3's code
# outside the step loop once plus the loop's body per step (an inactive
# edge runs no step). Each thread instruction counts as one operation
# against the float32 rate.
OPS_K1 = 262
OPS_K2 = (183, 165)      # (per active edge, per active edge and step)
OPS_K3 = (283, 226)

STEPS = 10                  # fused steps per K2/K3 launch, as bench.py
PROFILE_CALLS = 4
UPDATE_ITERS = 20           # UpdateLinks per timing sample
DROPIN_STEPS = 20
FUSED_CALLS = 10
TIME_REPS = 15
SRC = "kubedtn_tpu_torch/ops/cuda/csrc/shaping.cu"
PALLAS = "kubedtn_tpu/ops/pallas/shaping.py"
STATE_TOL = dict(rtol=1e-6, atol=1e-3)   # the repo's Pallas parity
DEPART_TOL = dict(rtol=1e-5, atol=1e-2)  # tolerances

# The live tick (runtime.fused_tick) at the Clos's full width.
LIVE_ROWS = 4000            # busy rows per class and tick, padded to 4096
LIVE_SLOTS = 64             # K, runtime's seq_slots default
LIVE_TICKS = 2              # chained ticks (8 until phase 21 joined)
LIVE_ELAPSED_US = 1000.0    # wall time between two ticks
LIVE_SHARDS = (2, 4)        # virtual shards of the one card
LIVE_TIMED_TICKS = 3        # the median of 3 timed ticks
LIVE_JAMMED = 40            # TBF busy rows that start with a full queue
K4_SRC = "kubedtn_tpu_torch/ops/cuda/csrc/exchange.cu"
K4_REPLACES = "kubedtn_tpu/parallel/exchange.py:70"
K4_SHARDS = 4
K4_ROWS = (4096, 32768)     # the live tick's R, and the byte regime
MAIL_WORDS = 24             # 21 float + 3 int payload words per row

# The K-slot simulator and the routed fabric on the churned Clos. The
# churn's link rates start at 20 Mbit/s, so 36 Mbit/s of 1,500-byte
# packets (three per edge and 1 ms step) is what overflows the slowest
# links' TBF queues, and with latencies up to 100 ms the 128-slot delay
# lines too: every drop class is raised inside SIM_STEPS.
SIM_RATE_BPS = 36e6
SIM_PKTS_PER_STEP = 3
SIM_K = 4                   # k_slots
SIM_Q = 128                 # delay-line slots per edge
SIM_DT_US = 1000.0
SIM_STEPS = 200
SIM_CPU_STEPS = 10          # steps repeated on the CPU on the same draws
SIM_TIMED_STEPS = 20
ROUTE_HOPS = 4              # max_hops of the full recompute
ROUTE_K_PATHS = 4
EVENT_LINKS = 10
ROUTED_RATE_BPS = 12e6      # one packet per sourcing row and step
ROUTED_K_FWD = 8
ROUTED_STEPS = 50
ROUTED_ECMP_STEPS = 10
ROUTED_TIMED_STEPS = 5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing ----------------------------------------------------------------

def timed(run, n: int) -> float:
    """Median host seconds of run(n), ended by a device sync, after one
    warm-up run(2) (first launches load modules)."""
    run(2)
    samples = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def section(run, n: int, prof: dict, name: str) -> float:
    """Host seconds per call of run (median of timed samples), and into
    prof[name] where its device time goes, from torch.profiler over
    PROFILE_CALLS more calls: device µs per call by launching op (and
    this package's kernels by name), and the device's busy share, device
    time over the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    wall = timed(run, n) / n
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        run(PROFILE_CALLS)
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in p.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    # torch's kernels are charged to the aten op that launched them; this
    # package's kernels have no aten op and are listed by name
    cpu = torch.autograd.DeviceType.CPU
    by_op = sorted(((a.key, a.self_device_time_total / PROFILE_CALLS)
                    for a in p.key_averages()
                    if a.self_device_time_total > 0
                    and (a.device_type == cpu or "shape_step" in a.key
                         or "ring_step" in a.key)),
                   key=lambda kv: -kv[1])
    per_call = device_us / PROFILE_CALLS
    prof[name] = {"wall_us_per_call": wall * 1e6,
                  "device_us_per_call": per_call,
                  "busy_share": per_call / (wall * 1e6),
                  "top_device_us_per_call": [[k[:48], v]
                                             for k, v in by_op[:6]],
                  "own_kernels_us_per_call": {
                      k[:48]: v for k, v in by_op
                      if "shape_step" in k or "ring_step" in k}}
    return wall


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor, tol: dict, name: str):
    """Max |a-b| over finite entries; infinities must coincide; fails
    beyond the stated tolerance."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb), f"{name}: finite/inf pattern differs")
    check(torch.equal(a[~fa], b[~fb]), f"{name}: infinities differ")
    if not bool(fa.any()):
        return 0.0
    x, y = a[fa].double(), b[fb].double()
    err = float((x - y).abs().max())
    ok = bool(((x - y).abs() <= tol["atol"] + tol["rtol"] * y.abs()).all())
    check(ok, f"{name}: max abs error {err} beyond {tol}")
    return err


def clone_tiled(shaping, ts):
    return shaping.TiledShapeState(
        **{k: v.clone() for k, v in vars(ts).items()})


# -- phases ----------------------------------------------------------------

def run_main_path(el, state, dev):
    """UpdateLinks churn and shaping, as a user drives them. Returns
    (state, the state right after UpdateLinks, metrics)."""
    from kubedtn_tpu_torch.models.topologies import random_link_props
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    m = {}
    L = el.n_links
    ends = [np.arange(0, L, dtype=np.int32),
            np.arange(L, 2 * L, dtype=np.int32)]  # host: no sync
    perm = np.random.default_rng(3).permutation(2 * L)[:L]
    scat = [torch.as_tensor(np.sort(perm).astype(np.int32), device=dev),
            torch.as_tensor(np.sort((perm + L) % (2 * L)).astype(np.int32),
                            device=dev)]
    props = [torch.as_tensor(random_link_props(L, s), device=dev)
             for s in (1, 2)]
    valid = torch.ones(L, dtype=torch.bool, device=dev)

    def updates(rows, contiguous):
        def run(n):
            for i in range(n):
                es.update_links(state, rows[i % 2], props[i % 2], valid,
                                contiguous)
        return run

    prof = m["profile"] = {}
    m["link_updates_scattered_per_s"] = L / section(
        updates(scat, False), UPDATE_ITERS, prof, "updates_scattered")
    m["link_updates_per_s"] = L / section(
        updates(ends, True), UPDATE_ITERS, prof, "updates_contiguous")
    # both ends were rewritten whole; the last write of end k was props[k]
    for k in (0, 1):
        rows = torch.as_tensor(ends[k], device=dev).long()
        check(torch.equal(state.props[rows], props[k]),
              f"update_links: end {k} props not written")
        check(torch.equal(state.tokens[rows],
                          es.burst_bytes(props[k][:, es.P_RATE_BPS])),
              f"update_links: end {k} token buckets not reset")
        check(not bool(state.pkt_count[rows].any())
              and not bool(state.corr[rows].any()),
              f"update_links: end {k} counters/corr not reset")

    # fresh qdiscs after UpdateLinks: full buckets, empty queues
    fresh = clone_state(state)

    E = state.capacity
    n_act = int(state.num_active)
    sizes = torch.full((E,), 1500.0, dtype=torch.float32, device=dev)
    t0s = torch.zeros(E, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    delivered = torch.zeros((), dtype=torch.int64, device=dev)

    def dropin(n):
        nonlocal state, delivered
        for _ in range(n):
            state, res = netem.shape_step_auto(state, sizes, state.active,
                                               t0s, gen)
            delivered += res.delivered.sum()

    m["shape_dropin_pkts_per_s"] = n_act / section(
        dropin, DROPIN_STEPS, prof, "dropin")
    m["dropin_delivered"] = int(delivered)

    ts = shaping.tile_state(state)
    sizes_t = shaping.tile_vec(sizes, ts)
    act_t = shaping.tile_vec(state.active.to(torch.int32), ts)
    t_arr_t = shaping.tile_vec(t0s, ts)
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    calls = 0

    def fused(n):  # in-kernel Philox, as bench.py times the fused path
        nonlocal ts, calls
        for _ in range(n):
            ts, dep, fl = shaping.shape_steps_tiled(ts, sizes_t, act_t,
                                                    t_arr_t, calls, STEPS)
            counts.add_(torch.stack(list(shaping.flag_counts(fl).values())))
            calls += 1

    m["shape_fused_pkts_per_s"] = n_act * STEPS / section(
        fused, FUSED_CALLS, prof, "fused")
    u_t = torch.rand((STEPS * netem.NU, E), generator=gen, device=dev)
    ts, dep, fl = shaping.shape_steps_tiled(ts, sizes_t, act_t, t_arr_t, 0,
                                            STEPS, u_t)
    counts += torch.stack(list(shaping.flag_counts(fl).values()))
    calls += 1
    state = shaping.untile_state(ts, state)

    c = dict(zip((k for k, _ in shaping.COUNT_BITS), counts.tolist()))
    m["fused_counts"] = c
    offered = n_act * STEPS * calls
    check(c["delivered"] + c["drop_loss"] + c["drop_queue"] == offered,
          f"fused outcomes do not partition the offered packets: {c}")
    check(c["delivered"] > 0 and m["dropin_delivered"] > 0,
          "nothing delivered")
    for name in ("tokens", "t_last", "backlog_until", "corr"):
        check(bool(torch.isfinite(getattr(state, name)).all()),
              f"non-finite {name} after the main path")
    check(bool(torch.isfinite(dep[fl & shaping.FLAG_DELIVERED != 0]).all()),
          "a delivered packet has no finite departure")
    return state, fresh, m


def check_k1(state, dev, timer, gen):
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    E = state.capacity
    sizes = torch.tensor([64.0, 512.0, 1500.0], device=dev)[
        torch.randint(0, 3, (E,), generator=gen, device=dev)]
    have = torch.rand(E, generator=gen, device=dev) < 0.9
    t_arr = torch.rand(E, generator=gen, device=dev) * 1000.0
    u = torch.rand((E, netem.NU), generator=gen, device=dev)
    args = (state, sizes, have, t_arr, u)

    p_state, p_res = netem._shape_step_from_u(*args)
    k_state, dep, fl = shaping.shape_step_flags(*args, donate=False)
    torch.cuda.synchronize()
    check(torch.equal(fl, shaping.pack_flags(p_res)), "K1 flags differ")
    check(torch.equal(k_state.pkt_count, p_state.pkt_count),
          "K1 pkt_count differs")
    err = max(max_err(dep, p_res.depart_us, DEPART_TOL, "K1 depart"),
              *(max_err(getattr(k_state, n), getattr(p_state, n),
                        STATE_TOL, f"K1 {n}")
                for n in ("tokens", "t_last", "backlog_until", "corr")))
    ms = timer.ms(lambda: shaping.shape_step_flags(*args, donate=False))
    plain = timer.ms(lambda: netem._shape_step_from_u(*args), reps=5)
    moved = nbytes(state.props, state.corr, u, state.tokens, state.t_last,
                   state.backlog_until, state.pkt_count, sizes, t_arr, have,
                   state.active, dep, fl, k_state.tokens, k_state.t_last,
                   k_state.backlog_until, k_state.corr, k_state.pkt_count)
    b, by = bound_ms(moved, OPS_K1 * E)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, bytes=moved,
                delivered=int((fl & shaping.FLAG_DELIVERED != 0).sum()))


def tiled_inputs(state, dev):
    from kubedtn_tpu_torch.ops.cuda import shaping

    ts = shaping.tile_state(state)
    E = state.capacity
    g = torch.Generator(device=dev).manual_seed(11)
    sizes = shaping.tile_vec(
        torch.tensor([64.0, 512.0, 1500.0], device=dev)[
            torch.randint(0, 3, (E,), generator=g, device=dev)], ts)
    act = shaping.tile_vec(state.active.to(torch.int32), ts)
    t_arr = shaping.tile_vec(torch.zeros(E, device=dev), ts)
    return ts, sizes, act, t_arr


def compare_tiled(k, p, name):
    """(kernel ts', depart, flags) against the plain triple."""
    (kts, kdep, kfl), (pts, pdep, pfl) = k, p
    check(torch.equal(kfl, pfl), f"{name} flags differ")
    check(torch.equal(kts.count, pts.count), f"{name} count differs")
    return max(max_err(kdep, pdep, DEPART_TOL, f"{name} depart"),
               *(max_err(getattr(kts, n), getattr(pts, n), STATE_TOL,
                         f"{name} {n}")
                 for n in ("tokens", "t_last", "backlog", "corr")))


# words of one edge in the fused kernels' layout: every input of an
# active edge (props, corr, tokens, t_last, backlog, count, size, t_arr,
# act) and the state it writes back (corr, tokens, t_last, backlog, count)
EDGE_IN_WORDS = 13 + 5 + 4 + 3
EDGE_STATE_WORDS = 5 + 4


def tiled_bytes(act, dep, fl, uniforms: bool):
    """Bytes K2/K3 must move on this data: an active edge's inputs (and
    K2's uniforms for it) read once and its state written once; an
    inactive edge reads only its act word (it departs nothing and keeps
    its state); depart and flags written for every edge and step."""
    E, n = act.numel(), int((act > 0).sum())
    steps = dep.shape[0]
    words = n * (EDGE_IN_WORDS + EDGE_STATE_WORDS) + (E - n)
    if uniforms:
        words += n * 5 * steps
    return 4 * words + nbytes(dep, fl)


def tiled_ops(act, per_edge: int, per_step: int, steps: int) -> int:
    """SASS instructions K2/K3 run for the active edges of `act`."""
    return int((act > 0).sum()) * (per_edge + per_step * steps)


def check_k2(state, dev, timer, gen):
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    ts, sizes, act, t_arr = tiled_inputs(state, dev)
    E = ts.capacity
    u_t = torch.rand((STEPS * netem.NU, E), generator=gen, device=dev)
    plain = shaping.shape_steps_plain(ts, sizes, act, t_arr, u_t, STEPS)
    kern = shaping.shape_steps_tiled(clone_tiled(shaping, ts), sizes, act,
                                     t_arr, 0, STEPS, u_t)
    torch.cuda.synchronize()
    err = compare_tiled(kern, plain, "K2")
    work = clone_tiled(shaping, ts)
    ms = timer.ms(lambda: shaping.shape_steps_tiled(work, sizes, act, t_arr,
                                                    0, STEPS, u_t))
    plain_ms = timer.ms(lambda: shaping.shape_steps_plain(
        ts, sizes, act, t_arr, u_t, STEPS), reps=3)
    moved = tiled_bytes(act, kern[1], kern[2], uniforms=True)
    b, by = bound_ms(moved, tiled_ops(act, *OPS_K2, STEPS))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, bytes=moved)


def check_k3(state, dev, timer):
    """K3 on `state` (fresh qdiscs) against K2 fed the materialised
    Philox draws, bit for bit; its outcome shares against the configured
    loss; flag_counts against a host count."""
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops.cuda import philox, shaping

    seed = 12345
    ts, sizes, act, t_arr = tiled_inputs(state, dev)
    E = ts.capacity
    k3 = shaping.shape_steps_tiled(clone_tiled(shaping, ts), sizes, act,
                                   t_arr, seed, STEPS)
    draws = philox.uniforms(seed, E, STEPS, dev)
    k2 = shaping.shape_steps_tiled(clone_tiled(shaping, ts), sizes, act,
                                   t_arr, seed, STEPS, draws)
    torch.cuda.synchronize()
    check(torch.equal(k3[1].view(torch.int32), k2[1].view(torch.int32))
          and torch.equal(k3[2], k2[2]), "K3 outputs differ from K2 on the "
          "materialised Philox draws")
    for n in ("tokens", "t_last", "backlog", "corr", "count"):
        a, b = getattr(k3[0], n), getattr(k2[0], n)
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"K3 state {n} differs bitwise from K2's")
    plain = shaping.shape_steps_plain(ts, sizes, act, t_arr, draws, STEPS)
    err = compare_tiled(k3, plain, "K3")

    # the counters' face: flag_counts against a host count
    fl = k3[2]
    counts = {k: int(v) for k, v in shaping.flag_counts(fl).items()}
    host = fl.cpu().numpy()
    for name, bit in shaping.COUNT_BITS:
        check(counts[name] == int(((host & bit) != 0).sum()),
              f"flag_counts[{name}] differs from the host count")
    # On fresh qdiscs (full buckets: 10 packets of <= 1500 B fit every
    # burst) nothing overflows the queue, so the delivered share is one
    # minus the configured loss: random_link_props sets no correlation
    # and no duplication, so each packet drops with p = loss/100.
    offered = int((act > 0).sum()) * STEPS
    check(counts["drop_queue"] == 0, "K3 queue drops on fresh qdiscs")
    p = (ts.props[es.P_LOSS].double() / 100.0)[act > 0]
    expect = float(p.sum()) * STEPS
    sigma = float((p * (1 - p)).sum() * STEPS) ** 0.5
    for name, got, want in (("loss", counts["drop_loss"], expect),
                            ("delivered", counts["delivered"],
                             offered - expect)):
        check(abs(got - want) < 6 * sigma + 1,
              f"K3 {name} {got} vs configured {want:.0f} "
              f"(sigma {sigma:.1f})")

    work = clone_tiled(shaping, ts)
    ms = timer.ms(lambda: shaping.shape_steps_tiled(work, sizes, act, t_arr,
                                                    seed, STEPS))
    # one step per launch: the per-edge part of the time alone
    ms_s1 = timer.ms(lambda: shaping.shape_steps_tiled(work, sizes, act,
                                                       t_arr, seed, 1))
    plain_ms = timer.ms(lambda: shaping.shape_steps_plain(
        ts, sizes, act, t_arr, philox.uniforms(seed, E, STEPS, dev), STEPS),
        reps=3)
    moved = tiled_bytes(act, k3[1], k3[2], uniforms=False)
    ops = tiled_ops(act, *OPS_K3, STEPS)
    b, by = bound_ms(moved, ops)
    return dict(max_abs_err=err, ms=ms, ms_one_step=ms_s1,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, bytes=moved,
                ops=ops, ops_ms=ops / F32_OPS_PER_S * 1e3,
                delivered_share=counts["delivered"] / offered,
                loss_share=counts["drop_loss"] / offered,
                configured_loss_share=expect / offered)


def check_entry(dev):
    """The fat-tree twin of __graft_entry__.entry(): latency 10ms, jitter
    1ms, 1 Gbit, full buckets — every delivered packet departs within
    [9, 11] ms of t=0."""
    from kubedtn_tpu_torch import entry

    fn, args = entry.entry()
    _, res = fn(*args)
    d = res.depart_us[res.delivered]
    check(res.depart_us.shape == (1024,), "entry: wrong output shape")
    check(int(res.delivered.sum()) > 400, "entry: too few delivered")
    check(bool(((d >= 9000.0) & (d <= 11000.0)).all()),
          "entry: a departure lies outside latency +- jitter")
    check(not bool(res.delivered[512:].any()), "entry: padding delivered")
    return int(res.delivered.sum())


# -- the live tick ------------------------------------------------------------

def same(a, b, name: str) -> None:
    """Nested tuples / lists / dicts / dataclasses of tensors (or plain
    values), bit for bit; a tensor pair may lie on two devices."""
    if dataclasses.is_dataclass(a):
        same(vars(a), vars(b), name)
    elif isinstance(a, dict):
        check(a.keys() == b.keys(), f"{name}: keys differ")
        for k in a:
            same(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (tuple, list)):
        check(len(a) == len(b), f"{name}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{name}[{i}]")
    elif isinstance(a, torch.Tensor):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}"
              f"{tuple(b.shape)}")
        y = b.to(a.device)
        if a.dtype == torch.float32:
            a, y = a.view(torch.int32), y.view(torch.int32)
        check(torch.equal(a, y), f"{name}: differs bitwise")
    else:
        check(a == b, f"{name}: {a} vs {b}")


def tick_runs(state, groups, dev):
    """Closures running n chained ticks from `state`, returning (outs per
    tick, dyn, tel): the fused program, and the per-class ladder."""
    from kubedtn_tpu_torch import runtime
    from kubedtn_tpu_torch import telemetry as tele

    E = state.capacity
    seq, tbf, ind = groups["seq"], groups["tbf"], groups["ind"]

    def fused(n):
        key, dyn, tel = runtime.tick_key(1), None, tele.init_acc(E, dev)
        outs = []
        for _ in range(n):
            key, _sub, dyn, o, tel = runtime.fused_tick(
                state, dyn, key, LIVE_ELAPSED_US, seq, tbf, ind, tel)
            outs.append(o)
        return outs, dyn, tel

    def ladder(n):
        key, dyn, tel = runtime.tick_key(1), None, tele.init_acc(E, dev)
        outs = []
        for _ in range(n):
            key, sub = runtime.split(key)
            el, o = LIVE_ELAPSED_US, {}
            for kind in runtime.CLASS_ORDER:
                dyn, o[kind], tel = runtime.class_tick(
                    state, dyn, sub, el, groups[kind], tel, kind=kind)
                el = 0.0
            outs.append(o)
        return outs, dyn, tel

    return fused, ladder


def sharded_run(state, groups, mesh):
    """n chained sharded ticks on `mesh`: (outs, dyn, tel) with dyn and
    tel joined on the first mesh device."""
    from kubedtn_tpu_torch import convert, runtime
    from kubedtn_tpu_torch import telemetry as tele

    fn = runtime.make_sharded_fused(mesh)
    shards = convert.shard(state, mesh)
    tel0 = convert.shard(tele.init_acc(state.capacity, mesh[0]), mesh)

    def run(n):
        key, dyn, tel, outs = runtime.tick_key(1), None, tel0, []
        for _ in range(n):
            key, _sub, dyn, o, tel = fn(shards, dyn, key, LIVE_ELAPSED_US,
                                        groups["seq"], groups["tbf"],
                                        groups["ind"], tel)
            outs.append(o)
        return outs, convert.unshard(dyn), convert.unshard(tel)

    return run


def check_live_outputs(state, groups, fused_res, dev):
    """What comes out is right by the repo's own means: the outcome
    partition (delivered + loss + queue drops == offered, exactly, per
    the telemetry window), finite departures for every delivered frame,
    the TBF fallback raised, and the max-plus TBF core equal to the
    sequential core on the rows it did not flag."""
    from kubedtn_tpu_torch import runtime
    from kubedtn_tpu_torch import telemetry as tele
    from kubedtn_tpu_torch.ops import netem

    outs, dyn, tel = fused_res
    m = {}
    for name, x in zip(("tokens", "t_last", "backlog_until", "corr"), dyn):
        check(bool(torch.isfinite(x).all()), f"live tick: non-finite {name}")
    check(tuple(tel.shape) == (state.capacity, tele.KCOLS),
          "live tick: telemetry window shape")
    tot = tel.double().sum(0)
    check(float(tot[tele.T_TX]) == float(
        tot[tele.T_DELIVERED] + tot[tele.T_DROP_LOSS]
        + tot[tele.T_DROP_QUEUE]), "live tick: outcomes do not partition "
        "the offered frames")
    check(float(tot[tele.T_HIST0:].sum()) == float(tot[tele.T_DELIVERED]),
          "live tick: latency histogram does not count every delivery")
    m["tel_totals"] = {c: float(tot[i]) for i, c in enumerate(
        tele.COLUMN_NAMES[:tele.T_HIST0])}
    fallback = []
    for t, o in enumerate(outs):
        for kind, out in o.items():
            delivered, depart = out[0], out[1]
            check(tuple(depart.shape) == (runtime._pad_rows(LIVE_ROWS),
                                          LIVE_SLOTS),
                  f"live tick {t} {kind}: depart shape")
            check(bool(torch.isfinite(depart[delivered]).all()),
                  f"live tick {t} {kind}: a delivered frame has no finite "
                  "departure")
            check(bool(delivered.any()), f"live tick {t} {kind}: nothing "
                  "delivered")
        fallback.append(int(o["tbf"][5].sum()))
    m["tbf_fallback_rows_per_tick"] = fallback
    check(sum(fallback) > 0, "live tick: no TBF row raised the fallback")

    # max-plus TBF core vs the sequential core, same draws, first tick
    rows, sizes, valid, kids = groups["tbf"]
    g = lambda col: netem.gather_rows(col, rows)  # noqa: E731
    sub = runtime.split(runtime.tick_key(1))[1]
    u = netem.uniform_rows(sub, netem.CLASS_TBF, kids, *sizes.shape, dev)
    st = runtime._roll_clocks(state, LIVE_ELAPSED_US)
    res, *_rest, fbk = netem.shape_rows_tbf(
        g(st.props), g(st.active), g(st.corr), g(st.pkt_count),
        g(st.tokens), g(st.t_last), g(st.backlog_until), sizes, valid, sub,
        kids, u=u)
    _, sres = netem.shape_rows_seq(
        g(st.props), g(st.active), (g(st.tokens), g(st.t_last),
                                    g(st.backlog_until), g(st.corr),
                                    g(st.pkt_count)),
        sizes, valid, sub, kids, u=u)
    ok = ~fbk
    check(torch.equal(res.delivered[ok], sres.delivered[ok]),
          "TBF max-plus core and sequential core deliver differently")
    m["tbf_vs_seq_core_max_abs_err"] = max_err(
        res.depart_us[ok], sres.depart_us[ok], DEPART_TOL,
        "TBF max-plus core vs sequential core")
    return m


def cross_shard_rows(groups, n_links: int, E: int, S: int) -> int:
    """Busy rows of one tick whose link's other direction (row r +- L)
    lies in another shard's block."""
    from kubedtn_tpu_torch.parallel.partition import shard_of_rows

    rows = torch.cat([groups[k][0] for k in groups]).cpu().numpy()
    rows = rows[rows < E].astype(np.int64)
    peer = np.where(rows < n_links, rows + n_links, rows - n_links)
    return int((shard_of_rows(rows, E, S) != shard_of_rows(peer, E, S))
               .sum())


def run_live_tick(dev, card):
    """Phases 6-8. Returns (metrics, K4 launches on the sharded path)."""
    from kubedtn_tpu_torch import entry, runtime
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    m = {}
    el, state, _ = entry.build_clos_100k()
    groups = entry.build_live_tick(el, state, LIVE_ROWS, LIVE_SLOTS, 17)
    # congested links: some TBF rows start with a 200 ms queue, which the
    # max-plus core must flag for the fallback re-shape
    jam = groups["tbf"][0][:min(LIVE_JAMMED, LIVE_ROWS)].long()
    state.backlog_until[jam] = 2e5
    for kind, g in groups.items():
        check(tuple(g[1].shape) == (runtime._pad_rows(LIVE_ROWS),
                                    LIVE_SLOTS),
              f"{kind} group shape {tuple(g[1].shape)}")
    fused, ladder = tick_runs(state, groups, dev)
    t0 = time.perf_counter()
    want = fused(LIVE_TICKS)
    torch.cuda.synchronize()
    m["first_run_s"] = time.perf_counter() - t0
    same(ladder(LIVE_TICKS), want, "per-class ladder vs fused tick")
    log(f"live tick: fused == per-class ladder, bit for bit, over "
        f"{LIVE_TICKS} ticks (3 x {runtime._pad_rows(LIVE_ROWS)} rows x "
        f"{LIVE_SLOTS} slots, "
        f"capacity {state.capacity})")
    m.update(check_live_outputs(state, groups, want, dev))

    prof = m["profile"] = {}
    m["fused_wall_ms_per_tick"] = 1e3 * section(
        fused, LIVE_TIMED_TICKS, prof, "fused_tick")
    sub = runtime.split(runtime.tick_key(1))[1]
    for kind in runtime.CLASS_ORDER:
        def one_class(n, kind=kind):
            for _ in range(n):
                runtime.class_tick(state, None, sub, LIVE_ELAPSED_US,
                                   groups[kind], None, kind=kind)
        section(one_class, LIVE_TIMED_TICKS, prof, f"class_{kind}")
        p = prof[f"class_{kind}"]
        log(f"live tick class {kind}: device {p['device_us_per_call']:.1f} "
            f"us, wall {p['wall_us_per_call']:.1f} us, busy share "
            f"{p['busy_share']:.3f} ({card})")
    p = prof["fused_tick"]
    log(f"live tick fused: wall {p['wall_us_per_call'] / 1e3:.3f} ms/tick, "
        f"device {p['device_us_per_call'] / 1e3:.3f} ms/tick, busy share "
        f"{p['busy_share']:.3f} ({card})")

    pex.reset_launches()
    for S in LIVE_SHARDS:
        run = sharded_run(state, groups, make_mesh([dev] * S))
        same(run(LIVE_TICKS), want, f"sharded tick S={S} vs unsharded")
        xs = cross_shard_rows(groups, el.n_links, state.capacity, S)
        check(xs > 0, f"S={S}: no link pair straddles a block")
        wall = timed(run, LIVE_TIMED_TICKS) / LIVE_TIMED_TICKS
        m[f"sharded_S{S}"] = {"wall_ms_per_tick": wall * 1e3,
                              "cross_shard_rows_per_tick": xs}
        log(f"sharded tick S={S} virtual shards: bit for bit the unsharded "
            f"tick over {LIVE_TICKS} ticks; {xs} cross-shard rows per "
            f"tick; wall {wall * 1e3:.3f} ms/tick ({card})")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        mesh = make_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
        run = sharded_run(state, groups, mesh)
        same(run(LIVE_TICKS), want, "sharded tick on two cards vs unsharded")
        wall = timed(run, LIVE_TIMED_TICKS) / LIVE_TIMED_TICKS
        m["sharded_two_cards"] = {"wall_ms_per_tick": wall * 1e3}
        log(f"sharded tick on cuda:0 + cuda:1: bit for bit the unsharded "
            f"tick; wall {wall * 1e3:.3f} ms/tick")
    else:
        log(f"sharded tick on several cards: not run, {n_cards} CUDA "
            f"device visible and the phase needs 2")
    launches = pex.LAUNCHES["ring_step"]
    log(f"sharded path launches {dict(pex.LAUNCHES)}")
    check(launches > 0, "K4 never launched on the sharded path")
    return m, launches


def check_k4(dev, timer):
    """K4 against its plain version (the list rotation into new buffers),
    bit for bit, on 4 virtual shards, one launch per ring step; timed
    against its byte bound and torch.roll over the stacked mailbox."""
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([dev] * K4_SHARDS)
    out = {}
    for R in K4_ROWS:
        g = torch.Generator(device=dev).manual_seed(R)
        blocks = [torch.randint(-2 ** 31, 2 ** 31 - 1, (R, MAIL_WORDS),
                                generator=g, dtype=torch.int32, device=dev)
                  for _ in range(K4_SHARDS)]
        got = pex.ring_right_shift(blocks, mesh)
        want = pex.ring_right_shift_plain(blocks)
        same(got, want, f"K4 R={R}")
        err = max(float((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        stacked = torch.stack(blocks)
        same(torch.stack(got), torch.roll(stacked, 1, 0),
             f"K4 R={R} vs torch.roll")
        before = pex.LAUNCHES["ring_step"]
        pex.ring_right_shift(blocks, mesh)
        per_step = pex.LAUNCHES["ring_step"] - before
        check(per_step == len(pex.ring_plan(mesh)) == 1,
              f"K4 R={R}: {per_step} launches for one ring step on one card")
        moved = 2 * nbytes(*blocks)
        b, by = bound_ms(moved, 0)
        out[R] = dict(
            max_abs_err=err,
            ms=timer.ms(lambda: pex.ring_right_shift(blocks, mesh)),
            plain_ms=timer.ms(lambda: pex.ring_right_shift_plain(blocks)),
            library_ms=timer.ms(lambda: torch.roll(stacked, 1, 0)),
            bound_ms=b, bound_by=by, bytes=moved, shards=K4_SHARDS,
            launches_per_step=per_step)
        log(f"K4 R={R}: {out[R]}")
    return out


# -- the K-slot simulator and the routed fabric ------------------------------

def clone_state(state):
    """A copy of an EdgeState for an in-place batch op to change."""
    return type(state)(**{k: v.clone() for k, v in vars(state).items()})


def close_trees(card, cpu, name: str) -> float:
    """Nested dataclasses of tensors, card against CPU: counters, masks
    and integers exactly; float state within STATE_TOL, delivery times
    within DEPART_TOL. Returns the largest absolute error."""
    worst = 0.0
    for k, a in vars(card).items():
        b, label = getattr(cpu, k), f"{name}.{k}"
        if dataclasses.is_dataclass(a):
            worst = max(worst, close_trees(a, b, label))
        elif a.dtype != torch.float32 or ".counters" in label:
            check(torch.equal(a.cpu(), b), f"{label}: card and CPU differ")
        else:
            tol = DEPART_TOL if label.endswith("inflight.t") else STATE_TOL
            worst = max(worst, max_err(a.cpu(), b, tol, label))
    return worst


def host_ms(fn, reps: int = 3) -> float:
    """Median host ms of fn(), each ended by a device sync."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def k1_share(p: dict) -> float:
    """Kernel K1's share of a profiled section's device time."""
    k1 = sum(v for k, v in p["own_kernels_us_per_call"].items()
             if "shape_step_rows" in k)
    return k1 / p["device_us_per_call"]


def run_sim_phase(el, fresh, dev, card):
    """Phase 10: the K-slot simulator on the churned Clos. Returns
    (metrics, K1 launches of the path)."""
    from kubedtn_tpu_torch import convert, entry, sim
    from kubedtn_tpu_torch.models import traffic
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.ops.cuda import shaping

    m = {}
    n_rows = 2 * el.n_links
    sim0, spec = entry.build_sim(el, fresh, SIM_RATE_BPS, 1500.0, q=SIM_Q)
    shaping.reset_launches()
    t0 = time.perf_counter()
    out = sim.run(sim0, spec, SIM_STEPS, SIM_DT_US, SIM_K, seed=21)
    torch.cuda.synchronize()
    m["first_run_s"] = time.perf_counter() - t0
    launches = shaping.LAUNCHES["shape_step_rows"]
    check(launches == SIM_STEPS * SIM_K,
          f"sim path: {launches} K1 launches for {SIM_STEPS} steps of "
          f"{SIM_K} slots")
    # (a) the books close, per edge
    check(not bool(sim.conservation_residual(out).any()),
          "sim: tx + duplicated != rx + drops + in flight on some edge")
    # (b) K1 per slot against the plain step, through the whole run
    plain = sim.run(sim0, spec, SIM_STEPS, SIM_DT_US, SIM_K, seed=21,
                    shape_fn=queues.shape_packets_plain)
    check(shaping.LAUNCHES["shape_step_rows"] == launches,
          "the plain path launched K1")
    same(out, plain, "sim: K1 path vs plain path")
    log(f"sim: {SIM_STEPS} steps x {SIM_K} slots through K1 == the plain "
        f"path, bit for bit (E {fresh.capacity}, Q {SIM_Q}, "
        f"{launches} launches)")
    # (e) every outcome the configuration can raise was raised
    c = out.counters
    totals = {n: float(getattr(c, n).double().sum())
              for n in queues.COUNTER_NAMES}
    m["totals"] = totals
    for name in ("rx_packets", "dropped_loss", "dropped_queue",
                 "dropped_ring"):
        check(totals[name] > 0, f"sim: {name} stayed 0")
    check(totals["tx_packets"] == SIM_STEPS * n_rows * SIM_PKTS_PER_STEP,
          f"sim: offered {totals['tx_packets']} packets")
    # (c) the card against the port on the CPU, same draws
    gen = torch.Generator(device=dev).manual_seed(22)
    dt = sim.as_dt(SIM_DT_US, dev)
    draws = [sim.StepDraws(
        traffic=traffic.draw(spec, dt, SIM_K, gen),
        shape_u=queues.draw_shape_uniforms(fresh, SIM_K, gen))
        for _ in range(SIM_CPU_STEPS)]
    on_card = sim.run(sim0, spec, SIM_CPU_STEPS, SIM_DT_US, SIM_K,
                      draws=draws)
    t0 = time.perf_counter()
    on_cpu = sim.run(convert.tree_to(sim0, "cpu"),
                     convert.tree_to(spec, "cpu"), SIM_CPU_STEPS, SIM_DT_US,
                     SIM_K, draws=[convert.tree_to(d, "cpu") for d in draws])
    m["cpu_steps_s"] = time.perf_counter() - t0
    m["card_vs_cpu_max_abs_err"] = close_trees(on_card, on_cpu, "sim")
    log(f"sim: {SIM_CPU_STEPS} steps on the card == the CPU run on the "
        f"same draws (counters and masks exactly, floats within "
        f"{m['card_vs_cpu_max_abs_err']:.3g})")

    # steady state: from the run's end, rings filled
    def steps(n):
        sim.run(out, spec, n, SIM_DT_US, SIM_K, seed=23)

    prof = m["profile"] = {}
    wall = section(steps, SIM_TIMED_STEPS, prof, "sim_step")  # s per step
    p = prof["sim_step"]
    m.update(wall_ms_per_step=wall * 1e3, steps_per_s=1 / wall,
             packets_per_s=n_rows * SIM_PKTS_PER_STEP / wall,
             k1_share_of_device_time=k1_share(p))
    log(f"sim step: wall {m['wall_ms_per_step']:.3f} ms, device "
        f"{p['device_us_per_call'] / 1e3:.3f} ms per profiled step, busy "
        f"share {p['busy_share']:.3f}, K1 {100 * k1_share(p):.2f} % of "
        f"device time; {m['steps_per_s']:.1f} steps/s, "
        f"{m['packets_per_s']:.4g} offered packets/s ({card})")
    log(f"sim step top device ops: {p['top_device_us_per_call']}")
    return m, launches


def realises(state, dist, nh, name: str) -> None:
    """Every next hop realises its distance exactly, and there is one
    exactly where a path exists: dist[u, j] == w[nh] + dist[dst[nh], j]."""
    from kubedtn_tpu_torch.ops import routing

    w, dst = routing.edge_weights_latency(state), state.dst.long()
    ii, jj = torch.nonzero(nh >= 0, as_tuple=True)
    e = nh[ii, jj].long()
    check(torch.equal(w[e] + dist[dst[e], jj], dist[ii, jj]),
          f"{name}: a next hop does not realise its distance")
    check(torch.equal(nh >= 0, torch.isfinite(dist) & (dist > 0)),
          f"{name}: next hops and reachable pairs differ")


def run_routed_phase(el, fresh, dev, card, keep=None):
    """Phase 11: routes, a link event and the routed fabric on the
    churned Clos. Returns (metrics, K1 launches of the path); with
    `keep`, keep["routed"] = the fabric's (rs, spec, flow_dst) for phase
    22."""
    from kubedtn_tpu_torch import convert, entry, router, sim
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import queues, routing
    from kubedtn_tpu_torch.ops.cuda import shaping

    m = {}
    n = el.n_nodes
    leaves = np.arange(entry.N_SPINE, n)
    build = dict(seed=31, rate_bps=ROUTED_RATE_BPS, q=SIM_Q,
                 k_fwd=ROUTED_K_FWD, max_hops=ROUTE_HOPS)
    rs, spec, flow_dst, dist4 = entry.build_routed(el, fresh, leaves,
                                                   **build)
    rs_e, _, _, dist_e = entry.build_routed(el, fresh, leaves,
                                            k_paths=ROUTE_K_PATHS, **build)
    if keep is not None:
        keep["routed"] = (rs, spec, flow_dst)
    nh4, nh_e = rs.next_edge, rs_e.next_edge
    m["recompute_ms"] = host_ms(lambda: routing.recompute_routes(
        fresh, n, ROUTE_HOPS))
    m["recompute_ecmp_ms"] = host_ms(lambda: routing.recompute_routes_ecmp(
        fresh, n, ROUTE_K_PATHS, ROUTE_HOPS), reps=2)
    # the card against the port on the CPU, bit for bit
    cpu = convert.tree_to(fresh, "cpu")
    t0 = time.perf_counter()
    c_dist, c_nh = routing.recompute_routes(cpu, n, ROUTE_HOPS)
    _, c_nh_e = routing.recompute_routes_ecmp(cpu, n, ROUTE_K_PATHS,
                                              ROUTE_HOPS)
    m["cpu_recompute_s"] = time.perf_counter() - t0
    same([dist4, nh4, dist_e, nh_e], [c_dist, c_nh, c_dist, c_nh_e],
         "routes: card vs CPU")
    same(nh_e[:, :, 0], nh4, "ECMP's first pick vs the single path")
    leaf_block = dist4[entry.N_SPINE:, entry.N_SPINE:]
    check(bool(torch.isfinite(leaf_block).all()),
          "routes: a leaf cannot reach a leaf")
    # the hop bound cuts paths; the event below needs converged routes
    dist = routing.refine_dist(fresh, n, dist4, 64)
    nh = routing.next_hop_edges(fresh, dist, n)
    m["pairs_shorter_beyond_the_hop_bound"] = int((dist < dist4).sum())
    realises(fresh, dist, nh, "routes")
    log(f"routes: card == CPU bit for bit (dist, nh, ECMP k = "
        f"{ROUTE_K_PATHS}); every next hop realises its distance; "
        f"recompute {m['recompute_ms']:.2f} ms, ECMP "
        f"{m['recompute_ecmp_ms']:.2f} ms ({card})")

    # a 10-link event, both directions down, then up again
    # a random link of this Clos carries no shortest path (routes crowd
    # onto the few fastest uplinks): take the links that carry the most
    L = el.n_links
    used = torch.bincount(nh[nh >= 0].long() % L, minlength=L)
    top = torch.topk(used, EVENT_LINKS)
    links = top.indices.cpu().numpy()
    m["event_links_pairs_routed_over"] = top.values.tolist()
    both = np.concatenate([links, links + L])
    rows = torch.as_tensor(both, device=dev)
    w = routing.edge_weights_latency(fresh)[rows].cpu().numpy()
    s_k, d_k = fresh.src[rows].cpu().numpy(), fresh.dst[rows].cpu().numpy()
    inf = np.full(len(both), np.inf, np.float32)
    ones = np.ones(len(both), dtype=bool)
    down = es.delete_links(clone_state(fresh), both, ones)
    unknown = torch.full((n, n), torch.inf, device=dev)

    def event(state, dist, nh, w_old, w_new, name):
        t0 = time.perf_counter()
        d2, n2, cells = routing.update_routes_incremental(
            state, n, dist, nh, s_k, d_k, w_old, w_new)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        full = routing.refine_dist(state, n, unknown, 64)
        same(d2, full, f"{name}: incremental vs full recompute")
        realises(state, d2, n2, name)
        check(cells > 0, f"{name}: the event re-derived nothing")
        m[name] = {"ms": ms, "cells": cells}
        return d2, n2

    d_down, n_down = event(down, dist, nh, w, inf, "event_down")
    up = es.apply_links(clone_state(down), both, fresh.uid[rows],
                        fresh.src[rows], fresh.dst[rows], fresh.props[rows],
                        ones)
    d_up, _ = event(up, d_down, n_down, inf, w, "event_up")
    same(d_up, dist, "links up again: the first distances")
    log(f"link event ({EVENT_LINKS} links, both directions): incremental "
        f"== full recompute; down {m['event_down']}, up {m['event_up']} "
        f"of {n * n} cells ({card})")

    # the routed fabric: leaf -> spine rows bound for another leaf
    k_shape = SIM_K + ROUTED_K_FWD

    def run(rs, steps, seed=33, shape_fn=queues.shape_packets):
        return router.run_routed(rs, spec, flow_dst, steps, SIM_DT_US,
                                 SIM_K, ROUTED_K_FWD, seed=seed,
                                 shape_fn=shape_fn)

    shaping.reset_launches()
    out = run(rs, ROUTED_STEPS)
    launches = shaping.LAUNCHES["shape_step_rows"]
    check(launches == ROUTED_STEPS * k_shape,
          f"routed path: {launches} K1 launches for {ROUTED_STEPS} steps "
          f"of {k_shape} slots")
    same(run(rs, ROUTED_STEPS), out, "routed run vs its rerun")
    # K1 per slot (pending lanes arrive at 0, the state carried through
    # 12 launches a step) against the plain step, through the whole run
    plain = run(rs, ROUTED_STEPS, shape_fn=queues.shape_packets_plain)
    check(shaping.LAUNCHES["shape_step_rows"] == 2 * launches,
          "the plain routed path launched K1")
    same(plain, out, "routed: K1 path vs plain path")
    for name, o, steps in (("single path", out, ROUTED_STEPS),
                           ("ECMP", run(rs_e, ROUTED_ECMP_STEPS),
                            ROUTED_ECMP_STEPS)):
        check(not bool(sim.conservation_residual(o.sim).any()),
              f"routed {name}: an edge's books do not close")
        c = o.sim.counters
        sourced = steps * int((spec.mode == 1).sum())
        reinjected = float(c.tx_packets.double().sum()) - sourced
        balance = (float(o.node_rx_packets.double().sum()) + reinjected
                   + int((o.pend_dst >= 0).sum()) + float(o.fwd_dropped)
                   + float(o.no_route_dropped))
        check(float(c.rx_packets.double().sum()) == balance,
              f"routed {name}: transit packets are unaccounted for")
        check(float(o.no_route_dropped) == 0,
              f"routed {name}: packets found no route")
        check(reinjected > 0, f"routed {name}: nothing was forwarded")
    check(float(out.node_rx_packets.sum()) > 0,
          "routed: nothing reached its destination")
    check(not bool(out.node_rx_packets[:entry.N_SPINE].any()),
          "routed: a spine took delivery")
    m.update(node_rx_packets=float(out.node_rx_packets.sum()),
             fwd_dropped=float(out.fwd_dropped),
             forwarded=float(out.sim.counters.tx_packets.double().sum())
             - ROUTED_STEPS * int((spec.mode == 1).sum()))
    log(f"routed: {ROUTED_STEPS} steps x {k_shape} slots through K1 == "
        f"the plain path == the rerun, bit for bit; "
        f"{m['node_rx_packets']:.0f} packets delivered to their leaves, "
        f"{m['forwarded']:.0f} forwarded, {m['fwd_dropped']:.0f} "
        f"lost to forwarding overflow, 0 without a route")

    prof = m["profile"] = {}
    wall = section(lambda k: run(out, k, seed=34), ROUTED_TIMED_STEPS, prof,
                   "routed_step")
    p = prof["routed_step"]
    m.update(wall_ms_per_step=wall * 1e3,
             k1_share_of_device_time=k1_share(p))
    log(f"routed step: wall {m['wall_ms_per_step']:.3f} ms, device "
        f"{p['device_us_per_call'] / 1e3:.3f} ms per profiled step, busy "
        f"share {p['busy_share']:.3f}, K1 {100 * k1_share(p):.2f} % of "
        f"device time ({card})")
    log(f"routed step top device ops: {p['top_device_us_per_call']}")
    return m, launches


# -- phase 12: the host live plane -------------------------------------------

PLANE_ROWS = 4096           # rows per kernel class (the live tick's width)
PLANE_TICKS = 2             # explicit-clock ticks that feed frames (16
#                             until phase 16 joined, then 10; 6 since a
#                             whole run with phase 19 went over the
#                             script's time bound, 4 since phase 20
#                             joined, 2 since phase 21, PERF.md §4)
PLANE_DT_S = 0.01
PLANE_MAX_FRAMES = 64       # 1..64 frames per ingress wire and tick
PLANE_SIZES = (64, 257)     # frame bytes drawn from [64, 257)
PLANE_DRAIN_TICKS = 40      # idle ticks at most, to empty the delay line
PLANE_PROFILED = (1, 4)     # feed ticks [a, b) under torch.profiler
UPDATE_BATCH = 1000         # links in phase 12(a)'s UpdateLinks batch
GRPC_PAIRS = 8
GRPC_FRAMES = 20_000        # per wire and round
GRPC_ROUNDS = 3
GRPC_CHUNK = 256            # frames per PacketBatch message
GRPC_TIMEOUT_S = 60.0

# the three kernel classes' props, varied by link index (phase 12(b)).
# The TBF class is TBF-only (rate, latency; no draw decides anything):
# the 1 Mbit links overflow their 50 ms queue now and then, forcing the
# fallback re-shape, and a batch a newer in-flight dispatch shaped from
# the uncorrected bucket is re-shaped by the exact scan under the
# fallback draws, where depth 1 shapes it with the TBF core's draws, so
# with loss on such a row depth 2 would part from depth 1, in the JAX
# package too (ROADMAP §3)
CLASS_PROPS = {
    "tbf": [dict(latency="1ms", rate="1Mbit"),
            dict(latency="2ms", rate="20Mbit"),
            dict(latency="500us", rate="200Mbit"),
            dict(rate="2Gbit")],
    "seq": [dict(latency="2ms", jitter="500us", loss="2", loss_corr="25"),
            dict(latency="1ms", latency_corr="30", jitter="1ms"),
            dict(latency="3ms", reorder_prob="5", gap=2)],
    "ind": [dict(latency="3ms", jitter="1ms", loss="1"),
            dict(latency="1ms"),
            dict(latency="4ms", duplicate="2", corrupt_prob="1")],
}


def update_links_rpc(daemon, pod: str, links) -> None:
    """One Local.UpdateLinks through the Daemon's handler, in process."""
    from kubedtn_tpu_torch.wire import proto as pb

    q = pb.LinksBatchQuery(local_pod=pb.Pod(name=pod, kube_ns="default"),
                           links=[pb.link_to_proto(l) for l in links])
    check(daemon.UpdateLinks(q, None).response, f"UpdateLinks {pod} failed")


def same_columns(a, b, name: str) -> None:
    """Every EdgeState column and every row binding equal, exactly."""
    ea, eb = a["engine"], b["engine"]
    check(ea._rows == eb._rows, f"{name}: row bindings differ")
    sa, sb = ea.state, eb.state
    for f in dataclasses.fields(sa):
        check(torch.equal(getattr(sa, f.name).cpu(),
                          getattr(sb, f.name).cpu()),
              f"{name}: column {f.name} differs")


def plane_classes(built, n_rows: int) -> dict:
    """The first 3 * n_rows spine links in order, a third per class,
    re-shaped by one UpdateLinks per spine CR through the Daemon's
    handler (the spine end is the link's ingress direction). Returns
    {kind: [(spine pod, leaf pod, uid)]}."""
    from kubedtn_tpu_torch.api.types import LinkProperties

    store, daemon = built["store"], built["daemon"]
    kinds = ("tbf", "seq", "ind")
    out = {k: [] for k in kinds}
    need = 3 * n_rows
    i = 0
    for t in sorted(store.list(), key=lambda t: (len(t.name), t.name)):
        if not t.name.startswith("spine") or i >= need:
            continue
        new = []
        for link in t.spec.links[:need - i]:
            kind = kinds[i // n_rows]
            props = CLASS_PROPS[kind][i % len(CLASS_PROPS[kind])]
            new.append(link.with_properties(LinkProperties(**props)))
            out[kind].append((t.name, link.peer_pod, link.uid))
            i += 1
        update_links_rpc(daemon, t.name, new)
    return out


def plane_wires(daemon, classes):
    """Wires on both ends of every class link: (ingress, egress) lists."""
    import types

    def wd(pod, uid):
        return types.SimpleNamespace(
            local_pod_name=pod, kube_ns="default", link_uid=uid,
            intf_name_in_pod="eth1", veth_name_local_host="",
            peer_intf_id=0, peer_ip="")

    win, wout = [], []
    for links in classes.values():
        for spine, leaf, uid in links:
            win.append(daemon._add_wire(wd(spine, uid)))
            wout.append(daemon._add_wire(wd(leaf, uid)))
    return win, wout


def feed_tick(win, t: int, rng, max_frames: int = PLANE_MAX_FRAMES) -> int:
    """1..max_frames tagged frames on every ingress wire, as ONE
    FrameSeg window each over one blob for the tick (the bulk ingress
    form). A frame's first 8 bytes are its tag (wire, tick, index).
    Returns the frames fed."""
    return apply_feed(win, make_feed(len(win), t, rng, max_frames))


def apply_feed(win, feed) -> int:
    """Queue a make_feed tick on the wires `win` (one FrameSeg window of
    the shared blob per wire); returns the frames fed."""
    from kubedtn_tpu_torch.wire.server import FrameSeg

    blob, offs, lens, counts = feed
    lo = 0
    for w, c in zip(win, counts):
        w.ingress.append(FrameSeg(blob, offs, lens, lo, lo + c))
        lo += c
    return lo


def make_feed(n: int, t: int, rng, max_frames: int = PLANE_MAX_FRAMES):
    """One tick's feed for n ingress wires: (blob, offsets, lengths,
    per-wire counts), the frames tagged (wire index, tick, index)."""
    counts = rng.integers(1, max_frames + 1, n)
    total = int(counts.sum())
    lens = rng.integers(*PLANE_SIZES, total).astype(np.uint64)
    offs = np.zeros(total, np.uint64)
    np.cumsum(lens[:-1], out=offs[1:])
    blob = np.full(int(lens.sum()), 0x5A, np.uint8)
    wire_of = np.repeat(np.arange(n, dtype=np.uint32), counts)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx = np.arange(total) - np.repeat(first, counts)
    tag = np.zeros((total, 8), np.uint8)
    tag[:, :4] = wire_of.view(np.uint8).reshape(-1, 4)
    tag[:, 4:6] = np.array([t], np.uint16).view(np.uint8)
    tag[:, 6:8] = idx.astype(np.uint16).view(np.uint8).reshape(-1, 2)
    pos = offs.astype(np.int64)[:, None] + np.arange(8)
    blob[pos] = tag
    return blob.tobytes(), offs, lens, counts.tolist()


def plane_run(built, win, wout, state0, seed: int, depth: int,
              telemetry: bool = False, mesh=None, profile: bool = False):
    """One run of phase 12(b): a fresh plane over the engine restored to
    `state0`, PLANE_TICKS feed ticks of PLANE_DT_S, then idle ticks until
    the delay line is empty. Returns a dict with the per-wire egress
    digests and counts, the counters, the plane, and the timings."""
    import hashlib

    from kubedtn_tpu_torch import entry

    engine = built["engine"]
    engine.state = clone_state(state0)
    plane = entry.build_plane(built["daemon"], dt_us=PLANE_DT_S * 1e6,
                              seed=seed, pipeline_depth=depth)
    plane.pipeline_explicit_clock = True
    if telemetry:
        plane.enable_telemetry(window_s=3600.0, sample_period=1024)
    if mesh is not None:
        plane.enable_sharding(mesh)
    rng = np.random.default_rng(seed)
    digests = [hashlib.blake2b(digest_size=16) for _ in wout]
    counts = [0] * len(wout)
    fed = 0
    walls = []
    prof_out = None
    dev = engine.device

    def collect():
        # explicit-clock ticks on this thread: nothing appends to an
        # egress deque while it is read here
        for k, w in enumerate(wout):
            if w.egress:
                digests[k].update(b"".join(w.egress))
                counts[k] += len(w.egress)
                w.egress.clear()

    t = 0
    prof_ctx = p_t0 = None
    for t in range(PLANE_TICKS):
        fed += feed_tick(win, t, rng)
        if profile and t == PLANE_PROFILED[0] and dev.type == "cuda":
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile

            torch.cuda.synchronize()
            prof_ctx = tprofile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof_ctx.__enter__()
            p_t0 = time.perf_counter()
        w0 = time.perf_counter()
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - w0)
        if prof_ctx is not None and t == PLANE_PROFILED[1] - 1:
            p_wall = time.perf_counter() - p_t0
            prof_ctx.__exit__(None, None, None)
            n = PLANE_PROFILED[1] - PLANE_PROFILED[0]
            dev_us = sum(e.time_range.elapsed_us()
                         for e in prof_ctx.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            prof_out = {"device_ms_per_tick": dev_us / 1e3 / n,
                        "busy_share": dev_us / 1e6 / p_wall}
            prof_ctx = None
        collect()
    feed_wall = sum(walls)
    shaped_fed = plane.shaped
    for j in range(PLANE_DRAIN_TICKS):
        t += 1
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        collect()
        if (not plane._inflight and not plane._holdback
                and len(plane._wheel) == 0):
            break
    plane.flush()
    collect()
    check(plane.tick_errors == 0, "live plane: tick errors")
    check(len(plane._wheel) == 0 and not plane._pending,
          "live plane: delay line not empty after the drain")
    c = plane.counters
    return {"digests": [d.hexdigest() for d in digests], "counts": counts,
            "fed": fed, "plane": plane, "counters": c,
            "feed_wall_s": feed_wall, "wall_ms_per_tick":
            1e3 * statistics.median(walls), "shaped_in_feed": shaped_fed,
            "profile": prof_out}


def same_egress(a: dict, b: dict, name: str) -> None:
    check(a["counts"] == b["counts"], f"{name}: per-wire egress counts "
                                      f"differ")
    check(a["digests"] == b["digests"], f"{name}: per-wire egress bytes "
                                        f"differ")
    pa, pb = a["plane"], b["plane"]
    check((pa.shaped, pa.dropped) == (pb.shaped, pb.dropped),
          f"{name}: shaped/dropped differ")
    for f in dataclasses.fields(a["counters"]):
        check(np.array_equal(getattr(a["counters"], f.name),
                             getattr(b["counters"], f.name)),
              f"{name}: counter {f.name} differs")


def books_close(r: dict, name: str) -> None:
    """Per edge rx + loss + queue == tx; shaped + dropped == fed."""
    c, p = r["counters"], r["plane"]
    check(np.array_equal(c.rx_packets + c.dropped_loss + c.dropped_queue,
                         c.tx_packets), f"{name}: per-edge books open")
    check(p.shaped + p.dropped == r["fed"] == int(c.tx_packets.sum()),
          f"{name}: shaped {p.shaped} + dropped {p.dropped} != fed "
          f"{r['fed']}")
    check(sum(r["counts"]) == p.shaped, f"{name}: egress != shaped")


GRPC_INJECTOR = r"""
import sys, time
import grpc
sys.path.insert(0, sys.argv[1])
from kubedtn_tpu_torch.wire import proto as pb
port, wids, n, chunk = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
wids = [int(w) for w in wids.split(",")]
frame = lambda w, i: w.to_bytes(4, "big") + i.to_bytes(4, "big") + bytes(56)
msgs = []
for lo in range(0, n, chunk):
    for w in wids:
        msgs.append(pb.PacketBatch(packets=[
            pb.Packet(remot_intf_id=w, frame=frame(w, i))
            for i in range(lo, min(n, lo + chunk))]))
ch = grpc.insecure_channel(f"127.0.0.1:{port}")
call = ch.stream_unary("/proto.v1.WireProtocol/SendToBulk",
                       request_serializer=pb.PacketBatch.SerializeToString,
                       response_deserializer=pb.BoolResponse.FromString)
t0 = time.perf_counter()
ok = call(iter(msgs)).response
print(ok, time.perf_counter() - t0, flush=True)
ch.close()
"""


def run_grpc_phase(dev, card) -> dict:
    """Phase 12(e): the real-time runner behind a real gRPC server; a
    client process streams GRPC_FRAMES frames per wire over SendToBulk;
    every frame must be delivered. Median frames/s of GRPC_ROUNDS rounds
    after one warm-up round."""
    import os
    import subprocess

    from kubedtn_tpu_torch import scenarios

    # the live-plane scenarios' set-up: GRPC_PAIRS pairs of 5 ms links
    # on a real gRPC daemon, the runner started
    _daemon, server, port, plane, win, wout = scenarios._live_plane_setup(
        GRPC_PAIRS, "5ms", 2_000.0, "lp", device=dev)
    root = os.path.dirname(os.path.abspath(__file__))
    wids = ",".join(str(w.wire_id) for w in win)
    total = GRPC_PAIRS * GRPC_FRAMES

    def one_round() -> float:
        for w in wout:
            w.egress.clear()
        proc = subprocess.Popen(
            [sys.executable, "-c", GRPC_INJECTOR, root, str(port), wids,
             str(GRPC_FRAMES), str(GRPC_CHUNK)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            deadline = time.monotonic() + GRPC_TIMEOUT_S
            done, t_first = 0, None
            while time.monotonic() < deadline:
                done = sum(len(w.egress) for w in wout)
                if done and t_first is None:
                    t_first = time.perf_counter()
                if done >= total:
                    break
                time.sleep(0.002)
            elapsed = time.perf_counter() - t_first if t_first else 0.0
            out, err = proc.communicate(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"gRPC injector failed: {err[-2000:]}")
        check(done == total, f"gRPC round delivered {done} of {total}")
        got = [list(w.egress) for w in wout]
        for k, frames in enumerate(got):
            want = [win[k].wire_id.to_bytes(4, "big") + i.to_bytes(4, "big")
                    + bytes(56) for i in range(GRPC_FRAMES)]
            check(frames == want, f"gRPC wire {k}: frames differ")
        return total / elapsed

    try:
        one_round()  # warm-up: kernel loads, first ticks
        rates = sorted(one_round() for _ in range(GRPC_ROUNDS))
    finally:
        plane.stop()
        server.stop(0)
    check(plane.tick_errors == 0, "gRPC plane: tick errors")
    m = {"frames_per_s": statistics.median(rates), "rates": rates,
         "pairs": GRPC_PAIRS, "frames_per_wire": GRPC_FRAMES,
         "stage": plane.stage_breakdown()}
    log(f"12(e) gRPC: {GRPC_PAIRS} pairs at 5 ms, {GRPC_FRAMES} frames per "
        f"wire over SendToBulk, all delivered in order; median "
        f"{m['frames_per_s']:.1f} frames/s of {GRPC_ROUNDS} rounds "
        f"{[round(r, 1) for r in rates]} ({card})")
    return m


def run_live_plane_phase(dev, card, n_spine=None, n_leaf=None,
                         n_rows: int = PLANE_ROWS) -> tuple:
    """Phase 12: the host live plane at the 100k-link Clos. Returns
    (metrics, K4 launches of the sharded plane)."""
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.edge_state import props_row, burst_bytes
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh
    from kubedtn_tpu_torch.telemetry import (T_DELIVERED, T_DROP_LOSS,
                                             T_DROP_QUEUE, T_TX)
    from kubedtn_tpu_torch.topology.engine import ping_inputs

    m = {}
    size = {} if n_spine is None else dict(n_spine=n_spine, n_leaf=n_leaf,
                                           capacity=1 << 12)
    # (a) control plane: 600 CRs -> store -> reconciler -> engine
    built = entry.build_daemon(dev, **size)
    m["reconcile_s"] = built["reconcile_s"]
    cpu = entry.build_daemon("cpu", **size)
    same_columns(built, cpu, "12(a) realized state vs the CPU build")
    engine = built["engine"]
    log(f"12(a) control plane: {len(built['crs'])} CRs, "
        f"{engine.num_active} rows in capacity {engine.state.capacity}; "
        f"reconcile-to-steady {m['reconcile_s']:.3f} s; realized columns "
        f"== the CPU engine's from the same CRs ({card})")
    spine0 = built["store"].get("default", "spine0")
    new = LinkProperties(latency="20ms", jitter="1ms", rate="1Gbit")
    batch = [l.with_properties(new)
             for l in spine0.spec.links[:UPDATE_BATCH]]
    update_links_rpc(cpu["daemon"], "spine0", batch)  # (loads proto)
    t0 = time.perf_counter()
    update_links_rpc(built["daemon"], "spine0", batch)
    engine.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    m["update_links_ms"] = 1e3 * (time.perf_counter() - t0)
    same_columns(built, cpu, "12(a) after UpdateLinks vs the CPU engine")
    rows = [engine.row_of("default/spine0", l.uid) for l in batch]
    want = torch.as_tensor(props_row(new.to_numeric()), device=dev)
    st = engine.state
    check(bool((st.props[rows] == want).all()), "UpdateLinks props")
    check(bool((st.tokens[rows] == burst_bytes(want[5:6])).all()),
          "UpdateLinks did not refill the buckets")
    log(f"12(a) UpdateLinks: {len(batch)} links through the Daemon's Local "
        f"handler in {m['update_links_ms']:.3f} ms, state == the CPU "
        f"engine's ({card})")

    # (d) ping on one deterministic link (latency 10 ms, no jitter, on
    # the last spine, which no later step re-shapes): K1
    spine = max((t.name for t in built["store"].list()
                 if t.name.startswith("spine")), key=lambda n: int(n[5:]))
    link = built["store"].get("default", spine).spec.links[0]
    leaf, uid = link.peer_pod, link.uid
    ra = engine.row_of(f"default/{spine}", uid)
    rb = engine.row_of(f"default/{leaf}", uid)
    plain_in = ping_inputs(engine.state, (ra, rb), 84.0, uid, 3)
    _ps, plain = netem.shape_step(clone_state(engine.state), *plain_in)
    r = engine.ping(spine, leaf, uid, seed=3)
    check(r["reachable"], "ping: not delivered")
    check(r["fwd_us"] == float(plain.depart_us[ra])
          and r["rev_us"] == float(plain.depart_us[rb]),
          "ping: K1 differs from the plain step")
    check(r["fwd_us"] == 10_000.0 and r["rev_us"] == 10_000.0,
          f"ping: one-way delays {r['fwd_us']} / {r['rev_us']} us, the "
          f"link's latency is 10,000 us")
    m["ping"] = r
    log(f"12(d) ping {spine}->{leaf} uid {uid}: one-way {r['fwd_us']} us "
        f"and {r['rev_us']} us == the link's 10 ms latency; K1 == the plain "
        f"step ({card})")

    # (b) the data plane at the live tick's width
    classes = plane_classes(built, n_rows)
    win, wout = plane_wires(built["daemon"], classes)
    state0 = clone_state(engine.state)
    seed = 12
    # depth 1 with telemetry off against depth 2 with telemetry on: one
    # comparison holds both contracts (a run apiece costs ~30 s here)
    d1 = plane_run(built, win, wout, state0, seed, depth=1)
    d2 = plane_run(built, win, wout, state0, seed, depth=2, telemetry=True,
                   profile=True)
    same_egress(d1, d2, "12(b) depth 2 + telemetry on vs depth 1 off")
    for name, r in (("depth 1", d1), ("depth 2", d2)):
        books_close(r, f"12(b) {name}")
    total, _secs = d2["plane"].telemetry.window_sum()
    c = d2["counters"]
    for col, arr in ((T_TX, c.tx_packets), (T_DELIVERED, c.rx_packets),
                     (T_DROP_LOSS, c.dropped_loss),
                     (T_DROP_QUEUE, c.dropped_queue)):
        check(np.array_equal(total[:len(arr), col], arr),
              f"12(b) window column {col} != the counters")
    for r in (d1, d2):
        check(r["plane"].fallbacks > 0, "12(b) the TBF fallback never ran")
    p2 = d2["plane"]
    m["plane"] = {
        "rows_per_class": n_rows, "wires": len(win) + len(wout),
        "fed": d1["fed"], "shaped": d1["plane"].shaped,
        "dropped": d1["plane"].dropped,
        "fallback_rows": d1["plane"].fallbacks,
        "wall_ms_per_tick_depth1": d1["wall_ms_per_tick"],
        "wall_ms_per_tick_depth2": d2["wall_ms_per_tick"],
        "frames_shaped_per_s_depth1": d1["shaped_in_feed"]
        / d1["feed_wall_s"],
        "frames_shaped_per_s_depth2": d2["shaped_in_feed"]
        / d2["feed_wall_s"],
        "stage_depth1": d1["plane"].stage_breakdown(),
        "stage_depth2": p2.stage_breakdown(),
        "profile_depth2": d2["profile"]}
    mp = m["plane"]
    log(f"12(b) live plane: 3 x {n_rows} rows, {len(win)} + {len(wout)} "
        f"wires, {PLANE_TICKS} ticks of {PLANE_DT_S * 1e3:.0f} ms, "
        f"{d1['fed']} frames fed, {mp['shaped']} shaped, {mp['dropped']} "
        f"dropped, {mp['fallback_rows']} TBF fallback rows; depth 1 "
        f"(telemetry off) == depth 2 (telemetry on), byte for byte per "
        f"wire; books closed per edge; window totals == counters")
    for d, r in (("1", d1), ("2 + telemetry", d2)):
        sh = r["plane"].stage_breakdown()["share"]
        log(f"12(b) depth {d}: wall {r['wall_ms_per_tick']:.3f} ms/tick "
            f"(median), {r['shaped_in_feed'] / r['feed_wall_s']:.1f} "
            f"frames shaped/s; stage shares {sh} ({card})")
    if d2["profile"] is not None:
        log(f"12(b) depth 2 + telemetry device "
            f"{d2['profile']['device_ms_per_tick']:.3f}"
            f" ms/tick, busy share {d2['profile']['busy_share']:.4f} "
            f"(torch.profiler over ticks {PLANE_PROFILED}) ({card})")

    # (c) the sharded plane: 2 virtual shards, and two cards where there
    # are two; K4 launches counted from 0
    pex.reset_launches()
    meshes = [("2 virtual shards", make_mesh([dev] * 2))]
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 2:
        meshes.append(("cuda:0 + cuda:1", make_mesh(
            [torch.device("cuda", 0), torch.device("cuda", 1)])))
    probes = []
    for name, mesh in meshes:
        sh = plane_run(built, win, wout, state0, seed, depth=2, mesh=mesh)
        same_egress(sh, d1, f"12(c) sharded on {name} vs unsharded")
        summ = sh["plane"].shard_summary()
        runs = sh["plane"].shard_exchange_runs
        # 22(f): the sampled exchange probe ran on dispatches 1, 65, ...
        check(summ["exchange_seconds"] > 0 and runs >= 1,
              f"22(f) {name}: exchange_seconds {summ['exchange_seconds']} "
              f"after {runs} probe runs")
        probes.append((sh["plane"]._exchange_probe, mesh))
        m[f"sharded {name}"] = {
            "wall_ms_per_tick": sh["wall_ms_per_tick"],
            "xshard_frames": summ["xshard_frames"],
            "mailbox_hwm": summ["mailbox_hwm"],
            "exchange_seconds": summ["exchange_seconds"],
            "exchange_probe_runs": runs}
        log(f"12(c) sharded plane on {name}: per-wire egress == unsharded; "
            f"{summ['xshard_frames']} cross-shard frames; wall "
            f"{sh['wall_ms_per_tick']:.3f} ms/tick; 22(f) exchange probe "
            f"{runs} runs, exchange_seconds {summ['exchange_seconds']} "
            f"({card})")
    if n_cards < 2:
        log(f"12(c) sharded plane on two cards: not run, {n_cards} CUDA "
            f"device visible and it needs 2")
    k4 = pex.LAUNCHES["ring_step"]
    log(f"12(c) K4 launches on the sharded planes and their probes: {k4}")
    check(k4 > 0 or dev.type != "cuda", "K4 never launched on the plane")
    # 22(f): the probe's output once against the plain ring, on a
    # mailbox whose rows every shard owns (these launches only compare)
    from kubedtn_tpu_torch import runtime as rt
    from kubedtn_tpu_torch.ops.edge_state import NCORR, NPROP

    probe_fn, mesh = probes[0]
    g = torch.Generator(device=dev).manual_seed(12)
    fm = torch.randn((PLANE_ROWS, NPROP + 3 + NCORR), generator=g,
                     device=dev)
    im = torch.randint(-9, 9, (PLANE_ROWS, 3), generator=g, device=dev,
                       dtype=torch.int32)
    im[:, pex.OWNER_COL] = 1
    k0 = pex.LAUNCHES["ring_step"]
    got = probe_fn(fm, im)
    _sync(dev)
    probe_launches = pex.LAUNCHES["ring_step"] - k0
    cpu_mesh = make_mesh([torch.device("cpu")] * len(mesh))
    same(got, rt.exchange_probe(cpu_mesh)(fm.cpu(), im.cpu()),
         "22(f) the exchange probe vs the plain ring")
    want_launches = ((len(mesh) - 1) * len(pex.ring_plan(mesh))
                     if dev.type == "cuda" else 0)
    check(probe_launches == want_launches,
          f"22(f): a probe run launched K4 {probe_launches} times, want "
          f"{want_launches}")
    log(f"22(f) the exchange probe on {len(mesh)} virtual shards == the "
        f"plain ring, bit for bit, on a {PLANE_ROWS}-row mailbox; "
        f"{probe_launches} K4 launches a run ({card})")

    # (e) gRPC, where it imports
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
        have_grpc = True
    except ImportError as e:
        have_grpc, why = False, str(e)
    if have_grpc:
        m["grpc"] = run_grpc_phase(dev, card)
    else:
        log(f"12(e) gRPC: not run, grpc/protobuf do not import here: {why}")
    return m, k4


# -- phase 13: two daemons, cross-node egress --------------------------------

XN_B_LEAVES = 62            # leaves 0..61 on node B: 100 x 62 x 2 links
XN_TICKS = 3                # full-feed ticks (phase 12's feed; 10 there:
#                             a tick here takes 4.0-5.2 s on an NVIDIA
#                             H100 80GB HBM3 at 700.00 W, PERF.md; 8
#                             until phase 14 joined, 6 until phase 15
#                             did, 4 until phase 17 did: 3 keep the
#                             script in its time budget)
XN_EQ_TICKS = 16            # equality-feed ticks, 1 frame per wire;
#                             cut from 32 to keep the script, phase 14
#                             included, near 600 s, from 24 when phase
#                             15 joined, from 20 when phase 17 did. The
#                             flap run opens A's breaker by an outage of
#                             B first: under the flap alone each first
#                             failure opened it with probability ~1/4
#                             and a run on the card saw 0 opens in 23
#                             retries (PERF.md)
XN_REF_TICKS = 4            # the reference-peer round's ticks: the
#                             per-frame stream moved ~2,000 frames/s
#                             with both daemons in one interpreter (NVIDIA
#                             H100 80GB HBM3 host, 700.00 W, PERF.md)
XN_FLUSH_S = 120.0          # bound on every flush_peers wait
XN_CHILD_S = 600.0          # bound on every answer of node B's process
XN_FLAP = (0.05, 0.5)       # flap period (s) and share down, run (c)
XN_FORWARD_TIMEOUT_S = 30.0  # node A's deadline floor in this phase:
#                              an attempt's deadline, forward_timeout_s +
#                              0.02 s a 256-frame chunk, is priced for
#                              bulk chunks; at the Daemon's default 0.5 s
#                              slices missed it on the card (the stream
#                              fallback; bulk slices while A's tick held
#                              the interpreter lock) and their retries
#                              delivered frames twice (ROADMAP §3,
#                              PERF.md); the phase checks exactly-once
#                              books


class _AdapterClient:
    """An in-process peer: Update(request) on another Daemon (the CPU
    reference of 13(a) runs without sockets)."""

    def __init__(self, daemon) -> None:
        self.daemon = daemon

    def Update(self, request):
        return self.daemon.Update(request, None)


def _peer_daemon_cls():
    """Node B's Daemon; with refuse_bulk it answers SendToBulk
    UNIMPLEMENTED, as a reference-built daemon does."""
    import grpc

    from kubedtn_tpu_torch.wire.server import Daemon

    class PeerDaemon(Daemon):
        refuse_bulk = False

        def SendToBulk(self, request_iterator, context):
            if self.refuse_bulk:
                context.abort(grpc.StatusCode.UNIMPLEMENTED,
                              "method SendToBulk not implemented")
            return super().SendToBulk(request_iterator, context)

    return PeerDaemon


def xn_node_b_main(conn, dev: str, cap: int) -> None:
    """Node B's process: its store, engine on `dev`, Daemon and gRPC
    server on 127.0.0.1 port 0, then one answer ("ok", value) or
    ("err", traceback) per request (op, args) from the script until
    "stop". Its first message is its address."""
    import hashlib
    import traceback

    from kubedtn_tpu_torch.wire.server import make_server

    try:
        n = xn_node(torch.device(dev), [], "", cap,
                    daemon_cls=_peer_daemon_cls())
        srv, port = make_server(n["daemon"], port=0, host="127.0.0.1",
                                log_rpcs=False)
        srv.start()
        addr = n["engine"].node_ip = f"127.0.0.1:{port}"
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    engine, daemon = n["engine"], n["daemon"]

    def crs(addr_a, n_spine, n_leaf, n_b):
        for t in xn_crs(n_spine, n_leaf, n_b, addr_a, addr, "b"):
            n["store"].create(t)
        engine.warm_kernels()

    def reconcile():
        n["reconciler"].drain()
        engine.flush()
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        return engine.num_active, engine.stats.remote_errors

    def columns():
        st = engine.state
        return dict(engine._rows), {
            f.name: getattr(st, f.name).cpu().numpy()
            for f in dataclasses.fields(st)}

    def egress(keys):
        """Per wire end: digest and count of its pod-side egress, then
        cleared."""
        digests, counts = [], []
        for key in keys:
            w = daemon.wires.get_by_key(*key)
            frames = list(w.egress)
            w.egress.clear()
            digests.append(hashlib.blake2b(b"".join(frames),
                                           digest_size=16).hexdigest())
            counts.append(len(frames))
        return digests, counts

    def refuse_bulk(flag):
        daemon.refuse_bulk = flag

    ops = {"crs": crs, "reconcile": reconcile, "columns": columns,
           "egress": egress, "refuse_bulk": refuse_bulk,
           "has_wires": lambda keys: [daemon.wires.get_by_key(*k)
                                      is not None for k in keys],
           "bulk_unresolved": lambda: daemon.bulk_unresolved}
    conn.send(("ok", addr))
    try:
        while True:
            op, args = conn.recv()
            if op == "stop":
                break
            try:
                conn.send(("ok", ops[op](*args)))
            except BaseException:
                conn.send(("err", traceback.format_exc()))
    finally:
        srv.stop(0)
        conn.close()


class NodeB:
    """Node B in a child process (spawned: the card cannot be shared
    through a fork), so its handlers do not take A's interpreter lock:
    two daemons on two nodes are two processes. Calling it runs one op
    there and returns its value."""

    def __init__(self, dev, cap: int) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=xn_node_b_main,
                                args=(child, str(dev), cap), daemon=True)
        self.proc.start()
        child.close()
        self.addr = self._answer("start")

    def _answer(self, op: str):
        check(self.conn.poll(XN_CHILD_S),
              f"13: node B did not answer {op} in {XN_CHILD_S} s")
        try:
            status, out = self.conn.recv()
        except EOFError:
            fail(f"13: node B's process ended at {op} (exit code "
                 f"{self.proc.exitcode})")
        check(status == "ok", f"13: node B failed {op}: {out}")
        return out

    def __call__(self, op: str, *args):
        self.conn.send((op, args))
        return self._answer(op)

    def close(self) -> None:
        try:
            self.conn.send(("stop", ()))
        except OSError:
            pass
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self.conn.close()


def xn_crs(n_spine, n_leaf, n_b, addr_a, addr_b, owner):
    """The Clos CRs as node `owner` ("a" or "b") sees the cluster:
    leaves 0..n_b-1 are placed on node B, every other pod on node A;
    the other node's pods are recorded as realized there (status.links
    == spec.links), so this node's reconciler realizes only its own."""
    from kubedtn_tpu_torch import entry

    crs = entry.clos_crs(n_spine, n_leaf, node_ip=addr_a)
    for t in crs:
        on_b = t.name.startswith("leaf") and int(t.name[4:]) < n_b
        if on_b:
            t.status.src_ip = addr_b
        if on_b != (owner == "b"):
            t.status.links = list(t.spec.links)
    return crs


def xn_node(dev, crs, addr, capacity, daemon_cls=None, dialer=None):
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon

    store = TopologyStore()
    engine = SimEngine(store, capacity=capacity, node_ip=addr, device=dev,
                       dialer=dialer)
    for t in crs:
        store.create(t)
    return {"store": store, "engine": engine,
            "reconciler": Reconciler(store, engine),
            "daemon": (daemon_cls or Daemon)(engine)}


def xn_reconcile(a, b) -> None:
    """Two in-process nodes (the CPU reference of 13(a)): node A's
    reconciler, then node B's (each realizes its own pods, completing
    the far ends through Remote.Update), then A's engine flushed again,
    as the card's nodes run."""
    a["reconciler"].drain()
    a["engine"].flush()
    b["reconciler"].drain()
    b["engine"].flush()
    a["engine"].flush()


def xn_classes(a, n_rows: int, n_b: int) -> dict:
    """The first 3 * n_rows cross-node links (spine -> leaf on B) in
    spine order, a third per kernel class, re-shaped by one UpdateLinks
    per spine CR through node A's handler."""
    from kubedtn_tpu_torch.api.types import LinkProperties

    kinds = ("tbf", "seq", "ind")
    out = {k: [] for k in kinds}
    need, i = 3 * n_rows, 0
    for t in sorted(a["store"].list(), key=lambda t: (len(t.name), t.name)):
        if not t.name.startswith("spine") or i >= need:
            continue
        new = []
        for link in t.spec.links:
            if i >= need or int(link.peer_pod[4:]) >= n_b:
                continue
            kind = kinds[i // n_rows]
            props = CLASS_PROPS[kind][i % len(CLASS_PROPS[kind])]
            new.append(link.with_properties(LinkProperties(**props)))
            out[kind].append((t.name, link.peer_pod, link.uid))
            i += 1
        if new:
            update_links_rpc(a["daemon"], t.name, new)
    check(i == need, f"13(b): only {i} cross-node links, need {need}")
    return out


def xn_wires(a, nb, addr_a, addr_b, classes):
    """B's wire ends by AddGRPCWireRemote over gRPC, then A's ends
    pointing at them. Returns (A's ingress wires, the keys of B's
    pod-side wire ends)."""
    import types

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    c = DaemonClient(addr_b)
    win, keys = [], []
    try:
        for links in classes.values():
            for spine, leaf, uid in links:
                r = c.AddGRPCWireRemote(pb.WireDef(
                    local_pod_name=leaf, kube_ns="default", link_uid=uid,
                    intf_name_in_pod="eth1", peer_ip=addr_a))
                check(r.response, "13(b): AddGRPCWireRemote failed")
                win.append(a["daemon"]._add_wire(types.SimpleNamespace(
                    local_pod_name=spine, kube_ns="default", link_uid=uid,
                    intf_name_in_pod="eth1", veth_name_local_host="",
                    peer_intf_id=r.peer_intf_id, peer_ip=addr_b)))
                keys.append((f"default/{leaf}", uid))
    finally:
        c.close()
    check(all(nb("has_wires", keys)), "13(b): a wire end at B is missing")
    return win, keys


def xn_run(a, nb, addr_b, keys, win, state0, seed: int, depth: int,
           ticks: int, max_frames: int, name: str, telemetry: bool = False,
           chaos=None):
    """One run of phase 13: a fresh plane on node A over its engine
    restored to `state0`, `ticks` explicit-clock feed ticks of
    PLANE_DT_S (1..max_frames frames per ingress wire), idle ticks until
    the delay line is empty (under `chaos`, B flaps until then), then
    flush_peers. Returns B's pod-side egress per wire end `keys`
    (digests, counts) and A's books."""
    from kubedtn_tpu_torch import entry, runtime

    engine = a["engine"]
    engine.state = clone_state(state0)
    plane = entry.build_plane(a["daemon"], dt_us=PLANE_DT_S * 1e6,
                              seed=seed, pipeline_depth=depth)
    plane.pipeline_explicit_clock = True
    if telemetry:
        plane.enable_telemetry(window_s=3600.0, sample_period=1024)
    # under `chaos`, B is down from the start until A's breaker has
    # opened (read after each tick), then flaps: a flap alone opens the
    # breaker only when three attempts in a row land in down halves,
    # which the wall clock's phase and the backoff's jitter decide
    # (tests/test_torch_breaker_flap.py)
    outage = chaos is not None
    outage_ticks = 0
    if chaos is not None:
        plane.attach_chaos(chaos)
        chaos.blackhole_peer(addr_b)
    errors0 = a["daemon"].forward_errors
    unresolved0 = nb("bulk_unresolved")
    # staged frames = what the remote stage hands the per-peer senders
    staged = [0]
    enqueue = runtime._PeerSender.enqueue

    def counting(self, packets, traced=None):
        staged[0] += len(packets)
        return enqueue(self, packets, traced)

    runtime._PeerSender.enqueue = counting
    rng = np.random.default_rng(seed)
    fed, walls = 0, []

    def end_outage() -> None:
        nonlocal outage, outage_ticks
        outage_ticks += 1
        if plane.peer_fault_stats().get(addr_b, {}).get("opens", 0):
            chaos.heal_peer(addr_b)
            chaos.flap_peer(addr_b, *XN_FLAP)
            outage = False

    try:
        t_start = time.perf_counter()
        t = 0
        for t in range(ticks):
            fed += feed_tick(win, t, rng, max_frames)
            w0 = time.perf_counter()
            plane.tick(now_s=(t + 1) * PLANE_DT_S)
            if engine.device.type == "cuda":
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - w0)
            if outage:
                end_outage()
        for _ in range(PLANE_DRAIN_TICKS):
            t += 1
            plane.tick(now_s=(t + 1) * PLANE_DT_S)
            if outage:
                end_outage()
            if (not plane._inflight and not plane._holdback
                    and len(plane._wheel) == 0):
                break
        plane.flush()
        if chaos is not None:
            # the flap lasts as long as the ticks; healed, the breaker
            # closes at its next half-open probe and the outage buffer
            # drains (the probe cooldown doubles on every failed probe,
            # and a period that divides it keeps probing the down half)
            chaos.heal_peer(addr_b)
        flushed = plane.flush_peers(XN_FLUSH_S)
        deliver_s = time.perf_counter() - t_start
        stats = plane.peer_fault_stats().get(addr_b, {})
        digests, counts = nb("egress", keys)
        log(f"13 run {name}: fed {fed}, released {plane.shaped}, staged "
            f"{staged[0]}, ring-dropped {plane.ring_dropped}, arrived at B "
            f"{sum(counts)}, peer {stats}, forward errors "
            f"{a['daemon'].forward_errors - errors0}; median "
            f"{1e3 * statistics.median(walls):.3f} ms/tick, "
            f"{deliver_s:.3f} s to flushed")
        check(flushed, f"13 {name}: the per-peer senders did not empty "
                       f"within {XN_FLUSH_S} s")
    finally:
        runtime._PeerSender.enqueue = enqueue
    out = {"digests": digests, "counts": counts, "fed": fed,
           "plane": plane, "counters": plane.counters,
           "staged": staged[0], "ring_dropped": plane.ring_dropped,
           "queue_dropped": plane.peer_queue_dropped,
           "forward_errors": a["daemon"].forward_errors - errors0,
           "bulk_unresolved": nb("bulk_unresolved") - unresolved0,
           "peer": stats, "outage_ticks": outage_ticks,
           "wall_ms_per_tick":
           1e3 * statistics.median(walls), "deliver_s": deliver_s}
    plane.stop()
    check(plane.tick_errors == 0, "13: tick errors on node A's plane")
    check(len(plane._wheel) == 0 and not plane._pending,
          "13: node A's delay line not empty after the drain")
    return out


def xn_books(r: dict, name: str) -> None:
    """Per edge rx + loss + queue == tx, shaped + dropped == fed; every
    released frame (all bound for node B) staged or ring-dropped, the
    drops charged per row; staged == sent + queue-dropped + forwarding
    errors; sent == the frames that arrived at B's pod side."""
    c, p = r["counters"], r["plane"]
    check(np.array_equal(c.rx_packets + c.dropped_loss + c.dropped_queue,
                         c.tx_packets), f"{name}: per-edge books open")
    check(p.shaped + p.dropped == r["fed"] == int(c.tx_packets.sum()),
          f"{name}: shaped {p.shaped} + dropped {p.dropped} != fed "
          f"{r['fed']}")
    check(p.shaped == r["staged"] + r["ring_dropped"],
          f"{name}: released {p.shaped} != staged {r['staged']} + "
          f"ring-dropped {r['ring_dropped']}")
    check(int(c.dropped_ring.sum()) == r["ring_dropped"],
          f"{name}: per-row dropped_ring {int(c.dropped_ring.sum())} != "
          f"ring_dropped {r['ring_dropped']}")
    sent = r["peer"].get("sent", 0)
    check(r["staged"] == sent + r["queue_dropped"] + r["forward_errors"],
          f"{name}: staged {r['staged']} != sent {sent} + queue-dropped "
          f"{r['queue_dropped']} + forward errors {r['forward_errors']}")
    check(sent == sum(r["counts"]), f"{name}: sent {sent} != arrived at "
                                    f"B {sum(r['counts'])}")
    check(r["bulk_unresolved"] == 0, f"{name}: bulk_unresolved at B")


def run_cross_node_phase(dev, card, n_spine=None, n_leaf=None,
                         n_b: int = XN_B_LEAVES,
                         n_rows: int = PLANE_ROWS) -> dict:
    """Phase 13: two daemons, node A in this process and node B in a
    child process, each behind a real gRPC server on 127.0.0.1, both
    engines on `dev`; node A's plane sends its released cross-node
    frames to node B."""
    import types

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.chaos import ChaosInjector
    from kubedtn_tpu_torch.wire.server import make_server

    n_spine = n_spine or entry.N_SPINE
    n_leaf = n_leaf or entry.N_LEAF
    lpp = entry.LINKS_PER_PAIR
    rows_b = n_spine * n_b * lpp
    rows_a = n_spine * (n_leaf - n_b) * lpp * 2 + rows_b
    cap_a = 1 << max(10, (rows_a - 1).bit_length())
    cap_b = 1 << max(10, (rows_b - 1).bit_length())
    m = {"b_leaves": n_b, "cross_links": rows_b}

    # (a) two nodes: servers first (their ports are the node addresses)
    srv, nb = None, None
    try:
        nb = NodeB(dev, cap_b)
        a = xn_node(dev, [], "", cap_a)
        a["daemon"].forward_timeout_s = XN_FORWARD_TIMEOUT_S
        srv, port = make_server(a["daemon"], port=0, host="127.0.0.1",
                                log_rpcs=False)
        srv.start()
        addr_a, addr_b = f"127.0.0.1:{port}", nb.addr
        a["engine"].node_ip = addr_a
        for t in xn_crs(n_spine, n_leaf, n_b, addr_a, addr_b, "a"):
            a["store"].create(t)
        a["engine"].warm_kernels()
        nb("crs", addr_a, n_spine, n_leaf, n_b)
        # A's reconciler, then B's (each realizes its own pods, the far
        # ends through Remote.Update), then A's engine flushed again
        t0 = time.perf_counter()
        a["reconciler"].drain()
        a["engine"].flush()
        active_b, errors_b = nb("reconcile")
        a["engine"].flush()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        m["reconcile_s"] = time.perf_counter() - t0
        check(a["engine"].num_active == rows_a and active_b == rows_b,
              f"13(a): {a['engine'].num_active} + {active_b} rows "
              f"realized, expected {rows_a} + {rows_b}")
        check(a["engine"].stats.remote_errors == 0 and errors_b == 0,
              "13(a): Remote.Update failed")
        # the CPU reference: the same two nodes on the CPU, Remote.Update
        # in process
        ref = {}
        for name, cap, addr in (("a", cap_a, addr_a), ("b", cap_b, addr_b)):
            other = "b" if name == "a" else "a"
            ref[name] = xn_node(
                "cpu", xn_crs(n_spine, n_leaf, n_b, addr_a, addr_b, name),
                addr, cap,
                dialer=lambda ip, o=other: _AdapterClient(ref[o]["daemon"]))
        xn_reconcile(ref["a"], ref["b"])
        same_columns(a, ref["a"], "13(a) node A vs the CPU nodes")
        rows, cols = nb("columns")
        b_view = {"engine": types.SimpleNamespace(
            _rows=rows, state=dataclasses.replace(
                ref["b"]["engine"].state,
                **{k: torch.from_numpy(v) for k, v in cols.items()}))}
        same_columns(b_view, ref["b"], "13(a) node B vs the CPU nodes")
        del ref, b_view
        log(f"13(a) two nodes: {n_spine + n_leaf} CRs, leaves "
            f"0..{n_b - 1} on node B (a process of its own); node A "
            f"{rows_a} rows, node B {rows_b} rows ({rows_b} cross-node "
            f"links); reconcile-to-steady {m['reconcile_s']:.3f} s (A's "
            f"reconciler, then B's, far ends through Remote.Update over "
            f"gRPC); both nodes' realized columns == the CPU nodes' from "
            f"the same CRs; node A's deadline floor "
            f"{XN_FORWARD_TIMEOUT_S} s ({card})")

        # (b) full feed
        classes = xn_classes(a, n_rows, n_b)
        t0 = time.perf_counter()
        win, keys = xn_wires(a, nb, addr_a, addr_b, classes)
        m["wires_s"] = time.perf_counter() - t0
        a["engine"].flush()
        state0 = clone_state(a["engine"].state)
        seed = 13
        full = xn_run(a, nb, addr_b, keys, win, state0, seed, depth=1,
                      ticks=XN_TICKS, max_frames=PLANE_MAX_FRAMES,
                      name="(b) full feed")
        xn_books(full, "13(b) full feed")
        p = full["plane"]
        arrived = sum(full["counts"])
        m["full"] = {
            "wires": len(win), "ticks": XN_TICKS, "fed": full["fed"],
            "shaped": p.shaped, "dropped": p.dropped,
            "staged": full["staged"], "ring_dropped": full["ring_dropped"],
            "ring_drop_share": full["ring_dropped"] / max(p.shaped, 1),
            "sent": full["peer"].get("sent", 0), "arrived_at_b": arrived,
            "wall_ms_per_tick": full["wall_ms_per_tick"],
            "deliver_s": full["deliver_s"],
            "delivered_per_s_at_b": arrived / full["deliver_s"],
            "wires_s": m["wires_s"], "stage": p.stage_breakdown()}
        mf = m["full"]
        log(f"13(b) full feed: {len(win)} cross-node wires, {XN_TICKS} "
            f"ticks of {PLANE_DT_S * 1e3:.0f} ms at depth 1, "
            f"{full['fed']} frames fed, {p.shaped} released to node B, "
            f"{full['staged']} staged + {full['ring_dropped']} ring-dropped "
            f"(share {mf['ring_drop_share']:.4f}); books closed: per edge, "
            f"released == staged + ring_dropped == per-row dropped_ring "
            f"sum + staged, staged == sent {mf['sent']} + queue-dropped "
            f"{full['queue_dropped']} + forward errors "
            f"{full['forward_errors']}, sent == arrived at B")
        log(f"13(b) wall {mf['wall_ms_per_tick']:.3f} ms/tick (median), "
            f"{mf['delivered_per_s_at_b']:.1f} frames/s arrived at B "
            f"({arrived} in {full['deliver_s']:.3f} s from the first "
            f"feed tick to flush_peers); stage shares "
            f"{mf['stage']['share']}; B's {len(keys)} wire ends by "
            f"AddGRPCWireRemote + A's ends in {m['wires_s']:.3f} s "
            f"({card})")

        # (c) equality feed: 1 frame per wire and tick fits the ring
        def eq(depth, name, ticks=XN_EQ_TICKS, **kw):
            r = xn_run(a, nb, addr_b, keys, win, state0, seed + 1,
                       depth=depth, ticks=ticks, max_frames=1, name=name,
                       **kw)
            xn_books(r, f"13{name}")
            check(r["ring_dropped"] == 0 and r["queue_dropped"] == 0,
                  f"13(c): ring {r['ring_dropped']} / queue "
                  f"{r['queue_dropped']} drops at the equality feed")
            return r

        def same_at_b(x, y, name):
            check(x["counts"] == y["counts"], f"{name}: per-wire counts "
                                              f"at B differ")
            check(x["digests"] == y["digests"], f"{name}: per-wire bytes "
                                                f"at B differ")

        e1 = eq(1, "(c) depth 1")
        e2 = eq(2, "(c) depth 2 + telemetry", telemetry=True)
        same_at_b(e1, e2, "13(c) depth 2 + telemetry vs depth 1")
        # the reference peer on the first XN_REF_TICKS ticks of the same
        # feed, against the bulk transport on the same ticks
        eb = eq(1, "(c) bulk, reference round's ticks", ticks=XN_REF_TICKS)
        nb("refuse_bulk", True)
        try:
            er = eq(1, "(c) reference peer", ticks=XN_REF_TICKS)
        finally:
            nb("refuse_bulk", False)
        check(a["daemon"].peer_bulk_ok.get(addr_b) is False,
              "13(c) reference peer: the stream latch never set")
        same_at_b(er, eb, "13(c) reference peer (SendToStream) vs bulk")
        a["daemon"].reset_peer_bulk(addr_b)
        chaos = ChaosInjector(seed=13)
        ef = eq(2, "(c) depth 2 under the flap", chaos=chaos)
        fs = ef["peer"]
        check(fs.get("opens", 0) >= 1 and fs.get("retries", 0) >= 1,
              f"13(c) flap: breaker opens {fs.get('opens')} / retries "
              f"{fs.get('retries')}")
        check(fs.get("closes", 0) >= 1 and fs.get("state") == 0,
              f"13(c) flap: breaker closes {fs.get('closes')}, state "
              f"{fs.get('state')} after the heal")
        check(ef["forward_errors"] == 0, "13(c) flap: forwarding errors")
        same_at_b(ef, e1, "13(c) depth 2 under the flap vs depth 1")
        m["equality"] = {
            "ticks": XN_EQ_TICKS, "reference_ticks": XN_REF_TICKS,
            "fed": e1["fed"],
            "arrived_at_b": sum(e1["counts"]),
            "wall_ms_per_tick": {"depth1": e1["wall_ms_per_tick"],
                                 "depth2_telemetry": e2["wall_ms_per_tick"],
                                 "reference_peer": er["wall_ms_per_tick"],
                                 "flap": ef["wall_ms_per_tick"]},
            "deliver_s": {"depth1": e1["deliver_s"],
                          "bulk_reference_ticks": eb["deliver_s"],
                          "reference_peer": er["deliver_s"],
                          "flap": ef["deliver_s"]},
            "flap_peer": fs, "outage_ticks": ef["outage_ticks"],
            "chaos_injected": dict(chaos.injected)}
        log(f"13(c) equality feed: {XN_EQ_TICKS} ticks x {len(win)} "
            f"frames, {sum(e1['counts'])} arrived at B, 0 ring and 0 "
            f"queue drops; depth 1 == depth 2 + telemetry == depth 2 "
            f"under an outage of B until A's breaker opened "
            f"({ef['outage_ticks']} ticks) and then a {XN_FLAP[0]} s / "
            f"{XN_FLAP[1]} flap of B, byte for "
            f"byte per wire at B; on the first {XN_REF_TICKS} ticks the "
            f"reference peer (SendToBulk UNIMPLEMENTED, SendToStream) "
            f"== the bulk transport, {sum(er['counts'])} frames; flap: "
            f"breaker opens {fs['opens']}, half-opens "
            f"{fs['half_opens']}, closes {fs['closes']}, retries "
            f"{fs['retries']}, forward errors 0; wall ms/tick "
            f"{m['equality']['wall_ms_per_tick']} ({card})")
    finally:
        if srv is not None:
            srv.stop(0)
        if nb is not None:
            nb.close()
    return m


# -- phase 14: the what-if twin and planned updates --------------------------

TWIN_SCENARIOS = 15         # MAX_REPLICA_CELLS // 2^18 lanes at full width
TWIN_STEPS = 20             # cut from twin.query.DEFAULT_TICKS = 1,000
#                             (200 until a whole run with phase 19 went
#                             over the script's time bound, 100 until
#                             phase 20 joined, 50 until phase 21, PERF.md
#                             §4)
TWIN_K = 4
TWIN_DT_US = 1000.0
TWIN_SEED = 41
TWIN_CHECK_STEPS = 2        # K1's replica launches vs the plain version
TWIN_SUBSET = 8             # scenarios of the N = 8 sweep
TWIN_PROFILED_STEPS = 5
TWIN_ROUTED_LANES = 4
TWIN_ROUTED_STEPS = 10      # (50 until phase 21, 20 until phase 24)
WHATIF_TICKS = 50           # (100 until phase 24 joined)
WHATIF_FEED_ROUNDS = 4      # phase 12's feed rounds around the WhatIf
WHATIF_WAIT_S = 300.0       # bound on every wait of 14(c) and 14(d)
PLAN_LINKS = 64             # links of one leaf whose latency the plan moves
PLAN_LATENCY = "8ms"        # from the Clos's 10 ms (the same (5, 10] ms bucket)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def twin_scenarios(store, n_leaf: int):
    """Phase 14(a)'s 15 futures of the Clos: the baseline; degrades
    (latency x 2, 1 % loss, a rate cut) of single links and of 64 links
    of a leaf; failed links; a spine and a leaf blackholed by name; the
    offered load scaled by 1.5 and by 0.5."""
    from kubedtn_tpu_torch.api.types import LinkProperties as LP
    from kubedtn_tpu_torch.twin import Perturbation as P
    from kubedtn_tpu_torch.twin import Scenario as S

    def links(pod):
        return store.get("default", pod).spec.links

    slow = LP(latency="20ms", rate="10Gbit")
    lossy = LP(latency="10ms", rate="10Gbit", loss="1")
    cut = LP(latency="10ms", rate="100Mbit")
    s0, l3, l4 = links("spine0"), links("leaf3"), links("leaf4")

    def deg(ls, props):
        return tuple(P("degrade", uid=l.uid, props=props) for l in ls)

    return [
        S("baseline"),
        S("latency-x2", deg(s0[:1], slow)),
        S("loss-1pct", deg(s0[1:2], lossy)),
        S("rate-cut", deg(s0[2:3], cut)),
        S("fail", (P("fail", uid=s0[3].uid),)),
        S("blackhole-spine1", (P("blackhole", node="spine1"),)),
        S("blackhole-leaf2", (P("blackhole", node="leaf2"),)),
        S("scale-1.5", (P("scale", factor=1.5),)),
        S("leaf3-latency-x2", deg(l3[:64], slow)),
        S("leaf3-loss-1pct", deg(l3[64:128], lossy)),
        S("leaf3-rate-cut", deg(l3[128:192], cut)),
        S("leaf4-fail", tuple(P("fail", uid=l.uid) for l in l4[:64])),
        S("spine2-latency-x2", deg(links("spine2"), slow)),
        S("blackhole-spine3-scale-1.5", (P("blackhole", node="spine3"),
                                         P("scale", factor=1.5))),
        S(f"blackhole-leaf{n_leaf - 1}-scale-0.5",
          (P("blackhole", node=f"leaf{n_leaf - 1}"),
           P("scale", factor=0.5))),
    ]


def k1_replica_launch(bstate, E: int, dev, timer, gen):
    """One K1 launch over the replica-major rows of a sweep, the [E, NU]
    uniforms shared (u_rows = E), against its plain version on the same
    inputs; timed against its bound (each input read once: the
    uniforms' E rows, every other column's N x E)."""
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    R = bstate.capacity
    sizes = torch.full((R,), 200.0, device=dev)
    have = torch.rand(R, generator=gen, device=dev) < 0.6
    t_arr = torch.rand(R, generator=gen, device=dev) * 1000.0
    u = torch.rand((E, netem.NU), generator=gen, device=dev)
    args = (bstate, sizes, have, t_arr, u)
    k_state, dep, fl = shaping.shape_step_flags(*args, donate=False,
                                                u_rows=E)
    p_state, p_res = netem._shape_step_from_u(
        bstate, sizes, have, t_arr, u.repeat(R // E, 1))
    _sync(dev)
    same((dep, fl, k_state), (p_res.depart_us, shaping.pack_flags(p_res),
                              p_state), "K1 over replica rows vs plain")
    out = {"max_abs_err": 0.0, "rows": R, "u_rows": E}
    if dev.type == "cuda":
        out["ms"] = timer.ms(lambda: shaping.shape_step_flags(
            *args, donate=False, u_rows=E))
        out["plain_ms"] = timer.ms(lambda: netem._shape_step_from_u(
            bstate, sizes, have, t_arr, u.repeat(R // E, 1)), reps=5)
        moved = nbytes(bstate.props, bstate.corr, u, bstate.tokens,
                       bstate.t_last, bstate.backlog_until,
                       bstate.pkt_count, sizes, t_arr, have, bstate.active,
                       dep, fl, k_state.tokens, k_state.t_last,
                       k_state.backlog_until, k_state.corr,
                       k_state.pkt_count)
        out["bound_ms"], out["bound_by"] = bound_ms(moved, OPS_K1 * R)
        out["bytes"] = moved
    return out


def twin_sweep_profile(run, dev) -> dict | None:
    """Device time and busy share of a few sweep steps (torch.profiler)."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    _sync(dev)
    t0 = time.perf_counter()
    run()
    _sync(dev)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        run()
        _sync(dev)
    dev_us = sum(e.time_range.elapsed_us() for e in p.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    cpu = torch.autograd.DeviceType.CPU
    top = sorted(((a.key, a.self_device_time_total / TWIN_PROFILED_STEPS)
                  for a in p.key_averages()
                  if a.self_device_time_total > 0
                  and (a.device_type == cpu or "shape_step" in a.key)),
                 key=lambda kv: -kv[1])
    k1 = sum(v for k, v in top if "shape_step_rows" in k)
    return {"device_ms_per_step": dev_us / 1e3 / TWIN_PROFILED_STEPS,
            "wall_ms_per_step": wall * 1e3 / TWIN_PROFILED_STEPS,
            "busy_share": dev_us / 1e6 / wall,
            "k1_share_of_device_time": k1 * TWIN_PROFILED_STEPS / dev_us,
            "top_device_us_per_step": [[k[:48], v] for k, v in top[:6]]}


def run_twin_sweep(built, dev, card, timer) -> tuple:
    """Phase 14(a): the unrouted sweep at full width. Returns (metrics,
    K1 launches of the sweep)."""
    from kubedtn_tpu_torch import sim
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.twin import (compile_scenarios, run_sweep,
                                        snapshot_from_engine)
    from kubedtn_tpu_torch.twin.engine import replica_lane
    from kubedtn_tpu_torch.twin.query import (MAX_REPLICA_CELLS,
                                              build_cbr_spec)

    engine, store = built["engine"], built["store"]
    n_leaf = sum(1 for t in store.list() if t.name.startswith("leaf"))
    snap = snapshot_from_engine(engine)
    E = snap.sim.edges.capacity
    with engine._lock:
        pod_ids = dict(engine._pod_ids)
    scen = twin_scenarios(store, n_leaf)
    n = len(scen)
    check(n * E <= MAX_REPLICA_CELLS, f"{n} x {E} rows exceed the budget")
    spec = build_cbr_spec(snap.sim.edges)
    edits = compile_scenarios(scen, snap.sim.edges, pod_ids=pod_ids)
    kw = dict(dt_us=TWIN_DT_US, spec=spec, k_slots=TWIN_K, seed=TWIN_SEED,
              pod_ids=pod_ids, keep_final=True)
    m = {"replicas": n, "rows_per_replica": E, "rows": n * E,
         "steps": TWIN_STEPS, "q": snap.sim.inflight.q}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
    shaping.reset_launches()
    res = run_sweep(snap, scen, steps=TWIN_STEPS, edits=edits, **kw)
    _sync(dev)
    launches = shaping.LAUNCHES["shape_step_rows"]
    check(launches == TWIN_STEPS * TWIN_K or dev.type != "cuda",
          f"14(a): {launches} K1 launches for {TWIN_STEPS} steps of "
          f"{TWIN_K} slots (one per slot over all {n} x {E} rows)")
    if dev.type == "cuda":
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        m["peak_mem_gb_over_before"] = (torch.cuda.max_memory_allocated(dev)
                                        - base_mem) / 1e9
    m.update(run_s=res.run_s, compile_s=res.compile_s,
             ms_per_step=res.run_s * 1e3 / TWIN_STEPS,
             replica_steps_per_s=res.replicas_steps_per_s)
    final = res.final
    check(not bool(sim.conservation_residual(final).any()),
          "14(a): a replica's per-edge books do not close")
    by = dict(zip(res.names, res.metrics))
    b = by["baseline"]
    check(b["tx_packets"] > 0 and b["delivered_packets"] > 0,
          "14(a): the baseline carried no traffic")
    check(by["blackhole-spine1"]["tx_packets"] < b["tx_packets"],
          "14(a): the blackholed spine still sourced traffic")
    check(by["scale-1.5"]["delivered_bytes"] > b["delivered_bytes"],
          "14(a): scaling the load by 1.5 moved no more bytes")
    check(by["latency-x2"]["p99_us"] >= b["p99_us"], "14(a): p99")
    m["metrics"] = {k: {f: v[f] for f in ("tx_packets", "delivered_packets",
                                          "dropped_loss", "dropped_queue",
                                          "delivery_ratio", "p99_us")}
                    for k, v in by.items()}
    log(f"14(a) sweep: {n} scenarios x {E} rows ({n * E} rows) x "
        f"{TWIN_STEPS} steps of {TWIN_DT_US / 1e3:g} ms, K = {TWIN_K}, "
        f"Q = {m['q']}: {m['ms_per_step']:.3f} ms/step, "
        f"{m['replica_steps_per_s']:.1f} replica-steps/s, "
        f"{launches} K1 launches (one per slot and step); books closed "
        f"per replica and edge; peak memory "
        f"{m.get('peak_mem_gb', 0.0):.3f} GB ({card})")
    # replica 0 == sim.run on the same snapshot and seed
    ref = sim.run(snap.sim, spec, TWIN_STEPS, TWIN_DT_US, TWIN_K,
                  seed=TWIN_SEED)
    same(replica_lane(final, 0, n), ref, "14(a) replica 0 vs sim.run")
    # the first 8 scenarios == the same lanes of the 15-lane sweep
    sub = run_sweep(snap, scen[:TWIN_SUBSET], steps=TWIN_STEPS, **kw)
    check(sub.metrics == res.metrics[:TWIN_SUBSET],
          "14(a): N = 8 metrics differ from the N = 15 lanes")
    for i in range(TWIN_SUBSET):
        same(replica_lane(sub.final, i, TWIN_SUBSET),
             replica_lane(final, i, n), f"14(a) lane {i}, N = 8 vs 15")
    del sub, ref
    # K1's replica launches == the plain version, the first 2 steps
    two = dict(steps=TWIN_CHECK_STEPS, edits=edits, **kw)
    k2 = run_sweep(snap, scen, shape_fn=queues.shape_packets, **two)
    p2 = run_sweep(snap, scen, shape_fn=queues.shape_packets_plain, **two)
    same(k2.final, p2.final, "14(a) 2 steps: K1 vs the plain version")
    check(k2.metrics == p2.metrics, "14(a) 2 steps: metrics differ")
    del k2, p2
    log(f"14(a): replica 0 == sim.run bit for bit; the first "
        f"{TWIN_SUBSET} scenarios alone == their lanes of the {n}-lane "
        f"sweep; {TWIN_CHECK_STEPS} steps through K1 == the plain version, "
        f"bit for bit")
    gen = torch.Generator(device=dev).manual_seed(43)
    m["k1"] = k1_replica_launch(final.edges, E, dev, timer, gen)
    if "ms" in m["k1"]:
        k = m["k1"]
        log(f"14(a) K1 over {k['rows']} rows (u_rows {E}): "
            f"{k['ms'] * 1e3:.2f} us per launch, bound "
            f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms ({card})")
    del final, res
    m["profile"] = twin_sweep_profile(lambda: run_sweep(
        snap, scen, steps=TWIN_PROFILED_STEPS, **kw), dev)
    if m["profile"] is not None:
        p = m["profile"]
        log(f"14(a) sweep step: device {p['device_ms_per_step']:.3f} ms, "
            f"wall {p['wall_ms_per_step']:.3f} ms, busy share "
            f"{p['busy_share']:.3f}, K1 "
            f"{100 * p['k1_share_of_device_time']:.2f} % of device time "
            f"({card})")
        log(f"14(a) sweep top device ops: {p['top_device_us_per_step']}")
    return m, launches


def run_twin_routed(el, fresh, dev, card, n_spine: int) -> tuple:
    """Phase 14(b): the routed sweep, 4 lanes on the Clos with its
    routes; replica 0 == run_routed bit for bit."""
    from kubedtn_tpu_torch import entry, router
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.twin import (Perturbation, Scenario,
                                        run_sweep_routed,
                                        snapshot_from_router)
    from kubedtn_tpu_torch.twin.engine import replica_lane

    leaves = np.arange(n_spine, el.n_nodes)
    rs, spec, flow_dst, _dist = entry.build_routed(
        el, fresh, leaves, seed=31, rate_bps=ROUTED_RATE_BPS, q=SIM_Q,
        k_fwd=ROUTED_K_FWD, max_hops=ROUTE_HOPS)
    snap = snapshot_from_router(rs)
    uids = fresh.uid[:3].tolist()
    scen = [Scenario("baseline"),
            Scenario("fail", (Perturbation("fail", uid=uids[0]),)),
            Scenario("blackhole-node0", (Perturbation("blackhole",
                                                      node=0),)),
            Scenario("fail-two", tuple(Perturbation("fail", uid=u)
                                       for u in uids[1:3]))]
    shaping.reset_launches()
    t0 = time.perf_counter()
    res = run_sweep_routed(snap, scen[:TWIN_ROUTED_LANES],
                           steps=TWIN_ROUTED_STEPS, dt_us=SIM_DT_US,
                           spec=spec, flow_dst=flow_dst, k_slots=SIM_K,
                           k_fwd=ROUTED_K_FWD, seed=TWIN_SEED,
                           keep_final=True)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = shaping.LAUNCHES["shape_step_rows"]
    k_shape = SIM_K + ROUTED_K_FWD
    check(launches == TWIN_ROUTED_STEPS * k_shape or dev.type != "cuda",
          f"14(b): {launches} K1 launches for {TWIN_ROUTED_STEPS} routed "
          f"steps of {k_shape} slots")
    ref = router.run_routed(rs, spec, flow_dst, TWIN_ROUTED_STEPS,
                            SIM_DT_US, SIM_K, ROUTED_K_FWD, seed=TWIN_SEED)
    same(replica_lane(res.final, 0, res.replicas), ref,
         "14(b) routed replica 0 vs run_routed")
    b = res.metrics[0]
    check(b["node_rx_packets"] > 0, "14(b): nothing reached a leaf")
    m = {"replicas": res.replicas, "steps": TWIN_ROUTED_STEPS,
         "wall_s": wall, "ms_per_step": wall * 1e3 / TWIN_ROUTED_STEPS,
         "node_rx_packets": [x["node_rx_packets"] for x in res.metrics]}
    log(f"14(b) routed sweep: {res.replicas} lanes x {fresh.capacity} rows "
        f"x {TWIN_ROUTED_STEPS} steps, {launches} K1 launches; replica 0 "
        f"== run_routed bit for bit; {m['ms_per_step']:.3f} ms/step "
        f"({card})")
    return m, launches


def run_twin_live(built, dev, card, n_rows: int) -> tuple:
    """Phases 14(c) and 14(d) on phase 12's daemon: its plane ticking in
    the real-time runner at depth 2. (c) WhatIf over gRPC while phase
    12's feed flows; (d) PlanUpdate-shaped change through the planned
    reconciler, staged while the plane ticks, == the change applied
    directly to a copy. Returns (metrics, K1 launches of the phase)."""
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.twin.query import stats_for
    from kubedtn_tpu_torch.twin.snapshot import snapshot_from_plane
    from kubedtn_tpu_torch.updates import Guardrails, UpdateStats
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient
    from kubedtn_tpu_torch.wire.server import make_server

    daemon, engine, store = built["daemon"], built["engine"], built["store"]
    classes = plane_classes(built, n_rows)
    win, wout = plane_wires(daemon, classes)
    m = {}
    shaping.reset_launches()
    plane = entry.build_plane(daemon, dt_us=PLANE_DT_S * 1e6,
                              pipeline_depth=2, seed=14)
    server, port = make_server(daemon, port=0, host="127.0.0.1",
                               log_rpcs=False)
    server.start()
    client = DaemonClient(f"127.0.0.1:{port}")
    counts = [0] * len(wout)

    def collect():
        for k, w in enumerate(wout):
            n = len(w.egress)
            for _ in range(n):
                w.egress.popleft()
            counts[k] += n

    def wait_ticks(k: int) -> None:
        start, deadline = plane.ticks, time.monotonic() + WHATIF_WAIT_S
        while plane.ticks - start < k and time.monotonic() < deadline:
            collect()
            time.sleep(0.005)
        check(plane.ticks - start >= k, "14: the runner stopped ticking")

    rng = np.random.default_rng(14)
    fed = 0
    try:
        plane.start()
        # (c) WhatIf while the feed flows
        fed += feed_tick(win, 0, rng)
        wait_ticks(1)
        with plane._tick_lock:  # the barrier's own cost, lock held
            t0 = time.perf_counter()
            snapshot_from_plane(plane)
            _sync(dev)
            m["barrier_ms"] = (time.perf_counter() - t0) * 1e3
        req = pb.WhatIfRequest(ticks=WHATIF_TICKS, dt_us=1000.0, seed=7,
                               include_baseline=True)
        spine0 = store.get("default", "spine0").spec.links
        for name, kind, extra in (("latency-x2", "degrade", spine0[0]),
                                  ("fail", "fail", spine0[1]),
                                  ("blackhole-leaf1", "blackhole", None)):
            sc = req.scenarios.add()
            sc.name = name
            p = sc.perturbations.add()
            p.kind = kind
            if kind == "blackhole":
                p.node = "leaf1"
            else:
                p.uid = extra.uid
            if kind == "degrade":
                p.properties.CopyFrom(pb.props_to_proto(LinkProperties(
                    latency="20ms", rate="10Gbit")))
        box = {}

        def ask():
            t1 = time.perf_counter()
            box["resp"] = client.WhatIf(req, timeout=WHATIF_WAIT_S)
            box["wall_s"] = time.perf_counter() - t1

        th = threading.Thread(target=ask, daemon=True)
        ticks0 = plane.ticks
        th.start()
        for r in range(1, WHATIF_FEED_ROUNDS):
            fed += feed_tick(win, r, rng)
            wait_ticks(1)
        th.join(timeout=WHATIF_WAIT_S)
        check(not th.is_alive(), "14(c): WhatIf did not return")
        resp = box["resp"]
        check(resp.ok, f"14(c) WhatIf failed: {resp.error}")
        check([x.name for x in resp.results] == ["baseline", "latency-x2",
                                                 "fail", "blackhole-leaf1"],
              "14(c): WhatIf results")
        check(sorted(x.rank for x in resp.results) == [1, 2, 3, 4],
              "14(c): ranks")
        m["whatif"] = {"wall_s": box["wall_s"], "run_s": resp.run_s,
                       "replicas": resp.replicas, "ticks": resp.ticks,
                       "plane_ticks_during": plane.ticks - ticks0}
        # drain: every frame fed is shaped or dropped by its qdisc, and
        # every shaped one arrives
        deadline = time.monotonic() + WHATIF_WAIT_S
        while time.monotonic() < deadline:
            collect()
            if (plane.shaped + plane.dropped == fed
                    and sum(counts) == plane.shaped):
                break
            time.sleep(0.01)
        collect()
        check(plane.shaped + plane.dropped == fed and
              sum(counts) == plane.shaped,
              f"14(c): fed {fed}, shaped {plane.shaped}, dropped "
              f"{plane.dropped}, delivered {sum(counts)}: frames lost "
              f"across the snapshot barrier")
        check(plane.tick_errors == 0, "14(c): tick errors")
        check(stats_for(daemon).sweeps == 1, "14(c): sweep not counted")
        w = m["whatif"]
        log(f"14(c) WhatIf over gRPC on the live Clos plane (runner at "
            f"depth 2, {len(win)} + {len(wout)} wires, {fed} frames fed in "
            f"{WHATIF_FEED_ROUNDS} rounds): {w['replicas']} lanes x "
            f"{w['ticks']} ticks in {w['wall_s']:.3f} s wall ({w['run_s']}"
            f" s sweep), {w['plane_ticks_during']} plane ticks meanwhile; "
            f"barrier (flush + copy of the edge state, lock held) "
            f"{m['barrier_ms']:.3f} ms; every frame shaped or queue-"
            f"dropped and delivered, none lost ({card})")

        # (d) a latency change on 64 links of one leaf, planned
        leaf = "leaf5"
        topo = store.get("default", leaf)
        new_props = LinkProperties(latency=PLAN_LATENCY, rate="10Gbit")
        moved = [l.with_properties(new_props)
                 for l in topo.spec.links[:PLAN_LINKS]]
        rows = [engine.row_of(f"default/{leaf}", l.uid) for l in moved]
        with plane._tick_lock:
            plane.flush()
            direct = clone_state(engine.state)
        es.update_links(direct, np.asarray(rows, np.int64),
                        np.stack([es.props_row(new_props.to_numeric())]
                                 * len(rows)), np.ones(len(rows), bool))
        stats = UpdateStats()
        rec = Reconciler(store, engine, plane=plane, planned=True,
                         guardrails=Guardrails(), update_stats=stats)
        list(rec._watch.poll())  # phase 14's own CR edits only
        topo.spec.links = moved + topo.spec.links[PLAN_LINKS:]
        store.update(topo)
        p0 = plane.pauses.causes().get("staged_update", {})
        t0 = time.perf_counter()
        results = [r for r in rec.drain() if r.action != "noop"]
        plan_s = time.perf_counter() - t0
        check([r.action for r in results] == ["planned"],
              f"14(d): reconcile results {[(r.action, r.ok) for r in results]}")
        fresh = store.get("default", leaf)
        check(fresh.status.links == fresh.spec.links, "14(d): status")
        with plane._tick_lock:
            plane.flush()
            st = engine.state
            for f in ("uid", "src", "dst", "active", "props"):
                same(getattr(st, f), getattr(direct, f),
                     f"14(d) staged vs direct: {f}")
        snap = stats.snapshot()
        pc = plane.pauses.causes().get("staged_update", {})
        rounds = int(pc.get("count", 0) - p0.get("count", 0))
        check(rounds >= 1, "14(d): no staging barrier recorded")
        m["plan"] = {"links": PLAN_LINKS, "reconcile_s": plan_s,
                     "gate_s": snap["gate_seconds"],
                     "stage_s": snap["stage_seconds"], "rounds": rounds,
                     "pause_ms_per_round": 1e3 * (pc.get("seconds", 0.0)
                                                  - p0.get("seconds", 0.0))
                     / rounds,
                     "phase_ms": results[0].phase_ms}
        check(plane.tick_errors == 0, "14(d): tick errors")
        p = m["plan"]
        log(f"14(d) planned update: latency {PLAN_LATENCY} on {len(moved)} "
            f"links of {leaf} through the planned reconciler while the "
            f"plane ticks: gate {p['gate_s']:.3f} s (the twin at "
            f"{engine.state.capacity} rows), {p['rounds']} round(s), "
            f"pause {p['pause_ms_per_round']:.3f} ms per round, stage "
            f"{p['stage_s']:.3f} s; the engine's columns == the change "
            f"applied directly to a copy, byte for byte ({card})")
    finally:
        client.close()
        plane.stop()
        server.stop(0)
    return m, shaping.LAUNCHES["shape_step_rows"]


def run_twin_phase(el, fresh, dev, card, n_spine=None, n_leaf=None,
                   n_rows: int = PLANE_ROWS) -> tuple:
    """Phase 14: the what-if twin and the planned-update path. Returns
    (metrics, {sub-phase: K1 launches})."""
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.kernel_bench import Timer

    size = {} if n_spine is None else dict(n_spine=n_spine, n_leaf=n_leaf,
                                           capacity=1 << 12)
    t0 = time.perf_counter()
    built = entry.build_daemon(dev, **size)
    timer = Timer(dev) if dev.type == "cuda" else None
    m, k1 = {"reconcile_s": built["reconcile_s"]}, {}
    m["sweep"], k1["sweep"] = run_twin_sweep(built, dev, card, timer)
    m["routed"], k1["routed"] = run_twin_routed(
        el, fresh, dev, card, n_spine or entry.N_SPINE)
    m["live"], k1["whatif_and_plan"] = run_twin_live(built, dev, card,
                                                     n_rows)
    m["phase_s"] = time.perf_counter() - t0
    log(f"14: phase {m['phase_s']:.1f} s; K1 launches {k1}")
    return m, k1


# -- phase 15: checkpoint and restart, the exporter, kdt_ext -----------------

def toolchain_lines() -> list:
    """What phase 15 depends on beside the card: prometheus_client (its
    version), the interpreter's Python.h (kdt_ext's build), cc / g++."""
    import importlib.metadata
    import os
    import subprocess
    import sysconfig

    try:
        import prometheus_client  # noqa: F401
        prom = importlib.metadata.version("prometheus_client")
    except ImportError as e:
        prom = f"does not import ({e})"
    inc = sysconfig.get_paths()["include"]
    out = [f"prometheus_client {prom}",
           f"Python.h under {inc}: "
           f"{os.path.exists(os.path.join(inc, 'Python.h'))}"]
    for cc in ("cc", "g++"):
        try:
            v = subprocess.run([cc, "--version"], capture_output=True,
                               text=True, timeout=60).stdout
            out.append(v.splitlines()[0] if v else f"{cc}: no output")
        except OSError as e:
            out.append(f"{cc}: {e}")
    return out

CKPT_FEED_TICKS = 2         # k: phase 12's feed before the cut (4 until
#                             phase 20 joined, 3 until phase 21, PERF.md §4)
CKPT_RESUME_TICKS = 2       # m: the same feed after it, on both daemons
#                             (4 until phase 20 joined, 3 until phase 21)
SNAP_LANES = 2              # 15(d): scenarios of the snapshot-file sweep
SNAP_STEPS = 20
SCRAPES = 2                 # (3 until phase 21 joined)
SERIES_CAP = 10_000         # make_registry's default max_interfaces


def _file_bytes(path: str) -> dict:
    import os

    return {f: os.path.getsize(os.path.join(path, f))
            for f in sorted(os.listdir(path))}


def _egress_log(wout, t: int, log_, tags=None, want=None) -> None:
    """Append (tick, frames, digest) of each wire's released frames at
    tick t to log_[k] and empty the egress; with `tags`, count the
    delivered frames whose tag is in `want`."""
    import hashlib

    for k, w in enumerate(wout):
        if not w.egress:
            continue
        frames = list(w.egress)
        w.egress.clear()
        log_[k].append((t, len(frames), hashlib.blake2b(
            b"".join(frames), digest_size=16).digest()))
        if tags is not None:
            tags.update(f[:8] for f in frames if f[:8] in want)


def _resume(plane, win, wout, feeds, k0: int, tags=None, want=None):
    """Phase 15(a)/(b)'s resume: feeds[i] queued before tick k0 + i
    (feeds[0] is already queued), then idle ticks until the delay line
    is empty. Returns the per-wire release log."""
    log_ = [[] for _ in wout]
    t = k0
    for i in range(len(feeds)):
        if i:
            apply_feed(win, feeds[i])
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        _egress_log(wout, t, log_, tags, want)
        t += 1
    for _ in range(PLANE_DRAIN_TICKS):
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        _egress_log(wout, t, log_, tags, want)
        t += 1
        if (not plane._inflight and not plane._holdback
                and len(plane._wheel) == 0):
            break
    check(plane.tick_errors == 0, "15: tick errors")
    check(len(plane._wheel) == 0 and not plane._pending,
          "15: the delay line did not empty")
    return log_


def _draws_nothing(props: dict) -> bool:
    """A class props entry whose shaping no random draw decides
    (latency and TBF rate only)."""
    return set(props) <= {"latency", "rate"}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _scrape_values(body: str, name: str) -> list:
    return [float(line.rsplit(" ", 1)[1]) for line in body.splitlines()
            if line.startswith(name + "{") or line.startswith(name + " ")]


def run_checkpoint_phase(dev, card, n_spine=None, n_leaf=None,
                         n_rows: int = PLANE_ROWS) -> dict:
    """Phase 15: checkpoint and restart of phase 12's daemon at depth 1
    on an explicit clock, a damaged checkpoint, the twin's snapshot
    files, the daemon's Prometheus exporter and kdt_ext."""
    import shutil
    import tempfile

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.twin import snapshot_from_engine

    m = {}
    size = {} if n_spine is None else dict(n_spine=n_spine, n_leaf=n_leaf,
                                           capacity=1 << 12)
    try:
        import prometheus_client  # noqa: F401
        have_prom, why = True, ""
    except ImportError as e:
        have_prom, why = False, str(e)
    plane_kw = dict(dt_us=PLANE_DT_S * 1e6, seed=15, pipeline_depth=1)
    built = entry.build_daemon(dev, metrics_port=0 if have_prom else None,
                               plane_kwargs=plane_kw, tenancy=True, **size)
    daemon, engine = built["daemon"], built["engine"]
    plane = built.get("plane") or entry.build_plane(daemon, **plane_kw)
    plane.pipeline_explicit_clock = True
    # 15(d)'s fork base: phase 14's snapshot of the CR-built Clos
    snap = snapshot_from_engine(engine)
    # update observations so far (the reconciler's), then the phase's
    # own UpdateLinks calls: one per re-shaped spine CR
    n_update_calls = len(engine.stats.op_ms.get("update", ()))
    classes = plane_classes(built, n_rows)
    n_update_calls += len({spine for links in classes.values()
                           for spine, _leaf, _uid in links})
    win, wout = plane_wires(daemon, classes)
    keep = []   # wire indices whose link's props draw nothing
    i = 0
    for kind in ("tbf", "seq", "ind"):
        for _ in classes[kind]:
            props = CLASS_PROPS[kind][i % len(CLASS_PROPS[kind])]
            if _draws_nothing(props):
                keep.append(i)
            i += 1
    check(len(keep) > n_rows, "15: no non-drawing class beside TBF")

    # (a)-(f) in a directory of their own, removed afterwards
    tmp = tempfile.mkdtemp(prefix="chip_smoke-phase15-")
    try:
        return _checkpoint_phase(m, tmp, built, plane, snap, win, wout,
                                 keep, n_update_calls, have_prom, why,
                                 plane_kw, dev, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _checkpoint_phase(m, tmp, built, plane, snap, win, wout, keep,
                      n_update_calls, have_prom, why, plane_kw, dev, card):
    """Phase 15 (a)-(f) in the directory `tmp` (run_checkpoint_phase)."""
    import os
    import shutil
    import urllib.request
    from collections import Counter

    from kubedtn_tpu_torch import checkpoint, entry, native
    from kubedtn_tpu_torch.chaos import ChaosInjector
    from kubedtn_tpu_torch.twin import (load_snapshot, run_sweep,
                                        save_snapshot)
    from kubedtn_tpu_torch.twin.engine import replica_lane
    from kubedtn_tpu_torch.twin.query import build_cbr_spec
    from kubedtn_tpu_torch.utils.logging import get_logger
    from kubedtn_tpu_torch.wire.server import FrameSeg

    daemon, engine, store = built["daemon"], built["engine"], built["store"]
    cap = int(engine.state.capacity)
    rng = np.random.default_rng(15)
    for t in range(CKPT_FEED_TICKS):
        feed_tick(win, t, rng)
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        for w in wout:
            w.egress.clear()
    feeds = [make_feed(len(win), CKPT_FEED_TICKS + i, rng)
             for i in range(CKPT_RESUME_TICKS)]
    apply_feed(win, feeds[0])   # queued at the cut: captured as ingress
    cut_s = CKPT_FEED_TICKS * PLANE_DT_S
    state_at_cut = clone_state(engine.state)
    counters_at_cut = {f.name: getattr(plane.counters, f.name).copy()
                       for f in dataclasses.fields(plane.counters)}
    wires_at_cut = sorted((w.pod_key, w.uid, w.peer_ip, w.peer_intf_id,
                           w.node_iface_name) for w in daemon.wires.all())
    path = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    checkpoint.save_live(path, store, engine, plane)
    m["save_s"] = time.perf_counter() - t0
    # the auto-registered "default" tenant (every CR's namespace)
    reg = built["tenancy"]
    tenancy_at_cut = reg.export_config()
    rows_at_cut = reg.rows_of("default")
    check([t.name for t in reg.list()] == ["default"]
          and rows_at_cut.size == engine.num_active,
          "15(a): the default tenant does not own every row")
    pz = plane.pauses.snapshot()["causes"]["checkpoint_save"]
    m["save_pause_ms"] = 1e3 * pz["seconds"]
    m["file_bytes"] = _file_bytes(path)
    m["dir_bytes"] = sum(m["file_bytes"].values())
    pending = checkpoint.read_pending_entries(path)
    m["pending_frames"] = len(pending)
    m["ingress_frames"] = len(checkpoint.read_ingress_entries(path))
    check(m["pending_frames"] > 0, "15(a): no frame pending at the cut")
    check(m["ingress_frames"] == sum(feeds[0][3]),
          f"15(a): {m['ingress_frames']} ingress frames captured, "
          f"{sum(feeds[0][3])} queued")
    want = {f[:8] for _pk, _u, f, _r in pending}
    check(len(want) == len(pending), "15(a): pending tags not unique")
    del pending
    log(f"15(a) save_live at the cut (tick {CKPT_FEED_TICKS}): "
        f"{m['save_s']:.3f} s, tick-lock pause (checkpoint_save) "
        f"{m['save_pause_ms']:.3f} ms, {m['dir_bytes']} bytes "
        f"{m['file_bytes']}; {m['pending_frames']} frames pending, "
        f"{m['ingress_frames']} ingress frames captured ({card})")
    control = _resume(plane, win, wout, feeds, CKPT_FEED_TICKS)

    # (e) the exporter of this daemon, after the control's ticks
    if have_prom:
        url = f"http://127.0.0.1:{built['metrics']['port']}/metrics"
        walls, sizes, body = [], [], ""
        for _ in range(SCRAPES):
            t0 = time.perf_counter()
            body = urllib.request.urlopen(url, timeout=120).read().decode()
            walls.append(1e3 * (time.perf_counter() - t0))
            sizes.append(len(body))
        c = plane.counters
        snap_rows, n_active, active = engine.metrics_snapshot(
            limit=SERIES_CAP)
        tx = _scrape_values(body, "interface_tx_packets")
        check(len(tx) == min(SERIES_CAP, n_active),
              f"15(e): {len(tx)} interface series, the cap is "
              f"{SERIES_CAP}")
        check(_scrape_values(body, "kubedtn_interface_series_truncated")
              == [float(max(0, n_active - SERIES_CAP))],
              "15(e): the truncation gauge")
        want_tx = sum(float(c.tx_packets[r]) for _p, _u, r, _v in snap_rows)
        want_rx = sum(float(c.rx_packets[v]) for _p, _u, _r, v in snap_rows
                      if v is not None)
        check(sum(tx) == want_tx and sum(_scrape_values(
            body, "interface_rx_packets")) == want_rx,
              "15(e): interface_* sums != the plane's counters")
        for k in ("tx_packets", "rx_packets", "dropped_loss",
                  "dropped_queue"):
            check(_scrape_values(body, f"kubedtn_node_{k}_total")
                  == [float(getattr(c, k)[active].sum())],
                  f"15(e): kubedtn_node_{k}_total != the counters")
        n_upd = _scrape_values(body, 'kubedtnd_request_duration_'
                                     'milliseconds_count{method="update"}')
        check(n_upd == [float(n_update_calls)],
              f"15(e): update observations {n_upd}, the daemon made "
              f"{n_update_calls} UpdateLinks calls")
        m["scrape_ms"] = walls
        m["scrape_bytes"] = sizes
        log(f"15(e) /metrics over HTTP: {SCRAPES} scrapes in "
            f"{', '.join(f'{w:.1f}' for w in walls)} ms, {sizes[-1]} bytes; "
            f"{len(tx)} interface series (cap {SERIES_CAP}, "
            f"{n_active - len(tx)} truncated); interface_* sums and node "
            f"totals == the plane's counters; request histogram counts "
            f"the daemon's {n_update_calls} UpdateLinks calls ({card})")
        built["metrics"]["server"].stop()
    else:
        log(f"15(e) metrics: not run, prometheus_client does not import "
            f"here: {why}")

    # (b) restart from the directory alone
    t0 = time.perf_counter()
    r = entry.restore_daemon(path, dev, capacity=cap, now_s=cut_s,
                             plane_kwargs=plane_kw)
    m["load_s"] = time.perf_counter() - t0
    rplane, rd = r["plane"], r["daemon"]
    m["load_pause_ms"] = 1e3 * rplane.pauses.snapshot()["causes"][
        "checkpoint_load"]["seconds"]
    check(r["source"] == "checkpoint", "15(b): not restored from the "
                                       "checkpoint")
    check(r["tenancy"] is not None and rd.tenancy is r["tenancy"]
          and rplane.tenancy is r["tenancy"]
          and r["tenancy"].export_config() == tenancy_at_cut
          and np.array_equal(r["tenancy"].rows_of("default"), rows_at_cut),
          "15(b): the restored registry differs from the cut's")
    check(r["pending"] == m["pending_frames"]
          and r["ingress"] == m["ingress_frames"],
          "15(b): pending / ingress frames restored")
    same(r["engine"].state, state_at_cut, "15(b) EdgeState after load")
    got_w = sorted((w.pod_key, w.uid, w.peer_ip, w.peer_intf_id,
                    w.node_iface_name) for w in rd.wires.all())
    check(got_w == wires_at_cut, "15(b): the wire registry differs")
    for name, col in counters_at_cut.items():
        check(np.array_equal(getattr(rplane.counters, name), col),
              f"15(b): counter {name} differs from the cut")
    rplane.pipeline_explicit_clock = True
    rwin = [rd.wires.get_by_key(w.pod_key, w.uid) for w in win]
    rwout = [rd.wires.get_by_key(w.pod_key, w.uid) for w in wout]
    tags = Counter()
    restored = _resume(rplane, rwin, rwout, feeds, CKPT_FEED_TICKS,
                       tags, want)
    for k in keep:
        check(restored[k] == control[k],
              f"15(b): wire {k} (non-drawing) egress differs from the "
              f"uninterrupted daemon's")
    twice = sum(1 for v in tags.values() if v > 1)
    check(len(tags) == len(want) and twice == 0,
          f"15(b): {len(want) - len(tags)} pending frames not delivered, "
          f"{twice} twice")
    m["compared_wires"] = len(keep)
    log(f"15(b) restore_daemon from the directory: {m['load_s']:.3f} s, "
        f"checkpoint_load pause {m['load_pause_ms']:.3f} ms; EdgeState, "
        f"wires, counters and the tenant registry (export_config, "
        f"rows_of('default'): {rows_at_cut.size} rows) == the cut's; {len(keep)} non-drawing wires "
        f"(TBF-only and delay-only) released the same bytes on the same "
        f"ticks as the uninterrupted daemon over {CKPT_RESUME_TICKS} fed "
        f"ticks and the drain; all {len(want)} frames pending at the cut "
        f"delivered exactly once ({card})")
    del r, rplane, rd, restored, control

    # (c) damage: a truncated edge_state.npz, then a crash between renames
    bad = path + "-damaged"
    shutil.rmtree(bad, ignore_errors=True)
    shutil.copytree(path, bad)
    ChaosInjector(seed=15).truncate_file(os.path.join(bad,
                                                      "edge_state.npz"))
    rec = _Records()
    lg = get_logger("checkpoint")
    lg.addHandler(rec)
    try:
        _s, e_rb, src = checkpoint.load_or_rebuild(
            bad, store=store, capacity=cap, node_ip=engine.node_ip,
            device=dev)
    finally:
        lg.removeHandler(rec)
    check(src == "rebuild" and e_rb.num_active == engine.num_active,
          "15(c): no reconstruction from the store")
    check(any("CheckpointCorruptError" in x for x in rec.lines),
          "15(c): the typed error was not logged")
    del e_rb
    os.rename(path, path + ".prev")
    _s, e_prev = checkpoint.load(path, device=dev)
    same(e_prev.state, state_at_cut, "15(c) the .prev generation")
    check(e_prev._rows == engine._rows, "15(c) .prev registries")
    del e_prev
    log(f"15(c) truncated edge_state.npz: load_or_rebuild rebuilt "
        f"{engine.num_active} rows from the store, CheckpointCorruptError "
        f"logged; with only <dir>.prev left (a crash between the "
        f"renames) load restored the previous generation bit for bit")

    # (d) the twin's snapshot files
    spath = os.path.join(tmp, "snapshot.npz")
    t0 = time.perf_counter()
    save_snapshot(spath, snap)
    m["snapshot_save_s"] = time.perf_counter() - t0
    m["snapshot_bytes"] = os.path.getsize(spath)
    t0 = time.perf_counter()
    snap2 = load_snapshot(spath, dev)
    m["snapshot_load_s"] = time.perf_counter() - t0
    check(snap2.sim.edges.uid.device.type == dev.type,
          "15(d): the snapshot did not load onto the device")
    same(snap2.sim, snap.sim, "15(d) loaded snapshot")
    n_leaf_ = sum(1 for t in store.list() if t.name.startswith("leaf"))
    scen = twin_scenarios(store, n_leaf_)[:SNAP_LANES]
    with engine._lock:
        pod_ids = dict(engine._pod_ids)
    kw = dict(steps=SNAP_STEPS, dt_us=TWIN_DT_US, k_slots=TWIN_K,
              seed=TWIN_SEED, pod_ids=pod_ids, keep_final=True,
              spec=build_cbr_spec(snap.sim.edges))
    a = run_sweep(snap, scen, **kw)
    b = run_sweep(snap2, scen, **kw)
    same(replica_lane(b.final, 0, SNAP_LANES),
         replica_lane(a.final, 0, SNAP_LANES),
         "15(d) replica 0 from the file vs in memory")
    check(a.metrics == b.metrics, "15(d): sweep metrics differ")
    log(f"15(d) save_snapshot {m['snapshot_bytes']} bytes in "
        f"{m['snapshot_save_s']:.3f} s, load_snapshot onto the card in "
        f"{m['snapshot_load_s']:.3f} s; run_sweep ({SNAP_LANES} lanes x "
        f"{SNAP_STEPS} steps) replica 0 == the in-memory snapshot's, bit "
        f"for bit ({card})")
    del snap, snap2, a, b

    # (f) kdt_ext on phase 12's ingress blobs
    ext = native.kdt_ext()
    m["kdt_ext"] = ext is not None
    if ext is None:
        log(f"15(f) kdt_ext: not built, {native.kdt_ext_reason()}")
    else:
        blob, offs, lens, counts = make_feed(len(win), 99, rng)
        lo, n = 0, 0
        for c in counts:
            py = [blob[o:o + ln] for o, ln in
                  zip(offs[lo:lo + c].tolist(), lens[lo:lo + c].tolist())]
            check(ext.slice_frames(blob, offs, lens, lo, lo + c) == py
                  and FrameSeg(blob, offs, lens, lo, lo + c).materialize()
                  == py, "15(f): slice_frames != the Python path")
            lo += c
            n += len(py)
        log(f"15(f) kdt_ext loaded ({native.kdt_ext_path().name}): "
            f"slice_frames == the Python path on {len(counts)} segments, "
            f"{n} frames of phase 12's feed")
    return m


# -- phase 16: tenancy and the shared-memory ingest plane --------------------

TEN_NAMES = ("t0", "t1", "t2")
TEN_SPINE, TEN_LEAF, TEN_LPP = 100, 166, 2   # 33,200 links a tenant
TEN_BLOCK = 70_000          # t1's reserved rows (66,400 used)
TEN_TICKS = 3               # fed ticks of (b)-(d) (6 until a whole run
#                             with phase 19 went over the script's time
#                             bound, 5 until phase 21 joined, PERF.md §4);
#                             more than TEN_NOISY_TICKS: (d) reads its
#                             books on the tick after the throttled ones
TEN_NOISY_TICKS = 2         # (d): t0 throttled on these fed ticks (4
#                             until phase 21 joined)
TEN_NOISY_SHARE = 0.2       # (d): t0's frame budget over its fed rate
TEN_SEED = 16
TEN_SWEEP_STEPS = 50        # (e): the t1-scoped sweep's 4 lanes
TEN_CHECK_STEPS = 2         # (e): K1 vs the plain version
SHM_PRODUCERS = 8           # (f): one ring each, on t1's wires
SHM_FRAMES = 50_000         # frames per producer
SHM_FRAME_BYTES = 256
SHM_PREFILL = 8_192         # frames per ring of the equivalence round
SHM_WAIT_S = 300.0          # bound on (f)'s producer run
# one kernel class per tenant (tests/test_tenant_isolation.py): t1 is
# TBF-only because of the depth-2 lossy-TBF fault (ROADMAP §3)
TENANT_CLASS_PROPS = {
    "t0": dict(latency="2ms", jitter="1ms", loss="10"),
    "t1": dict(rate="2Mbit"),
    "t2": dict(latency="1ms", loss="10", loss_corr="25"),
}


def ten_crs(names, n_spine, n_leaf, lpp):
    """Each tenant's Clos in its own namespace, uids disjoint."""
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties

    n = n_spine * n_leaf * lpp
    return {t: entry.clos_crs(n_spine, n_leaf, lpp,
                              props=LinkProperties(**TENANT_CLASS_PROPS[t]),
                              namespace=t, uid_base=TEN_NAMES.index(t) * n)
            for t in names}


def ten_wires(daemon, crs, n_rows: int) -> tuple:
    """Wires on both ends of a tenant's first n_rows spine links (the
    spine end is the ingress direction): ([ingress], [egress],
    [(spine, leaf, uid)])."""
    import types

    def wd(pod, ns, uid):
        return types.SimpleNamespace(
            local_pod_name=pod, kube_ns=ns, link_uid=uid,
            intf_name_in_pod="eth1", veth_name_local_host="",
            peer_intf_id=0, peer_ip="")

    win, wout, links = [], [], []
    for t in crs:
        if not t.name.startswith("spine") or len(links) >= n_rows:
            continue
        for link in t.spec.links[:n_rows - len(links)]:
            links.append((t.name, link.peer_pod, link.uid))
            win.append(daemon._add_wire(wd(t.name, t.namespace, link.uid)))
            wout.append(daemon._add_wire(wd(link.peer_pod, t.namespace,
                                            link.uid)))
    return win, wout, links


def ten_rows_by_identity(engine, ns: str):
    """The tenant's rows in link-identity order ((pod_key, uid) sorted),
    so two engines' rows of one link line up."""
    keys = sorted(k for k in engine._rows if k[0].partition("/")[0] == ns)
    return np.fromiter((engine._rows[k] for k in keys), np.int64, len(keys))


def ten_run(built, wires: dict, feeds: dict, state0, depth: int,
            ticks: int = TEN_TICKS, mesh=None, hook=None) -> dict:
    """One run on a fresh plane over the daemon's engine restored to
    state0: feeds[t][i] queued on tenant t's ingress wires before fed
    tick i, then idle ticks until the delay line is empty; `hook(plane,
    i)` runs before fed tick i. Per tenant: egress digests and counts per
    wire, counter and telemetry rows in link-identity order, and the
    registry's tenant_counters."""
    import hashlib

    from kubedtn_tpu_torch import entry

    engine = built["engine"]
    engine.state = clone_state(state0)
    plane = entry.build_plane(built["daemon"], dt_us=PLANE_DT_S * 1e6,
                              seed=TEN_SEED, pipeline_depth=depth)
    plane.pipeline_explicit_clock = True
    plane.enable_telemetry(window_s=3600.0, sample_period=1024)
    if mesh is not None:
        plane.enable_sharding(mesh)
    dev = engine.device
    dig = {t: [hashlib.blake2b(digest_size=16) for _ in wires[t][1]]
           for t in wires}
    counts = {t: [0] * len(wires[t][1]) for t in wires}
    fed = {t: 0 for t in wires}

    def collect():
        for t, (_win, wout, _l) in wires.items():
            for k, w in enumerate(wout):
                if w.egress:
                    dig[t][k].update(b"".join(w.egress))
                    counts[t][k] += len(w.egress)
                    w.egress.clear()

    walls = []
    t = 0
    for t in range(ticks):
        if hook is not None:
            hook(plane, t)
        for ten, (win, _wout, _l) in wires.items():
            fed[ten] += apply_feed(win, feeds[ten][t])
        w0 = time.perf_counter()
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - w0)
        collect()
    stage = plane.stage_breakdown()
    for _ in range(PLANE_DRAIN_TICKS):
        t += 1
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        collect()
        if (not plane._inflight and not plane._holdback
                and len(plane._wheel) == 0
                and not any(w.ingress for v in wires.values()
                            for w in v[0])):
            break
    plane.flush()
    collect()
    check(plane.tick_errors == 0, "16: tick errors")
    check(len(plane._wheel) == 0 and not plane._pending,
          "16: the delay line did not empty")
    reg = built["tenancy"]
    c = plane.counters
    total, _secs = plane.telemetry.window_sum()
    out = {"plane": plane, "fed": fed, "walls": walls, "stage": stage,
           "digests": {t: [d.hexdigest() for d in v] for t, v in dig.items()},
           "counts": counts, "rows": {}, "tel": {}, "cnt": {},
           "tenant_counters": {}}
    for ten in wires:
        rows = ten_rows_by_identity(engine, ten)
        out["rows"][ten] = rows
        out["cnt"][ten] = {f.name: getattr(c, f.name)[rows].copy()
                           for f in dataclasses.fields(c)}
        out["tel"][ten] = total[rows].copy()
        out["tenant_counters"][ten] = reg.tenant_counters(plane, ten)
    return out


def ten_same(a: dict, b: dict, ten: str, name: str,
             lat_tol: bool = False) -> int:
    """Tenant `ten` of two runs: per-wire egress bytes, counter rows in
    link-identity order and the registry's tenant_counters, bit for bit;
    telemetry rows bit for bit too, but with `lat_tol` the latency-sum
    column within the parity tolerance (STATE_TOL): a depth-2 plane
    corrects FORCED fallback rows' window stats on the host in float64
    where depth 1 folds them in float32 on the card, in the JAX package
    as in the port (ROADMAP §3). Returns the rows whose latency sums
    differ."""
    from kubedtn_tpu_torch.telemetry import T_LAT_SUM_US

    check(a["counts"][ten] == b["counts"][ten],
          f"{name}: tenant {ten} per-wire egress counts differ")
    check(a["digests"][ten] == b["digests"][ten],
          f"{name}: tenant {ten} per-wire egress bytes differ")
    ta, tb = a["tel"][ten], b["tel"][ten]
    cols = [c for c in range(ta.shape[1]) if not lat_tol or c != T_LAT_SUM_US]
    check(np.array_equal(ta[:, cols], tb[:, cols]),
          f"{name}: tenant {ten} telemetry rows differ")
    lat_a, lat_b = ta[:, T_LAT_SUM_US], tb[:, T_LAT_SUM_US]
    check(np.allclose(lat_a, lat_b, **STATE_TOL),
          f"{name}: tenant {ten} latency sums beyond the tolerance")
    for k, col in a["cnt"][ten].items():
        check(np.array_equal(col, b["cnt"][ten][k]),
              f"{name}: tenant {ten} counter {k} differs")
    check(a["tenant_counters"][ten] == b["tenant_counters"][ten],
          f"{name}: tenant {ten} tenant_counters differ")
    return int((lat_a != lat_b).sum())


def _ns_update_links(daemon, ns: str, pod: str, links) -> None:
    from kubedtn_tpu_torch.wire import proto as pb

    q = pb.LinksBatchQuery(local_pod=pb.Pod(name=pod, kube_ns=ns),
                           links=[pb.link_to_proto(l) for l in links])
    check(daemon.UpdateLinks(q, None).response, f"UpdateLinks {ns}/{pod}")


def run_tenancy_phase(dev, card, n_spine=None, n_leaf=None,
                      n_rows: int = PLANE_ROWS, block: int = TEN_BLOCK,
                      capacity: int = 1 << 18, shm_frames: int = SHM_FRAMES,
                      prefill: int = SHM_PREFILL,
                      sweep_steps: int = TEN_SWEEP_STEPS,
                      plane_d1_drain_share=None) -> tuple:
    """Phase 16: three tenant fabrics cohabiting one plane against each
    alone, sharded, under a noisy neighbour, the tenant-scoped WhatIf,
    shared-memory ingest from producer processes and the scrape. Returns
    (metrics, K1 launches, K4 launches) of the phase's path."""
    import shutil
    import tempfile

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh
    from kubedtn_tpu_torch.tenancy import HostTokenBucket
    from kubedtn_tpu_torch.wire import proto as pb

    n_spine = n_spine or TEN_SPINE
    n_leaf = n_leaf or TEN_LEAF
    m = {"rows_per_class": n_rows}
    shaping.reset_launches()
    pex.reset_launches()
    cmp = {"k1": 0, "k4": 0}   # launches made only to compare
    crs = ten_crs(TEN_NAMES, n_spine, n_leaf, TEN_LPP)
    n_rows_ten = 2 * n_spine * n_leaf * TEN_LPP

    # (a) the cohabited daemon and one solo daemon per tenant
    co = entry.build_daemon(
        dev, capacity=capacity, crs=[c for t in TEN_NAMES for c in crs[t]],
        tenancy={"t1": {"block_edges": block}})
    solo = {t: entry.build_daemon(dev, capacity=capacity, crs=crs[t],
                                  tenancy=True) for t in TEN_NAMES}
    m["reconcile_s"] = {"cohabited": co["reconcile_s"],
                        **{t: solo[t]["reconcile_s"] for t in TEN_NAMES}}
    reg, engine = co["tenancy"], co["engine"]
    check(engine.num_active == 3 * n_rows_ten,
          f"16(a): {engine.num_active} rows realized")
    lo, hi = reg.get("t1").block
    rows_t1 = reg.rows_of("t1")
    check(hi - lo == block and bool(((rows_t1 >= lo) & (rows_t1 < hi)).all()),
          "16(a): t1's rows are not inside its block")
    walk = {}
    for (pod_key, _uid), row in engine._rows.items():
        walk.setdefault(pod_key.partition("/")[0], []).append(row)
    for t in TEN_NAMES:
        check(reg.rows_of(t).tolist() == sorted(walk[t])
              and len(walk[t]) == n_rows_ten,
              f"16(a): rows_of({t}) != a walk of the engine's rows")
    lst = co["daemon"].TenantList(pb.TenantQuery(), None)
    check(lst.ok and sorted(x.name for x in lst.tenants) == list(TEN_NAMES)
          and all(x.links == n_rows_ten for x in lst.tenants),
          "16(a): TenantList over the Daemon")
    st1 = co["daemon"].TenantStats(pb.TenantQuery(name="t1"), None)
    check(st1.ok and st1.tenant.block_lo == lo and st1.tenant.links
          == n_rows_ten, "16(a): TenantStats over the Daemon")
    check(co["daemon"].health_snapshot()["tenants"] == 3,
          "16(a): Health's tenant count")
    alone = ", ".join(f"{t} {m['reconcile_s'][t]:.3f} s"
                      for t in TEN_NAMES)
    log(f"16(a) {sum(len(c) for c in crs.values())} CRs of 3 tenant "
        f"fabrics: {engine.num_active} rows in capacity "
        f"{engine.state.capacity}, reconcile-to-steady "
        f"{m['reconcile_s']['cohabited']:.3f} s cohabited, {alone} "
        f"alone; t1's {rows_t1.size} rows inside its block [{lo}, {hi}); "
        f"rows_of == a walk of the engine's rows; TenantList / TenantStats "
        f"/ Health answer over the Daemon ({card})")

    # the fed wires, each tenant's feed made once from its own seed
    wires_co = {t: ten_wires(co["daemon"], crs[t], n_rows) for t in TEN_NAMES}
    wires_so = {t: ten_wires(solo[t]["daemon"], crs[t], n_rows)
                for t in TEN_NAMES}
    feeds = {}
    for j, t in enumerate(TEN_NAMES):
        rng = np.random.default_rng(TEN_SEED + j)
        feeds[t] = [make_feed(n_rows, i, rng) for i in range(TEN_TICKS)]
    state_co = clone_state(engine.state)
    state_so = {t: clone_state(solo[t]["engine"].state) for t in TEN_NAMES}

    # (b) solo == cohabited at depth 1
    b_co = ten_run(co, wires_co, feeds, state_co, depth=1)
    b_so = {t: ten_run(solo[t], {t: wires_so[t]}, feeds, state_so[t],
                       depth=1) for t in TEN_NAMES}
    for t in TEN_NAMES:
        ten_same(b_co, b_so[t], t, "16(b) cohabited vs alone")
    c = b_co["plane"].counters
    for f in dataclasses.fields(c):
        col = getattr(c, f.name).astype(np.float64)
        check(sum(float(b_co["cnt"][t][f.name].astype(np.float64).sum())
                  for t in TEN_NAMES) == float(col.sum()),
              f"16(b): the tenants' {f.name} do not sum to the plane's")
    p = b_co["plane"]
    check(p.shaped + p.dropped == sum(b_co["fed"].values()),
          "16(b): shaped + dropped != fed")
    m["b"] = {
        "fed": b_co["fed"], "shaped": p.shaped, "dropped": p.dropped,
        "tenant_counters": b_co["tenant_counters"],
        "wall_ms_per_tick_cohabited": 1e3 * statistics.median(
            b_co["walls"]),
        "wall_ms_per_tick_alone": {t: 1e3 * statistics.median(
            b_so[t]["walls"]) for t in TEN_NAMES},
        "stage_cohabited": b_co["stage"]}
    share = b_co["stage"]["share"]
    alone = {t: round(v, 3) for t, v in
             m["b"]["wall_ms_per_tick_alone"].items()}
    log(f"16(b) depth 1, {TEN_TICKS} fed ticks and the drain: each "
        f"tenant's per-wire egress bytes, telemetry rows and counter rows "
        f"(by link identity) and tenant_counters cohabited == alone, bit "
        f"for bit; the three tenants' counters sum to the plane's; fed "
        f"{b_co['fed']}, shaped {p.shaped}, dropped {p.dropped}; wall "
        f"{m['b']['wall_ms_per_tick_cohabited']:.3f} ms/tick cohabited, "
        f"{alone} alone; shares {share} ({card})")

    # (h) the drain's cost with tenancy on
    hot = 3 * n_rows
    drain_s = b_co["stage"]["seconds"]["drain"]
    m["h"] = {"drain_share_tenancy": share["drain"],
              "drain_us_per_hot_wire_tick": 1e6 * drain_s
              / (TEN_TICKS * hot),
              "drain_share_phase12_depth1": plane_d1_drain_share}
    log(f"16(h) depth-1 drain share with tenancy {share['drain']} "
        f"({m['h']['drain_us_per_hot_wire_tick']:.2f} us per hot wire and "
        f"tick, budget_for once per hot wire and tick) against 12(b)'s "
        f"{plane_d1_drain_share} without it ({card})")

    # (c) depth 2 on 2 virtual shards == depth 1 unsharded; K4
    captured = []
    real_shift = pex.ring_right_shift

    def capture(blocks, mesh):
        if not captured:
            captured.append(([b.clone() for b in blocks], tuple(mesh)))
        return real_shift(blocks, mesh)

    k4_0 = pex.LAUNCHES["ring_step"]
    pex.ring_right_shift = capture
    try:
        c_sh = ten_run(co, wires_co, feeds, state_co, depth=2,
                       mesh=make_mesh([dev] * 2))
    finally:
        pex.ring_right_shift = real_shift
    k4_c = pex.LAUNCHES["ring_step"] - k4_0
    lat_rows = sum(ten_same(c_sh, b_co, t, "16(c) depth 2 on 2 virtual "
                                           "shards vs depth 1 unsharded",
                            lat_tol=True) for t in TEN_NAMES)
    check(captured, "16(c): the sharded plane ran no ring step")
    blocks, mesh = captured[0]
    before = pex.LAUNCHES["ring_step"]
    same(pex.ring_right_shift(blocks, mesh),
         pex.ring_right_shift_plain(blocks), "16(c) K4 vs plain")
    cmp["k4"] += pex.LAUNCHES["ring_step"] - before
    summ = c_sh["plane"].shard_summary()
    m["c"] = {"wall_ms_per_tick": 1e3 * statistics.median(c_sh["walls"]),
              "k4_launches": k4_c, "mailbox_rows": int(blocks[0].shape[0]),
              "xshard_frames": summ["xshard_frames"],
              "latency_sum_rows_within_tol": lat_rows,
              "fallback_rows": c_sh["plane"].fallbacks}
    check(k4_c > 0 or dev.type != "cuda", "16(c): K4 never launched")
    log(f"16(c) depth 2 on 2 virtual shards == depth 1 unsharded per "
        f"tenant, bit for bit (egress, counters, telemetry; the latency "
        f"sums of {lat_rows} forced fallback rows within rtol 1e-6 / atol "
        f"1e-3 of {c_sh['plane'].fallbacks} fallback rows); {k4_c} K4 "
        f"launches, K4 == plain on one ring "
        f"step of this plane's mailbox ({blocks[0].shape[0]} x "
        f"{blocks[0].shape[1]} words a shard); {summ['xshard_frames']} "
        f"cross-shard frames; wall {m['c']['wall_ms_per_tick']:.3f} "
        f"ms/tick ({card})")

    # (d) noisy neighbour: t0 at 20 % of its fed rate for
    # TEN_NOISY_TICKS fed ticks
    t0 = reg.get("t0")
    fed_t0 = sum(sum(feeds["t0"][i][3]) for i in range(TEN_NOISY_TICKS))
    rate = TEN_NOISY_SHARE * fed_t0 / (TEN_NOISY_TICKS * PLANE_DT_S)
    base = {"admitted": t0.admitted_frames,
            "events": reg.admission.stats_for("t0")["throttle_events"]}
    seen = {}

    def noisy(plane, i):
        if i == 0:
            reg.set_quota("t0", frame_budget_per_s=rate)
            # a burst of one tick's budget, so the cut bites at once
            t0.bucket_frames = HostTokenBucket(rate, rate * PLANE_DT_S)
        elif i == TEN_NOISY_TICKS:
            queued = sum(len(w.ingress) for w in wires_co["t0"][0])
            seen.update(admitted=t0.admitted_frames - base["admitted"],
                        queued=queued)
            reg.set_quota("t0", frame_budget_per_s=0.0)

    d = ten_run(co, wires_co, feeds, state_co, depth=1, hook=noisy)
    events = (reg.admission.stats_for("t0")["throttle_events"]
              - base["events"])
    reasons = {v.reason for v in reg.admission.recent(1024)
               if v.tenant == "t0"}
    check(seen["admitted"] + seen["queued"] == fed_t0,
          f"16(d): t0 admitted {seen['admitted']} + queued "
          f"{seen['queued']} != fed {fed_t0}")
    check(seen["queued"] > 0 and events > 0 and reasons == {"frame-budget"},
          f"16(d): no typed frame-budget verdicts ({events}, {reasons})")
    for t in ("t1", "t2"):
        ten_same(d, b_so[t], t, "16(d) noisy t0: cohabited vs alone")
    pd = d["plane"]
    check(pd.shaped + pd.dropped == sum(d["fed"].values()),
          "16(d): t0's frames were not all shaped after the cut")
    m["d"] = {"t0_fed_throttled_ticks": fed_t0, "t0_admitted": seen["admitted"],
              "t0_queued": seen["queued"], "verdicts": events,
              "budget_frames_per_s": rate}
    log(f"16(d) t0 cut to {TEN_NOISY_SHARE:.0%} of its fed rate "
        f"({rate:.1f} frames/s) for {TEN_NOISY_TICKS} fed ticks: admitted "
        f"{seen['admitted']} + queued {seen['queued']} == fed {fed_t0}, "
        f"none dropped; {events} typed frame-budget verdicts; t1 and t2 "
        f"egress, telemetry and counters == alone, bit for bit ({card})")
    del b_so, c_sh, d

    # (e) the tenant-scoped WhatIf on the live cohabited plane
    m["e"], k1_cmp = ten_sweep(co, co["daemon"].dataplane, dev, card,
                               sweep_steps)
    cmp["k1"] += k1_cmp
    del b_co

    # (f) shared-memory ingest; (g) the scrape
    tmp = tempfile.mkdtemp(prefix="chip_smoke-phase16-")
    try:
        m["f"] = ten_shm(co, wires_co["t1"], state_co, dev, card, tmp,
                         shm_frames, prefill)
        m["g"] = ten_scrape(co, card)
    finally:
        if co["daemon"].shm is not None:
            co["daemon"].shm.close()
        shutil.rmtree(tmp, ignore_errors=True)
    k1 = shaping.LAUNCHES["shape_step_rows"] - cmp["k1"]
    k4 = pex.LAUNCHES["ring_step"] - cmp["k4"]
    check(k1 > 0 or dev.type != "cuda", "16: K1 never launched")
    return m, k1, k4


def ten_sweep(co, plane, dev, card, steps: int) -> tuple:
    """16(e): t1's scoped fork of the live plane swept on the card.
    Returns (metrics, K1 launches made only to compare)."""
    from kubedtn_tpu_torch import sim
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.twin import Perturbation, Scenario, run_sweep
    from kubedtn_tpu_torch.twin.engine import replica_lane
    from kubedtn_tpu_torch.twin.query import build_cbr_spec
    from kubedtn_tpu_torch.wire import proto as pb

    reg = co["tenancy"]
    t0 = time.perf_counter()
    snap = reg.tenant_snapshot(plane, "t1")
    snap_s = time.perf_counter() - t0
    rows = reg.rows_of("t1")
    active = snap.sim.edges.active.cpu().numpy()
    check(np.array_equal(np.flatnonzero(active), rows),
          "16(e): the fork's active rows != rows_of(t1)")
    uid = next(iter(sorted(u for (pk, u) in co["engine"]._rows
                           if pk.startswith("t1/"))))
    scen = [Scenario("baseline"),
            Scenario("t1-slower", (Perturbation(
                "degrade", uid=uid, props=LinkProperties(rate="1Mbit")),)),
            Scenario("t1-fail", (Perturbation("fail", uid=uid),)),
            Scenario("half-load", (Perturbation("scale", factor=0.5),))]
    E = snap.sim.edges.capacity
    spec = build_cbr_spec(snap.sim.edges)
    kw = dict(dt_us=TWIN_DT_US, spec=spec, k_slots=TWIN_K, seed=TWIN_SEED,
              keep_final=True)
    before = shaping.LAUNCHES["shape_step_rows"]
    res = run_sweep(snap, scen, steps=steps, **kw)
    _sync(dev)
    launches = shaping.LAUNCHES["shape_step_rows"] - before
    check(launches == steps * TWIN_K or dev.type != "cuda",
          f"16(e): {launches} K1 launches for {steps} steps")
    ref = sim.run(snap.sim, spec, steps, TWIN_DT_US, TWIN_K, seed=TWIN_SEED)
    same(replica_lane(res.final, 0, len(scen)), ref,
         "16(e) replica 0 vs sim.run on the scoped snapshot")
    tx = res.final.counters.tx_packets.reshape(len(scen), E).cpu().numpy()
    outside = np.setdiff1d(np.arange(E), rows)
    check(not tx[:, outside].any() and tx[0, rows].sum() > 0,
          "16(e): a row outside t1 carried packets, or t1 none")
    del ref
    before = shaping.LAUNCHES["shape_step_rows"]
    two = dict(steps=TEN_CHECK_STEPS, **kw)
    k2 = run_sweep(snap, scen, shape_fn=queues.shape_packets, **two)
    p2 = run_sweep(snap, scen, shape_fn=queues.shape_packets_plain, **two)
    same(k2.final, p2.final, "16(e) 2 steps: K1 vs the plain version")
    k1_cmp = shaping.LAUNCHES["shape_step_rows"] - before
    del k2, p2
    req = dict(ticks=20, dt_us=TWIN_DT_US, seed=3, include_baseline=True)
    t0 = time.perf_counter()
    ok = co["daemon"].WhatIf(pb.WhatIfRequest(tenant="t1", **req), None)
    rpc_s = time.perf_counter() - t0
    check(ok.ok and ok.results[0].tx_packets > 0,
          f"16(e): WhatIf tenant=t1 not served: {ok.error}")
    bad = co["daemon"].WhatIf(pb.WhatIfRequest(tenant="nope", **req), None)
    check(not bad.ok and "unknown tenant" in bad.error,
          "16(e): WhatIf tenant=nope was not refused")
    m = {"lanes": len(scen), "rows": len(scen) * E, "steps": steps,
         "ms_per_step": res.run_s * 1e3 / steps, "snapshot_s": snap_s,
         "whatif_rpc_s": rpc_s, "k1_launches": launches,
         "metrics": {n: {k: x[k] for k in ("tx_packets", "delivered_packets",
                                           "dropped_queue")}
                     for n, x in zip(res.names, res.metrics)}}
    log(f"16(e) tenant_snapshot(plane, 't1') in {snap_s:.3f} s: active rows "
        f"== rows_of(t1) ({rows.size}); {len(scen)} lanes x {E} rows x "
        f"{steps} steps: {m['ms_per_step']:.3f} ms/step, {launches} K1 "
        f"launches (one per slot and step over {len(scen) * E} rows); "
        f"replica 0 == sim.run on the scoped snapshot; no packet outside "
        f"t1; {TEN_CHECK_STEPS} steps through K1 == the plain version, bit "
        f"for bit; WhatIf tenant=t1 served in {rpc_s:.3f} s, tenant=nope "
        f"refused ({card})")
    return m, k1_cmp


def ten_shm(co, wires_t1, state_co, dev, card, tmp: str, n_frames: int,
            prefill: int) -> dict:
    """16(f): producer processes into rings on t1's first ingress wires;
    the rings pre-filled against the same frames through wire.ingress;
    admission parking frames in a ring."""
    import os
    import subprocess

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.shm import ShmIngest, ShmRing, ShmSender
    from kubedtn_tpu_torch.shm.producer import make_frame
    from kubedtn_tpu_torch.tenancy import HostTokenBucket

    daemon, engine, reg = co["daemon"], co["engine"], co["tenancy"]
    win, wout, links = wires_t1
    n_p = min(SHM_PRODUCERS, len(win))
    # the fed links re-shaped latency-only (1 ms, no draw, no queue): every
    # frame must arrive once, in order
    spine = co["store"].get("t1", links[0][0])
    uids = {u for _s, _l, u in links[:n_p]}
    check(all(s == links[0][0] for s, _l, _u in links[:n_p]),
          "16(f): the fed links span two spines")
    _ns_update_links(daemon, "t1", spine.name, [
        l.with_properties(LinkProperties(latency="1ms"))
        for l in spine.spec.links if l.uid in uids])
    engine.flush()
    state_f = clone_state(engine.state)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")

    def fresh_plane(ingest, watcher, max_slots=4096):
        engine.state = clone_state(state_f)
        daemon.shm = None
        plane = entry.build_plane(daemon, dt_us=PLANE_DT_S * 1e6,
                                  seed=TEN_SEED, pipeline_depth=1,
                                  max_slots=max_slots)
        plane.pipeline_explicit_clock = True
        if ingest is not None:
            plane.attach_shm(ingest, watcher=watcher)
        return plane

    # producers in their own processes, the plane ticking as they push
    ring_dir = os.path.join(tmp, "rings")
    os.makedirs(ring_dir)
    ingest = ShmIngest(ring_dir, scan_interval_s=0.01)
    plane = fresh_plane(ingest, watcher=True)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kubedtn_tpu_torch.shm.producer",
         os.path.join(ring_dir, f"p{k}.ring"), str(win[k].wire_id),
         str(n_frames), "--frame-size", str(SHM_FRAME_BYTES),
         "--namespace", "t1"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(n_p)]
    nxt = [0] * n_p
    bad = []
    total = n_p * n_frames
    t, t_first, t_last = 0, None, None
    deadline = time.monotonic() + SHM_WAIT_S
    try:
        while sum(nxt) < total and time.monotonic() < deadline:
            if t_first is None:
                # the producers start up (a few seconds each): tick only
                # once a ring holds frames
                if not ingest.stats()["pending"]:
                    ingest.scan(force=True)
                    time.sleep(0.005)
                    continue
                t_first = time.perf_counter()
            t += 1
            plane.tick(now_s=t * PLANE_DT_S)
            for k in range(n_p):
                q = wout[k].egress
                while q:
                    f = q.popleft()
                    i = int.from_bytes(f[:8], "little")
                    if i != nxt[k] or len(f) != SHM_FRAME_BYTES:
                        bad.append((k, i, nxt[k]))
                    nxt[k] += 1
            if sum(nxt) >= total:
                t_last = time.perf_counter()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"16(f): a producer failed: {[o[1][-500:] for o in outs]}")
    check(all(o[0].splitlines()[-1] == f"done pushed={n_frames}"
              for o in outs), "16(f): a producer did not push every frame")
    check(not bad and nxt == [n_frames] * n_p,
          f"16(f): delivered {nxt} of {n_frames} a wire, out of order "
          f"{bad[:5]}")
    st = ingest.stats()
    check(st["frames_in"] == total and st["pending"] == 0,
          f"16(f): ingest stats {st}")
    rate = total / (t_last - t_first)
    m = {"producers": n_p, "frames": total, "ticks": t,
         "frames_per_s": rate, "ingest": st,
         "stage": plane.stage_breakdown()}
    log(f"16(f) {n_p} producer processes x {n_frames} frames of "
        f"{SHM_FRAME_BYTES} B into their rings on t1's wires: every wire "
        f"delivered frames 0..{n_frames - 1} once, in order, in {t} ticks; "
        f"{rate:.1f} frames/s from ring to egress ({card})")
    ingest.close()

    # the rings pre-filled == the same frames through wire.ingress
    frames = [make_frame(i, SHM_FRAME_BYTES) for i in range(prefill)]
    pre_dir = os.path.join(tmp, "prefill")
    os.makedirs(pre_dir)
    senders = [ShmSender(os.path.join(pre_dir, f"q{k}.ring"),
                         slots=max(prefill, 64), namespace="t1")
               for k in range(n_p)]
    for k, s in enumerate(senders):
        s.send(win[k].wire_id, frames)
        check(s.buffered() == 0, "16(f): a pre-filled ring overflowed")
    logs = {}
    for mode in ("shm", "ingress"):
        ing = None
        if mode == "shm":
            ing = ShmIngest(pre_dir)
            for s in senders:
                ing.attach_ring(ShmRing.attach(s.ring.path))
        p = fresh_plane(ing, watcher=False)
        if mode == "ingress":
            for k in range(n_p):
                win[k].ingress.extend(frames)
        out = [[] for _ in range(n_p)]
        for i in range(PLANE_DRAIN_TICKS):
            p.tick(now_s=(i + 1) * PLANE_DT_S)
            _egress_log(wout[:n_p], i, out)
            if (sum(len(x) for x in out) and not p._inflight
                    and len(p._wheel) == 0 and not any(
                        w.ingress for w in win[:n_p])
                    and (ing is None or ing.pending_total() == 0)):
                break
        logs[mode] = out
        if ing is not None:
            ing.close()
    check(logs["shm"] == logs["ingress"],
          "16(f): pre-filled rings != the same frames through wire.ingress")
    check(sum(n for x in logs["shm"] for _t, n, _d in x) == n_p * prefill,
          "16(f): the pre-filled frames were not all delivered")
    log(f"16(f) {n_p} rings pre-filled with {prefill} frames each, "
        f"explicit ticks: per wire and tick the egress == the same frames "
        f"fed through wire.ingress, bit for bit ({card})")

    # admission at the ring head: t1 at 5 % of the ring's frames a tick,
    # a quarter of the ring drained a tick while admitted
    rate_t1 = 0.05 * prefill / PLANE_DT_S
    reg.set_quota("t1", frame_budget_per_s=rate_t1)
    t1 = reg.get("t1")
    t1.bucket_frames = HostTokenBucket(rate_t1, rate_t1 * PLANE_DT_S)
    adm_dir = os.path.join(tmp, "admission")
    os.makedirs(adm_dir)
    sender = ShmSender(os.path.join(adm_dir, "a.ring"),
                       slots=max(prefill, 64), namespace="t1")
    sender.send(win[0].wire_id, frames)
    ing = ShmIngest(adm_dir)
    ing.attach_ring(ShmRing.attach(sender.ring.path))
    p = fresh_plane(ing, watcher=False, max_slots=prefill // 4)
    parked, got = 0, 0
    for i in range(4):
        p.tick(now_s=(i + 1) * PLANE_DT_S)
        st = ing.stats()
        parked = max(parked, st["throttled_frames_last"])
        check(st["frames_in"] + st["pending"] == prefill,
              "16(f): admission lost or duplicated ring frames")
    st_adm = ing.stats()
    check(st_adm["pending"] > 0 and st_adm["throttled_events"] > 0
          and parked > 0, f"16(f): admission did not park frames {st_adm}")
    reg.set_quota("t1", frame_budget_per_s=0.0)
    for i in range(4, 4 + PLANE_DRAIN_TICKS):
        p.tick(now_s=(i + 1) * PLANE_DT_S)
        got += len(wout[0].egress)
        wout[0].egress.clear()
        if ing.pending_total() == 0 and len(p._wheel) == 0:
            break
    check(got == prefill and p.dropped == 0,
          f"16(f): {got} of {prefill} parked frames delivered")
    log(f"16(f) admission at the ring head: t1 cut to {rate_t1:.0f} "
        f"frames/s: {st_adm['pending']} frames parked in the ring, "
        f"{st_adm['throttled_events']} throttled drains, frames_in + "
        f"pending == pushed every tick; budget restored, all {prefill} "
        f"delivered, none dropped ({card})")
    sender.close()
    m["admission"] = st_adm
    # (g) scrapes this daemon's shm ingest: the admission round's
    daemon.shm = ing
    return m


def ten_scrape(co, card) -> dict:
    """16(g): one scrape of /metrics with the tenant and shm collectors;
    the kubedtn_tenant_* series == registry.stats, kubedtn_shm_* ==
    ShmIngest.stats()."""
    import urllib.request

    from kubedtn_tpu_torch import entry

    daemon, reg = co["daemon"], co["tenancy"]
    plane = daemon.dataplane
    srv = entry.serve_metrics(daemon, plane, port=0, host="127.0.0.1")
    try:
        t0 = time.perf_counter()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv['port']}/metrics", timeout=120
        ).read().decode()
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        srv["server"].stop()
    for t in TEN_NAMES + ("default",):
        if reg.get(t) is None:
            continue
        s = reg.stats(plane, t)
        for key, fam in (("admitted_frames", "admitted_frames_total"),
                         ("admitted_bytes", "admitted_bytes_total"),
                         ("throttle_events", "throttle_events_total"),
                         ("tx_packets", "tx_packets_total"),
                         ("delivered_packets", "delivered_packets_total"),
                         ("dropped_queue", "dropped_queue_total"),
                         ("links", "links")):
            got = _scrape_values(body, f'kubedtn_tenant_{fam}'
                                       f'{{tenant="{t}"}}')
            check(got == [float(s[key])],
                  f"16(g): kubedtn_tenant_{fam}{{{t}}} {got} != {s[key]}")
    st = daemon.shm.stats()
    for fam, key in (("frames_total", "frames_in"),
                     ("bytes_total", "bytes_in"),
                     ("throttled_events_total", "throttled_events"),
                     ("pending_frames", "pending"), ("rings", "rings")):
        check(_scrape_values(body, f"kubedtn_shm_{fam}") == [float(st[key])],
              f"16(g): kubedtn_shm_{fam} != ShmIngest.stats()[{key}]")
    log(f"16(g) /metrics with the tenant and shm collectors: {ms:.1f} ms, "
        f"{len(body)} bytes; kubedtn_tenant_* == registry.stats, "
        f"kubedtn_shm_* == ShmIngest.stats() ({card})")
    return {"scrape_ms": ms, "bytes": len(body)}


# -- phase 17: the SLO plane and the autopilot -------------------------------

AP_BG = ("t1", "t2")        # phase 16's fabrics, bronze backfill here
AP_GOLD = "g0"
AP_GOLD_PAIRS = 4           # burn_recovery's shape, 4 pod pairs at 2 ms
AP_GOLD_LATENCY = "2ms"
AP_FEED = 40                # frames of AP_FRAME_BYTES per g0 wire and tick
AP_FRAME_BYTES = 200
AP_BG_LINKS = 512           # fed spine links per background tenant
AP_BG_MAX_FRAMES = 8        # 1..8 frames of 64-256 B per wire and tick
AP_TICK_S = 0.05            # explicit clock per tick
AP_WINDOW_S = 0.5           # telemetry windows
AP_DT_US = 1000.0
AP_WARM_TICKS = 12          # fed ticks before the baseline verdicts: the
                            # first window closes on the 11th
AP_POLL_TICKS = 5           # fed ticks per poll
AP_PAGE_POLLS = 30          # bound on (b)'s polls to the page
AP_GREEN_POLLS = 40         # bound on (d)'s polls to green
AP_LOSS = "25"
AP_SEED = 0
AP_STEPS = 50              # the search's steps (200 until phase 21,
#                             100 until phase 22 joined, PERF.md §4)
AP_GATE_TICKS = 50          # the gate's horizon, cut from 400 (200 until
#                             phase 21 joined, 100 until phase 22)
AP_CHECK_STEPS = 2          # (c): K1 vs the plain version
AP_EVAL_REPS = 3            # (a): timed evaluate() passes
AP_SIDECAR_S = 4.0          # (g): seconds of the real-time plane


def ap_gold_crs(prefix: str, ns: str, pairs: int, uid_base: int,
                node_ip: str = "10.0.0.1", latency: str = AP_GOLD_LATENCY):
    """burn_recovery's tenant as CRs: `pairs` pod pairs, one 2 ms link
    each (or `latency`), pods placed on `node_ip` (the CNI ran, no link
    realized)."""
    from kubedtn_tpu_torch.api.types import (Link, LinkProperties,
                                             Topology, TopologySpec)

    props = LinkProperties(latency=latency)
    out = []
    for i in range(pairs):
        a, b = f"{prefix}-{ns}-a{i}", f"{prefix}-{ns}-b{i}"
        for x, y in ((a, b), (b, a)):
            t = Topology(name=x, namespace=ns, spec=TopologySpec(links=[
                Link(local_intf="eth1", peer_intf="eth1", peer_pod=y,
                     uid=uid_base + i + 1, properties=props)]))
            t.status.src_ip, t.status.net_ns = node_ip, f"/run/netns/{x}"
            t.status.links = []
            out.append(t)
    return out


def ap_columns(engine) -> dict:
    """The engine's configuration columns, copied to the host."""
    return {n: getattr(engine.state, n).cpu().numpy().copy()
            for n in ("uid", "src", "dst", "active", "props")}


def ap_registries(engine) -> tuple:
    return (dict(engine._rows), dict(engine._peer),
            dict(engine._row_owner), set(engine._shaped_rows))


def ap_same_columns(a: dict, b: dict, name: str, rows=None) -> None:
    for k in a:
        x, y = (a[k], b[k]) if rows is None else (a[k][rows], b[k][rows])
        check(np.array_equal(x, y), f"{name}: column {k} moved")


class ApLoop:
    """Phase 17's explicit-clock driver: every tick feeds g0's ingress
    wires AP_FEED frames and, with `bg`, the background tenants' wires
    1..8 frames, then drains every egress wire, counting g0's. Fed and
    idle ticks' wall seconds are kept apart."""

    def __init__(self, plane, gold, bg, seed: int):
        self.plane = plane
        self.win, self.wout = gold
        self.bg = bg
        self.rng = np.random.default_rng(seed)
        self.frame = b"\xab" * AP_FRAME_BYTES
        # the explicit clock starts at the monotonic clock's reading: at
        # start() the plane rebases its own clock onto the monotonic one
        # but not the telemetry window clock, so an explicit clock AHEAD
        # of the monotonic one holds every window open after it, in the
        # JAX package too (ROADMAP §3); (g) runs the real-time plane
        self.clock = time.monotonic()
        self.fed = 0
        self.delivered = 0
        self.walls = {True: [], False: []}

    def ticks(self, n: int, feed: bool = True) -> None:
        for _ in range(n):
            if feed:
                for w in self.win:
                    w.ingress.extend([self.frame] * AP_FEED)
                self.fed += AP_FEED * len(self.win)
                for win, _wout in self.bg:
                    apply_feed(win, make_feed(len(win), 0, self.rng,
                                              AP_BG_MAX_FRAMES))
            self.clock += AP_TICK_S
            t0 = time.perf_counter()
            self.plane.tick(now_s=self.clock)
            self.walls[feed].append(time.perf_counter() - t0)
            for w in self.wout:
                self.delivered += len(w.egress)
                w.egress.clear()
            for _win, wout in self.bg:
                for w in wout:
                    w.egress.clear()


def run_autopilot_phase(dev, card, n_spine=None, n_leaf=None,
                        n_bg_links: int = AP_BG_LINKS,
                        capacity: int = 1 << 18, steps: int = AP_STEPS,
                        gate_ticks: int = AP_GATE_TICKS,
                        sidecar_s: float = AP_SIDECAR_S) -> tuple:
    """Phase 17: a gold tenant's burn page remediated at full width
    beside two bronze backfill fabrics. Returns (metrics, K1 launches
    of the phase's path)."""
    import dataclasses as dc

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.autopilot import (Autopilot, AutopilotConfig,
                                             Candidate, actuate)
    from kubedtn_tpu_torch.autopilot import actuator as ap_actuator
    from kubedtn_tpu_torch.autopilot import controller as ap_controller
    from kubedtn_tpu_torch.autopilot.candidates import _scaled_props
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.scenarios import wire_def
    from kubedtn_tpu_torch.slo import SloEvaluator
    from kubedtn_tpu_torch.telemetry import T_DELIVERED, T_TX
    from kubedtn_tpu_torch.updates import Guardrails

    t_phase = time.perf_counter()
    n_spine = n_spine or TEN_SPINE
    n_leaf = n_leaf or TEN_LEAF
    shaping.reset_launches()
    cmp = 0                     # K1 launches made only to compare
    m = {"capacity": capacity}

    # (a) build: t1 and t2 as phase 16 builds them, bronze; g0 gold
    crs = ten_crs(AP_BG, n_spine, n_leaf, TEN_LPP)
    n_ten = n_spine * n_leaf * TEN_LPP
    gold_crs = ap_gold_crs("ap", AP_GOLD, AP_GOLD_PAIRS, len(TEN_NAMES)
                           * n_ten)
    co = entry.build_daemon(
        dev, capacity=capacity,
        crs=[c for t in AP_BG for c in crs[t]] + gold_crs,
        tenancy={"t1": {"qos": "bronze"}, "t2": {"qos": "bronze"},
                 AP_GOLD: {"qos": "gold"}})
    daemon, reg, engine = co["daemon"], co["tenancy"], co["engine"]
    store, rec = co["store"], co["reconciler"]
    rows_g0 = reg.rows_of(AP_GOLD)
    check(engine.num_active == 2 * (2 * n_ten + AP_GOLD_PAIRS)
          and rows_g0.size == 2 * AP_GOLD_PAIRS,
          f"17(a): {engine.num_active} rows realized")
    plane = entry.build_plane(daemon, dt_us=AP_DT_US, seed=AP_SEED)
    plane.pipeline_explicit_clock = True
    plane.enable_telemetry(window_s=AP_WINDOW_S, sample_period=256)
    gold = ([], [])
    for i in range(AP_GOLD_PAIRS):
        uid = len(TEN_NAMES) * n_ten + i + 1
        for side, lst in (("a", gold[0]), ("b", gold[1])):
            lst.append(daemon._add_wire(wire_def(
                f"ap-{AP_GOLD}-{side}{i}", AP_GOLD, uid)))
    bg = [ten_wires(daemon, crs[t], n_bg_links)[:2] for t in AP_BG]
    loop = ApLoop(plane, gold, bg, TEN_SEED)
    ev = SloEvaluator(reg, plane).attach(daemon)
    cfg = AutopilotConfig(seed=AP_SEED, width=2, steps=steps,
                          dt_us=AP_DT_US, page_polls=1, cooldown_s=5.0,
                          verify_polls=20,
                          guardrail_overrides=(("ticks", gate_ticks),))
    ap = Autopilot(reg, plane, ev, config=cfg,
                   tick_driver=lambda n: loop.ticks(n, feed=False)
                   ).attach(daemon)
    ap.enable()

    loop.ticks(AP_WARM_TICKS)
    fresh = ev.maybe_evaluate()
    tel = plane.telemetry
    check(fresh is not None and tel.windows_closed >= 1
          and ev.stats.snapshot()["evaluations"] >= 1,
          f"17(a): no evaluation ({tel.windows_closed} windows closed)")
    vs = ev.verdicts()
    check(sorted(vs) == sorted(AP_BG + (AP_GOLD,)), f"17(a): {sorted(vs)}")
    check(all(v.severity != "page" for v in vs.values()),
          f"17(a): a tenant pages: "
          f"{ {n: v.severity for n, v in vs.items()} }")
    g = vs[AP_GOLD]
    check(g.attainment_ok and g.latency_ok and g.tx > 0,
          f"17(a): g0's baseline verdict {g.to_dict()}")
    total, _secs = tel.window_sum(last=12, include_open=False)
    act = np.flatnonzero(engine.state.active.cpu().numpy())
    direct = total[act].sum(axis=0)
    check(sum(v.tx for v in vs.values()) == float(direct[T_TX])
          and sum(v.delivered for v in vs.values())
          == float(direct[T_DELIVERED]),
          "17(a): the tenants' slow-window tx / delivered != a direct "
          "sum over all active rows")
    walls = []
    for _ in range(AP_EVAL_REPS):
        t0 = time.perf_counter()
        ev.evaluate()
        walls.append(time.perf_counter() - t0)
    m["a"] = {"reconcile_s": co["reconcile_s"], "rows": engine.num_active,
              "evaluate_s": statistics.median(walls),
              "evaluate_s_samples": walls,
              "windows_closed": tel.windows_closed,
              "baseline": {n: {"severity": v.severity, "tx": v.tx,
                               "slow_burn": v.slow_burn}
                           for n, v in vs.items()}}
    log(f"17(a) {len(crs['t1']) + len(crs['t2']) + len(gold_crs)} CRs "
        f"(t1, t2 bronze; g0 gold, {AP_GOLD_PAIRS} pairs): "
        f"{engine.num_active} rows in capacity {engine.state.capacity}, "
        f"reconcile-to-steady {co['reconcile_s']:.3f} s; "
        f"{AP_WARM_TICKS} fed ticks: {tel.windows_closed} window(s) "
        f"closed, no page, g0 attainment and latency ok; the tenants' "
        f"slow-window tx / delivered == a direct sum over the active "
        f"rows; evaluate() {m['a']['evaluate_s']:.3f} s a pass at "
        f"{engine.state.capacity} rows ({card})")

    # (b) the page: 25 % loss on g0's a-side links, the canonical path
    for topo in store.list(AP_GOLD):
        if f"-{AP_GOLD}-a" not in topo.name:
            continue
        fresh_t = store.get(topo.namespace, topo.name)
        fresh_t.spec.links = [
            l.with_properties(dc.replace(l.properties, loss=AP_LOSS))
            for l in fresh_t.spec.links]
        store.update(fresh_t)
    rec.drain()
    paged = None
    polls = 0
    for polls in range(1, AP_PAGE_POLLS + 1):
        loop.ticks(AP_POLL_TICKS)
        ev.maybe_evaluate()
        vs = ev.verdicts()
        check(all(vs[t].severity != "page" for t in AP_BG),
              f"17(b): a background tenant pages: "
              f"{ {t: vs[t].severity for t in AP_BG} }")
        if vs[AP_GOLD].severity == "page":
            paged = vs[AP_GOLD]
            break
    check(paged is not None, f"17(b): g0 did not page in {polls} polls")
    m["b"] = {"polls_to_page": polls, "fast_burn": paged.fast_burn,
              "slow_burn": paged.slow_burn,
              "bg_severity": {t: vs[t].severity for t in AP_BG}}
    log(f"17(b) {AP_LOSS} % loss on g0's a-side links (spec -> "
        f"store.update -> reconciler): g0 pages after {polls} polls of "
        f"{AP_POLL_TICKS} fed ticks (fast burn {paged.fast_burn:.2f}, "
        f"slow {paged.slow_burn:.2f}); t1 / t2 never page "
        f"({m['b']['bg_severity']})")

    # (e) a gate-rejected one-topology candidate leaves the plane as it
    # was; (f) the same candidate in dry run: gated, not staged
    snap = reg.tenant_snapshot(plane, AP_GOLD)
    props = ap._edge_props(snap, AP_GOLD)
    uid0 = min(props)
    one = Candidate(name="shape:one-topology", kind="shape", cost=1,
                    props_by_uid=((uid0, _scaled_props(
                        props[uid0], 1.0, 1.0, clear_loss=True)),))
    del snap
    before = (ap_columns(engine), ap_registries(engine))
    l0 = shaping.LAUNCHES["shape_step_rows"]
    out_e = actuate(plane, reg, AP_GOLD, one, paged,
                    guardrails=Guardrails(max_delivery_drop=-1.0,
                                          ticks=gate_ticks,
                                          dt_us=AP_DT_US),
                    tick_driver=lambda n: loop.ticks(n, feed=False))
    check(out_e.rejected and not out_e.staged and not out_e.ok
          and len(out_e.plans) == 1 and "delivery" in out_e.reason,
          f"17(e): {out_e}")
    ap_same_columns(before[0], ap_columns(engine), "17(e)")
    check(ap_registries(engine) == before[1], "17(e): registries moved")
    ap.set_dry_run(True)
    out_f = actuate(plane, reg, AP_GOLD, one, paged,
                    overrides=cfg.guardrail_overrides,
                    dry_run=ap.dry_run,
                    tick_driver=lambda n: loop.ticks(n, feed=False))
    ap.set_dry_run(False)
    check(out_f.dry_run and out_f.ok and not out_f.staged
          and len(out_f.plans) == 1 and out_f.plans[0].gate_ok
          and "dry-run" in out_f.plans[0].reason, f"17(f): {out_f}")
    ap_same_columns(before[0], ap_columns(engine), "17(f)")
    check(ap_registries(engine) == before[1], "17(f): registries moved")
    m["e"] = {"gate_s": out_e.gate_s, "reason": out_e.reason}
    m["f"] = {"gate_s": out_f.gate_s,
              "k1_launches_e_f": shaping.LAUNCHES["shape_step_rows"] - l0}
    log(f"17(e) a one-topology shape candidate (loss cleared on uid "
        f"{uid0}) through guardrails that reject it: rejected in "
        f"{out_e.gate_s:.3f} s ({out_e.reason}); SoA columns and the "
        f"engine's row / peer / owner / shaped registries unchanged; "
        f"17(f) the same in dry run: gated ok in {out_f.gate_s:.3f} s, "
        f"not staged, the plane unchanged ({card})")

    # (c) the search and (d) the gates and the stage, in one poll
    seen = {"search": [], "gates": []}
    real_score = ap_controller.score_candidates
    real_gate = ap_actuator.verify_plan_live
    real_k1 = shaping.shape_step_flags

    def score(snap, *a, **kw):
        rows = []

        def k1(state, *ka, **kk):
            if state.tokens.is_cuda:
                rows.append(state.capacity)
            return real_k1(state, *ka, **kk)

        l0 = shaping.LAUNCHES["shape_step_rows"]
        shaping.shape_step_flags = k1
        try:
            sr = real_score(snap, *a, **kw)
        finally:
            shaping.shape_step_flags = real_k1
        _sync(dev)
        seen["search"].append(dict(
            snap=snap, args=a, kw=kw, result=sr, rows=rows,
            launches=shaping.LAUNCHES["shape_step_rows"] - l0))
        return sr

    def gate(plane_, plan, **kw):
        l0 = shaping.LAUNCHES["shape_step_rows"]
        gv = real_gate(plane_, plan, **kw)
        seen["gates"].append(dict(
            key=plan.key, ok=gv.ok, gate_s=gv.gate_s, ticks=gv.ticks,
            replicas=gv.replicas,
            launches=shaping.LAUNCHES["shape_step_rows"] - l0))
        return gv

    cols0 = ap_columns(engine)
    ap_controller.score_candidates = score
    ap_actuator.verify_plan_live = gate
    t0 = time.perf_counter()
    try:
        acts = ap.poll()
    finally:
        ap_controller.score_candidates = real_score
        ap_actuator.verify_plan_live = real_gate
    poll_s = time.perf_counter() - t0
    check(len(seen["search"]) == 1,
          f"17(c): {len(seen['search'])} searches in the poll")
    s = seen["search"][0]
    sr = s["result"]
    E = s["snap"].sim.edges.capacity
    check(E == capacity and sr.replicas == sr.candidates + 1,
          f"17(c): {sr.replicas} replicas of {E} rows")
    if dev.type == "cuda":
        check(s["launches"] == steps * cfg.k_slots
              and s["rows"] == [sr.replicas * E] * len(s["rows"])
              and len(s["rows"]) == s["launches"],
              f"17(c): {s['launches']} K1 launches for {steps} steps x "
              f"{cfg.k_slots} slots (rows {sorted(set(s['rows']))})")
    check(sr.winner is not None and acts and acts[0]["verdict"]
          == "staged", f"17(c)/(d): {acts} {sr.winner}")
    l0 = shaping.LAUNCHES["shape_step_rows"]
    again = real_score(s["snap"], *s["args"], **s["kw"])
    _sync(dev)
    cmp += shaping.LAUNCHES["shape_step_rows"] - l0
    check([x.candidate.name for x in again.ranked]
          == [x.candidate.name for x in sr.ranked]
          and [x.projected_burn for x in again.ranked]
          == [x.projected_burn for x in sr.ranked]
          and again.winner.name == sr.winner.name
          and again.baseline_burn == sr.baseline_burn,
          "17(c): the same snapshot, seed and verdict ranked differently")
    cmp += ap_k1_vs_plain(s, dev)
    m["c"] = {"candidates": sr.candidates, "replicas": sr.replicas,
              "rows": sr.replicas * E, "steps": steps,
              "k1_launches": s["launches"], "search_run_s": sr.run_s,
              "search_compile_s": sr.compile_s,
              "ms_per_step": sr.run_s * 1e3 / steps,
              "baseline_burn": sr.baseline_burn,
              "ranked": [[x.candidate.name, x.projected_burn]
                         for x in sr.ranked],
              "winner": sr.winner.name, "poll_s": poll_s}
    log(f"17(c) one search: {sr.candidates} candidates + the baseline = "
        f"{sr.replicas} replicas x {E} rows, {steps} steps: ONE sweep, "
        f"{s['launches']} K1 launches (steps x slots) each over "
        f"{sr.replicas * E} rows; {sr.run_s:.3f} s "
        f"({m['c']['ms_per_step']:.3f} ms/step); winner {sr.winner.name} "
        f"(projected burn {sr.ranked[0].projected_burn:.4f} < baseline "
        f"{sr.baseline_burn:.4f}); the same snapshot, seed and verdict "
        f"rank the same, burns bit for bit; {AP_CHECK_STEPS} steps of the "
        f"grid's rows through K1 == the plain version, bit for bit "
        f"({card})")

    # (d) the gates, the stage, the verify
    a0 = acts[0]
    plans = a0["plans"]
    check(len(seen["gates"]) == plans and all(x["ok"]
                                              for x in seen["gates"])
          and len({x["key"] for x in seen["gates"]}) == plans,
          f"17(d): {seen['gates']} for {plans} plans")
    rows_g0_after = reg.rows_of(AP_GOLD)
    check(np.array_equal(rows_g0_after, rows_g0), "17(d): g0's rows moved")
    outside = np.setdiff1d(np.arange(capacity), rows_g0)
    cols1 = ap_columns(engine)
    ap_same_columns(cols0, cols1, "17(d) rows outside g0", rows=outside)
    check(not np.array_equal(cols0["props"][rows_g0],
                             cols1["props"][rows_g0]),
          "17(d): the staged delta did not reach g0's rows")
    green = -1
    for i in range(1, AP_GREEN_POLLS + 1):
        loop.ticks(AP_POLL_TICKS)
        ev.maybe_evaluate()
        ap.poll()
        vs = ev.verdicts()
        check(all(vs[t].severity != "page" for t in AP_BG),
              "17(d): a background tenant pages")
        if vs[AP_GOLD].severity != "page":
            green = i
            break
    check(green > 0, f"17(d): g0 still pages after {AP_GREEN_POLLS} polls")
    la = ap.last_action(AP_GOLD) or {}
    loop.ticks(40, feed=False)
    c0 = reg.tenant_counters(plane, AP_GOLD)
    fed0, del0 = loop.fed, loop.delivered
    loop.ticks(20)
    loop.ticks(40, feed=False)
    c1 = reg.tenant_counters(plane, AP_GOLD)
    post_fed, post_del = loop.fed - fed0, loop.delivered - del0
    post_lost = sum(c1[k] - c0[k] for k in ("dropped_loss",
                                            "dropped_queue",
                                            "dropped_ring"))
    check(post_fed > 0 and post_lost == 0 and post_del == post_fed
          and plane.tick_errors == 0,
          f"17(d): post-cutover fed {post_fed}, delivered {post_del}, "
          f"lost {post_lost}, tick errors {plane.tick_errors}")
    gate_s = [x["gate_s"] for x in seen["gates"]]
    m["d"] = {"plans": plans, "gate_s_per_plan": statistics.median(gate_s),
              "gate_s": gate_s, "gate_ticks": gate_ticks,
              "gate_k1_launches": [x["launches"] for x in seen["gates"]],
              "stage_s": a0["stage_s"], "candidate": a0["candidate"],
              "kind": a0["kind"], "polls_to_green": green,
              "time_to_green_s": float(la.get("time_to_green_s", 0.0)),
              "post_frames_fed": post_fed,
              "post_frames_delivered": post_del,
              "post_frames_lost": post_lost,
              "wall_ms_per_fed_tick": 1e3 * statistics.median(
                  loop.walls[True]),
              "wall_ms_per_idle_tick": 1e3 * statistics.median(
                  loop.walls[False]),
              "fed_ticks": len(loop.walls[True]),
              "idle_ticks": len(loop.walls[False])}
    log(f"17(d) {a0['candidate']} ({a0['kind']}): {plans} plans, each "
        f"gated first ({m['d']['gate_s_per_plan']:.3f} s a gate of 2 "
        f"lanes x {gate_ticks} ticks at {capacity} rows), then staged "
        f"({a0['stage_s']:.3f} s); rows outside g0 byte-identical "
        f"(uid, src, dst, active, props); green after {green} polls "
        f"({m['d']['time_to_green_s']:.3f} s from the page); post-cutover "
        f"{post_fed} fed == {post_del} delivered, lost {post_lost}, tick "
        f"errors 0; the loop's fed tick "
        f"{m['d']['wall_ms_per_fed_tick']:.3f} ms (median of "
        f"{m['d']['fed_ticks']}), idle tick "
        f"{m['d']['wall_ms_per_idle_tick']:.3f} ms ({card})")

    # (g) the surfaces: RPCs over gRPC, the scrape, the sidecars
    m["g"] = ap_surfaces(co, plane, ev, ap, card, sidecar_s)
    plane.stop()
    k1 = shaping.LAUNCHES["shape_step_rows"] - cmp
    check(k1 > 0 or dev.type != "cuda", "17: K1 never launched")
    m["phase_s"] = time.perf_counter() - t_phase
    return m, k1


def ap_k1_vs_plain(s: dict, dev) -> int:
    """17(c): AP_CHECK_STEPS steps of the search's grid (baseline + every
    candidate, the same snapshot and seed) through K1 and through the
    plain version, bit for bit. Returns the K1 launches made."""
    from kubedtn_tpu_torch.autopilot.search import BASELINE
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.twin import Scenario, run_sweep

    grid = s["args"][3]
    kw = s["kw"]
    scen = [Scenario(BASELINE, ())] + [c.scenario() for c in grid]
    two = dict(steps=AP_CHECK_STEPS, dt_us=kw["dt_us"],
               k_slots=kw["k_slots"], seed=kw["seed"], keep_final=True)
    l0 = shaping.LAUNCHES["shape_step_rows"]
    k = run_sweep(s["snap"], scen, shape_fn=queues.shape_packets, **two)
    p = run_sweep(s["snap"], scen, shape_fn=queues.shape_packets_plain,
                  **two)
    same(k.final, p.final, "17(c) K1 vs the plain version on the "
                           "search's replica rows")
    check(k.metrics == p.metrics, "17(c): metrics differ")
    return shaping.LAUNCHES["shape_step_rows"] - l0


def ap_surfaces(co, plane, ev, ap, card, sidecar_s: float) -> dict:
    """17(g): ObserveSLO / AutopilotCtl / AutopilotStatus over gRPC ==
    the in-process state; one scrape's kubedtn_slo_* and
    kubedtn_autopilot_* == the verdicts and AutopilotStats; the
    sidecars on the real-time plane."""
    import urllib.request

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.slo.spec import SEVERITY_LEVELS
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient
    from kubedtn_tpu_torch.wire.server import Daemon, make_server

    daemon = co["daemon"]
    out = {}
    server, port = make_server(daemon, port=0, host="127.0.0.1",
                               log_rpcs=False)
    server.start()
    c = DaemonClient(f"127.0.0.1:{port}")
    try:
        for tenant in ("", AP_GOLD, "nope"):
            payloads = ev.verdict_payloads(tenant=tenant)
            resp = c.ObserveSLO(pb.ObserveSLORequest(tenant=tenant),
                                timeout=120)
            want = [Daemon._slo_tenant_msg(v) for v in payloads]
            check(resp.ok and len(resp.tenants) == len(want) and all(
                x.SerializeToString(deterministic=True)
                == y.SerializeToString(deterministic=True)
                for x, y in zip(resp.tenants, want))
                and resp.evaluations == ev.stats.snapshot()["evaluations"]
                and resp.windows_closed == plane.telemetry.windows_closed,
                f"17(g): ObserveSLO(tenant={tenant!r}) != "
                f"verdict_payloads()")
        for action, en, dry in (("disable", False, False),
                                ("dry-run-on", False, True),
                                ("dry-run-off", False, False),
                                ("enable", True, False)):
            r = c.AutopilotCtl(pb.AutopilotCtlRequest(action=action),
                               timeout=60)
            check(r.ok and (r.enabled, r.dry_run) == (en, dry)
                  and (ap.enabled, ap.dry_run) == (en, dry),
                  f"17(g): AutopilotCtl {action}")
        resp = c.AutopilotStatus(pb.AutopilotStatusRequest(history=10),
                                 timeout=60)
        st, hist = ap.status(), ap.history(limit=10)
        want = [Daemon._autopilot_action_msg(r) for r in hist]
        check(resp.ok and len(resp.actions) == len(want) >= 1 and all(
            x.SerializeToString(deterministic=True)
            == y.SerializeToString(deterministic=True)
            for x, y in zip(resp.actions, want)),
            "17(g): AutopilotStatus actions != history()")
        snap = st["stats"]
        check((resp.enabled, resp.dry_run, resp.running, resp.pages_seen,
               resp.searches_run, resp.deltas_staged,
               resp.deltas_rejected, resp.deltas_rolled_back,
               resp.escalations)
              == (st["enabled"], st["dry_run"], st["running"],
                  snap["pages_seen"], snap["searches_run"],
                  snap["deltas_staged"], snap["deltas_rejected"],
                  snap["deltas_rolled_back"], snap["escalations"]),
              "17(g): AutopilotStatus != status()")
        check([(s.tenant, s.state, s.pages, s.fails) for s in resp.states]
              == [(n, x["state"], x["pages"], x["fails"])
                  for n, x in st["tenants"].items()],
              "17(g): AutopilotStatus states != status()")
    finally:
        c.close()
        server.stop(0)
    srv = entry.serve_metrics(daemon, plane, port=0, host="127.0.0.1")
    try:
        t0 = time.perf_counter()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv['port']}/metrics", timeout=300
        ).read().decode()
        out["scrape_ms"] = 1e3 * (time.perf_counter() - t0)
    finally:
        srv["server"].stop()
    vs = ev.verdicts()
    for n, v in vs.items():
        for fam, val in (("slow_burn", v.slow_burn),
                         ("fast_burn", v.fast_burn),
                         ("budget_remaining", v.budget_remaining),
                         ("severity", SEVERITY_LEVELS[v.severity]),
                         ("target", v.spec.delivery_ratio_floor)):
            got = _scrape_values(body, f'kubedtn_slo_{fam}'
                                       f'{{tenant="{n}"}}')
            check(got == [float(val)],
                  f"17(g): kubedtn_slo_{fam}{{{n}}} {got} != {val}")
    for key, val in ev.stats.snapshot().items():
        check(_scrape_values(body, f"kubedtn_slo_{key}_total")
              == [float(val)], f"17(g): kubedtn_slo_{key}_total")
    for key, val in ap.stats.snapshot().items():
        check(_scrape_values(body, f"kubedtn_autopilot_{key}_total")
              == [float(val)], f"17(g): kubedtn_autopilot_{key}_total")
    check(_scrape_values(body, "kubedtn_autopilot_enabled") == [1.0]
          and _scrape_values(body, "kubedtn_slo_series_truncated")
          == [0.0], "17(g): kubedtn_autopilot_enabled / truncation")
    # the sidecars beside the real-time runner
    recs = _Records()
    recs.setLevel(logging.ERROR)
    logging.getLogger("kubedtn").addHandler(recs)
    ev0 = ev.stats.snapshot()["evaluations"]
    w0 = plane.telemetry.windows_closed
    errs0 = ap.stats.snapshot()["errors"]
    plane.start()
    ev.start()
    ap.start(poll_s=0.25)
    try:
        time.sleep(sidecar_s)
    finally:
        ap.stop()
        ev.stop()
        plane.stop()
        logging.getLogger("kubedtn").removeHandler(recs)
    out["sidecar"] = {
        "seconds": sidecar_s,
        "evaluations": ev.stats.snapshot()["evaluations"] - ev0,
        "windows_closed": plane.telemetry.windows_closed - w0,
        "autopilot_errors": ap.stats.snapshot()["errors"] - errs0,
        "error_records": recs.lines[:5]}
    sc = out["sidecar"]
    check(sc["windows_closed"] >= 1 and sc["evaluations"] >= 1
          and not recs.lines and sc["autopilot_errors"] == 0
          and not ev._thread and not ap._thread,
          f"17(g): the sidecars {sc}")
    log(f"17(g) ObserveSLO (all, g0, unknown), AutopilotCtl (disable, "
        f"dry-run on / off, enable) and AutopilotStatus (history 10) over "
        f"gRPC == verdict_payloads() / status() / history(); one scrape "
        f"({out['scrape_ms']:.1f} ms, {len(body)} bytes): kubedtn_slo_* "
        f"== the verdicts and SloStats, kubedtn_autopilot_* == "
        f"AutopilotStats; the sidecars over {sidecar_s:g} s of the "
        f"real-time plane: {sc['evaluations']} evaluations on "
        f"{sc['windows_closed']} window rollovers, no error logged, both "
        f"threads stopped ({card})")
    return out


MIG_LINKS = 2048            # fed spine links per tenant
MIG_MAX_FRAMES = 16         # 1..16 frames of 64-256 B per wire and tick
MIG_TICKS = 18              # fed ticks; each migration in a 2-tick gap
MIG_GAPS = {"t0": 4, "t1": 9, "t2": 14}   # first tick of each gap
MIG_GAP = 2
MIG_SEED = 18
MIG_B0 = "b0"               # B's own tenant: phase 17's g0 shape
MIG_B0_FEED = 8             # frames of AP_FRAME_BYTES per b0 wire, tick
MIG_TIMEOUT_S = 120.0       # bound on every RECONCILE wait
# the barriers of a migration: FORK, RESTORE (with restore_tenant_slice's
# own round inside it), CUTOVER; RELEASE's round and the undo's are
# staged_update rounds
MIG_PAUSES = ("migration_fork", "migration_restore", "migration_cutover",
              "staged_update")


def mig_keys(crs, n_links: int) -> tuple:
    """The link identities of a tenant's first n_links spine links:
    ([(spine pod key, uid)], [(leaf pod key, uid)]) — the ingress and
    egress ends, looked up on whichever plane serves the tenant."""
    ins, outs = [], []
    for t in crs:
        if not t.name.startswith("spine") or len(ins) >= n_links:
            continue
        for link in t.spec.links[:n_links - len(ins)]:
            ins.append((t.key, link.uid))
            outs.append((f"{t.namespace}/{link.peer_pod}", link.uid))
    return ins, outs


class MigRun:
    """One side of phase 18 (the federation A + B, or the references
    A' + B'): where each tenant is served, its fed ticks' frames queued
    on the serving plane's wires, every egress wire drained into
    per-wire digests in identity order (A's wire first, then B's: the
    egress a RELEASE hands off lands at the head of B's wire)."""

    def __init__(self, a, b, keys, dev):
        import hashlib

        self.a, self.b, self.keys, self.dev = a, b, keys, dev
        self.serve = {t: a for t in keys if t != MIG_B0}
        self.serve[MIG_B0] = b
        self.dig = {t: [hashlib.blake2b(digest_size=16)
                        for _ in keys[t][1]] for t in keys}
        self.counts = {t: [0] * len(keys[t][1]) for t in keys}
        self.fed = {t: 0 for t in keys}
        self.hold_egress = set()   # (plane id, tenant) left undrained
        self.walls = {"a": [], "b": []}

    def feed(self, t: str, feed) -> None:
        d = self.serve[t]["daemon"]
        win = [d.wires.get_by_key(*k) for k in self.keys[t][0]]
        self.fed[t] += apply_feed(win, feed)

    def collect(self) -> None:
        for t, (_ins, outs) in self.keys.items():
            for side in (self.a, self.b):
                if (id(side), t) in self.hold_egress:
                    continue
                wires = side["daemon"].wires
                for i, k in enumerate(outs):
                    w = wires.get_by_key(*k)
                    if w is not None and w.egress:
                        self.dig[t][i].update(b"".join(w.egress))
                        self.counts[t][i] += len(w.egress)
                        w.egress.clear()

    def tick(self, now_s: float) -> None:
        for name, side in (("a", self.a), ("b", self.b)):
            t0 = time.perf_counter()
            side["plane"].tick(now_s=now_s)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            self.walls[name].append(time.perf_counter() - t0)
        self.collect()

    def idle(self) -> bool:
        for side in (self.a, self.b):
            p = side["plane"]
            if (p._inflight or p._holdback or len(p._wheel)
                    or p._pending):
                return False
        return True

    def digests(self, t: str) -> list:
        return [d.hexdigest() for d in self.dig[t]]


def _mig_side(dev, crs, capacity, tenancy, node_ip, mesh=None,
              telemetry=False) -> dict:
    from kubedtn_tpu_torch import entry

    side = entry.build_daemon(dev, capacity=capacity, crs=crs,
                              tenancy=tenancy, node_ip=node_ip)
    plane = entry.build_plane(side["daemon"], dt_us=PLANE_DT_S * 1e6,
                              seed=MIG_SEED, pipeline_depth=2)
    plane.pipeline_explicit_clock = True
    if telemetry:
        plane.enable_telemetry(window_s=3600.0, sample_period=1024)
    if mesh is not None:
        plane.enable_sharding(mesh)
    side["plane"] = plane
    return side


def _journal_probe(journal):
    """Wrap journal.save_record: seconds and file bytes per commit."""
    import os

    real = journal.save_record
    log_ = []

    def save_record(root, mid, record, arrays=None):
        t0 = time.perf_counter()
        real(root, mid, record, arrays=arrays)
        d = journal.record_dir(root, mid)
        log_.append({"id": mid, "s": time.perf_counter() - t0,
                     "step": (record.get("steps_done") or ["-"])[-1],
                     "manifest": os.path.getsize(
                         os.path.join(d, "manifest.json")),
                     "fork": (os.path.getsize(os.path.join(d, "fork.npz"))
                              if os.path.exists(os.path.join(d, "fork.npz"))
                              else 0)})

    journal.save_record = save_record
    return real, log_


def run_migration_phase(dev, card, n_spine=None, n_leaf=None,
                        n_links: int = MIG_LINKS, block: int = TEN_BLOCK,
                        capacity: int = 1 << 18, keep=None) -> tuple:
    """Phase 18: live tenant migration between two 2^18-row planes.
    Returns (metrics, K1 launches, K4 launches) of the phase's path. A
    dict `keep` receives the never-migrated planes A' and B' as they
    stand at the end ("A", "B"), the lockstep tick count ("k"), and per
    tenant the frames fed and delivered on them ("fed", "out")."""
    import shutil
    import tempfile

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.chaos import ChaosError, ChaosInjector
    from kubedtn_tpu_torch.federation import (STEPS, FederationController,
                                              MigrationError, PlaneHandle)
    from kubedtn_tpu_torch.federation import journal
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh
    from kubedtn_tpu_torch.scenarios import wire_def
    from kubedtn_tpu_torch.wire import proto as pb

    t_phase = time.perf_counter()
    n_spine = n_spine or TEN_SPINE
    n_leaf = n_leaf or TEN_LEAF
    n_ten = n_spine * n_leaf * TEN_LPP
    shaping.reset_launches()
    pex.reset_launches()
    m = {"links_per_tenant": n_links, "capacity": capacity}

    # (a) A and A' from phase 16's CRs, B and B' with b0
    crs = ten_crs(TEN_NAMES, n_spine, n_leaf, TEN_LPP)
    all_crs = [c for t in TEN_NAMES for c in crs[t]]
    b0_crs = ap_gold_crs("mig", MIG_B0, AP_GOLD_PAIRS,
                         len(TEN_NAMES) * n_ten, node_ip="10.0.0.2")
    ten_kw = {"t1": {"block_edges": block}}
    A = _mig_side(dev, all_crs, capacity, ten_kw, "10.0.0.1",
                  mesh=make_mesh([dev] * 2), telemetry=True)
    A_ref = _mig_side(dev, all_crs, capacity, dict(ten_kw), "10.0.0.1")
    B = _mig_side(dev, b0_crs, capacity, True, "10.0.0.2")
    B_ref = _mig_side(dev, b0_crs, capacity, True, "10.0.0.2")
    m["reconcile_s"] = {"A": A["reconcile_s"], "A_ref": A_ref["reconcile_s"],
                        "B": B["reconcile_s"], "B_ref": B_ref["reconcile_s"]}
    for side in (A, A_ref):
        check(side["engine"].num_active == 3 * 2 * n_ten,
              f"18(a): {side['engine'].num_active} rows on A")
    keys = {t: mig_keys(crs[t], n_links) for t in TEN_NAMES}
    keys[MIG_B0] = ([(f"{MIG_B0}/mig-{MIG_B0}-a{i}",
                      len(TEN_NAMES) * n_ten + i + 1)
                     for i in range(AP_GOLD_PAIRS)],
                    [(f"{MIG_B0}/mig-{MIG_B0}-b{i}",
                      len(TEN_NAMES) * n_ten + i + 1)
                     for i in range(AP_GOLD_PAIRS)])
    for side, tens in ((A, TEN_NAMES), (A_ref, TEN_NAMES),
                       (B, (MIG_B0,)), (B_ref, (MIG_B0,))):
        d = side["daemon"]
        for t in tens:
            for pod_key, uid in keys[t][0] + keys[t][1]:
                ns, _, pod = pod_key.partition("/")
                d._add_wire(wire_def(pod, ns, uid))
    log(f"18(a) A: {A['engine'].num_active} rows of t0, t1, t2 in "
        f"capacity {A['engine'].state.capacity} at depth 2 on 2 virtual "
        f"shards (t1 in its {block}-row block), A' the same unsharded; B "
        f"and B' {B['engine'].num_active} rows of {MIG_B0}; "
        f"reconcile-to-steady A {A['reconcile_s']:.3f} s, A' "
        f"{A_ref['reconcile_s']:.3f} s, B {B['reconcile_s']:.3f} s, B' "
        f"{B_ref['reconcile_s']:.3f} s ({card})")

    mig = MigRun(A, B, keys, dev)
    ref = MigRun(A_ref, B_ref, keys, dev)
    rngs = {t: np.random.default_rng(MIG_SEED + j)
            for j, t in enumerate(TEN_NAMES)}
    b0_frame = b"\xab" * AP_FRAME_BYTES
    clock = {"k": 0, "migrating": None, "settle": 0, "walls_during": []}
    walls_before = []      # A's ticks before the first migration
    gap_of = {t: range(g, g + MIG_GAP) for t, g in MIG_GAPS.items()}

    # K4 against its plain version on one ring step of A's mailbox
    captured = []
    real_shift = pex.ring_right_shift

    def capture(blocks, mesh):
        if not captured:
            captured.append(([b.clone() for b in blocks], tuple(mesh)))
        return real_shift(blocks, mesh)

    def lockstep():
        clock["k"] += 1
        k = clock["k"]
        if k <= MIG_TICKS:
            for t in TEN_NAMES:
                if k in gap_of[t]:
                    continue
                feed = make_feed(n_links, k, rngs[t], MIG_MAX_FRAMES)
                mig.feed(t, feed)
                ref.feed(t, feed)
            for run in (mig, ref):
                d = run.serve[MIG_B0]["daemon"]
                for pod_key, uid in keys[MIG_B0][0]:
                    d.wires.get_by_key(pod_key, uid).ingress.extend(
                        [b0_frame] * MIG_B0_FEED)
                run.fed[MIG_B0] += MIG_B0_FEED * AP_GOLD_PAIRS
        now = k * PLANE_DT_S
        mig.tick(now)
        ref.tick(now)
        if clock["migrating"] is not None:
            clock["settle"] += 1
            clock["walls_during"].append(mig.walls["a"][-1])
        elif k < MIG_GAPS["t0"]:
            walls_before.append(mig.walls["a"][-1])

    def settle():
        # the next tick must still lie in the migrating tenant's gap
        check(clock["k"] + 1 < MIG_GAPS[clock["migrating"]] + MIG_GAP,
              f"18: the migration of {clock['migrating']} overran its "
              f"feed gap")
        lockstep()

    root = tempfile.mkdtemp(prefix="chip_smoke-phase18-")
    real_save, commits = _journal_probe(journal)
    pex.ring_right_shift = capture
    srv = None
    try:
        fed = entry.build_federation(
            {"A": A, "B": B}, root, chaos=ChaosInjector(seed=MIG_SEED))
        check(A["daemon"].federation is fed
              and B["daemon"].federation is fed, "18: build_federation")
        out = {}

        def migrate(t, fail=None, then=None):
            """Run up to tenant t's gap, migrate it A -> B (with a fault
            at `fail`, then `then`), tick out the gap; the metrics."""
            while clock["k"] < MIG_GAPS[t] - 1:
                lockstep()
            clock["migrating"], clock["settle"] = t, 0
            mig.hold_egress.add((id(A), t))
            ev0 = {n: time.monotonic() - s["plane"].pauses._t0
                   for n, s in (("A", A), ("B", B))}
            c0 = len(commits)
            t0 = time.perf_counter()
            if fail:
                fed.chaos.fail_migration_step(fail)
            try:
                rec = fed.migrate(t, "A", "B", settle=settle,
                                  reconcile_timeout_s=MIG_TIMEOUT_S)
                check(fail is None, f"18: no fault at {fail}")
            except ChaosError:
                check(fail is not None, "18: an unarmed fault")
                rec = then(fed.status(tenant=t)[-1]["migration_id"])
            wall = time.perf_counter() - t0
            mig.hold_egress.discard((id(A), t))
            if rec["state"] == "done":
                mig.serve[t] = B
            clock["migrating"] = None
            settle_ticks = clock["settle"]
            while clock["k"] < MIG_GAPS[t] + MIG_GAP - 1:
                lockstep()
            pauses = {n: [e for e in s["plane"].pauses.events(-1)
                          if e["t_s"] >= round(ev0[n], 3) - 1e-3
                          and e["cause"] in MIG_PAUSES]
                      for n, s in (("A", A), ("B", B))}
            r = {"record": rec, "wall_s": wall,
                 "settle_ticks": settle_ticks,
                 "step_seconds": rec.get("step_seconds", {}),
                 "pauses_ms": {n: [(e["cause"], 1e3 * e["dur_s"])
                                   for e in v] for n, v in pauses.items()},
                 "commits": commits[c0:]}
            return r

        # (b) t0: a clean migration
        out["b"] = migrate("t0")
        rec = out["b"]["record"]
        check(rec["state"] == "done" and rec["steps_done"] == list(STEPS),
              f"18(b): {rec['state']} {rec['steps_done']}")
        check(A["tenancy"].get("t0") is None
              and not A["tenancy"].rows_of("t0").size
              and rec["released_rows"] == 2 * n_ten
              and not [k for k in A["engine"]._rows
                       if k[0].startswith("t0/")],
              f"18(b): A still knows t0 ({rec.get('released_rows')} "
              f"rows released)")
        check(B["tenancy"].rows_of("t0").size == 2 * n_ten,
              "18(b): B does not serve t0's rows")
        slo = A["daemon"].ObserveSLO(pb.ObserveSLORequest(tenant="t0"),
                                     None)
        win = rec["reconcile"]["window_src"]
        check(slo.ok and slo.plane == "A"
              and [(x.tenant, x.frozen, x.plane) for x in slo.tenants]
              == [("t0", True, "A")]
              and slo.tenants[0].delivered == win["delivered"] > 0,
              f"18(e): ObserveSLO on A: {slo}")
        out["b"]["observe_slo"] = {"delivered": slo.tenants[0].delivered,
                                   "tx": slo.tenants[0].tx}

        # (c) t1: a fault in RESTORE, then rollback
        reserved = B["tenancy"].reserved_free()

        def rollback(mid):
            co = fed.coordinator(mid)
            return co.rollback()

        out["c"] = migrate("t1", fail="restore", then=rollback)
        rec = out["c"]["record"]
        check(rec["state"] == "rolled_back", f"18(c): {rec['state']}")
        check(B["tenancy"].get("t1") is None
              and not B["tenancy"].rows_of("t1").size
              and B["tenancy"].reserved_free() == reserved
              and not [k for k in B["engine"]._rows
                       if k[0].startswith("t1/")]
              and not B["daemon"].wires.in_namespaces(["t1"])
              and not B["store"].list("t1"),
              "18(c): B keeps a trace of t1")
        try:
            fed.resume(rec["migration_id"])
            check(False, "18(c): resume() after rollback did not raise")
        except MigrationError:
            pass

        # (d) t2: a crash after CUTOVER's side effects, before its
        # commit; a NEW controller over the same journal resumes it
        def restart_and_resume(mid):
            nonlocal fed
            fed = FederationController(root, stats=fed.stats)
            for name, side in (("A", A), ("B", B)):
                fed.register(PlaneHandle(name, side["daemon"],
                                         side["plane"], side["tenancy"]))
            co = fed.coordinator(mid)
            co.settle = settle
            return co.resume()

        out["d"] = migrate("t2", fail="cutover", then=restart_and_resume)
        rec = out["d"]["record"]
        check(rec["state"] == "done" and rec["resumed"] >= 1
              and rec["steps_done"] == list(STEPS),
              f"18(d): {rec['state']} resumed {rec['resumed']}")

        # the rest of the feed, then the drain
        while clock["k"] < MIG_TICKS:
            lockstep()
        for _ in range(PLANE_DRAIN_TICKS):
            if mig.idle() and ref.idle():
                break
            lockstep()
        for run in (mig, ref):
            for side in (run.a, run.b):
                side["plane"].flush()
                check(side["plane"].tick_errors == 0, "18: tick errors")
            run.collect()
        check(mig.idle() and ref.idle(), "18: a delay line did not empty")
        for t in TEN_NAMES + (MIG_B0,):
            check(mig.counts[t] == ref.counts[t]
                  and mig.digests(t) == ref.digests(t)
                  and mig.fed[t] == ref.fed[t],
                  f"18: tenant {t}'s per-wire egress differs from the "
                  f"never-migrated planes'")
        acct = {}
        for t, part in (("t0", "b"), ("t2", "d")):
            co = fed.coordinator(out[part]["record"]["migration_id"])
            acct[t] = co.check_accounting(mig.fed[t])
            check(acct[t]["mismatch"] == 0.0
                  and fed.stats.snapshot()["accounting_mismatch"] == 0.0,
                  f"18: {t}'s accounting {acct[t]}")
        m["accounting"] = acct

        # (e) the RPCs over gRPC on B's server; a scrape
        from kubedtn_tpu_torch.metrics.metrics import make_registry
        from kubedtn_tpu_torch.wire.client import DaemonClient
        from kubedtn_tpu_torch.wire.server import make_server
        from prometheus_client import generate_latest

        srv, port = make_server(B["daemon"], port=0, host="127.0.0.1",
                                log_rpcs=False)
        srv.start()
        c = DaemonClient(f"127.0.0.1:{port}")
        try:
            st = c.MigrationStatus(pb.MigrationStatusRequest())
            want = [B["daemon"]._migration_info(r) for r in fed.status()]
            check(st.ok and list(st.migrations) == want
                  and len(want) == 3,
                  f"18(e): MigrationStatus over gRPC {st}")
            mid0 = out["b"]["record"]["migration_id"]
            rr = c.MigrateTenant(pb.MigrateRequest(migration_id=mid0,
                                                   resume=True))
            check(rr.ok and rr.migration == want[0]
                  and rr.migration.state == "done",
                  f"18(e): MigrateTenant(resume) over gRPC {rr}")
            bad = c.MigrateTenant(pb.MigrateRequest(tenant="t1", src="A",
                                                    dst="nope"))
            check(not bad.ok and "unknown federation plane" in bad.error,
                  f"18(e): a refused MigrateTenant {bad}")
        finally:
            c.close()
        reg, _h = make_registry(migration_stats=fed.stats)
        body = generate_latest(reg).decode()
        snap = fed.stats.snapshot()
        for key in ("attempts", "completed", "rolled_back", "resumed",
                    "bytes_reconciled"):
            check(_scrape_values(body, f"kubedtn_migration_{key}_total")
                  == [float(snap[key])], f"18(e): kubedtn_migration_{key}")
        for step, s in snap["step_seconds"].items():
            check(_scrape_values(
                body, f'kubedtn_migration_step_seconds_total'
                      f'{{step="{step}"}}') == [float(s)],
                f"18(e): step_seconds {step}")
        check(_scrape_values(body, "kubedtn_migration_accounting_mismatch")
              == [0.0], "18(e): the mismatch gauge")
        m["stats"] = snap
    finally:
        pex.ring_right_shift = real_shift
        journal.save_record = real_save
        if srv is not None:
            srv.stop(0)
        shutil.rmtree(root, ignore_errors=True)

    # the path's launches, read before K4 is held against its plain
    # version on one ring step of A's mailbox
    k4 = pex.LAUNCHES["ring_step"]
    k1 = shaping.LAUNCHES["shape_step_rows"]
    check(captured, "18: A ran no ring step")
    blocks, mesh = captured[0]
    same(pex.ring_right_shift(blocks, mesh),
         pex.ring_right_shift_plain(blocks), "18 K4 vs plain")
    check(k4 > 0 or dev.type != "cuda", "18: K4 never launched")
    check(clock["walls_during"], "18: no migration ticked its planes")
    med = lambda w: 1e3 * statistics.median(w)  # noqa: E731
    m.update(
        fed=mig.fed, counts={t: sum(v) for t, v in mig.counts.items()},
        ticks=clock["k"], k4_launches=k4, k1_launches=k1,
        mailbox_rows=int(blocks[0].shape[0]),
        wall_ms_a=med(mig.walls["a"]), wall_ms_a_before=med(walls_before),
        wall_ms_a_during=med(clock["walls_during"]),
        wall_ms_a_ref=med(ref.walls["a"]), wall_ms_b=med(mig.walls["b"]))
    for part, t in (("b", "t0"), ("c", "t1"), ("d", "t2")):
        r = out[part]
        rec = r["record"]
        m[part] = {k: v for k, v in r.items() if k != "record"}
        m[part].update(
            state=rec["state"], resumed=rec["resumed"],
            transferred=(rec.get("cutover") or {}).get(
                "transferred_frames", 0),
            handed_off=rec.get("egress_handed_off", 0),
            restored_rows=rec.get("restored_rows", 0))
        steps = ", ".join(f"{s} {v:.3f}" for s, v in
                          r["step_seconds"].items())
        pa = "; ".join(f"{n}: " + ", ".join(f"{c} {ms:.1f}"
                                             for c, ms in v)
                       for n, v in r["pauses_ms"].items())
        secs = [x["s"] for x in r["commits"]]
        jb = (f"{len(secs)} commits, {statistics.median(secs):.3f} s "
              f"median ({min(secs):.3f}-{max(secs):.3f}), manifest.json "
              f"{max(x['manifest'] for x in r['commits'])} B, fork.npz "
              f"{max(x['fork'] for x in r['commits'])} B") if secs \
            else "no commit"
        log(f"18({part}) {t}: {rec['state']} in {r['wall_s']:.3f} s "
            f"(resumed {rec['resumed']}); steps s: {steps}; pauses ms: "
            f"{pa}; journal: {jb}; transferred at cutover "
            f"{m[part]['transferred']}, egress handed off "
            f"{m[part]['handed_off']}, residue drained in "
            f"{r['settle_ticks']} settle ticks ({card})")
    m["phase_s"] = time.perf_counter() - t_phase
    if keep is not None:
        keep.update(A=A_ref, B=B_ref, k=clock["k"], fed=dict(ref.fed),
                    out={t: sum(v) for t, v in ref.counts.items()})
    log(f"18(b)-(d) per wire, t0 and t2 (A's egress, the egress handed "
        f"off at RELEASE, then B's) and t1 == A', b0 == B', bit for bit "
        f"({sum(m['counts'].values())} frames); accounting mismatch 0 "
        f"({acct}); A's registry no longer knows t0, {2 * n_ten} rows "
        f"freed; B keeps no trace of the rolled-back t1 ({card})")
    log(f"18(e) MigrationStatus and MigrateTenant(resume) over gRPC on B "
        f"== controller.status(); ObserveSLO on A serves t0's frozen "
        f"slice; the scrape's kubedtn_migration_* == MigrationStats "
        f"{m['stats']} ({card})")
    log(f"18: wall ms per tick of A {m['wall_ms_a_before']:.1f} before the "
        f"first migration, {m['wall_ms_a_during']:.1f} during one (its "
        f"settle ticks), {m['wall_ms_a']:.1f} over the phase (A' "
        f"{m['wall_ms_a_ref']:.1f}, B {m['wall_ms_b']:.1f}); K4 {k4} "
        f"launches on "
        f"this path, == plain on one ring step of A's mailbox "
        f"({blocks[0].shape[0]} x {blocks[0].shape[1]} words a shard); "
        f"phase {m['phase_s']:.1f} s ({card})")
    return m, k1, k4


FL_FEED_TICKS = 2           # fed ticks before the checkpoint (3 until
                            # phase 24 joined)
FL_POST_TICKS = 2           # fed ticks after the evacuation (3 until
                            # phase 24 joined)
FL_C0 = "c0"                # C's own tenant: phase 17's g0 shape on
FL_C0_LATENCY = "1ms"       # latency-only links, as fleet_rolling_upgrade's
FL_C0_FEED = 8              # frames of AP_FRAME_BYTES per c0 wire and tick
FL_MACHINE = dict(suspect_after=2, dead_after=4, healthy_after=2)
FL_MAX_SWEEPS = 20
FL_UP_FRAMES = 128          # (c): 64-byte frames per c0 wire every pace
FL_UP_PACE_S = 0.02
FL_UP_TEN_PACE_S = 0.5      # (c): a make_feed tick of t1 every this
FL_UP_STEADY_S = 0.5        # (c): seconds of load before and after
FL_OUTCOMES = ("delivered_packets", "dropped_loss", "dropped_queue",
               "dropped_ring")   # a fed frame's terminal outcomes
FL_TIMEOUT_S = 300.0        # bound on the upgrade RPC and every wait
FL_COLS = ("tokens", "t_last", "corr", "pkt_count", "backlog_until",
           "props")


def fl_rows_of(engine, identities) -> list:
    """The engine's rows of a slice's (pod key, uid) identities."""
    return [engine._rows[(pk, int(uid))] for pk, uid, *_r in identities]


def fl_offer_feed(nodes: dict, order, keys_in, feed) -> int:
    """scenarios.gated_offer for one make_feed tick: each wire's frames
    go to the first node of `order` whose accept gate is open and which
    realizes the link, one gate hold per node. Returns the frames
    accepted (a wire no open node realizes refuses its frames)."""
    from kubedtn_tpu_torch.wire.server import FrameSeg

    blob, offs, lens, counts = feed
    bounds = np.concatenate([[0], np.cumsum(counts)]).tolist()
    left = range(len(keys_in))
    n = 0
    for name in order:
        if not left:
            break
        node = nodes[name]
        with node["gate"]:
            if node["draining"]:
                continue
            wires, engine, rest = node["daemon"].wires, node["engine"], []
            for i in left:
                w = wires.get_by_key(*keys_in[i])
                if w is None or engine.row_of(*keys_in[i]) is None:
                    rest.append(i)
                    continue
                w.ingress.append(FrameSeg(blob, offs, lens, bounds[i],
                                          bounds[i + 1]))
                n += bounds[i + 1] - bounds[i]
            left = rest
    return n


def fl_columns(engine, rows) -> dict:
    """The shaping columns of `rows`, gathered on the engine's device and
    copied to the host."""
    st = engine.state
    ri = torch.as_tensor(rows, dtype=torch.int64, device=st.device)
    return {c: getattr(st, c).index_select(0, ri).cpu().numpy()
            for c in FL_COLS}


def fl_same_columns(a: dict, b: dict, name: str) -> None:
    for c in FL_COLS:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        check(x.dtype == y.dtype and x.shape == y.shape
              and x.tobytes() == y.tobytes(),
              f"{name}: column {c} differs bitwise")


class FleetRun:
    """Phase 19's lockstep loop: the planes alive, which plane serves
    each tenant, one make_feed draw per fed tenant and tick applied to
    the serving plane (and to C' for every tenant C serves), egress
    drained per tenant after every tick, per wire digests of every
    tenant's egress on C and C'."""

    def __init__(self, planes: dict, serve: dict, keys: dict, dev,
                 n_links: int, k0: int, twin=None):
        import hashlib

        self.planes, self.serve, self.keys = planes, serve, keys
        self.dev, self.n_links, self.k = dev, n_links, k0
        self.twin = twin                     # (C, C') while C' lives
        self.dead = set()
        self.fed = {t: 0 for t in keys}
        self.out = {t: 0 for t in keys}      # egress frames, all planes
        self.keepalive = 0
        self.rngs = {t: np.random.default_rng(MIG_SEED + 100 + j)
                     for j, t in enumerate(TEN_NAMES)}
        self.dig = {side: {t: [hashlib.blake2b(digest_size=16)
                               for _ in keys[t][1]]
                           for t in keys}
                    for side in ("C", "C2")}
        self.walls: dict = {n: [] for n in planes}
        self.on_tick = None

    def wires(self, side, t: str, end: int) -> list:
        d = side["daemon"]
        return [d.wires.get_by_key(*k) for k in self.keys[t][end]]

    def feed(self, t: str) -> int:
        """One make_feed tick of tenant t on its serving plane (and on C'
        when t is served by C); returns the frames."""
        feed = make_feed(self.n_links, self.k + 1, self.rngs[t],
                         MIG_MAX_FRAMES)
        n = apply_feed(self.wires(self.serve[t], t, 0), feed)
        if self.twin is not None and self.serve[t] is self.twin[0]:
            apply_feed(self.wires(self.twin[1], t, 0), feed)
        self.fed[t] += n
        return n

    def collect(self) -> None:
        for t, (_ins, outs) in self.keys.items():
            for name, side in self.planes.items():
                wires = side["daemon"].wires
                for i, k in enumerate(outs):
                    w = wires.get_by_key(*k)
                    if w is None or not w.egress:
                        continue
                    if name in ("C", "C2"):
                        self.dig[name][t][i].update(b"".join(w.egress))
                    if name != "C2":
                        self.out[t] += len(w.egress)
                    w.egress.clear()

    def tick(self, tenants=(), keepalive: bool = False,
             background: bool = True) -> None:
        """One lockstep tick of every live plane at k * PLANE_DT_S: the
        fed tenants, with `background` b0 and c0 (B, C and C' dispatch
        every tick), with `keepalive` one frame on t0's first wire of A
        (A dispatches too)."""
        for t in tenants:
            self.feed(t)
        if background:
            self._background()
        if keepalive:
            self.wires(self.planes["A"], "t0", 0)[0].ingress.append(
                b"\xee" * 64)
            self.fed["t0"] += 1
            self.keepalive += 1
        self.k += 1
        now = self.k * PLANE_DT_S
        for name, side in self.planes.items():
            if name in self.dead:
                continue
            t0 = time.perf_counter()
            if self.on_tick is not None:
                self.on_tick(name)
            side["plane"].tick(now_s=now)
            _sync(self.dev)
            self.walls[name].append(time.perf_counter() - t0)
        self.collect()

    def _background(self) -> None:
        b0 = self.planes["B"]["daemon"]
        for k in self.keys[MIG_B0][0]:
            b0.wires.get_by_key(*k).ingress.extend(
                [b"\xab" * AP_FRAME_BYTES] * MIG_B0_FEED)
        self.fed[MIG_B0] += MIG_B0_FEED * len(self.keys[MIG_B0][0])
        for name in ("C", "C2"):
            if name in self.planes:
                d = self.planes[name]["daemon"]
                for k in self.keys[FL_C0][0]:
                    d.wires.get_by_key(*k).ingress.extend(
                        [b"\xcd" * AP_FRAME_BYTES] * FL_C0_FEED)
        self.fed[FL_C0] += FL_C0_FEED * len(self.keys[FL_C0][0])

    def idle(self, names) -> bool:
        for n in names:
            p = self.planes[n]["plane"]
            if p._inflight or p._holdback or len(p._wheel) or p._pending:
                return False
        return True

    def digests(self, side: str, t: str) -> list:
        return [d.hexdigest() for d in self.dig[side][t]]


def run_fleet_phase(dev, card, n_spine=None, n_leaf=None,
                    n_links: int = MIG_LINKS, block: int = TEN_BLOCK,
                    capacity: int = 1 << 18, reuse=None) -> tuple:
    """Phase 19: the fleet supervisor. Plane A (t0, t1, t2) dies
    mid-migration and is evacuated onto B and C with no operator call;
    C is upgraded over gRPC under load. `reuse` takes phase 18's
    never-migrated planes A' and B' as A and B (saving their builds).
    Returns (metrics, K1 launches, K4 launches) of the phase's path."""
    import shutil
    import tempfile

    from kubedtn_tpu_torch import checkpoint, entry
    from kubedtn_tpu_torch.chaos import ChaosError, ChaosInjector
    from kubedtn_tpu_torch.federation import (MigrationCoordinator,
                                              PlaneHandle, choose_plane,
                                              grpc_probe, journal,
                                              rebalance_plan,
                                              restore_tenant_slice)
    from kubedtn_tpu_torch.federation import supervisor as fsup
    from kubedtn_tpu_torch.metrics.metrics import make_registry
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh
    from kubedtn_tpu_torch.scenarios import (gated_producer, restart_node,
                                             serve_on, wire_def)
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient
    from prometheus_client import generate_latest

    t_phase = time.perf_counter()
    n_spine = n_spine or TEN_SPINE
    n_leaf = n_leaf or TEN_LEAF
    n_ten = n_spine * n_leaf * TEN_LPP
    shaping.reset_launches()
    pex.reset_launches()
    m = {"links_per_tenant": n_links, "capacity": capacity,
         "reused_phase18_planes": reuse is not None}
    crs = ten_crs(TEN_NAMES, n_spine, n_leaf, TEN_LPP)
    keys = {t: mig_keys(crs[t], n_links) for t in TEN_NAMES}
    b_uid = len(TEN_NAMES) * n_ten
    c_uid = b_uid + AP_GOLD_PAIRS
    for t, prefix, base in ((MIG_B0, "mig", b_uid), (FL_C0, "fl", c_uid)):
        keys[t] = tuple([(f"{t}/{prefix}-{t}-{s}{i}", base + i + 1)
                         for i in range(AP_GOLD_PAIRS)] for s in "ab")

    # (a) A and B (phase 18's A' and B', or built here), C and its twin
    # C' on 2 virtual shards
    t0 = time.perf_counter()
    fed0 = {t: 0 for t in keys}
    out0 = {t: 0 for t in keys}
    if reuse is not None:
        A, B, k0 = reuse["A"], reuse["B"], reuse["k"]
        for t in TEN_NAMES + (MIG_B0,):
            fed0[t], out0[t] = reuse["fed"][t], reuse["out"][t]
    else:
        all_crs = [c for t in TEN_NAMES for c in crs[t]]
        A = _mig_side(dev, all_crs, capacity, {"t1": {"block_edges": block}},
                      "10.0.0.1")
        B = _mig_side(dev, ap_gold_crs("mig", MIG_B0, AP_GOLD_PAIRS, b_uid,
                                       node_ip="10.0.0.2"),
                      capacity, True, "10.0.0.2")
        k0 = 0
        for side, tens in ((A, TEN_NAMES), (B, (MIG_B0,))):
            for t in tens:
                for pod_key, uid in keys[t][0] + keys[t][1]:
                    ns, _, pod = pod_key.partition("/")
                    side["daemon"]._add_wire(wire_def(pod, ns, uid))
    B["plane"].enable_telemetry(window_s=3600.0, sample_period=1024)
    c_crs = ap_gold_crs("fl", FL_C0, AP_GOLD_PAIRS, c_uid,
                        node_ip="10.0.0.3", latency=FL_C0_LATENCY)
    C = _mig_side(dev, c_crs, capacity, True, "10.0.0.3",
                  mesh=make_mesh([dev] * 2), telemetry=True)
    C2 = _mig_side(dev, c_crs, capacity, True, "10.0.0.3",
                   mesh=make_mesh([dev] * 2), telemetry=True)
    for side in (C, C2):
        for pod_key, uid in keys[FL_C0][0] + keys[FL_C0][1]:
            ns, _, pod = pod_key.partition("/")
            side["daemon"]._add_wire(wire_def(pod, ns, uid))
    m["setup_s"] = time.perf_counter() - t0
    check(A["engine"].num_active == 3 * 2 * n_ten
          and B["engine"].num_active == C["engine"].num_active
          == 2 * AP_GOLD_PAIRS, "19(a): plane sizes")

    root = tempfile.mkdtemp(prefix="chip_smoke-phase19-")
    ck_a, ck_c = f"{root}/ckA", f"{root}/ckC"
    chaos = ChaosInjector(seed=MIG_SEED)
    run = FleetRun({"A": A, "B": B, "C": C, "C2": C2},
                   {t: A for t in TEN_NAMES}, keys, dev, n_links, k0,
                   twin=(C, C2))
    run.serve.update({MIG_B0: B, FL_C0: C})
    srv = {}
    addr = {}
    nodes = {}
    clients = []
    real_shift = pex.ring_right_shift
    captured = []
    capture_on = [False]

    def capture(blocks, mesh):
        if capture_on[0] and not captured:
            captured.append(([b.clone() for b in blocks], tuple(mesh)))
        return real_shift(blocks, mesh)

    # a ring step of C's mailbox once the evacuated t1 rides on it
    run.on_tick = lambda name: capture_on.__setitem__(
        0, name == "C" and run.serve["t1"] is C)
    pex.ring_right_shift = capture
    timed_calls = {"restore": [], "fork_ckpt": [], "evacuate": [],
                   "migrate": [], "restart": []}
    forks = {}      # the evacuation's fork_from_checkpoint outputs
    slices = {}     # the evacuation's restore_tenant_slice sources
    real = {"restore": fsup.restore_tenant_slice,
            "fork_ckpt": fsup.fork_from_checkpoint}

    def timing(kind, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(dev)
            label = a[0] if kind == "migrate" else a[1] if len(a) > 1 \
                else ""
            timed_calls[kind].append((label,
                                      time.perf_counter() - t0,
                                      time.perf_counter()))
            if kind == "fork_ckpt":
                forks[label] = out
            if kind == "restore":
                slices[label] = a[2:5]    # fork, arrays, src address
            return out
        return wrapped

    fsup.restore_tenant_slice = timing("restore", real["restore"])
    fsup.fork_from_checkpoint = timing("fork_ckpt", real["fork_ckpt"])
    # each migration's src counters as RELEASE finds them: RECONCILE
    # froze them, nothing of the tenant may shape on src after that
    at_release = {}
    real_release = MigrationCoordinator._step_release

    def step_release(co):
        at_release[co.migration_id] = co.src.registry.tenant_counters(
            co.src.plane, co.tenant)
        return real_release(co)

    MigrationCoordinator._step_release = step_release
    # per migration, RECONCILE's checks that found the tenant's frames in
    # dispatches in flight: (such checks, most frames, frames at the last)
    residue = {}
    real_residue = MigrationCoordinator._src_residue

    def src_residue(co, *a):
        out = real_residue(co, *a)
        if out["inflight"]:
            n, most, _l = residue.get(co.migration_id, (0, 0, 0))
            residue[co.migration_id] = (n + 1, max(most, out["inflight"]),
                                        out["inflight"])
        return out

    MigrationCoordinator._src_residue = src_residue
    try:
        for name, side in (("A", A), ("B", B), ("C", C)):
            srv[name], port = serve_on(side["daemon"])
            addr[name] = f"127.0.0.1:{port}"
            nodes[name] = dict(side, server=srv[name], port=port,
                               gate=threading.Lock(), draining=False)

        def restart_c():
            """C's restarter: save_live, teardown, restore_daemon, a new
            server on the same port, warm_kernels."""
            t0 = time.perf_counter()
            node = nodes["C"]

            def drain(old):
                with consumer_lock:
                    drain_egress(old)

            def configure(plane):
                plane.enable_sharding(make_mesh([dev] * 2))
                plane.enable_telemetry(window_s=3600.0, sample_period=1024)

            r, steps = restart_node(
                node, ck_c, dev, node["port"], drain,
                plane_kwargs=dict(dt_us=PLANE_DT_S * 1e6, seed=MIG_SEED,
                                  pipeline_depth=2),
                live_save=True, configure=configure, capacity=capacity,
                node_ip="10.0.0.3")
            nodes["C"] = dict(r, port=node["port"],
                              old_pauses=node["plane"].pauses.events(-1))
            srv["C"] = r["server"]
            timed_calls["restart"].append(
                ("C", time.perf_counter() - t0, time.perf_counter(), steps))
            return PlaneHandle("C", r["daemon"], r["plane"], r["tenancy"],
                               checkpoint_dir=ck_c,
                               probe=grpc_probe(addr["C"]),
                               restarter=restart_c)

        handles = {
            "A": PlaneHandle("A", A["daemon"], A["plane"], A["tenancy"],
                             checkpoint_dir=ck_a,
                             probe=grpc_probe(addr["A"])),
            "B": PlaneHandle("B", B["daemon"], B["plane"], B["tenancy"],
                             probe=grpc_probe(addr["B"])),
            "C": PlaneHandle("C", C["daemon"], C["plane"], C["tenancy"],
                             probe=grpc_probe(addr["C"]),
                             restarter=restart_c)}
        fed = entry.build_federation(handles, f"{root}/journal",
                                     chaos=chaos)
        sup = entry.build_fleet(fed, f"{root}/ledger", chaos=chaos,
                                **FL_MACHINE)
        fed.migrate = timing("migrate", fed.migrate)
        sup.evacuate = timing("evacuate", sup.evacuate)
        seen = []
        real_cands = sup._live_candidates

        def live_candidates(exclude):
            out = real_cands(exclude)
            seen.append(({n: dict(h) for n, h in out[0].items()},
                         {p: list(ts) for p, ts in out[1].items()}))
            return out

        sup._live_candidates = live_candidates
        # each tenant's evacuation ends with its ledger entry: the time
        # from the previous one (or the evacuation's start) is its own
        assigned = []
        real_assign = sup.ledger.assign

        def assign(tenant, plane, qos=None):
            real_assign(tenant, plane, qos=qos)
            assigned.append((tenant, time.perf_counter()))

        sup.ledger.assign = assign
        want = {"t0": "A", "t1": "A", "t2": "A", MIG_B0: "B", FL_C0: "C"}
        check(sup.ledger.placements() == want
              and all(d.fleet is sup for d in (A["daemon"], B["daemon"],
                                               C["daemon"])),
              f"19(a): ledger {sup.ledger.placements()}")
        check(sup.sweep() == {}, "19(a): a plane left healthy")
        cb = DaemonClient(addr["B"])
        clients.append(cb)
        st = cb.FleetStatus(pb.FleetStatusRequest())
        st_in = B["daemon"].FleetStatus(pb.FleetStatusRequest(), None)
        status = sup.status()
        check(st.ok and st == st_in
              and [(p.name, p.state, p.tenants_placed, p.health.node)
                   for p in st.planes]
              == [(p["name"], p["state"], p["tenants_placed"],
                   p["health"]["node"]) for p in status["planes"]]
              and {e.tenant: e.plane for e in st.placements}
              == status["placements"] == want
              and st.sweeps == status["sweeps"] == 1,
              f"19(a): FleetStatus over gRPC {st}")
        origin = "phase 18's A' and B'" if reuse else "built here"
        log(f"19(a) A: {A['engine'].num_active} rows of t0, t1, t2 at depth "
            f"2 ({origin}), B: {B['engine'].num_active} rows of {MIG_B0}, C and C': "
            f"{C['engine'].num_active} rows of {FL_C0} at depth 2 on 2 "
            f"virtual shards, all in capacity {capacity}, behind gRPC on "
            f"{addr}; set-up {m['setup_s']:.3f} s; the ledger adopted "
            f"{want}; FleetStatus over gRPC == status() ({card})")

        # (b) the failover: feed A to idle, checkpoint, a RESTORE fault
        # in t1's move A -> C, gap frames, the kill
        for _ in range(FL_FEED_TICKS):
            run.tick(TEN_NAMES)
        drained = 0
        for drained in range(1, PLANE_DRAIN_TICKS + 1):
            run.tick(keepalive=True)
            cnt = {t: A["tenancy"].tenant_counters(A["plane"], t)
                   for t in ("t1", "t2")}
            if all(MigrationCoordinator._accounted(cnt[t])
                   == fed0[t] + run.fed[t]
                   and cnt[t]["delivered_packets"]
                   == out0[t] + run.out[t] for t in cnt):
                break
        check(drained < PLANE_DRAIN_TICKS, "19(b): A did not drain")
        t0 = time.perf_counter()
        checkpoint.save_live(ck_a, A["store"], A["engine"], A["plane"])
        m["save_live_s"] = time.perf_counter() - t0
        pend_ckpt = [e for e in checkpoint.read_pending_entries(ck_a)
                     if e[0].startswith("t0/")]
        m["checkpoint_bytes"] = sum(_file_bytes(ck_a).values())
        truth_ids = {t: [k for k, _r in sorted(
            ((k, r) for k, r in A["engine"]._rows.items()
             if k[0].startswith(t + "/")), key=lambda kr: kr[1])]
            for t in TEN_NAMES}
        truth = {t: fl_columns(A["engine"], [A["engine"]._rows[k]
                                             for k in truth_ids[t]])
                 for t in TEN_NAMES}
        chaos.fail_migration_step("restore")
        t0 = time.perf_counter()
        try:
            fed.migrate("t1", "A", "C", settle=lambda: fail(
                "19(b): a settle tick before the RESTORE fault"))
            fail("19(b): the RESTORE fault did not fire")
        except ChaosError:
            pass
        m["failed_move_s"] = time.perf_counter() - t0
        mid = fed.status(tenant="t1")[-1]["migration_id"]
        meta = journal.load_record_meta(f"{root}/journal", mid)
        check(meta["state"] == "running" and "fork" in meta["steps_done"]
              and "cutover" not in meta["steps_done"],
              f"19(b): journal {meta['state']} {meta['steps_done']}")
        gap = {}
        for t in TEN_NAMES:
            gap[t] = run.feed(t)
        caps_kill = {n: run.planes[n]["engine"].state.capacity
                     for n in ("B", "C")}
        chaos.kill_plane(fed.handle("A"), server=srv["A"])
        t_kill = time.perf_counter()
        run.dead.add("A")
        trans = {}
        sweeps = 0
        while sweeps < FL_MAX_SWEEPS:
            sweeps += 1
            tr = sup.sweep()
            if "A" in tr:
                trans[tr["A"]] = (sweeps, time.perf_counter() - t_kill)
            if tr.get("A") == "dead":
                break
        # the sweep that declares A dead evacuates it before returning:
        # DEAD is the evacuation's start
        _l, evac_s, evac_end = timed_calls["evacuate"][-1]
        if "dead" in trans:
            trans["dead"] = (trans["dead"][0], evac_end - evac_s - t_kill)
        check(list(trans) == ["suspect", "dead"]
              and trans["suspect"][0] == FL_MACHINE["suspect_after"]
              and trans["dead"][0] == FL_MACHINE["dead_after"],
              f"19(b): A's transitions {trans}")
        evac = sup.evacuations()[-1]
        ents = evac["tenants"]
        per_tenant, prev = {}, evac_end - evac_s
        for t, at in assigned:
            if t in ents and t not in per_tenant:
                per_tenant[t] = at - prev
                prev = at
        check(evac["plane"] == "A" and sorted(ents) == list(TEN_NAMES)
              and [r["action"] for r in evac["migrations_resolved"]]
              == ["rolled back: src died pre-cutover; re-forking from "
                  "the journal capture onto a survivor"]
              and ents["t1"]["source"] == "journal-fork"
              and ents["t0"]["source"] == ents["t2"]["source"]
              == "checkpoint"
              and all(not e.get("error") for e in ents.values()),
              f"19(b): evacuation {evac}")
        # each tenant landed where choose_plane puts it, replayed on the
        # healths the supervisor probed
        healths, placed = seen[-1]
        for t in TEN_NAMES:
            s = choose_plane(healths, placed, sup.ledger.qos_of,
                             exclude={"A"})
            check(ents[t]["survivor"] == s and sup.ledger.get(t) == s,
                  f"19(b): {t} on {ents[t]['survivor']}, choose_plane {s}")
            placed.setdefault(s, []).append(t)
            run.serve[t] = B if s == "B" else C
        check(ents["t0"]["pending_restored"] == len(pend_ckpt)
              and sum(e["ingress_restored"] for e in ents.values()) == 0,
              f"19(b): pending restored {ents['t0']['pending_restored']} "
              f"of {len(pend_ckpt)}")
        # the restored rows against their sources: the fork capture (t1)
        # or the checkpoint slice (t0, t2), and the dead plane's own rows
        rec_full, arrays = journal.load_record(f"{root}/journal", mid)
        src = {"t1": (rec_full["fork"]["identities"], arrays)}
        for t in ("t0", "t2"):
            fork, arr, *_r = forks[t]
            src[t] = (fork["identities"], arr)
        m["fork_from_checkpoint_s"] = {t: s for t, s, _e in
                                       timed_calls["fork_ckpt"]}
        for t, (ids, arr) in src.items():
            side = run.serve[t]
            check([(pk, int(u)) for pk, u, *_r in ids] == truth_ids[t],
                  f"19(b): {t}'s identities")
            got = fl_columns(side["engine"], fl_rows_of(side["engine"],
                                                        ids))
            fl_same_columns(got, arr, f"19(b) {t} restored vs its source")
            fl_same_columns(got, truth[t], f"19(b) {t} vs A's rows")
        check(run.serve["t1"] is C, "19(b): t1 not on C")
        # C': every slice the evacuation put on C restored by hand from
        # the same source, no supervisor: the journal's fork, or the
        # evacuation's own read of A's checkpoint (no second capture)
        twin = PlaneHandle("C'", C2["daemon"], C2["plane"], C2["tenancy"])
        t0 = time.perf_counter()
        on_c = [t for t in TEN_NAMES if run.serve[t] is C]
        for t in on_c:
            fork, arr, src_addr = slices[t]
            restore_tenant_slice(twin, t, fork, arr, src_addr, hold=False)
            if ents[t]["source"] == "checkpoint":
                _f, _a, _c, pending, ingress, _s = forks[t]
                if pending:
                    C2["plane"].restore_pending(
                        pending, now_s=C2["plane"].last_now_s)
                for pk, uid, frame in ingress:
                    C2["daemon"].wires.get_by_key(pk, int(uid)) \
                        .ingress.append(frame)
        m["hand_restore_s"] = time.perf_counter() - t0
        caps = {n: (caps_kill[n], run.planes[n]["engine"].state.capacity)
                for n in ("B", "C")}
        grew = [n for n, (a, b) in caps.items() if b != a]
        log(f"19(b) survivors' capacity across the evacuation {caps}: "
            + (f"{', '.join(grew)} grew (each row kept its counts: the "
               f"port's repair of the JAX plane's counter reset)"
               if grew else "neither survivor grew"))
        for _ in range(FL_POST_TICKS):
            run.tick(TEN_NAMES)
        for _ in range(PLANE_DRAIN_TICKS):
            if run.idle(("B", "C", "C2")):
                break
            run.tick(background=False)
        for n in ("B", "C", "C2"):
            run.planes[n]["plane"].flush()
            check(run.planes[n]["plane"].tick_errors == 0,
                  f"19(b): tick errors on {n}")
        run.collect()
        check(run.idle(("B", "C", "C2")), "19(b): a delay line did not "
                                          "empty")
        for t in on_c + [FL_C0]:
            check(run.digests("C", t) == run.digests("C2", t),
                  f"19(b): {t}'s streams on C differ from C'")
        acct = {}
        for t in TEN_NAMES:
            a = sup.check_failover_accounting(t, fed0[t] + run.fed[t])
            acct[t] = a
            check(a["mismatch"] == 0.0 and a["reported_lost"] == gap[t]
                  and a["fed"] == a["accounted"] + a["reported_lost"]
                  and out0[t] + run.out[t]
                  == a["delivered_src"] + a["delivered_dst"],
                  f"19(b): {t}'s failover accounting {a} (gap {gap[t]}, "
                  f"egress {out0[t] + run.out[t]})")
        check(fed.stats.snapshot()["accounting_mismatch"] == 0.0
              and sup.stats.snapshot()["reported_lost"]
              == gap[TEN_NAMES[-1]], "19(b): the gauges")
        check(captured, "19(b): C ran no ring step")
        blocks, mesh = captured[0]
        pex.ring_right_shift = real_shift
        k4_b = pex.LAUNCHES["ring_step"]
        same(pex.ring_right_shift(blocks, mesh),
             pex.ring_right_shift_plain(blocks), "19 K4 vs plain")
        # the comparison's launches are not the path's
        k4_check = pex.LAUNCHES["ring_step"] - k4_b
        check(k4_b > 0 or dev.type != "cuda",
              "19(b): K4 never launched on C")
        m["b"] = {
            "sweeps": {s: v[0] for s, v in trans.items()},
            "kill_to_s": {s: v[1] for s, v in trans.items()},
            "evacuate_s": evac_s, "evacuate_s_per_tenant": per_tenant,
            "restore_s": {t: s for t, s, _e in timed_calls["restore"]},
            "survivors": {t: ents[t]["survivor"] for t in TEN_NAMES},
            "rows": {t: ents[t]["rows"] for t in TEN_NAMES},
            "pending_restored": ents["t0"]["pending_restored"],
            "gap": gap, "accounting": acct, "fed": dict(run.fed),
            "keepalive": run.keepalive, "drain_ticks": drained,
            "k4_launches": k4_b, "mailbox_rows": int(blocks[0].shape[0])}
        log(f"19(b) A fed {FL_FEED_TICKS} ticks then drained in {drained} "
            f"(t0 kept A dispatching), save_live {m['save_live_s']:.3f} s "
            f"({m['checkpoint_bytes']} B, {len(pend_ckpt)} t0 frames "
            f"pending); t1 A -> C failed at RESTORE in "
            f"{m['failed_move_s']:.3f} s; {sum(gap.values())} gap frames; "
            f"A killed: suspect at sweep {trans['suspect'][0]} "
            f"({trans['suspect'][1]:.3f} s), dead at sweep "
            f"{trans['dead'][0]} ({trans['dead'][1]:.3f} s after the kill); "
            f"evacuation {evac_s:.3f} s: "
            + ", ".join(f"{t} -> {ents[t]['survivor']} from "
                        f"{ents[t]['source']} in {per_tenant[t]:.3f} s "
                        f"({ents[t]['rows']} rows, restore "
                        f"{m['b']['restore_s'].get(t, 0):.3f} s)"
                        for t in TEN_NAMES)
            + "; fork_from_checkpoint "
            + ", ".join(f"{t} {v:.3f} s" for t, v in
                        m["fork_from_checkpoint_s"].items())
            + f"; C' by hand {m['hand_restore_s']:.3f} s ({card})")
        log(f"19(b) the restored rows == their sources and A's rows, bit "
            f"for bit; {', '.join(on_c + [FL_C0])} on C == C' per wire, "
            f"bit for bit; "
            f"failover accounting exact, reported_lost == the gap "
            f"({ {t: acct[t]['reported_lost'] for t in TEN_NAMES} }), the "
            f"mismatch gauge 0; K4 {k4_b} launches, == plain on one ring "
            f"step of C's mailbox ({blocks[0].shape[0]} rows) ({card})")

        # (c) FleetUpgrade of C over gRPC under load: a paced feeder on
        # c0's latency-only wires (nothing may be lost there) and one on
        # every other tenant C serves, at its phase-16 props (t1's 2 Mbit
        # TBF: a frame may end in a counted drop); each is drained to B
        # and refilled
        del run.planes["C2"]
        run.twin = None
        C2 = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        consumer_lock = threading.Lock()
        up_tenants = sorted(t for t in keys if run.serve[t] is C)
        C_rows = {t: C["tenancy"].rows_of(t).size for t in up_tenants}
        fed_ten = [t for t in up_tenants if t != FL_C0]
        up = {t: {"fed": [0], "out": 0} for t in up_tenants}
        stop = threading.Event()

        def drain_egress(node) -> None:
            wires = node["daemon"].wires
            for t in up_tenants:
                for k in keys[t][1]:
                    w = wires.get_by_key(*k)
                    if w is None:
                        continue
                    n = 0
                    while True:
                        try:
                            w.egress.popleft()
                        except IndexError:
                            break
                        n += 1
                    up[t]["out"] += n

        def consumer():
            while not stop.is_set():
                with consumer_lock:
                    for name in ("B", "C"):
                        drain_egress(nodes[name])
                stop.wait(FL_UP_PACE_S)

        def tenant_feeder():
            rngs = {t: np.random.default_rng(MIG_SEED + 200 + j)
                    for j, t in enumerate(fed_ten)}
            tick = 0
            while not stop.is_set():
                tick += 1
                for t in fed_ten:
                    feed = make_feed(n_links, tick, rngs[t],
                                     MIG_MAX_FRAMES)
                    up[t]["fed"][0] += fl_offer_feed(
                        nodes, ("B", "C"), keys[t][0], feed)
                stop.wait(FL_UP_TEN_PACE_S)

        # the upgraded tenants' counters on C before the upgrade, and the
        # migrations before it: the upgrade's records are the rest
        base = {t: C["tenancy"].tenant_counters(C["plane"], t)
                for t in up_tenants}
        mids0 = {r["migration_id"] for r in fed.status()}
        caps0 = {n: nodes[n]["engine"].state.capacity for n in ("B", "C")}
        # B's own tenants take no traffic in (c): their counters must
        # come through the upgrade as they are, also where the drained
        # tenants' blocks grow B's engine (the JAX plane zeroes every
        # row's counters when its engine grows)
        stay_b = sorted(t for t in keys if run.serve[t] is B)
        kept_b = {t: B["tenancy"].tenant_counters(B["plane"], t)
                  for t in stay_b}
        for name in ("B", "C"):
            p = nodes[name]["plane"]
            p.pipeline_explicit_clock = False
            p.start()
        ev0 = {n: time.monotonic() - nodes[n]["plane"].pauses._t0
               for n in ("B", "C")}
        n_mig0 = len(timed_calls["migrate"])
        threads = [threading.Thread(
            target=gated_producer, daemon=True,
            args=(nodes, ("B", "C"), keys[FL_C0][0],
                  [b"\x77" * 64] * FL_UP_FRAMES, up[FL_C0]["fed"], stop,
                  FL_UP_PACE_S)),
            threading.Thread(target=tenant_feeder, daemon=True),
            threading.Thread(target=consumer, daemon=True)]
        for th in threads:
            th.start()
        time.sleep(FL_UP_STEADY_S)
        t0 = time.perf_counter()
        resp = cb.FleetUpgrade(pb.FleetUpgradeRequest(planes=["C"],
                                                      verify_probes=2),
                               timeout=FL_TIMEOUT_S)
        up_s = time.perf_counter() - t0
        time.sleep(FL_UP_STEADY_S)
        stop.set()
        for th in threads:
            th.join(timeout=10)
        in_keys = [k for t in up_tenants for k in keys[t][0]]
        # drain until nothing is left anywhere: no ingress on the fed
        # wires, nothing in flight, and no new egress for 0.5 s
        deadline = time.monotonic() + FL_TIMEOUT_S
        quiet, last = 0, -1
        while quiet < 10 and time.monotonic() < deadline:
            time.sleep(0.05)
            busy = False
            for name in ("B", "C"):
                drain_egress(nodes[name])
                p = nodes[name]["plane"]
                wires = nodes[name]["daemon"].wires
                busy = busy or bool(
                    p._inflight or p._holdback or len(p._wheel)
                    or p._pending or any(
                        w is not None and len(w.ingress)
                        for w in (wires.get_by_key(*k) for k in in_keys)))
            total = sum(u["out"] for u in up.values())
            quiet = quiet + 1 if not busy and total == last else 0
            last = total
        recs = [r for r in fed.status() if r["migration_id"] not in mids0]
        check(len(recs) == 2 * len(up_tenants)
              and all(r["state"] == "done" for r in recs),
              f"19(c): the upgrade's migrations {recs}")
        for r in recs:
            cs, rel = r["reconcile"]["counters_src"], at_release[
                r["migration_id"]]
            check(all(cs[k] == rel[k] for k in cs),
                  f"19(c): {r['migration_id']}'s src counters moved after "
                  f"RECONCILE froze them: {cs} -> {rel}")
        # every frame fed reached a terminal outcome, by the counters of
        # the rows it crossed: C's before the drain (less their state at
        # the start), B's between the drain and the refill (zeroed when
        # restored), the new C's since the refill
        newc = nodes["C"]
        term = {t: dict.fromkeys(FL_OUTCOMES, 0.0) for t in up_tenants}
        for r in recs:
            cs = r["reconcile"]["counters_src"]
            for k in FL_OUTCOMES:
                term[r["tenant"]][k] += cs[k] - (
                    base[r["tenant"]][k] if r["src"] == "C" else 0.0)
        for t in up_tenants:
            live = newc["tenancy"].tenant_counters(newc["plane"], t)
            for k in FL_OUTCOMES:
                term[t][k] += live[k]
        check(resp.ok and len(resp.reports) == 1
              and resp.migrations == 2 * len(up_tenants),
              f"19(c): FleetUpgrade {resp}")
        rep = resp.reports[0]
        check(rep.plane == "C" and rep.restarted and rep.healthy
              and not rep.error
              and list(rep.drained_tenants) == list(rep.refilled_tenants)
              == up_tenants,
              f"19(c): the report {rep}")
        # per tenant: fed == delivered at the egress wires + the drops
        # counted by cause, and the counters' delivered == the egress;
        # c0's latency-only links drop nothing: fed == delivered
        for t in up_tenants:
            fed_n, out_n, tm = up[t]["fed"][0], up[t]["out"], term[t]
            dropped = sum(tm[k] for k in FL_OUTCOMES[1:])
            check(fed_n > 0 and fed_n == out_n + dropped
                  and tm["delivered_packets"] == out_n,
                  f"19(c): {t}: {fed_n} fed, {out_n} out of the egress "
                  f"wires, the counters {tm}")
        check(up[FL_C0]["fed"][0] == up[FL_C0]["out"],
              f"19(c): {FL_C0} fed {up[FL_C0]['fed'][0]}, delivered "
              f"{up[FL_C0]['out']}")
        check(fed.stats.snapshot()["accounting_mismatch"] == 0.0,
              "19(c): the mismatch gauge")
        check(fed.handle("C").daemon is newc["daemon"]
              and all(sup.ledger.get(t) == "C" for t in up_tenants)
              and all(newc["tenancy"].rows_of(t).size
                      == C_rows[t] for t in up_tenants),
              "19(c): C's new daemon does not serve its tenants")
        after_b = {t: B["tenancy"].tenant_counters(B["plane"], t)
                   for t in stay_b}
        check(after_b == kept_b,
              f"19(c): B's counters of {stay_b} moved: {kept_b} -> "
              f"{after_b}")
        acct_c = {t: sup.check_failover_accounting(t, fed0[t] + run.fed[t])
                  for t in stay_b if t in TEN_NAMES}
        check(all(a["mismatch"] == 0.0 and a == acct[t]
                  for t, a in acct_c.items()),
              f"19(c): the failover accounting after the upgrade {acct_c}")
        h0 = newc["daemon"].health_snapshot()
        hr = cb.Health(pb.HealthRequest(plane="C"))
        h1 = newc["daemon"].health_snapshot()
        check(hr.ok and hr.node == "10.0.0.3" and hr.running
              and hr.heartbeat_age_s >= 0
              and h0["ticks"] <= hr.ticks <= h1["ticks"]
              and hr.tenants == len(up_tenants),
              f"19(c): Health(plane=C) through B {hr}")
        migs = timed_calls["migrate"][n_mig0:]
        restart = timed_calls["restart"][-1]
        n_up = len(up_tenants)
        refill_start = migs[n_up][2] - migs[n_up][1]
        # B's and the old C's events since the upgrade began, then all
        # of the new C's
        evs = {n: [e for e in ev if e["t_s"] >= round(ev0[n], 3) - 1e-3]
               for n, ev in (("B", nodes["B"]["plane"].pauses.events(-1)),
                             ("C", newc["old_pauses"]))}
        evs["C"] += newc["plane"].pauses.events(-1)
        pauses = {n: [(e["cause"], 1e3 * e["dur_s"]) for e in ev
                      if e["cause"] in MIG_PAUSES]
                  for n, ev in evs.items()}
        moves = {f"{r['tenant']} {r['src']}->{r['dst']}":
                 residue.get(r["migration_id"], (0, 0, 0)) for r in recs}
        caps1 = {"B": nodes["B"]["engine"].state.capacity,
                 "C": newc["engine"].state.capacity}
        m["c"] = {"rpc_s": up_s,
                  "drain_s": [s for _t, s, _e in migs[:n_up]],
                  "restart_s": restart[1], "restart_steps": restart[3],
                  "verify_s": refill_start - restart[2],
                  "refill_s": [s for _t, s, _e in migs[n_up:2 * n_up]],
                  "pauses_ms": pauses,
                  "fed": {t: up[t]["fed"][0] for t in up_tenants},
                  "delivered": {t: up[t]["out"] for t in up_tenants},
                  "counters": term, "inflight_residue": moves,
                  "capacity": {"before": caps0, "after": caps1}}
        log(f"19(c) FleetUpgrade(C) over gRPC in {up_s:.3f} s under "
            f"{len(keys[FL_C0][0])} paced {FL_C0} wires ({FL_UP_FRAMES} "
            f"frames each every {FL_UP_PACE_S} s) and "
            + ", ".join(f"{t}'s {len(keys[t][0])} wires" for t in fed_ten)
            + f" (one phase-16 feed tick every {FL_UP_TEN_PACE_S} s): drain "
            + ", ".join(f"{t} {s:.3f} s" for t, s, _e in migs[:n_up])
            + f"; restart {restart[1]:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in restart[3].items())
            + f"); verify {m['c']['verify_s']:.3f} s; refill "
            + ", ".join(f"{t} {s:.3f} s" for t, s, _e in
                        migs[n_up:2 * n_up])
            + "; barrier pauses ms: "
            + "; ".join(f"{n}: " + ", ".join(f"{c} {ms:.1f}" for c, ms in v)
                        for n, v in pauses.items())
            + f"; capacity {caps0} -> {caps1} ({card})")
        grew = [n for n in caps0 if caps1[n] != caps0[n]]
        log(f"19(c) {', '.join(grew) or 'no plane'} grew during the "
            f"upgrade; the counters of {', '.join(stay_b)} on B came "
            f"through it unchanged and the failover accounting of "
            f"{', '.join(acct_c)} is still exact (mismatch 0)"
            + (" (each row kept its counts: the port's repair of the JAX "
               "plane's counter reset)" if "B" in grew else "")
            + f" ({card})")
        log("19(c) per tenant, fed == egress + drops by cause, counters' "
            "delivered == egress: "
            + "; ".join(f"{t} fed {up[t]['fed'][0]}, egress {up[t]['out']}, "
                        f"counters delivered "
                        f"{term[t]['delivered_packets']:.0f}, netem loss "
                        f"{term[t]['dropped_loss']:.0f}, TBF queue "
                        f"{term[t]['dropped_queue']:.0f}, delay ring "
                        f"{term[t]['dropped_ring']:.0f}"
                        for t in up_tenants)
            + f"; {FL_C0} fed == delivered; RECONCILE's in-flight residue "
            "per move (checks that saw frames in flight, most frames, "
            "frames at the last such check): "
            + ", ".join(f"{k} {v}" for k, v in moves.items())
            + f"; Health(plane=C) through B's daemon: C's new heartbeat "
            f"({hr.ticks} ticks) ({card})")

        # (d) the surfaces: the scrape, ObserveSLO's fleet branch,
        # rebalance
        sup.sweep()
        snap = sup.stats.snapshot()
        reg, _h = make_registry(fleet=sup)
        body = generate_latest(reg).decode()
        for key in ("probes", "probe_failures", "sweeps", "evacuations",
                    "evacuated_tenants", "evacuated_rows",
                    "pending_restored", "orphans_resumed", "upgrades",
                    "upgrade_migrations"):
            check(_scrape_values(body, f"kubedtn_fleet_{key}_total")
                  == [float(snap[key])], f"19(d): kubedtn_fleet_{key}")
        for state, n in snap["transitions"].items():
            check(_scrape_values(body, f'kubedtn_fleet_transitions_total'
                                       f'{{to_state="{state}"}}')
                  == [float(n)], f"19(d): transitions {state}")
        check(_scrape_values(body, 'kubedtn_fleet_planes{state="dead"}')
              == [1.0] and _scrape_values(
                  body, 'kubedtn_fleet_planes{state="healthy"}') == [2.0]
              and _scrape_values(body, "kubedtn_fleet_reported_lost")
              == [float(snap["reported_lost"])]
              and _scrape_values(body, "kubedtn_fleet_placements")
              == [float(len(want))], "19(d): the plane gauges")
        cc = DaemonClient(addr["C"])
        clients.append(cc)
        slo = cc.ObserveSLO(pb.ObserveSLORequest(tenant="t1", fleet=True))
        merged = sup.last_fleet_slo()
        check(slo.ok and slo.fleet
              and list(slo.tenants) == [newc["daemon"]._slo_tenant_msg(
                  merged["t1"])]
              and slo.tenants[0].frozen_planes,
              f"19(d): ObserveSLO(fleet) {slo}")
        healths, placed = real_cands(set())
        plan = rebalance_plan(healths, placed, sup.ledger.qos_of,
                              exclude=sup.ledger.cordoned())
        t0 = time.perf_counter()
        moves = sup.rebalance()
        m["rebalance_s"] = time.perf_counter() - t0
        check([(x["tenant"], x["src"], x["dst"]) for x in moves] == plan
              and all(x["state"] == "done" for x in moves),
              f"19(d): rebalance() {moves} vs its plan {plan}")
        # the gain is taken: the next call, on fresh probes, has none
        t0 = time.perf_counter()
        again = sup.rebalance()
        m["rebalance_again_s"] = time.perf_counter() - t0
        check(again == [], f"19(d): rebalance() again moved {again}")
        m["d"] = {"plan": plan, "again": again,
                  "headroom_rows": {n: h.get("headroom_rows")
                                    for n, h in healths.items()},
                  "stats": snap}
        log(f"19(d) the scrape's kubedtn_fleet_* == FleetStats.snapshot() "
            f"{snap}; ObserveSLO(fleet) on C serves t1's merge with the "
            f"frozen slices of {list(slo.tenants[0].frozen_planes)}; "
            f"rebalance() on the live healths took {plan} in "
            f"{m['rebalance_s']:.3f} s, the next call [] in "
            f"{m['rebalance_again_s']:.3f} s ({card})")
    finally:
        pex.ring_right_shift = real_shift
        MigrationCoordinator._step_release = real_release
        MigrationCoordinator._src_residue = real_residue
        fsup.restore_tenant_slice = real["restore"]
        fsup.fork_from_checkpoint = real["fork_ckpt"]
        for c in clients:
            c.close()
        for name, node in nodes.items():
            try:
                node["plane"].stop()
            except Exception:
                pass
        for s in srv.values():
            s.stop(0)
        shutil.rmtree(root, ignore_errors=True)
    k1 = shaping.LAUNCHES["shape_step_rows"]
    k4 = pex.LAUNCHES["ring_step"] - k4_check
    m["phase_s"] = time.perf_counter() - t_phase
    m.update(k1_launches=k1, k4_launches=k4)
    log(f"19: phase {m['phase_s']:.1f} s; K1 {k1} launches, K4 {k4} "
        f"({card})")
    return m, k1, k4


# -- phase 20: the daemon process ------------------------------------------

DMN_LINKS = 4096            # fed Clos links, leaf ends among the scrape's
                            # first 10,000 interface series
DMN_PRODUCERS = 8           # shm producer processes, one fed link each
DMN_SHM_FRAMES = 2_500      # frames per producer (5,000 until phase 24)
DMN_SHM_BYTES = 200
DMN_FEED_S = 1.0            # seconds of feed (3 until phase 21 joined,
                            # 2 until phase 24)
DMN_ROUND_S = 0.5           # the InjectBulk feeder's pace: a round a 0.5 s
DMN_MAX_FRAMES = 4          # 1..4 frames of 64-256 B per wire and round
DMN_HOLD_LATENCY = "2s"     # the fed links' leaf ends before 20(d)'s burst:
                            # the burst is in the delay line at the stop
DMN_PLAN_LINKS = 64
DMN_PLAN_LATENCY = "8ms"    # from 10 ms, the same (5, 10] ms bucket
DMN_WHATIF_TICKS = 100      # (200 until phase 21 joined, PERF.md §4)
DMN_SEED = 20
DMN_BOOT_S = 300.0          # bound on boot-to-ready
DMN_WAIT_S = 180.0          # bound on the feed's drain and every verb
DMN_TERM_S = 120.0          # bound on SIGTERM to exit
DMN_RATE_FEED_S = 3.0       # --daemon-rate: seconds of saturating feed

DMN_FEEDER = r"""
import json, random, sys, time
sys.path.insert(0, sys.argv[1])
from kubedtn_tpu_torch.wire import proto as pb
from kubedtn_tpu_torch.wire.client import DaemonClient
addr, wids = sys.argv[2], [int(w) for w in sys.argv[3].split(",")]
seconds, round_s = float(sys.argv[4]), float(sys.argv[5])
max_frames, rng = int(sys.argv[6]), random.Random(int(sys.argv[7]))
fed = dict.fromkeys(wids, 0)
nbytes = 0

def batches(r):
    global nbytes
    out = []
    for lo in range(0, len(wids), 512):
        pkts = []
        for w in wids[lo:lo + 512]:
            for j in range(rng.randint(1, max_frames)):
                size = rng.randint(64, 256)
                tag = (w.to_bytes(4, "big") + r.to_bytes(4, "big")
                       + fed[w].to_bytes(4, "big"))
                pkts.append(pb.Packet(remot_intf_id=w,
                                      frame=tag + bytes(size - 12)))
                fed[w] += 1
                nbytes += size
        out.append(pb.PacketBatch(packets=pkts))
    return out

client = DaemonClient(addr)
t0 = time.perf_counter()
r = 0
while time.perf_counter() - t0 < seconds:
    t_r = time.perf_counter()
    if not client.InjectBulk(iter(batches(r)), timeout=120).response:
        sys.exit("InjectBulk refused a round")
    r += 1
    time.sleep(max(0.0, round_s - (time.perf_counter() - t_r)))
client.close()
print(json.dumps({"fed": fed, "bytes": nbytes, "rounds": r,
                  "s": time.perf_counter() - t0}), flush=True)
"""


class DaemonChild:
    """`python -m kubedtn_tpu_torch.cli daemon ARGS` (or another `verb`
    with its own `ready` line, two ports in it) as a child process: its
    ready line parsed, its stderr in a file, SIGTERM and the wait.
    `tag` names the phase in its failures."""

    READY = re.compile(r"^kubedtn-tpu daemon: gRPC on :(\d+), metrics on "
                       r":(\d+)/metrics$")

    def __init__(self, args: list, err_path: str, root: str,
                 verb: str = "daemon", ready=None, tag: str = "20") -> None:
        import os
        import subprocess

        if ready is not None:
            self.READY = ready
        self.tag = tag
        self.err_path = err_path
        self._err = open(err_path, "w")
        self.t0 = time.perf_counter()
        self.t_wall0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubedtn_tpu_torch.cli", verb,
             *args], cwd=root, env=dict(os.environ, PYTHONPATH=root,
                                        PYTHONFAULTHANDLER="1"),
            stdout=subprocess.PIPE, stderr=self._err, text=True)
        self.lines = []
        self.ports = None
        self._ready = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            m = self.READY.match(line.strip())
            if m and self.ports is None:
                self.ports = (int(m.group(1)), int(m.group(2)))
                self._ready.set()
        self._ready.set()

    def wait_ready(self, timeout: float) -> float:
        self._ready.wait(timeout)
        check(self.ports is not None,
              f"{self.tag}: the child printed no ready line in {timeout} s "
              f"(rc {self.proc.poll()}): {self.lines[-5:]}\n"
              f"{self.err_tail()}")
        return time.perf_counter() - self.t0

    def err_tail(self, n: int = 4000) -> str:
        self._err.flush()
        with open(self.err_path) as f:
            return f.read()[-n:]

    def term(self, timeout: float) -> float:
        """SIGTERM, then the wait for exit 0: seconds between them."""
        self.send_term()
        return self.wait_exit(timeout)

    def send_term(self, sig=None) -> None:
        import signal

        self.t_term = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM if sig is None else sig)

    def wait_exit(self, timeout: float) -> float:
        """Exit 0 within `timeout` s of send_term; seconds since it."""
        try:
            rc = self.proc.wait(max(0.0, self.t_term + timeout
                                    - time.perf_counter()))
        except Exception:
            self.kill()
            fail(f"{self.tag}: the child did not exit within {timeout} s "
                 f"of its signal:\n{self.err_tail()}")
        check(rc == 0, f"{self.tag}: the child exited {rc} after its "
                       f"signal:\n{self.err_tail()}")
        return time.perf_counter() - self.t_term

    def wait_log(self, msg: str, timeout: float) -> float:
        """Seconds from send_term until the daemon logs a message that
        starts with `msg`; fatal when it exits or times out first."""
        while True:
            self._err.flush()
            with open(self.err_path) as f:
                if any(f'msg="{msg}' in line for line in f):
                    return time.perf_counter() - self.t_term
            exited = self.proc.poll() is not None
            check(not exited and time.perf_counter() - self.t_term < timeout,
                  f"20: the daemon logged no {msg!r} within {timeout} s of "
                  f"SIGTERM (exit {self.proc.poll()}):\n{self.err_tail()}")
            time.sleep(0.1)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._err.close()

    BOOT_STEPS = ("daemon starting", "restored from checkpoint",
                  "tenant registry restored",
                  "link telemetry on", "slo autopilot on", "shm ingest on",
                  "profiler capturing", "daemon up")

    def logged(self, msg: str, key: str):
        """The number `key=` of the first log line whose message starts
        with `msg`, None when there is none."""
        self._err.flush()
        with open(self.err_path) as f:
            for line in f:
                if f'msg="{msg}' in line:
                    got = re.search(rf"\b{key}=([0-9.]+)", line)
                    return float(got.group(1)) if got else None
        return None

    def boot_steps(self) -> dict:
        """Seconds from the spawn to each boot step the daemon logged
        (its log lines' wall-clock stamps)."""
        import datetime

        self._err.flush()
        out = {}
        with open(self.err_path) as f:
            for line in f:
                m = re.match(r'time=(\S+) level=\w+ msg="([^"]*)', line)
                if not m:
                    continue
                step = next((s for s in self.BOOT_STEPS
                             if m.group(2).startswith(s)), None)
                if step and step not in out:
                    t = datetime.datetime.fromisoformat(m.group(1))
                    out[step] = round(t.timestamp() - self.t_wall0, 3)
                if step == "daemon up":
                    break
        return out

    def launches(self) -> dict:
        """The kernel launches the daemon logged at its shutdown."""
        self._err.flush()
        with open(self.err_path) as f:
            got = [l for l in f if 'msg="kernel launches' in l]
        check(got, "20: the daemon logged no kernel launches")
        return {k: int(v) for k, v in re.findall(
            r"(\w+)=(\d+)", got[-1].split('msg="kernel launches', 1)[1])}


def dmn_scrape(port: int) -> dict:
    """One scrape of the child's /metrics: {(name, labels): value}."""
    import urllib.request

    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=120).read().decode()
    out = {}
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        name, _, labels = key.partition("{")
        out[(name, labels.rstrip("}"))] = float(val)
    return out


def dmn_books(sc: dict, links, fed: dict) -> dict:
    """The books of the fed links from one scrape: per link the leaf
    end's tx_packets (frames shaped on the leaf -> spine row) == the
    frames fed into its wire, and the node totals over every active row
    (only the fed links carry traffic): fed == delivered + netem loss +
    TBF queue + delay-ring drops."""
    def node(k):
        return sc[(f"kubedtn_node_{k}_total", "")]

    tx = {}
    for (leaf, uid), wid in links.items():
        key = ("interface_tx_packets",
               f'interface="uid{uid}",namespace="default",pod="{leaf}"')
        check(key in sc, f"20: no interface series for {leaf} uid{uid} in "
                         f"the scrape")
        tx[wid] = sc[key]
    total = sum(fed.values())
    b = {"fed": total, "tx_packets": node("tx_packets"),
         "delivered": node("rx_packets"), "dropped_loss": node("dropped_loss"),
         "dropped_queue": node("dropped_queue"),
         "dropped_ring": node("dropped_ring"),
         "links_off": sum(1 for w in fed if tx[w] != fed[w])}
    b["closed"] = (b["links_off"] == 0 and b["tx_packets"] == total
                   and b["delivered"] + b["dropped_loss"]
                   + b["dropped_queue"] + b["dropped_ring"] == total)
    b["per_link"] = tx
    return b


def dmn_wait_books(port: int, links, fed: dict, what: str) -> tuple:
    t0 = time.perf_counter()
    deadline = time.monotonic() + DMN_WAIT_S
    while True:
        sc = dmn_scrape(port)
        b = dmn_books(sc, links, fed)
        if b["closed"] or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    off = [(w, b["per_link"][w], n) for w, n in fed.items()
           if b["per_link"][w] != n][:8]
    check(b["closed"], f"20: {what}: the books do not close: "
                       f"{ {k: v for k, v in b.items() if k != 'per_link'} }"
                       f"; (wire, tx, fed) {off}; "
                       f"{ {k: v for k, v in sc.items() if 'shm' in k[0]} }")
    return b, sc, time.perf_counter() - t0


def dmn_rows(sc: dict) -> tuple:
    """(realized rows, the interface series' label set): the scrape caps
    per-interface series and counts the rest as truncated."""
    labels = {k[1] for k in sc if k[0] == "interface_tx_packets"}
    return (len(labels) + int(sc[("kubedtn_interface_series_truncated", "")]),
            labels)


def dmn_checkpoint(dev, D: str, n_spine: int, n_leaf: int, capacity: int,
                   n_links: int) -> dict:
    """20(a): the Clos through the control plane with a tenancy registry
    (entry.build_daemon), saved cold into D; the fed links are leaf ends
    among the first 10,000 realized ends in the scrape's sorted (pod,
    uid) order, whose series it exports."""
    import os

    from kubedtn_tpu_torch import checkpoint, entry

    ck = {}
    t0 = time.perf_counter()
    built = entry.build_daemon(dev, n_spine, n_leaf, capacity=capacity,
                               tenancy=True)
    ck["n_rows"] = built["engine"].num_active
    ck["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save(D, built["store"], built["engine"])
    ck["save_cold_s"] = time.perf_counter() - t0
    ck["ckpt_bytes"] = sum(os.path.getsize(os.path.join(D, f))
                           for f in os.listdir(D))
    with open(os.path.join(D, "manifest.json"), "rb") as f:
        ck["manifest0"] = f.read()
    ck["crs"] = {t.name: t for t in built["crs"]}
    ck["tenants0"] = sorted(t.name for t in built["tenancy"].list())
    ends = sorted(k for k in built["engine"]._rows
                  if k[0].startswith("default/leaf"))[:10_000]
    step = max(1, len(ends) // n_links)
    ck["fed_ends"] = ends[::step][:n_links]
    check(len(ck["fed_ends"]) == n_links,
          f"20: {len(ck['fed_ends'])} fed links")
    del built
    _free_card(dev)
    return ck


def dmn_wire(client, fed_ends, crs) -> dict:
    """AddGRPCWireLocal on both ends of the fed links: the leaf ends one
    at a time, since their wire ids come from the registry's counter in
    call order (1001, 1002, ...); then the spine ends, whose ids nothing
    addresses, from 8 threads at once. {(leaf pod, uid): wire id}."""
    from concurrent.futures import ThreadPoolExecutor

    from kubedtn_tpu_torch.wire import proto as pb

    for leaf_key, uid in fed_ends:
        client.AddGRPCWireLocal(pb.WireDef(
            local_pod_name=leaf_key.split("/")[1], kube_ns="default",
            link_uid=uid, intf_name_in_pod="eth1"), timeout=30)
    spine_of = {l.uid: l.peer_pod for t in crs.values()
                if t.name.startswith("leaf") for l in t.spec.links}
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda e: client.AddGRPCWireLocal(pb.WireDef(
            local_pod_name=spine_of[e[1]], kube_ns="default",
            link_uid=e[1], intf_name_in_pod="eth1"), timeout=30),
            fed_ends))
    return {(k.split("/")[1], u): 1001 + i
            for i, (k, u) in enumerate(fed_ends)}


def run_daemon_phase(dev, card, n_spine=None, n_leaf=None,
                     capacity: int = 1 << 18, n_links: int = DMN_LINKS,
                     n_producers: int = DMN_PRODUCERS,
                     shm_frames: int = DMN_SHM_FRAMES,
                     child_device: str | None = None) -> dict:
    """Phase 20: the daemon process at full width, driven only through
    what an operator has — the child process, its CLI, gRPC, /metrics
    and files. `child_device` None lets the daemon take its default,
    the card."""
    import os
    import shutil
    import subprocess
    import tempfile

    import yaml

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    n_spine = n_spine or entry.N_SPINE
    n_leaf = n_leaf or entry.N_LEAF
    m = {}
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="kdt-p20-")
    D, S = os.path.join(tmp, "ckpt"), os.path.join(tmp, "shm")
    T, P = os.path.join(tmp, "trace.json"), os.path.join(tmp, "profile")
    children = []
    try:
        # (a) the checkpoint: the Clos through the control plane, saved
        ck = dmn_checkpoint(dev, D, n_spine, n_leaf, capacity, n_links)
        m.update({k: ck[k] for k in ("build_s", "save_cold_s",
                                     "ckpt_bytes")})
        n_rows, crs, fed_ends = ck["n_rows"], ck["crs"], ck["fed_ends"]
        tenants0, manifest0 = ck["tenants0"], ck["manifest0"]
        log(f"20(a) the Clos through the control plane ({n_rows} rows in "
            f"{capacity}, tenants {tenants0}) in {m['build_s']:.1f} s; "
            f"checkpoint.save {m['save_cold_s']:.3f} s, {m['ckpt_bytes']} "
            f"bytes ({card})")

        # (b) the boot
        args = ["--port", "0", "--metrics-port", "0", "--checkpoint-dir", D,
                "--shm-dir", S, "--trace-out", T, "--profile", P,
                "--telemetry-window", "0.5"]
        if child_device is not None:
            args += ["--device", child_device]
        apps0 = _card_apps(dev)
        child = DaemonChild(args, os.path.join(tmp, "daemon1.err"), root)
        children.append(child)
        m["boot_cold_s"] = child.wait_ready(DMN_BOOT_S)
        m["boot_cold_steps"] = child.boot_steps()
        m["load_cold_s"] = child.logged("restored from checkpoint", "load_s")
        gport, mport = child.ports
        addr = f"127.0.0.1:{gport}"
        m["on_card"] = _child_on_card(child.proc.pid, dev, apps0)
        client = DaemonClient(addr)
        h = client.Health(pb.HealthRequest(), timeout=30)
        check(h.ok and h.serving, f"20(b): Health {h}")
        sc = dmn_scrape(mport)
        rows, labels0 = dmn_rows(sc)
        check(rows == n_rows, f"20(b): /metrics realizes {rows} rows, the "
                              f"checkpoint {n_rows}")
        ten = {k[1] for k in sc if k[0] == "kubedtn_tenant_links"}
        check(ten == {f'tenant="{t}"' for t in tenants0},
              f"20(b): /metrics tenants {ten}, the checkpoint {tenants0}")
        check(sc[("kubedtn_tenant_links", 'tenant="default"')] == n_rows,
              "20(b): the default tenant's rows")
        log(f"20(b) tpudtn-torch daemon from the checkpoint, no --device: "
            f"ready in {m['boot_cold_s']:.1f} s (s after the spawn: "
            f"{m['boot_cold_steps']}; checkpoint.load {m['load_cold_s']} s)"
            f"; {m['on_card']}; Health serving, "
            f"/metrics {rows} rows, tenants {tenants0} ({card})")

        # (c) wires, the feed, the books
        t0 = time.perf_counter()
        links = dmn_wire(client, fed_ends, crs)
        m["wires_s"] = time.perf_counter() - t0
        wids = list(links.values())
        shm_w, bulk_w = wids[:n_producers], wids[n_producers:]
        env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        feeder = subprocess.Popen(
            [sys.executable, "-c", DMN_FEEDER, root, addr,
             ",".join(map(str, bulk_w)), str(DMN_FEED_S), str(DMN_ROUND_S),
             str(DMN_MAX_FRAMES), str(DMN_SEED)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        producers = [subprocess.Popen(
            [sys.executable, "-m", "kubedtn_tpu_torch.shm.producer",
             os.path.join(S, f"p{k}.ring"), str(w), str(shm_frames),
             "--frame-size", str(DMN_SHM_BYTES), "--namespace", "default",
             "--pace-s", str(DMN_FEED_S * 256 / shm_frames)],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for k, w in enumerate(shm_w)]
        try:
            f_out, f_err = feeder.communicate(timeout=DMN_WAIT_S)
            p_out = [p.communicate(timeout=DMN_WAIT_S) for p in producers]
        finally:
            for p in [feeder, *producers]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        m["feed_s"] = time.perf_counter() - t0
        check(feeder.returncode == 0, f"20(c): the feeder failed: "
                                      f"{f_err[-2000:]}")
        check(all(p.returncode == 0 and o[0].splitlines()[-1]
                  == f"done pushed={shm_frames}"
                  for p, o in zip(producers, p_out)),
              f"20(c): a producer failed: {[o[1][-300:] for o in p_out]}")
        fr = json.loads(f_out.splitlines()[-1])
        fed = {int(w): n for w, n in fr["fed"].items()}
        fed.update({w: shm_frames for w in shm_w})
        m["fed"] = sum(fed.values())
        m["fed_bulk"], m["fed_shm"] = sum(fr["fed"].values()), \
            n_producers * shm_frames
        # the operator verbs, each a tpudtn-torch process, started as the
        # feed ends: the books are read from the scrape while they run
        spec_path = os.path.join(tmp, "whatif.yaml")
        u0, u1 = fed_ends[0][1], fed_ends[1][1]
        with open(spec_path, "w") as f:
            yaml.safe_dump([
                {"name": "degrade", "perturbations": [
                    {"kind": "degrade", "uid": u0,
                     "properties": {"latency": "50ms"}}]},
                {"name": "fail", "perturbations": [
                    {"kind": "fail", "uid": u1}]},
                {"name": "spine0-blackholed", "perturbations": [
                    {"kind": "blackhole", "node": "spine0"}]},
                {"name": "load-x1.5", "perturbations": [
                    {"kind": "scale", "factor": 1.5}]}], f)
        plan_leaf = crs[f"leaf{n_leaf - 1}"]
        n_plan = min(DMN_PLAN_LINKS, len(plan_leaf.spec.links))
        new_props = LinkProperties(latency=DMN_PLAN_LATENCY, rate="10Gbit")
        plan_topo = dataclasses.replace(plan_leaf, spec=dataclasses.replace(
            plan_leaf.spec, links=[l.with_properties(new_props)
                                   for l in plan_leaf.spec.links[:n_plan]]
            + plan_leaf.spec.links[n_plan:]))
        plan_path = os.path.join(tmp, "plan.yaml")
        with open(plan_path, "w") as f:
            yaml.safe_dump(plan_topo.to_manifest(), f, sort_keys=False)
        d = ["--daemon", addr]
        together = {
            "top": ["top", "--json", *d], "slo": ["slo", "--json", *d],
            "pauses": ["pauses", "--json", "--events", "20", *d],
            "tenant list": ["tenant", "list", *d],
            "tenant stats": ["tenant", "stats", "default", *d],
            "autopilot status": ["autopilot", "status", "--json", *d],
            "fleet status": ["fleet", "status", *d],
            "migrate --status": ["migrate", "--status", *d],
            "trace latest": ["trace", "latest", "--json", *d],
            "whatif": ["whatif", "--json", "--ticks",
                       str(DMN_WHATIF_TICKS), "--spec", spec_path, *d],
            "plan": ["plan", plan_path, "--json", *d]}
        verbs = {}

        def launch(cmds: dict) -> tuple:
            return time.perf_counter(), {k: subprocess.Popen(
                [sys.executable, "-m", "kubedtn_tpu_torch.cli", *a],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for k, a in cmds.items()}

        def collect(started: tuple) -> None:
            t0, procs = started
            for k, p in procs.items():
                out, err = p.communicate(timeout=DMN_WAIT_S)
                check(p.returncode == 0, f"20(c): tpudtn-torch {k} exited "
                      f"{p.returncode}: {err[-1500:]}")
                verbs[k] = {"s": time.perf_counter() - t0,
                            "out": json.loads(out.splitlines()[-1])}

        # `top` starts once the daemon has closed its first telemetry
        # window, and `trace latest` once its flight recorder has sampled
        # a frame: before that they have nothing to report. On a slow
        # host the feed's first two dispatches hold the plane ~5 s each
        # (PERF.md §7), and verbs started with the others asked inside
        # them
        late = {k: together.pop(k) for k in ("top", "trace latest")}
        running = launch(together)
        m["first_window_s"] = wait_for(
            lambda: dmn_scrape(mport).get(
                ("kubedtn_link_windows_closed_total", ""), 0.0) >= 1,
            DMN_WAIT_S, "20(c): the daemon's first telemetry window",
            interval=0.25)
        m["first_sample_s"] = wait_for(
            lambda: dmn_scrape(mport).get(
                ("kubedtn_flight_sampled_frames_total", ""), 0.0) >= 1,
            DMN_WAIT_S, "20(c): the daemon's first sampled frame",
            interval=0.25)
        running_top = launch(late)
        books, sc, m["drain_s"] = dmn_wait_books(mport, links, fed,
                                                 "20(c) the feed")
        log(f"20(c) {len(wids)} + {len(wids)} wires by AddGRPCWireLocal in "
            f"{m['wires_s']:.1f} s; fed {m['feed_s']:.1f} s: "
            f"{m['fed_bulk']} frames over InjectBulk from a client process "
            f"({fr['rounds']} rounds, {len(bulk_w)} wires, 1-"
            f"{DMN_MAX_FRAMES} frames of 64-256 B) and {m['fed_shm']} from "
            f"{n_producers} ShmSender processes; drained {m['drain_s']:.1f} "
            f"s after; books closed: fed {books['fed']} == delivered "
            f"{books['delivered']:.0f} + loss {books['dropped_loss']:.0f} + "
            f"queue {books['dropped_queue']:.0f} + ring "
            f"{books['dropped_ring']:.0f}, every link's tx == its feed "
            f"({card})")

        collect(running)
        collect(running_top)
        plan = verbs["plan"]["out"]["plans"][0]
        check(plan["ok"] and plan["verified"], f"20(c): plan {plan}")
        n_changed = sum(r["changes"] for r in plan["rounds"])
        check(n_changed == n_plan,
              f"20(c): the plan changes {n_changed} links")
        collect(launch({"apply --plan": ["apply", "--plan",
                                         str(plan["plan_id"]), *d]}))
        check(verbs["apply --plan"]["out"]["ok"],
              f"20(c): apply --plan {verbs['apply --plan']['out']}")
        ap = verbs["autopilot status"]["out"]
        check(ap["running"] and not ap["enabled"],
              f"20(c): the autopilot is not attached and disabled: {ap}")
        check([t["name"] for t in verbs["tenant list"]["out"]["tenants"]]
              == tenants0, "20(c): tenant list")
        check(verbs["tenant stats"]["out"]["links"] == n_rows,
              "20(c): tenant stats")
        top = verbs["top"]
        check(top["out"]["windows_closed"] > 0,
              f"20(c): top: no telemetry window closed (its answer "
              f"{top['s']:.1f} s after its start, covered_seconds "
              f"{top['out']['covered_seconds']}; after the drain the "
              f"scrape read kubedtn_link_windows_closed "
              f"{sc.get(('kubedtn_link_windows_closed_total', ''))} and "
              f"kubedtn_dataplane_ticks "
              f"{sc.get(('kubedtn_dataplane_ticks_total', ''))})")
        check(verbs["trace latest"]["out"]["events"], "20(c): no trace")
        ranked = verbs["whatif"]["out"]["ranked"]
        check(sorted(r["name"] for r in ranked) == sorted(
            ["baseline", "degrade", "fail", "spine0-blackholed",
             "load-x1.5"]), f"20(c): whatif ranked {ranked}")
        fleet = verbs["fleet status"]["out"]["planes"]
        check(len(fleet) == 1 and fleet[0]["state"] == "healthy",
              f"20(c): fleet status {fleet}")
        m["verbs_s"] = {k: v["s"] for k, v in verbs.items()}
        log(f"20(c) tpudtn-torch verbs against the daemon, rc 0 and JSON "
            f"each, wall s (the first {len(together)} run together while "
            f"the feed drained, top and trace latest once the first "
            f"telemetry window had closed {m['first_window_s']:.1f} s "
            f"after the feed ended and a frame was sampled "
            f"{m['first_sample_s']:.1f} s after that, then apply --plan): "
            + ", ".join(f"{k} {v:.2f}" for k, v in m["verbs_s"].items())
            + f"; plan {plan['plan_id']} verified ({n_changed} links, gate "
            f"{plan['gate_s']:.2f} s), applied in "
            f"{verbs['apply --plan']['out']['stage_s']:.2f} s ({card})")

        # (d) SIGTERM with frames pending: the fed links' leaf ends take
        # DMN_HOLD_LATENCY by UpdateLinks first, so the burst is in the
        # delay line (or still queued) when the plane stops. Nothing was
        # fed since the books closed: (e) holds each link's counter to
        # its value then, plus its burst frame.
        books1 = books
        hold = LinkProperties(latency=DMN_HOLD_LATENCY, rate="10Gbit")
        fed_uids = {}
        for leaf_key, uid in fed_ends:
            fed_uids.setdefault(leaf_key.split("/")[1], set()).add(uid)
        for pod, uids in fed_uids.items():
            check(client.UpdateLinks(pb.LinksBatchQuery(
                local_pod=pb.Pod(name=pod, kube_ns="default"),
                links=[pb.link_to_proto(l.with_properties(hold))
                       for l in crs[pod].spec.links if l.uid in uids]),
                timeout=60).response, f"20(d): UpdateLinks on {pod}")
        burst = client.InjectBulk(iter([pb.PacketBatch(packets=[
            pb.Packet(remot_intf_id=w, frame=w.to_bytes(4, "big")
                      + bytes(60)) for w in wids])]), timeout=60)
        check(burst.response, "20(d): the burst was refused")
        client.close()
        child.send_term()
        # D is whole once the daemon logs its save: read the counts, then
        # boot the restart while the daemon writes its profile and exits
        m["saved_s"] = child.wait_log("checkpoint written", DMN_TERM_S)
        with open(os.path.join(D, "manifest.json"), "rb") as f:
            check(f.read() != manifest0, "20(d): no new generation in D")
        # the frame counts from the npz files alone: the restart's
        # loaders verify them against the manifest (a parse of ~72 MB)
        for key, fname in (("pending_at_stop", "pending_frames.npz"),
                           ("ingress_at_stop", "wire_ingress.npz")):
            fpath = os.path.join(D, fname)
            m[key] = 0
            if os.path.exists(fpath):
                with np.load(fpath) as z:
                    m[key] = int(z["uids"].size)
        check(m["pending_at_stop"] + m["ingress_at_stop"] > 0,
              f"20(d): no frame pending or queued at the stop, with the "
              f"fed links at {DMN_HOLD_LATENCY}")
        # (e) the restart from D, without --profile and with a trace file
        # of its own (the first daemon still appends its last spans to T)
        args2 = list(args)
        i = args2.index("--profile")
        del args2[i:i + 2]
        args2[args2.index("--trace-out") + 1] = os.path.join(tmp,
                                                             "trace2.json")
        child2 = DaemonChild(args2, os.path.join(tmp, "daemon2.err"), root)
        children.append(child2)
        m["term_s"] = child.wait_exit(DMN_TERM_S)
        launches1 = child.launches()
        m["profile_start_s"] = child.logged("profiler capturing",
                                            "start_s")
        m["profile_write_s"] = child.logged("profile written", "s")
        with open(T) as f:
            text = f.read().rstrip().rstrip(",")
        spans = json.loads(text + ("" if text.endswith("]") else "\n]"))
        names = {s["name"] for s in spans}
        check({"checkpoint-load", "checkpoint-save"} <= names
              and any(n.startswith("pause:") for n in names),
              f"20(d): the trace holds {sorted(names)}")
        m["save_s"] = max(s["dur"] for s in spans
                          if s["name"] == "checkpoint-save") / 1e6
        profs = [f for f in os.listdir(P) if f.endswith(".pt.trace.json")]
        check(profs, f"20(d): no profiler trace in {os.listdir(P)}")
        m["profile_bytes"] = sum(os.path.getsize(os.path.join(P, f))
                                 for f in profs)
        m["spans"] = len(spans)
        log(f"20(d) SIGTERM after a burst of {len(wids)} frames on links "
            f"held at {DMN_HOLD_LATENCY} by UpdateLinks: exit 0 in "
            f"{m['term_s']:.1f} s (checkpoint-save {m['save_s']:.3f} s, "
            f"logged {m['saved_s']:.1f} s after the SIGTERM, when the "
            f"restart was spawned; the profile written in "
            f"{m['profile_write_s']} s); a new "
            f"generation with {m['pending_at_stop']} frames pending "
            f"and {m['ingress_at_stop']} queued; the trace {len(spans)} "
            f"spans ({', '.join(sorted(names))}); the profile "
            f"{m['profile_bytes']} bytes, its start {m['profile_start_s']} "
            f"s at the boot; the daemon's kernel launches {launches1} "
            f"({card})")

        # (e) the restart, spawned above
        m["boot_warm_s"] = child2.wait_ready(DMN_BOOT_S)
        m["boot_warm_steps"] = child2.boot_steps()
        m["load_warm_s"] = child2.logged("restored from checkpoint",
                                         "load_s")
        mport2 = child2.ports[1]
        fed2 = {w: n + 1 for w, n in fed.items()}
        books2, sc2, m["drain2_s"] = dmn_wait_books(
            mport2, links, fed2, "20(e) after the restart")
        rows2, labels2 = dmn_rows(sc2)
        check(rows2 == n_rows and labels2 == labels0,
              f"20(e): {rows2} rows after the restart, {n_rows} before")
        off = [w for w in wids
               if books2["per_link"][w] != books1["per_link"][w] + 1]
        check(not off, f"20(e): {len(off)} links' counters do not continue "
                       f"from the stop")
        for k in ("kubedtn_dataplane_undeliverable_total",
                  "kubedtn_dataplane_bulk_unresolved_total",
                  "kubedtn_dataplane_tick_errors_total"):
            check(sc2.get((k, ""), 0.0) == 0.0, f"20(e): {k} != 0")
        m["term2_s"] = child2.term(DMN_TERM_S)
        launches2 = child2.launches()
        check(child_device == "cpu" or launches1["shape_step_rows"] > 0,
              "20: K1 never launched in the daemon")
        m["launches"] = {"first": launches1, "restart": launches2}
        log(f"20(e) the restart from D: ready in {m['boot_warm_s']:.1f} s "
            f"(s after the spawn: {m['boot_warm_steps']}; checkpoint.load "
            f"{m['load_warm_s']} s), "
            f"{rows2} rows as before, every fed link's counters continued "
            f"by its burst frame, the {m['pending_at_stop']} pending and "
            f"{m['ingress_at_stop']} queued frames delivered with the books "
            f"closed (fed {books2['fed']} == delivered "
            f"{books2['delivered']:.0f} + drops "
            f"{books2['dropped_loss'] + books2['dropped_queue'] + books2['dropped_ring']:.0f}"
            f"), in {m['drain2_s']:.1f} s; exit 0 in {m['term2_s']:.1f} s; "
            f"its kernel launches {launches2} ({card})")
    except BaseException:
        for c in children:
            log(f"20: daemon (exit {c.proc.poll()}) stderr tail:\n"
                + "\n".join(l for l in c.err_tail(200_000).splitlines()
                             if 'msg="rpc' not in l)[-6000:])
        raise
    finally:
        for c in children:
            c.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"20: the daemon's own kernel launches (another process, not in "
        f"the kernels line): first run {launches1}, restart {launches2} "
        f"({card})")
    return m


def run_daemon_rate(dev, card, n_spine=None, n_leaf=None,
                    capacity: int = 1 << 18, n_links: int = DMN_LINKS,
                    child_device: str | None = None) -> dict:
    """`--daemon-rate` (not in the default run): the daemon process's
    shaping rate under a saturating feed, booted from one Clos checkpoint
    three ways: as phase 20 boots it (--profile, telemetry on, so the
    SLO evaluator and the autopilot run), without --profile, and without
    --profile with --no-telemetry. Per boot, on phase 20's fed links: the
    InjectBulk feeder's rounds back to back for DMN_RATE_FEED_S (1-4
    frames of 64-256 B a wire a round), then the books closed from the
    scrape; frames fed, the feeder's frames/s, and frames/s delivered
    from the feed's start to the books closing (scrapes every 0.5 s);
    from the scrapes before the feed and at the close, the plane's ticks,
    frames a tick, and its tick-stage seconds over that window (their
    sum against the window's wall seconds: how busy the plane thread
    was). Each child is killed, so none saves over the checkpoint."""
    import os
    import shutil
    import subprocess
    import tempfile

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.wire.client import DaemonClient

    n_spine = n_spine or entry.N_SPINE
    n_leaf = n_leaf or entry.N_LEAF
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="kdt-rate-")
    D, P = os.path.join(tmp, "ckpt"), os.path.join(tmp, "profile")
    out = {}
    child = None
    try:
        ck = dmn_checkpoint(dev, D, n_spine, n_leaf, capacity, n_links)
        base = ["--port", "0", "--metrics-port", "0", "--checkpoint-dir", D]
        if child_device is not None:
            base += ["--device", child_device]
        boots = {"as phase 20": ["--profile", P, "--telemetry-window", "0.5"],
                 "no --profile": ["--telemetry-window", "0.5"],
                 "no --profile, --no-telemetry": ["--no-telemetry"]}
        env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
        for name, extra in boots.items():
            child = DaemonChild(base + extra,
                                os.path.join(tmp, f"rate{len(out)}.err"), root)
            boot_s = child.wait_ready(DMN_BOOT_S)
            gport, mport = child.ports
            client = DaemonClient(f"127.0.0.1:{gport}")
            links = dmn_wire(client, ck["fed_ends"], ck["crs"])
            client.close()
            sc0 = dmn_scrape(mport)
            t0 = time.perf_counter()
            feeder = subprocess.run(
                [sys.executable, "-c", DMN_FEEDER, root,
                 f"127.0.0.1:{gport}", ",".join(map(str, links.values())),
                 str(DMN_RATE_FEED_S), "0", str(DMN_MAX_FRAMES),
                 str(DMN_SEED)], cwd=root, env=env, capture_output=True,
                text=True, timeout=DMN_WAIT_S)
            check(feeder.returncode == 0, f"daemon rate: the feeder failed: "
                                          f"{feeder.stderr[-2000:]}")
            fr = json.loads(feeder.stdout.splitlines()[-1])
            fed = {int(w): n for w, n in fr["fed"].items()}
            books, sc1, drain_s = dmn_wait_books(mport, links, fed,
                                                 f"daemon rate, {name}")
            total_s = time.perf_counter() - t0
            ticks = (sc1[("kubedtn_dataplane_ticks_total", "")]
                     - sc0[("kubedtn_dataplane_ticks_total", "")])
            stages = {k[1].split('"')[1]: v - sc0[k] for k, v in sc1.items()
                      if k[0] == "kubedtn_dataplane_stage_seconds_total"}
            in_ticks = sum(stages.values())
            out[name] = {"boot_s": boot_s, "fed": books["fed"],
                         "rounds": fr["rounds"], "feeder_s": fr["s"],
                         "feeder_fps": books["fed"] / fr["s"],
                         "drain_s": drain_s, "total_s": total_s,
                         "delivered_fps": books["fed"] / total_s,
                         "ticks": ticks, "stage_s": stages,
                         "tick_share": in_ticks / total_s}
            child.kill()
            child = None
            log(f"daemon rate, {name}: {books['fed']} frames fed in "
                f"{fr['s']:.2f} s ({fr['rounds']} rounds, "
                f"{out[name]['feeder_fps']:.0f} frames/s offered), books "
                f"closed {drain_s:.2f} s after: "
                f"{out[name]['delivered_fps']:.0f} frames/s delivered; "
                f"{ticks:.0f} ticks, {books['fed'] / max(ticks, 1):.0f} "
                f"frames and {in_ticks / max(ticks, 1) * 1e3:.1f} ms a tick, "
                f"the plane in ticks {out[name]['tick_share']:.3f} of the "
                f"window, stage s "
                f"{ {k: round(v, 3) for k, v in stages.items()} }; boot "
                f"{boot_s:.1f} s ({card})")
    except BaseException:
        if child is not None:
            log(f"daemon rate: daemon stderr tail:\n{child.err_tail()}")
        raise
    finally:
        if child is not None:
            child.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 21: the Kubernetes-facing control plane and six rungs -----------

MGR_WORKERS = 32            # config/manager/deployment.yaml's --workers
MGR_LEASE_S = 2.0           # ControllerManager's lease and renew defaults
MGR_RENEW_S = 0.5
MGR_NS = "kubedtn-tpu"      # the Lease's namespace
# a leaf's links re-shaped on the apiserver, before and after the
# takeover (leaves n_leaf // 3 and 2 * n_leaf // 3)
MGR_EDITS = (dict(latency="3ms", rate="1Gbit"),
             dict(latency="4ms", rate="2Gbit"))
MGR_WATCH_S = 1.0           # the apiserver ends each watch after this
MGR_EVENTS = 4096           # watch events it retains (every push's echo)
MGR_WAIT_S = 120.0          # bound on every wait of 21(a) and 21(b)
MGR_PING_SEED = 21
MGR_K1 = 2                  # K1 on 21(a)'s engine: warm_kernels, the ping
LADDER_RUNGS = ("3node", "fat_tree_64", "churn_1k", "clos_100k",
                "reconcile_100k", "scale_1m")
# the JAX rungs' result keys (kubedtn_tpu/scenarios.py:36-406); the
# port's add "device"
RUNG_KEYS = {
    "3node": {"scenario", "links", "reachable", "pings", "wall_s"},
    "fat_tree_64": {"scenario", "nodes", "links", "sim_time_s",
                    "tx_packets", "rx_packets", "wall_s"},
    "churn_1k": {"scenario", "nodes", "links", "churn_links_total",
                 "updates_per_sec", "wall_s"},
    "clos_100k": {"scenario", "links", "directed_edges", "sim_time_s",
                  "tx_packets", "rx_packets", "loss_rate",
                  "packet_events_per_sec", "wall_s"},
    "reconcile_100k": {"scenario", "topologies", "links", "directed_rows",
                       "setup_s", "reconcile_s", "churn_s", "teardown_s",
                       "grpc_update_s", "grpc_update_links", "grpc_ok",
                       "device_calls", "spot_check_latency_us", "target_s",
                       "meets_target"},
    "scale_1m": {"scenario", "links", "directed_rows", "capacity",
                 "load_s", "updates_per_sec", "shape_pkts_per_sec",
                 "wall_s"},
    "routes_10k": {"scenario", "nodes", "links", "recompute_s_first",
                   "recompute_s_steady", "reachable_frac", "wall_s"},
    "chaos_flaps": {"scenario", "nodes", "links", "events", "baseline_rx",
                    "baseline_no_route", "event_results",
                    "recompute_s_median", "traffic_survived_every_outage",
                    "wall_s"},
    "reconverge_10k": {"scenario", "nodes", "links", "initial_full_s",
                       "full_recompute_s", "events", "reconverge_s_steady",
                       "speedup_vs_full", "matches_full_recompute",
                       "flap10_down_s", "flap10_up_s", "flap10_cells",
                       "wall_s"},
}
RUNG_CHECK_STEPS = 2        # 21(c): K1 vs the plain version at 2^21 rows


def load_fake_apiserver():
    """The port's fake apiserver, tests/_torch_fake_apiserver.py, loaded
    by path (it imports neither jax nor the JAX package)."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent / "tests"
            / "_torch_fake_apiserver.py")
    spec = importlib.util.spec_from_file_location("_torch_fake_apiserver",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wait_for(cond, timeout: float, what: str, interval: float = 0.01):
    """Seconds until cond() holds; fatal after `timeout`."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout,
              f"{what}: not within {timeout} s")
        time.sleep(interval)
    return time.perf_counter() - t0


def same_realized(a, b, name: str) -> None:
    """Engine a's realized columns == engine b's per link end, bit for
    bit: the same (pod, uid) ends, and each end's row equal in every
    EdgeState column, src and dst compared as pod names (the two engines
    may hand out rows and pod ids in another order)."""
    check(a._rows.keys() == b._rows.keys(),
          f"{name}: the realized link ends differ "
          f"({len(a._rows)} vs {len(b._rows)})")
    keys = sorted(a._rows)
    sa, sb = a.state, b.state
    ra = torch.as_tensor([a._rows[k] for k in keys], device=sa.uid.device)
    rb = torch.as_tensor([b._rows[k] for k in keys], device=sb.uid.device)
    ids = torch.full((max(a._pod_ids.values(), default=0) + 1,), -1,
                     dtype=torch.long)
    for pod, pid in a._pod_ids.items():
        ids[pid] = b._pod_ids.get(pod, -2)
    ids = ids.to(sa.uid.device)
    for f in dataclasses.fields(sa):
        x = getattr(sa, f.name).index_select(0, ra)
        y = getattr(sb, f.name).index_select(0, rb)
        if f.name in ("src", "dst"):
            x = ids[x.long()].to(y.dtype)
        same(x, y, f"{name}: column {f.name}")
    check(int(sa.active.sum()) == int(sb.active.sum()) == len(keys),
          f"{name}: active rows differ from the realized ends")


def cni_call(cni, command: str, pod: str, port: int, prev=None) -> tuple:
    """One `cni.main` as the kubelet runs the plugin: CNI env, the
    network conf on stdin (the daemon's port in it). Returns (rc,
    stdout, ms)."""
    import contextlib
    import io

    conf = {"cniVersion": "1.0.0", "name": "k8s-pod-network",
            "type": "kubedtn", "daemonPort": port}
    if prev is not None:
        conf["prevResult"] = prev
    env = {"CNI_COMMAND": command,
           "CNI_ARGS": f"IgnoreUnknown=1;K8S_POD_NAMESPACE=default;"
                       f"K8S_POD_NAME={pod}",
           "CNI_NETNS": f"/var/run/netns/{pod}", "CNI_CONTAINERID": pod}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cni.main(stdin_text=json.dumps(conf), env=env)
    return rc, buf.getvalue().strip(), 1e3 * (time.perf_counter() - t0)


def http_get(port: int, path: str) -> tuple:
    """(status, body) of GET http://127.0.0.1:port/path; an HTTP error's
    status and body too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


MGR_SERIES = ("controller_runtime_reconcile_total",
              "controller_runtime_reconcile_errors_total",
              "leader_election_master_status", "controller_synced")


def mgr_series(port: int, identity: str) -> dict:
    """The manager's series on its /metrics, by name (None: absent)."""
    sc = dmn_scrape(port)
    return {name: sc.get((name, f'identity="{identity}"'))
            for name in MGR_SERIES}


def run_manager_phase(dev, card, n_spine=None, n_leaf=None, lpp=None,
                      capacity: int = 1 << 18, verb=None) -> dict:
    """Phase 21(a): the control plane as a cluster runs it. The Clos's
    CRs, unplaced, on the fake apiserver; a node's store, engine (on
    `dev`) and Daemon behind gRPC; a K8sBridge (LIST, then its watch);
    two ControllerManagers electing a leader through the Lease; the CNI
    shim's ADD for every pod, status pushed back, ping, spec edits
    through the watch, a takeover, DEL for every pod. `verb` (a
    callable returning a ManagerVerb) spawns 21(b)'s child as the status
    push starts and finishes it after the LIST back: metrics["verb"]."""
    import copy
    import os
    import shutil
    import tempfile

    from kubedtn_tpu_torch import GROUP_VERSION, cni, entry
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.ops.edge_state import props_row
    from kubedtn_tpu_torch.topology import SimEngine, TopologyStore
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.engine import ping_inputs
    from kubedtn_tpu_torch.topology.k8s import (HttpKubeApi, HttpLeaseApi,
                                                K8sBridge)
    from kubedtn_tpu_torch.topology.manager import (LEADER_ELECTION_ID,
                                                    ControllerManager,
                                                    KubeLeaseStore)
    from kubedtn_tpu_torch.wire.server import Daemon, make_server

    n_spine = n_spine or entry.N_SPINE
    n_leaf = n_leaf or entry.N_LEAF
    lpp = lpp or entry.LINKS_PER_PAIR
    n_rows = 2 * n_spine * n_leaf * lpp
    m = {}
    tmp = tempfile.mkdtemp(prefix="kdt-p21-")
    cni.LOG_PATH = os.path.join(tmp, "cni.log")
    srv = load_fake_apiserver().FakeApiServer(event_window=MGR_EVENTS,
                                              watch_timeout_s=MGR_WATCH_S)
    mgrs, bridge, server, pending = [], None, None, None
    try:
        host, port = srv.start()
        url = f"http://{host}:{port}"
        crs = entry.clos_crs(n_spine, n_leaf, lpp)
        t0 = time.perf_counter()
        for t in crs:   # unplaced: the CNI has not run
            manifest = t.to_manifest()
            manifest.pop("status", None)
            srv.put_object(manifest)
        m["apiserver_load_s"] = time.perf_counter() - t0
        store = TopologyStore()
        engine = SimEngine(store, capacity=capacity, node_ip="10.0.0.1",
                           device=dev)
        engine.warm_kernels()
        daemon = Daemon(engine)
        server, gport = make_server(daemon, port=0, host="127.0.0.1",
                                    log_rpcs=False)
        server.start()
        api = HttpKubeApi(url, timeout_s=MGR_WAIT_S)
        leases = HttpLeaseApi(url)
        bridge = K8sBridge(store, api)
        t0 = time.perf_counter()
        n = bridge.sync_once()
        m["list_s"] = time.perf_counter() - t0
        check(n == len(crs) == len(store.list()),
              f"21(a): the bridge's LIST brought {n} of {len(crs)} CRs")
        bridge.start()
        for i in range(2):
            mgrs.append(ControllerManager(
                store, engine, identity=f"manager-{i}",
                workers=MGR_WORKERS, leader_election=True,
                lease_store=KubeLeaseStore(MGR_NS, HttpLeaseApi(url)),
                lease_duration_s=MGR_LEASE_S, renew_interval_s=MGR_RENEW_S,
                probe_port=0, probe_host="127.0.0.1", metrics_port=0))
        t0 = time.perf_counter()
        for g in mgrs:
            g.start()

        def leaders():
            return [g for g in mgrs if g.status.is_leader]

        def holder():
            return leases.read_namespaced_lease(
                LEADER_ELECTION_ID, MGR_NS)["spec"]["holderIdentity"]

        wait_for(lambda: leaders(), MGR_WAIT_S, "21(a) a leader")
        end = time.perf_counter() + 2 * MGR_RENEW_S
        while time.perf_counter() < end:
            check(len(leaders()) == 1, f"21(a): leaders "
                  f"{[g.identity for g in leaders()]}")
            time.sleep(0.01)
        leader = leaders()[0]
        standby = next(g for g in mgrs if g is not leader)
        check(holder() == leader.identity,
              f"21(a): the Lease names {holder()}, {leader.identity} leads")
        wait_for(lambda: leader.status.synced, MGR_WAIT_S,
                 "21(a) the leader's initial resync")
        m["leader_synced_s"] = time.perf_counter() - t0
        for g in mgrs:
            code, body = http_get(g.probe_port, "/healthz")
            check(code == 200, f"21(a): {g.identity} healthz {code}")
            code, body = http_get(g.probe_port, "/readyz")
            checks = json.loads(body)["checks"]
            check(code == 200 and checks["leader"] == (g is leader)
                  and checks["standby"] == (g is standby)
                  and checks["synced"] == (g is leader),
                  f"21(a): {g.identity} readyz {code} {checks}")
        log(f"21(a) {len(crs)} CRs on the apiserver "
            f"({m['apiserver_load_s']:.3f} s to load), the bridge's LIST "
            f"{m['list_s']:.3f} s; "
            f"{leader.identity} leads, {standby.identity} stands by "
            f"(healthz / readyz 200 both), the leader's first resync "
            f"{m['leader_synced_s']:.3f} s after the start ({card})")

        # the CNI shim's ADD for every pod: the CNI realizes the links
        add_ms = []
        t_first = time.perf_counter()
        for i, t in enumerate(crs):
            prev = {"cniVersion": "1.0.0", "ips": [
                {"address": f"10.244.{i // 250}.{i % 250 + 1}/16"}]}
            rc, out, ms = cni_call(cni, "ADD", t.name, gport, prev)
            check(rc == 0 and json.loads(out) == prev,
                  f"21(a): CNI ADD {t.name}: rc {rc}, stdout {out[:200]}")
            add_ms.append(ms)
        engine.flush()
        _sync(dev)
        m["cni_add_to_rows_s"] = time.perf_counter() - t_first
        m["add_ms_median"] = statistics.median(add_ms)
        check(engine.num_active == n_rows
              and int(engine.state.active.sum()) == n_rows,
              f"21(a): {engine.num_active} rows realized, want {n_rows}")
        wait_for(lambda: all(t.status.links == t.spec.links
                             and t.status.src_ip == "10.0.0.1"
                             for t in store.list()), MGR_WAIT_S,
                 "21(a) every CR's status steady")
        m["reconcile_to_steady_s"] = time.perf_counter() - t_first
        check(leader.status.errors == 0 and standby.status.reconciles == 0,
              f"21(a): leader errors {leader.status.errors}, standby "
              f"reconciles {standby.status.reconciles}")
        # the reference: the same CRs straight through store -> Reconciler
        # into an engine of its own; it launches no kernel
        k1_before = shaping.LAUNCHES["shape_step_rows"]
        t0 = time.perf_counter()
        ref_store = TopologyStore()
        ref = SimEngine(ref_store, capacity=capacity, node_ip="10.0.0.1",
                        device=dev)
        for t in crs:
            ref_store.create(t)
        Reconciler(ref_store, ref).drain()
        ref.flush()
        _sync(dev)
        m["reference_s"] = time.perf_counter() - t0
        check(shaping.LAUNCHES["shape_step_rows"] == k1_before,
              "21(a): the reference build launched K1")
        same_realized(engine, ref, "21(a) the manager + bridge + CNI engine "
                                   "vs store -> Reconciler")
        del ref, ref_store
        log(f"21(a) CNI ADD of {len(crs)} pods (rc 0, prevResult echoed): "
            f"{n_rows} rows realized {m['cni_add_to_rows_s']:.3f} s after "
            f"the first ADD, every CR's status steady (reconcile-to-steady) "
            f"{m['reconcile_to_steady_s']:.3f} s after it, ADD "
            f"{m['add_ms_median']:.3f} ms a pod (median); the realized "
            f"columns == an engine realized straight through store -> "
            f"Reconciler ({m['reference_s']:.3f} s), per link end ({card})")

        # every CR's status pushed back, read back by a LIST
        if verb is not None:
            pending = verb()
        t0 = time.perf_counter()
        pushed = [bridge.push_status(t) for t in store.list()]
        m["status_push_s"] = time.perf_counter() - t0
        check(all(pushed), "21(a): a status push found no object")
        t0 = time.perf_counter()
        items, _rv = api.list_topologies()
        m["list_back_s"] = time.perf_counter() - t0
        # the last Topology write's version (the LIST's own counts the
        # Lease's writes too): the bridge has seen every echo from it on
        rv = max(int(i["metadata"]["resourceVersion"]) for i in items)
        m["echoes_s"] = wait_for(lambda: int(bridge.cluster_rv) >= rv,
                                 MGR_WAIT_S, "21(a) the pushes' echoes")
        by = {(i["metadata"]["namespace"], i["metadata"]["name"]): i
              for i in items}
        for t in store.list():
            got = by[(t.namespace, t.name)]
            check(got["status"] == t.to_manifest()["status"]
                  and got["status"]["net_ns"] == f"/var/run/netns/{t.name}"
                  and GROUP_VERSION in got["metadata"].get("finalizers", []),
                  f"21(a): {t.key}'s status or finalizers not pushed")
        log(f"21(a) {len(pushed)} statuses pushed (and finalizers) in "
            f"{m['status_push_s']:.3f} s, a LIST reads them back in "
            f"{m['list_back_s']:.3f} s, the echoes drained "
            f"{m['echoes_s']:.3f} s after it "
            f"({bridge.stats['echoes_skipped']} skipped) ({card})")
        if pending is not None:
            m["verb"], pending = pending.finish(), None

        # ping over a 10 ms link: K1
        spine = f"spine{n_spine - 1}"
        link = store.get("default", spine).spec.links[0]
        ra = engine.row_of(f"default/{spine}", link.uid)
        rb = engine.row_of(f"default/{link.peer_pod}", link.uid)
        plain_in = ping_inputs(engine.state, (ra, rb), 84.0, link.uid,
                               MGR_PING_SEED)
        _ps, plain = netem.shape_step(clone_state(engine.state), *plain_in)
        r = engine.ping(spine, link.peer_pod, link.uid, seed=MGR_PING_SEED)
        check(r["reachable"] and r["fwd_us"] == r["rev_us"] == 10_000.0
              and r["fwd_us"] == float(plain.depart_us[ra])
              and r["rev_us"] == float(plain.depart_us[rb]),
              f"21(a): ping {r} (10 ms link; plain step "
              f"{float(plain.depart_us[ra])})")
        m["ping"] = r

        def edit(pod: str, props: dict) -> float:
            """A spec change of every link of `pod`, PUT to the apiserver;
            seconds until the engine's rows hold it."""
            path = (f"/apis/{GROUP_VERSION}/namespaces/default/"
                    f"topologies/{pod}")
            body = copy.deepcopy(api._request("GET", path))
            body.pop("status", None)
            for link in body["spec"]["links"]:
                link["properties"] = dict(props)
            want = LinkProperties(**props)
            t0 = time.perf_counter()
            api._request("PUT", path, body)

            def landed():
                t = store.get("default", pod)
                return (t.spec.links[0].properties == want
                        and t.status.links == t.spec.links)

            wait_for(landed, MGR_WAIT_S, f"21(a) {pod}'s edit reconciled")
            engine.flush()
            _sync(dev)
            dt = time.perf_counter() - t0
            rows = [engine.row_of(f"default/{pod}", l["uid"])
                    for l in body["spec"]["links"]]
            got = engine.state.props[rows]
            check(bool((got == torch.as_tensor(
                props_row(want.to_numeric()), device=got.device)).all()),
                f"21(a): {pod}'s rows do not hold its edit")
            return dt

        edits = [(f"leaf{n_leaf // 3}", MGR_EDITS[0]),
                 (f"leaf{2 * n_leaf // 3}", MGR_EDITS[1])]
        m["watch_to_rows_s"] = edit(*edits[0])
        series = mgr_series(leader.metrics_port, leader.identity)
        check(series["leader_election_master_status"] == 1.0
              and series["controller_synced"] == 1.0
              and (series["controller_runtime_reconcile_total"] or 0) > 0
              and series["controller_runtime_reconcile_errors_total"]
              == 0.0, f"21(a): the leader's /metrics {series}")
        m["leader_series"] = series
        log(f"21(a) ping {spine}->{link.peer_pod}: one-way "
            f"{r['fwd_us']} / {r['rev_us']} us == the 10 ms link, == the "
            f"plain step (K1); {edits[0][0]}'s "
            f"{len(store.get('default', edits[0][0]).spec.links)} links "
            f"edited on the apiserver reach the rows in "
            f"{m['watch_to_rows_s']:.3f} s; /metrics {series} ({card})")

        # the takeover
        t0 = time.perf_counter()
        leader.stop()
        wait_for(lambda: standby.status.is_leader, MGR_WAIT_S,
                 "21(a) the standby's takeover")
        m["takeover_s"] = time.perf_counter() - t0
        check(m["takeover_s"] <= MGR_LEASE_S + MGR_RENEW_S
              and holder() == standby.identity,
              f"21(a): takeover {m['takeover_s']:.3f} s (bound "
              f"{MGR_LEASE_S + MGR_RENEW_S} s), the Lease names {holder()}")
        m["new_leader_synced_s"] = wait_for(
            lambda: standby.status.synced, MGR_WAIT_S,
            "21(a) the new leader's resync")
        m["watch_to_rows_after_s"] = edit(*edits[1])
        series = mgr_series(standby.metrics_port, standby.identity)
        check(series["leader_election_master_status"] == 1.0
              and series["controller_synced"] == 1.0,
              f"21(a): the new leader's /metrics {series}")
        log(f"21(a) {leader.identity} stopped: {standby.identity} holds the "
            f"Lease {m['takeover_s']:.3f} s later (bound "
            f"{MGR_LEASE_S + MGR_RENEW_S} s), resynced in "
            f"{m['new_leader_synced_s']:.3f} s, reconciles "
            f"{edits[1][0]}'s edit in {m['watch_to_rows_after_s']:.3f} "
            f"s ({card})")

        # the CNI shim's DEL for every pod
        del_ms = []
        t0 = time.perf_counter()
        for t in crs:
            rc, out, ms = cni_call(cni, "DEL", t.name, gport)
            check(rc == 0 and out == "",
                  f"21(a): CNI DEL {t.name}: rc {rc}, stdout {out[:200]}")
            del_ms.append(ms)
        engine.flush()
        _sync(dev)
        m["teardown_s"] = time.perf_counter() - t0
        m["del_ms_median"] = statistics.median(del_ms)
        check(engine.num_active == 0 and int(engine.state.active.sum()) == 0,
              f"21(a): {engine.num_active} rows left after DEL")
        m["bridge"] = dict(bridge.stats)
        m["reconciles"] = {g.identity: g.status.reconciles for g in mgrs}
        log(f"21(a) CNI DEL of {len(crs)} pods: 0 rows left after "
            f"{m['teardown_s']:.3f} s, DEL {m['del_ms_median']:.3f} ms a "
            f"pod (median); bridge {m['bridge']}, reconciles "
            f"{m['reconciles']} ({card})")
    finally:
        if pending is not None:
            pending.kill()
        for g in mgrs:
            g.stop()
        if bridge is not None:
            bridge.stop()
        if server is not None:
            server.stop(0)
        srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return m


MGR_READY = re.compile(r"^kubedtn-tpu manager: probes on :(\d+) "
                       r"\(healthz/readyz\), metrics on :(\d+)/metrics$")


class ManagerVerb:
    """Phase 21(b): `python -m kubedtn_tpu_torch.cli manager
    --leader-elect --probe-port 0 --metrics-port 0` as a child process
    (no --device: the card; `child_device` adds one for a CPU
    rehearsal), spawned at construction (the card's compute processes
    and free memory read just before); finish() checks its ready line,
    healthz / readyz 200, /metrics, its memory on the card, SIGINT and
    exit 0. Phase 21 spawns it while 21(a) pushes statuses, which moves
    no memory on the card."""

    def __init__(self, dev, card, child_device=None) -> None:
        import os
        import tempfile

        root = os.path.dirname(os.path.abspath(__file__))
        self.dev, self.card = dev, card
        self.tmp = tempfile.mkdtemp(prefix="kdt-p21b-")
        args = ["--leader-elect", "--probe-port", "0", "--metrics-port",
                "0"]
        if child_device:
            args += ["--device", child_device]
        self.before = _card_apps(dev)
        self.child = DaemonChild(args, os.path.join(self.tmp, "manager.err"),
                                 root, verb="manager", ready=MGR_READY,
                                 tag="21(b)")

    def finish(self) -> dict:
        import signal

        child, m = self.child, {}
        try:
            m["ready_line_s"] = child.wait_ready(MGR_WAIT_S)
            probe, metrics = child.ports
            wait_for(lambda: http_get(probe, "/readyz")[0] == 200,
                     MGR_WAIT_S, "21(b) readyz")
            m["boot_to_ready_s"] = time.perf_counter() - child.t0
            check(http_get(probe, "/healthz")[0] == 200, "21(b): healthz")
            sc = dmn_scrape(metrics)
            got = {name for name, _labels in sc}
            check(set(MGR_SERIES) <= got and 1.0 in [
                v for (name, _l), v in sc.items()
                if name == "leader_election_master_status"],
                f"21(b): /metrics lacks the manager's series: {sorted(got)}")
            m["on_card"] = _child_on_card(child.proc.pid, self.dev,
                                          self.before, tag="21(b)")
            child.send_term(signal.SIGINT)
            m["exit_s"] = child.wait_exit(MGR_WAIT_S)
            log(f"21(b) `tpudtn-torch manager --leader-elect --probe-port 0 "
                f"--metrics-port 0`: ready line {m['ready_line_s']:.1f} s, "
                f"readyz 200 {m['boot_to_ready_s']:.1f} s after the spawn, "
                f"healthz 200, /metrics with the manager's series; "
                f"{m['on_card']}; SIGINT: exit 0 in {m['exit_s']:.2f} s "
                f"({self.card})")
        finally:
            self.kill()
        return m

    def kill(self) -> None:
        import shutil

        self.child.kill()
        shutil.rmtree(self.tmp, ignore_errors=True)


def run_ladder_phase(dev, card, timer=None, sizes=None) -> tuple:
    """Phase 21(c): scenarios.LADDER's six BASELINE rungs in this
    process at their JAX defaults (`sizes` overrides their arguments
    for a rehearsal), K1's launches counted from 0 around each; then
    K1 over scale_1m's 2^21-row state against its plain version on the
    rung's keyed draws, and timed (with `timer`) against its bound.
    Returns (metrics, K1 launches by rung)."""
    from kubedtn_tpu_torch import scenarios
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    sizes = sizes or {}
    out, k1 = {}, {}
    keep = {}
    card_k1 = int(dev.type == "cuda")    # K1 launches only on the card
    for name in LADDER_RUNGS:
        kw = dict(sizes.get(name, {}))
        if name == "scale_1m":
            kw["keep"] = keep
        shaping.reset_launches()
        t0 = time.perf_counter()
        r = scenarios.LADDER[name](device=dev, **kw)
        _sync(dev)
        k1[name] = shaping.LAUNCHES["shape_step_rows"]
        r["phase_s"] = time.perf_counter() - t0
        check(set(r) - {"phase_s"} == RUNG_KEYS[name] | {"device"},
              f"21(c) {name}: keys {sorted(r)}")
        out[name] = r
        log(f"21(c) {name}: {json.dumps(r)}; K1 launches {k1[name]} "
            f"({card})")
    rs = out["3node"]
    check(rs["reachable"] and rs["links"] == 4
          and rs["pings"]["sat-a<->sat-b"] == 80_000.0
          and k1["3node"] == card_k1 * len(rs["pings"]),
          f"21(c) 3node: {rs}, K1 {k1['3node']}")
    for name, k_slots in (("fat_tree_64", 8), ("clos_100k", 2)):
        r = out[name]
        steps = round(r["sim_time_s"] * 1e3)
        check(r["tx_packets"] >= r["rx_packets"] > 0
              and k1[name] == card_k1 * steps * k_slots,
              f"21(c) {name}: tx {r['tx_packets']} rx {r['rx_packets']}, "
              f"K1 {k1[name]} (want {steps * k_slots})")
    r = out["churn_1k"]
    check(k1["churn_1k"] == 0 and r["churn_links_total"] > 0,
          f"21(c) churn_1k: {r}")
    r = out["reconcile_100k"]
    check(r["directed_rows"] == 2 * r["links"] and r["grpc_ok"]
          and r["spot_check_latency_us"] == 20_000.0
          and k1["reconcile_100k"] == card_k1,
          f"21(c) reconcile_100k: {r}")
    r = out["scale_1m"]
    st = keep["state"]
    check(int(st.active.sum()) == r["directed_rows"]
          and st.capacity == r["capacity"]
          and k1["scale_1m"] == card_k1 * 2 * sizes.get(
              "scale_1m", {}).get("shape_iters", 10),
          f"21(c) scale_1m: {r}, K1 {k1['scale_1m']}")
    # K1 over the rung's state, the rung's keyed draws, vs plain
    E = st.capacity
    fill = torch.full((E,), 1500.0, dtype=torch.float32, device=dev)
    t_arr = torch.zeros((E,), dtype=torch.float32, device=dev)
    k_st, p_st = clone_state(st), clone_state(st)
    for i in range(RUNG_CHECK_STEPS):
        u = torch.rand((E, netem.NU), dtype=torch.float32, device=dev,
                       generator=scenarios._keyed_generator(dev, 9, i))
        k_st, dep, fl = shaping.shape_step_flags(k_st, fill, st.active,
                                                 t_arr, u, donate=True)
        p_st, p_res = netem._shape_step_from_u(p_st, fill, st.active,
                                               t_arr, u)
        _sync(dev)
        same((dep, fl, k_st), (p_res.depart_us, shaping.pack_flags(p_res),
                               p_st), f"21(c) K1 step {i} at {E} rows vs "
                                      f"plain")
    k1m = {"rows": E, "steps": RUNG_CHECK_STEPS, "max_abs_err": 0.0}
    if timer is not None and dev.type == "cuda":
        args = (st, fill, st.active, t_arr, u)
        k1m["ms"] = timer.ms(lambda: shaping.shape_step_flags(
            *args, donate=False))
        k1m["plain_ms"] = timer.ms(lambda: netem._shape_step_from_u(*args),
                                   reps=5)
        moved = nbytes(st.props, st.corr, u, st.tokens, st.t_last,
                       st.backlog_until, st.pkt_count, fill, t_arr,
                       st.active, dep, fl, k_st.tokens, k_st.t_last,
                       k_st.backlog_until, k_st.corr, k_st.pkt_count)
        k1m["bound_ms"], k1m["bound_by"] = bound_ms(moved, OPS_K1 * E)
        k1m["bytes"] = moved
        log(f"21(c) K1 at {E} rows: {k1m['ms'] * 1e3:.2f} us against a "
            f"bound of {k1m['bound_ms'] * 1e3:.2f} us ({k1m['bound_by']}); "
            f"plain {k1m['plain_ms']:.3f} ms ({card})")
    log(f"21(c) K1 over scale_1m's {E} rows == the plain step, bit for "
        f"bit, {RUNG_CHECK_STEPS} steps on the rung's keyed draws ({card})")
    out["k1_2m"] = k1m
    return out, k1


def _free_card(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _card_apps(dev):
    """(nvidia-smi's compute processes as [pid, used memory] rows, the
    card's free bytes); (None, None) off the card."""
    import subprocess

    if dev.type != "cuda":
        return None, None
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout
    rows = [[x.strip() for x in l.split(",")] for l in out.splitlines()
            if l.strip()]
    return rows, torch.cuda.mem_get_info(dev)[0]


def _child_on_card(pid: int, dev, before, tag: str = "20(b)") -> str:
    """Where the child holds memory on the card: its pid among
    nvidia-smi's compute processes, or, where a container's pid
    namespace shows other pids, one compute process more than before
    the child started and the card's free memory down by its share."""
    if dev.type != "cuda":
        return "the child on the CPU (--device cpu)"
    rows0, free0 = before
    rows, free = _card_apps(dev)
    mine = [r for r in rows if r[0] == str(pid)]
    if mine:
        return f"the child's pid {pid} holds {mine[0][1]} on the card"
    drop = free0 - free
    check(len(rows) == len(rows0) + 1 and drop >= 256 << 20,
          f"{tag}: the child (pid {pid}) holds no memory on the card: "
          f"compute processes {rows0} before, {rows} after, free memory "
          f"down {drop} bytes")
    return (f"nvidia-smi lists {len(rows)} compute processes, one more "
            f"than before the child ({rows}; pids of another namespace), "
            f"the card's free memory down {drop / 2**20:.0f} MiB")


# -- phase 22: the scale path: the sharded step and the sharded router -------

SH_SHARDS = (2, 4, 8)       # 22(a): virtual shards of the one card
SH_STEPS = 3                # 22(a): sharded steps per shard count
SH_BATCH = 1000             # 22(a): scattered UpdateLinks rows a step
SR_SHARDS = 4               # 22(b): virtual shards of the sharded router
SR_STEPS = 10               # 22(b): routed steps, sharded and unsharded
#                             (20 until its first card run, PERF.md §4)
SR_BUDGET = 1 << 16         # 22(b): transit packets one (source,
#                             destination) shard pair may carry a step: a
#                             [4, 2^16, 4] f32 send buffer a shard (4 MiB),
#                             above a step's transit packets of a shard
SR_OVERFLOW_STEPS = 5       # 22(c): steps at JAX's default budget
SR_OVERFLOW_BUDGET = None   # 22(c): None = JAX's max(8 k_fwd, 16) = 64
DRYRUN_SHARDS = 8           # 22(d)
SCALE_RUNGS = ("routes_10k", "chaos_flaps", "reconverge_10k")
# 22(e): the rungs' events cut to 2 each (from JAX's 3, 4 and 4) to pay
# for the phase (PERF.md §4)
SCALE_RUNG_KW = {"routes_10k": {"events": 2}, "chaos_flaps": {"events": 2},
                 "reconverge_10k": {"events": 2}}


def scale_step_part(el, fresh, dev, card) -> tuple:
    """22(a): the sharded simulation step (parallel/sharded.py) on the
    churned Clos at S = 2, 4 and 8 virtual shards of the card, each step
    a 1,000-row scattered UpdateLinks batch and the drop-in step on every
    active row, against update_links + shape_step_auto's K1 route + the
    node counters on the whole state, on the same uniforms. Returns
    (metrics, K1 launches of the sharded steps)."""
    from kubedtn_tpu_torch import convert
    from kubedtn_tpu_torch.models.topologies import random_link_props
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel.mesh import make_mesh, shard_edge_state
    from kubedtn_tpu_torch.parallel.sharded import (make_node_stats_fn,
                                                    make_sharded_step)

    E, n_rows, n = fresh.capacity, 2 * el.n_links, el.n_nodes
    card_k1 = int(dev.type == "cuda")
    rng = np.random.default_rng(22)
    sizes = torch.full((E,), 1500.0, dtype=torch.float32, device=dev)
    t_arr = torch.zeros((E,), dtype=torch.float32, device=dev)
    stats_whole = make_node_stats_fn(make_mesh([dev]), n)
    out, launches = {}, 0
    for S in SH_SHARDS:
        mesh = make_mesh([dev] * S)
        step = make_sharded_step(mesh, n)
        shards = shard_edge_state(fresh, mesh)
        whole = clone_state(fresh)
        gen = torch.Generator(device=dev).manual_seed(220 + S)
        walls_s, walls_u, delivered = [], [], 0
        for i in range(SH_STEPS):
            rows = np.sort(rng.choice(n_rows, SH_BATCH, replace=False)
                           ).astype(np.int32)
            props = random_link_props(SH_BATCH, 100 * S + i)
            valid = np.ones(SH_BATCH, dtype=bool)
            have = whole.active.clone()
            u = torch.rand((E, netem.NU), generator=gen, device=dev)
            _sync(dev)
            k0 = shaping.LAUNCHES["shape_step_rows"]
            t0 = time.perf_counter()
            shards, res, stats = step(shards, rows, props, valid, sizes,
                                      have, t_arr, u=u)
            _sync(dev)
            walls_s.append(time.perf_counter() - t0)
            k = shaping.LAUNCHES["shape_step_rows"] - k0
            check(k == card_k1 * S, f"22(a) S={S}: {k} K1 launches a step, "
                                    f"want {S}")
            launches += k
            t0 = time.perf_counter()
            whole = es.update_links(whole, rows, props, valid)
            whole, res_u = shaping.shape_step(whole, sizes, have, t_arr, u,
                                              donate=True)
            stats_u = stats_whole([whole.src], [whole.dst],
                                  [res_u.delivered], [sizes],
                                  [res_u.dropped_loss | res_u.dropped_queue])
            _sync(dev)
            walls_u.append(time.perf_counter() - t0)
            name = f"22(a) S={S} step {i}"
            same(convert.unshard(shards), whole, f"{name} state")
            same(convert.unshard(res), res_u, f"{name} ShapeResult")
            same(stats, stats_u, f"{name} NodeStats")
            d = int(res_u.delivered.sum())
            check(d > 0 and float(stats.tx_packets.double().sum()) == d,
                  f"{name}: tx_packets {float(stats.tx_packets.sum())} vs "
                  f"{d} delivered")
            delivered += d
        out[S] = {"ms_per_step_sharded": 1e3 * statistics.median(walls_s),
                  "ms_per_step_unsharded": 1e3 * statistics.median(walls_u),
                  "delivered": delivered}
        log(f"22(a) sharded step on {S} virtual shards: state, ShapeResult "
            f"and NodeStats == update_links + K1 + node sums on the whole "
            f"state, bit for bit, {SH_STEPS} steps of a {SH_BATCH}-row "
            f"scattered batch ({delivered} packets delivered); K1 {S} a "
            f"step; ms per step sharded "
            f"{out[S]['ms_per_step_sharded']:.3f}, unsharded "
            f"{out[S]['ms_per_step_unsharded']:.3f} ({card})")
    return out, launches


def transit_books(o, spec, steps: int, name: str) -> dict:
    """The routed fabric's per-edge books and transit balance (as phase
    11): every packet delivered out of an edge reached its node, was
    re-injected, waits in a pending lane or was dropped by cause."""
    from kubedtn_tpu_torch import sim

    check(not bool(sim.conservation_residual(o.sim).any()),
          f"{name}: an edge's books do not close")
    c = o.sim.counters
    sourced = steps * int((spec.mode == 1).sum())
    reinjected = float(c.tx_packets.double().sum()) - sourced
    pending = int((o.pend_dst >= 0).sum())
    balance = (float(o.node_rx_packets.double().sum()) + reinjected
               + pending + float(o.fwd_dropped) + float(o.no_route_dropped))
    check(float(c.rx_packets.double().sum()) == balance,
          f"{name}: transit packets are unaccounted for")
    return {"reinjected": reinjected, "pending": pending,
            "fwd_dropped": float(o.fwd_dropped),
            "no_route_dropped": float(o.no_route_dropped),
            "node_rx_packets": float(o.node_rx_packets.double().sum())}


def scale_router_part(el, fresh, dev, card, routed=None) -> tuple:
    """22(b)-(c): the sharded router (parallel/router.py) on phase 11's
    routed fabric (`routed` = its (rs, spec, flow_dst), else built the
    same way) on SR_SHARDS virtual shards, fed the unsharded run's draws
    sliced per shard: every leaf == run_routed's, bit for bit, and so
    does the same over the plain step; then JAX's default budget, which
    overflows. Returns (metrics, K1 launches of the sharded steps)."""
    from kubedtn_tpu_torch import entry, router, sim
    from kubedtn_tpu_torch.models import traffic
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import router as prouter
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    if routed is None:
        leaves = np.arange(entry.N_SPINE, el.n_nodes)
        rs, spec, flow_dst, _ = entry.build_routed(
            el, fresh, leaves, seed=31, rate_bps=ROUTED_RATE_BPS, q=SIM_Q,
            k_fwd=ROUTED_K_FWD, max_hops=ROUTE_HOPS)
    else:
        rs, spec, flow_dst = routed
    m = {}
    n = el.n_nodes
    k_shape = SIM_K + ROUTED_K_FWD
    card_k1 = int(dev.type == "cuda")
    gen = torch.Generator(device=dev).manual_seed(222)
    dt = sim.as_dt(SIM_DT_US, dev)
    draws = [sim.StepDraws(
        traffic=traffic.draw(spec, dt, SIM_K, gen),
        shape_u=queues.draw_shape_uniforms(rs.sim.edges, k_shape, gen))
        for _ in range(SR_STEPS)]
    mesh = make_mesh([dev] * SR_SHARDS)
    per_shard = [prouter.shard_draws(d, mesh) for d in draws]

    _sync(dev)
    t0 = time.perf_counter()
    want = router.run_routed(rs, spec, flow_dst, SR_STEPS, SIM_DT_US, SIM_K,
                             ROUTED_K_FWD, draws=draws)
    _sync(dev)
    m["ms_per_step_unsharded"] = 1e3 * (time.perf_counter() - t0) / SR_STEPS

    def sharded(budget, steps, shape_fn=queues.shape_packets):
        step = prouter.make_sharded_router_step(
            mesh, n, k_slots=SIM_K, k_fwd=ROUTED_K_FWD, budget=budget)
        shards = prouter.shard_router_state(rs, mesh)
        for i in range(steps):
            shards = step(shards, spec, flow_dst, None, SIM_DT_US,
                          draws=per_shard[i], shape_fn=shape_fn)
        return prouter.gather_router_state(shards)

    k0 = shaping.LAUNCHES["shape_step_rows"]
    _sync(dev)
    t0 = time.perf_counter()
    got = sharded(SR_BUDGET, SR_STEPS)
    _sync(dev)
    m["ms_per_step_sharded"] = 1e3 * (time.perf_counter() - t0) / SR_STEPS
    launches = shaping.LAUNCHES["shape_step_rows"] - k0
    check(launches == card_k1 * SR_SHARDS * k_shape * SR_STEPS,
          f"22(b): {launches} K1 launches, want {SR_SHARDS} x {k_shape} x "
          f"{SR_STEPS}")
    same(got, want, f"22(b) sharded router on {SR_SHARDS} virtual shards "
                    f"vs run_routed")
    k1 = shaping.LAUNCHES["shape_step_rows"]
    plain = sharded(SR_BUDGET, SR_STEPS, shape_fn=queues.shape_packets_plain)
    check(shaping.LAUNCHES["shape_step_rows"] == k1,
          "22(b): the plain sharded router launched K1")
    same(plain, got, "22(b) sharded router over the plain step vs K1")
    books = transit_books(got, spec, SR_STEPS, "22(b) sharded router")
    want_books = transit_books(want, spec, SR_STEPS, "22(b) run_routed")
    check(books == want_books, "22(b): the books differ from run_routed's")
    exchanged = books["reinjected"] + books["pending"] + books["fwd_dropped"]
    check(exchanged > 0, "22(b): no packet crossed the all-to-all")
    m.update(books=books, budget=SR_BUDGET,
             send_bytes_per_shard=SR_SHARDS * SR_BUDGET * 4 * 4,
             exchanged_per_step=exchanged / SR_STEPS)
    log(f"22(b) sharded router, {SR_STEPS} steps x {k_shape} slots on "
        f"{SR_SHARDS} virtual shards, budget {SR_BUDGET} "
        f"({m['send_bytes_per_shard']} B of send buffer a shard): every "
        f"leaf == run_routed on the same draws, and == the same over the "
        f"plain step, bit for bit; {launches} K1 launches; transit books "
        f"closed; {m['exchanged_per_step']:.1f} packets through the "
        f"all-to-all a step, {books['fwd_dropped']:.0f} lane overflows "
        f"(as run_routed); ms per step sharded "
        f"{m['ms_per_step_sharded']:.3f}, unsharded "
        f"{m['ms_per_step_unsharded']:.3f} ({card})")

    # (c) JAX's default budget: the exchange overflows, counted
    default = (max(ROUTED_K_FWD * 8, 16) if SR_OVERFLOW_BUDGET is None
               else SR_OVERFLOW_BUDGET)
    k0 = shaping.LAUNCHES["shape_step_rows"]
    over = sharded(default, SR_OVERFLOW_STEPS)
    launches += shaping.LAUNCHES["shape_step_rows"] - k0
    ob = transit_books(over, spec, SR_OVERFLOW_STEPS,
                       "22(c) sharded router at budget 64")
    ref = router.run_routed(rs, spec, flow_dst, SR_OVERFLOW_STEPS,
                            SIM_DT_US, SIM_K, ROUTED_K_FWD,
                            draws=draws[:SR_OVERFLOW_STEPS])
    lane_drops = float(ref.fwd_dropped)
    check(ob["fwd_dropped"] > lane_drops,
          f"22(c): budget {default} dropped {ob['fwd_dropped']} packets, "
          f"no more than the lanes' {lane_drops}")
    m["overflow"] = dict(ob, budget=default, steps=SR_OVERFLOW_STEPS,
                         lane_drops_unsharded=lane_drops)
    log(f"22(c) at JAX's default budget {default}: {ob['fwd_dropped']:.0f} "
        f"packets counted in fwd_dropped over {SR_OVERFLOW_STEPS} steps "
        f"(run_routed's lanes drop {lane_drops:.0f}); the books close "
        f"({card})")
    return m, launches


def run_scale_phase(el, fresh, dev, card, routed=None,
                    rung_kw=None) -> tuple:
    """Phase 22: the scale path. (a) the sharded step, (b)-(c) the
    sharded router, (d) entry.dryrun_multichip, (e) the routing rungs
    (`rung_kw` overrides their arguments for a rehearsal). K1's launches
    are counted from 0 around each part. Returns (metrics, K1 launches
    by path: sharded_step, sharded_router, rungs)."""
    import contextlib
    import io

    from kubedtn_tpu_torch import entry, scenarios
    from kubedtn_tpu_torch.ops.cuda import shaping

    m, k1 = {}, {}
    t0 = time.perf_counter()
    m["a"], k1["sharded_step"] = scale_step_part(el, fresh, dev, card)
    m["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m["b"], k1["sharded_router"] = scale_router_part(el, fresh, dev, card,
                                                     routed)
    m["b_s"] = time.perf_counter() - t0

    # (d) the dryrun on 8 virtual shards of the card
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dr = entry.dryrun_multichip(DRYRUN_SHARDS, device=dev)
    line = buf.getvalue().strip()
    check(dr["delivered"] > 0 and dr["tx_packets"] == dr["delivered"]
          and line == f"dryrun_multichip({DRYRUN_SHARDS}): OK — "
                      f"{dr['delivered']} packets shaped across "
                      f"{DRYRUN_SHARDS} shards, psum'd node counters "
                      f"consistent", f"22(d): {dr}, {line!r}")
    m["d"] = dict(dr, s=time.perf_counter() - t0)
    log(f"22(d) {line} ({card})")

    # (e) the routing rungs at JAX's default widths
    rung_kw = SCALE_RUNG_KW if rung_kw is None else rung_kw
    card_k1 = int(dev.type == "cuda")
    m["e"], rung_k1 = {}, {}
    for name in SCALE_RUNGS:
        shaping.reset_launches()
        t0 = time.perf_counter()
        r = scenarios.LADDER[name](device=dev, **rung_kw.get(name, {}))
        _sync(dev)
        rung_k1[name] = shaping.LAUNCHES["shape_step_rows"]
        r["phase_s"] = time.perf_counter() - t0
        check(set(r) - {"phase_s"} == RUNG_KEYS[name] | {"device"},
              f"22(e) {name}: keys {sorted(r)}")
        m["e"][name] = r
        log(f"22(e) {name}: {json.dumps(r)}; K1 launches {rung_k1[name]} "
            f"({card})")
    r = m["e"]["routes_10k"]
    check(rung_k1["routes_10k"] == 0 and 0 < r["reachable_frac"] <= 1,
          f"22(e) routes_10k: {r}, K1 {rung_k1['routes_10k']}")
    r = m["e"]["reconverge_10k"]
    check(rung_k1["reconverge_10k"] == 0
          and r["matches_full_recompute"] is True,
          f"22(e) reconverge_10k: {r}, K1 {rung_k1['reconverge_10k']}")
    r = m["e"]["chaos_flaps"]
    kw = rung_kw.get("chaos_flaps", {})
    events = kw.get("events", 4)
    steps = kw.get("steps_per_event", 30) * (1 + 2 * events)
    slots = 2 + ROUTED_K_FWD     # the rung's k_slots at 2 Mbit/s, k_fwd
    check(rung_k1["chaos_flaps"] == card_k1 * slots * steps
          and r["traffic_survived_every_outage"] and r["baseline_rx"] > 0,
          f"22(e) chaos_flaps: {r}, K1 {rung_k1['chaos_flaps']} (want "
          f"{slots} x {steps})")
    log(f"22(e) routes_10k and reconverge_10k launch no kernel (route "
        f"recomputes only); chaos_flaps K1 {rung_k1['chaos_flaps']} = "
        f"{slots} slots x {steps} steps ({card})")
    k1["rungs"] = rung_k1["chaos_flaps"]
    m["rung_k1_launches"] = rung_k1
    return m, k1



# Phase 23: the live-plane soaks at JAX's widths; only their durations
# are cut (JAX's defaults in the comments, PERF.md §4).
SOAK_CUTS = {
    "live_plane": dict(rounds=2),                        # 5 rounds
    "live_plane_soak": dict(seconds=3.0, window_s=1.0,   # 20 s, 2.5 s,
                            settle_s=15.0),              # settle <= 90 s
    "chaos_soak": dict(seconds=3.0),                     # 12 s
    "staged_update_soak": dict(steady_s=1.5,             # 3 s
                               staging_s=1.5,            # 3 s
                               gate_ticks=60),           # 120 ticks
    "update_under_flap": dict(seconds=3.0,               # 5 s
                              gate_ticks=50),            # 100 ticks
}
# (phase 24 cut live_plane_soak 5 -> 3 s, chaos_soak 4 -> 3 s and the
# gates 120 -> 60 and 100 -> 50 ticks, PERF.md §4)
SOAK_TBF = dict(rate="2Gbit", chunk=512)    # bench.py's TBF soak


class GateLog:
    """While installed, records every update gate's inputs and verdict:
    updates.gate.verify_plan, which verify_plan_live calls with the
    snapshot it took of the running plane."""

    def __enter__(self) -> "GateLog":
        from kubedtn_tpu_torch.updates import gate

        real = self._real = gate.verify_plan
        self.calls = []

        def recorded(plan, snapshot, **kw):
            verdict = real(plan, snapshot, **kw)
            self.calls.append(types.SimpleNamespace(
                plan=plan, snapshot=snapshot, kw=kw, verdict=verdict))
            return verdict

        gate.verify_plan = recorded
        return self

    def __exit__(self, *exc) -> None:
        from kubedtn_tpu_torch.updates import gate

        gate.verify_plan = self._real


def _gate_launches(calls, gate_ticks: int, label: str) -> int:
    """K1 launches the gates of `calls` make: one sweep each of
    `gate_ticks` steps, one launch a shaping slot and step."""
    from kubedtn_tpu_torch.updates import Guardrails

    k_slots = Guardrails().k_slots
    for c in calls:
        check(c.verdict.ticks == gate_ticks and c.verdict.replicas > 0,
              f"{label}: a gate swept {c.verdict.replicas} replicas for "
              f"{c.verdict.ticks} ticks, want a sweep of {gate_ticks}")
    return len(calls) * gate_ticks * k_slots


def sweep_k1_vs_plain(snapshot, scenarios, kw: dict, on_card: bool,
                      label: str) -> tuple:
    """Sweep `scenarios` on `snapshot` (run_sweep's keywords `kw`)
    through K1 (queues.shape_packets) and through the plain version
    (shape_packets_plain) on the same seed: every metric of both equal
    bit for bit (JSON-equal), K1 launched once a shaping slot and step
    on the card. Returns (the sweep through K1, its K1 launches)."""
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.twin import run_sweep

    k0 = shaping.LAUNCHES["shape_step_rows"]
    kern = run_sweep(snapshot, scenarios, shape_fn=queues.shape_packets,
                     **kw)
    launches = shaping.LAUNCHES["shape_step_rows"] - k0
    plain = run_sweep(snapshot, scenarios,
                      shape_fn=queues.shape_packets_plain, **kw)
    want = on_card * kw["steps"] * kw["k_slots"]
    check(launches == want, f"{label}: the replayed sweep launched K1 "
                            f"{launches} times, want {want}")
    same_m = [json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
              for a, b in zip(kern.metrics, plain.metrics)]
    check(kern.names == plain.names and len(same_m) == len(scenarios)
          and all(same_m),
          f"{label}: the sweep through K1 != the plain version "
          f"(replicas equal: {same_m})")
    return kern, launches


def replay_gate_sweep(call, on_card: bool, label: str) -> dict:
    """Sweep a recorded gate's scenarios (GateLog) on its own snapshot
    again through K1 and through the plain version (sweep_k1_vs_plain),
    the baseline equal to the gate's own."""
    from kubedtn_tpu_torch.updates.gate import gate_scenarios

    pod_ids = call.kw["pod_ids"]
    scen, _adds, _edits = gate_scenarios(call.plan, call.snapshot,
                                         pod_ids=pod_ids)
    g = call.kw["guardrails"]
    kern, launches = sweep_k1_vs_plain(
        call.snapshot, scen, dict(steps=g.ticks, dt_us=g.dt_us, seed=g.seed,
                                  k_slots=g.k_slots, pod_ids=pod_ids),
        on_card, label)
    check(kern.metrics[0]["p99_us"] == call.verdict.baseline["p99_us"],
          f"{label}: the replayed baseline p99 {kern.metrics[0]['p99_us']} "
          f"!= the gate's {call.verdict.baseline['p99_us']}")
    return {"replicas": kern.replicas, "ticks": g.ticks,
            "k_slots": g.k_slots,
            "rows": int(call.snapshot.sim.edges.capacity),
            "k1_compare_launches": launches}


def run_soak_phase(dev, card) -> tuple:
    """Phase 23: the five live-plane scenarios through their entry
    points (scenarios.LADDER) on `dev` at JAX's widths, SOAK_CUTS
    cutting their durations; then K1 on the update gates'
    sweeps, counted from 0 around (d) and (e), and the regressing gate's
    sweep replayed through K1 and through its plain version. Returns
    (metrics, K1 launches of (d) and (e))."""
    from kubedtn_tpu_torch import scenarios
    from kubedtn_tpu_torch.ops.cuda import shaping

    on_card = dev.type == "cuda"
    m = {}

    def run(name, **kw):
        t0 = time.perf_counter()
        r = scenarios.LADDER[name](device=dev, **SOAK_CUTS[name], **kw)
        r["phase_s"] = time.perf_counter() - t0
        check(r["device"] == str(dev), f"23 {name} ran on {r['device']}")
        return r

    # (a) rounds of frames from the injector child over InjectBulk
    r = m["a"] = run("live_plane")
    want = r["pairs"] * -(-r["frames_per_wire"] // scenarios.INJECTOR_CHUNK) \
        * scenarios.INJECTOR_CHUNK
    check(r["dropped"] == 0 and r["tick_errors"] == 0
          and r["frames_delivered"] == want,
          f"23(a) live_plane: delivered {r['frames_delivered']} of {want}, "
          f"dropped {r['dropped']}, tick errors {r['tick_errors']}")
    log(f"23(a) live_plane {r['pairs']} pairs x {r['frames_per_wire']} "
        f"frames at {r['latency']}: median {r['frames_per_s']:.1f} "
        f"frames/s, best {r['frames_per_s_best']:.1f}, rounds "
        f"{r['rounds_frames_per_s']}, injector "
        f"{r['inject_frames_per_s']:.1f} frames/s; {r['ticks']} ticks, "
        f"{r['phase_s']:.1f} s ({card})")

    # (b) the sustained soak, over latency wires and over TBF wires
    for key, kw in (("b_latency", {}), ("b_tbf", SOAK_TBF)):
        r = m[key] = run("live_plane_soak", **kw)
        check(r["windows_frames_per_s"]
              and all(w > 0 for w in r["windows_frames_per_s"])
              and r["dropped"] == 0 and r["tick_errors"] == 0,
              f"23(b) live_plane_soak {r['shaping']}: windows "
              f"{r['windows_frames_per_s']}, dropped {r['dropped']}, tick "
              f"errors {r['tick_errors']}")
        log(f"23(b) live_plane_soak {r['shaping']} chunk "
            f"{r['injector_chunk']}: windows {r['windows_frames_per_s']} "
            f"frames/s, sustained {r['sustained_frames_per_s']:.1f}, "
            f"flatness {r['flatness']}, end backlog "
            f"{r['end_ingress_backlog']}, settle {r['settle_s']} s, gc "
            f"{r['gc_pause_s']} s, steal {r['host_steal_s']} s, stage "
            f"shares {r['stage_breakdown']['share']}, "
            f"{r['stage_breakdown']['ticks']} ticks; {r['phase_s']:.1f} s "
            f"({card})")

    # (c) zero loss and a cross-node trace under a flapping peer
    r = m["c"] = run("chaos_soak")
    check(r["frames_lost"] == 0 and r["peer_buffer_dropped"] == 0
          and r["shaping_dropped"] == 0 and r["tick_errors"] == 0,
          f"23(c) chaos_soak lost frames: {json.dumps(r)}")
    check(r["breaker_cycles"] >= 1
          and r["injected_faults"]["peer_blackhole"] > 0,
          f"23(c) chaos_soak: breaker {r['breaker']}, faults "
          f"{r['injected_faults']}")
    check(r["trace_ok"] and len(r["trace_nodes"]) == 2
          and all(s in r["trace_stages"] for s in (
              "ingress", "outage-buffered", "retried", "peer-sent",
              "received")),
          f"23(c) chaos_soak trace: {r['trace_stages']} on "
          f"{r['trace_nodes']}, sampled {r['sampled_frames']}, breaker "
          f"{r['breaker']}")
    log(f"23(c) chaos_soak {r['pairs']} pairs, "
        f"{r['offered_frames_per_s']} frames/s offered, "
        f"{r['flap_hz']} Hz at {r['duty_down']:.0%} down: "
        f"{r['frames_fed']} fed, {r['frames_delivered']} delivered, 0 "
        f"lost; windows {r['windows_frames_per_s']}, sustained "
        f"{r['sustained_under_flap_frames_per_s']:.1f} frames/s; breaker "
        f"cycles {r['breaker_cycles']}, retries {r['peer_retries']}; "
        f"trace {r['trace_id']} {r['trace_hops']} hops; "
        f"{r['phase_s']:.1f} s ({card})")

    # (d), (e): the update gates' sweeps launch K1, one launch a shaping
    # slot and step; nothing else on these planes does
    shaping.reset_launches()
    with GateLog() as gates_d:
        r = m["d"] = run("staged_update_soak")
    with GateLog() as gates_e:
        r_e = m["e"] = run("update_under_flap")
    k1 = shaping.LAUNCHES["shape_step_rows"]
    check(r["frames_lost"] == 0
          and r["clean_plans_verified"] == r["clean_plans"] == r["pairs"]
          and r["rounds_staged"] > 0 and r["regressing_rejected"]
          and r["gate_left_plane_untouched"] and r["tick_errors"] == 0,
          f"23(d) staged_update_soak: {json.dumps(r)}")
    log(f"23(d) staged_update_soak {r['pairs']} pairs, "
        f"{r['offered_frames_per_s']} frames/s: {r['frames_fed']} fed, 0 "
        f"lost; {r['clean_plans_verified']}/{r['clean_plans']} clean plans "
        f"verified, {r['rounds_staged']} rounds staged, {r['rollbacks']} "
        f"rollbacks; gate {r['gate_s']} s, stage {r['stage_s']} s; "
        f"staging / steady {r['staging_over_steady']} "
        f"({r['staging_frames_per_s']:.1f} / "
        f"{r['steady_frames_per_s']:.1f} frames/s); regressing delta "
        f"rejected ({r['regressing_reason']}), plane untouched; "
        f"{r['phase_s']:.1f} s ({card})")
    check(r_e["frames_lost"] == 0 and r_e["stages_clean"]
          and r_e["stage_results"] and r_e["breaker_cycles"] >= 1
          and r_e["tick_errors"] == 0,
          f"23(e) update_under_flap: {json.dumps(r_e)}")
    log(f"23(e) update_under_flap {r_e['pairs']} pairs at "
        f"{r_e['flap_hz']} Hz: {r_e['frames_fed']} fed, 0 lost; stages "
        f"{r_e['stage_results']}, breaker cycles "
        f"{r_e['breaker_cycles']}; {r_e['phase_s']:.1f} s ({card})")

    # (f) the gates that ran: (d)'s one per pair (the clean latency bump)
    # and the regressing loss=70 delta, (e)'s one per pair mid-flap
    ticks_d, ticks_e = (
        SOAK_CUTS[name].get("gate_ticks", inspect.signature(
            scenarios.LADDER[name]).parameters["gate_ticks"].default)
        for name in ("staged_update_soak", "update_under_flap"))
    check(len(gates_d.calls) == r["clean_plans"] + 1
          and len(gates_e.calls) == len(r_e["stage_results"]),
          f"23(f): {len(gates_d.calls)} gates in (d), "
          f"{len(gates_e.calls)} in (e)")
    want = on_card * (_gate_launches(gates_d.calls, ticks_d, "23(d)")
                      + _gate_launches(gates_e.calls, ticks_e, "23(e)"))
    check(k1 == want, f"23(f): K1 launched {k1} times in (d) and (e), want "
                      f"{want} ({len(gates_d.calls)} x {ticks_d} + "
                      f"{len(gates_e.calls)} x {ticks_e} ticks x the "
                      f"slots)")
    bad = gates_d.calls[-1]
    check(not bad.verdict.ok, "23(f): the last gate of (d) passed")
    replay = replay_gate_sweep(bad, on_card, "23(f)")
    m["f"] = dict(replay, k1_launches_d_e=k1, gates_d=len(gates_d.calls),
                  gates_e=len(gates_e.calls))
    log(f"23(f) K1 {k1} launches in (d) and (e) = ({len(gates_d.calls)} x "
        f"{ticks_d} + {len(gates_e.calls)} x {ticks_e}) ticks x "
        f"{replay['k_slots']} slots; the regressing gate's sweep "
        f"({replay['replicas']} replicas x {replay['ticks']} ticks, "
        f"{replay['rows']} rows) through K1 == plain, every metric bit "
        f"for bit ({card})")
    return m, k1


# Phase 24: the plane-only probes, the what-if sweep, the sharded soak and
# the tenant and shm soaks at JAX's widths; only durations are cut (JAX's
# defaults in the comments, PERF.md §4).
PROBE_CUTS = {
    # 5 rounds; JAX's 0.25 s windows close none on the probe's virtual
    # clock (~15 ms a round), so the windows are slo_overhead's 0.01 s
    "telemetry_overhead": dict(rounds=3, window_s=0.01),
    "slo_overhead": dict(rounds=3),                      # 5 rounds
    "pause_observability": dict(rounds=2),               # 4 rounds
    "whatif_sweep": dict(steps=200),                     # 10,000 steps
    "sharded_soak": dict(rounds=2, devices=8),           # 3; the cards' (1)
    "noisy_neighbor": dict(seconds=2.0),                 # 4.0 s
    "noisy_neighbor_shm": dict(seconds=1.0,              # 4.0 s
                               aggressor_via_shm=True),
    "shm_producer_crash": {},                            # JAX's defaults
    "shm_soak": {},                                      # JAX's defaults
    "tenant_soak": dict(seconds=3.0, settle_s=15.0),     # 8 s, <= 60 s
}
WHATIF_REPLAY_STEPS = 20    # 24(d): the recorded sweep through K1 and plain


class SweepLog:
    """While installed, records every twin.run_sweep call (its snapshot,
    scenarios and keywords), as the scenarios reach it through the
    package at call time; the sweeps run as they would."""

    def __enter__(self) -> "SweepLog":
        from kubedtn_tpu_torch import twin

        real = self._real = twin.run_sweep
        self.calls = []

        def recorded(snapshot, scenarios, **kw):
            self.calls.append(types.SimpleNamespace(
                snapshot=snapshot, scenarios=list(scenarios), kw=kw))
            return real(snapshot, scenarios, **kw)

        twin.run_sweep = recorded
        return self

    def __exit__(self, *exc) -> None:
        from kubedtn_tpu_torch import twin

        twin.run_sweep = self._real


class ShardLog:
    """While installed, records every plane that enables sharding and the
    first mailbox ring step of the run (its blocks and mesh), and counts
    the ring steps (parallel/exchange.ring_right_shift calls)."""

    def __enter__(self) -> "ShardLog":
        from kubedtn_tpu_torch import runtime
        from kubedtn_tpu_torch.parallel import exchange as pex

        self.planes, self.first, self.steps = [], None, 0
        real_en = self._real_en = runtime.WireDataPlane.enable_sharding
        real_shift = self._real_shift = pex.ring_right_shift
        log_ = self

        def enable(plane, *a, **kw):
            log_.planes.append(plane)
            return real_en(plane, *a, **kw)

        def shift(blocks, mesh):
            if log_.first is None:
                log_.first = ([b.clone() for b in blocks], tuple(mesh))
            log_.steps += 1
            return real_shift(blocks, mesh)

        runtime.WireDataPlane.enable_sharding = enable
        pex.ring_right_shift = shift
        return self

    def __exit__(self, *exc) -> None:
        from kubedtn_tpu_torch import runtime
        from kubedtn_tpu_torch.parallel import exchange as pex

        runtime.WireDataPlane.enable_sharding = self._real_en
        pex.ring_right_shift = self._real_shift


def replay_whatif_sweep(call, on_card: bool, steps: int) -> dict:
    """The recorded whatif_sweep call's (SweepLog) snapshot and scenarios
    swept again for `steps` steps on its seed through K1 and through the
    plain version (sweep_k1_vs_plain)."""
    kw = dict(call.kw, steps=steps)
    kern, launches = sweep_k1_vs_plain(call.snapshot, call.scenarios, kw,
                                       on_card, "24(d)")
    return {"replicas": kern.replicas, "steps": steps,
            "k_slots": kw["k_slots"],
            "rows": kern.replicas * int(call.snapshot.sim.edges.capacity),
            "k1_compare_launches": launches}


def run_probe_phase(dev, card, probe) -> tuple:
    """Phase 24: the nine scenarios the ladder adds over phase 23,
    through scenarios.LADDER on `dev` at JAX's widths, PROBE_CUTS cutting
    their durations; K1 counted from 0 around whatif_sweep and its
    recorded sweep replayed through K1 and through its plain version; K4
    counted from 0 around sharded_soak on 8 virtual shards, == its
    dispatches' ring steps plus its exchange probes' (`probe`, a
    ProbeK4), and == plain on one ring step of its mailbox. Returns
    (metrics, K1 launches by path, K4 launches around sharded_soak, its
    probes' among them)."""
    from kubedtn_tpu_torch import scenarios
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import exchange as pex

    on_card = dev.type == "cuda"
    m, k1_other = {}, {}

    def run(name, cut=None):
        t0 = time.perf_counter()
        k1 = shaping.LAUNCHES["shape_step_rows"]
        r = scenarios.LADDER[name](device=dev, **PROBE_CUTS[cut or name])
        r["phase_s"] = time.perf_counter() - t0
        k1_other[cut or name] = shaping.LAUNCHES["shape_step_rows"] - k1
        check(r["device"] == str(dev), f"24 {name} ran on {r['device']}")
        return r

    def pairs_line(r, bar: str, key: str) -> str:
        return (f"overhead {r[key]} % (best pair {r[key + '_best']} %), "
                f"meets the {bar} bar: {r[f'meets_{bar}_target']}; off "
                f"{r['rounds_off_frames_per_s']}, on "
                f"{r['rounds_on_frames_per_s']} frames/s"
                + (f"; stalled first attempt "
                   f"{r['stalled_first_attempt']['overhead_pct']} %"
                   if "stalled_first_attempt" in r else ""))

    # (a) telemetry's cost on the plane-only probe
    r = m["a"] = run("telemetry_overhead")
    check(r["tick_errors_off"] == 0 and r["tick_errors_on"] == 0
          and r["sampled_frames"] > 0 and r["recorder_events"] > 0
          and r["telemetry_link_rows"] == r["pairs"]
          and r["telemetry_windows_closed"] > 0,
          f"24(a) telemetry_overhead: {json.dumps(r)}")
    log(f"24(a) telemetry_overhead {r['pairs']} pairs x "
        f"{r['frames_per_wire']} frames, {r['rounds']} rounds: "
        f"{pairs_line(r, '5pct', 'overhead_pct')}; sampled "
        f"{r['sampled_frames']}, {r['recorder_events']} events, "
        f"{r['telemetry_windows_closed']} windows, "
        f"{r['telemetry_link_rows']} link rows; {r['phase_s']:.1f} s "
        f"({card})")

    # (b) the SLO evaluator's cost on two tenant planes
    r = m["b"] = run("slo_overhead")
    check(r["tick_errors_off"] == 0 and r["tick_errors_on"] == 0
          and r["slo_evaluations"] > 0
          and r["tenants_evaluated"] == r["tenants"] and r["all_ok"],
          f"24(b) slo_overhead: {json.dumps(r)}")
    log(f"24(b) slo_overhead {r['tenants']} tenants, "
        f"{r['frames_per_wire']} frames a wire, {r['rounds']} rounds: "
        f"{pairs_line(r, '1pct', 'overhead_pct')}; "
        f"{r['slo_evaluations']} evaluations, {r['slo_windows_evaluated']} "
        f"windows; {r['phase_s']:.1f} s ({card})")

    # (c) the pause ledger's hooks, and the forced barriers attributed
    r = m["c"] = run("pause_observability")
    check(r["all_attributed"] and r["staged_ok"] and r["staged_rounds"] >= 1
          and r["compact_moved"] >= 1 and r["dropped_events"] == 0
          and r["tick_errors_off"] == 0 and r["tick_errors_on"] == 0,
          f"24(c) pause_observability: {json.dumps(r)}")
    forced = {c: {k: v[k] for k in ("count", "seconds", "rows")}
              for c, v in r["forced"].items()}
    log(f"24(c) pause_observability: hook "
        f"{pairs_line(r, '2pct', 'hook_overhead_pct')}; forced {forced}, "
        f"compact moved {r['compact_moved']} rows, {r['staged_rounds']} "
        f"staged rounds, load window {r['load_window_s']} s; "
        f"{r['phase_s']:.1f} s ({card})")

    # (d) the what-if sweep: K1 once a shaping slot and step, over
    # replicas x capacity rows
    shaping.reset_launches()
    with SweepLog() as sweeps:
        r = m["d"] = run("whatif_sweep")
    k1_whatif = shaping.LAUNCHES["shape_step_rows"]
    k1_other["whatif_sweep"] -= k1_whatif
    want = on_card * r["steps"] * inspect.signature(
        scenarios.whatif_sweep).parameters["k_slots"].default
    check(r["replicas"] == 64 and len(sweeps.calls) == 1
          and 0 < r["baseline_delivery_ratio"] <= 1.0
          and (r["worst_delivery_ratio"] or 0.0)
          <= r["baseline_delivery_ratio"],
          f"24(d) whatif_sweep: {json.dumps(r)}")
    check(k1_whatif == want, f"24(d): K1 launched {k1_whatif} times in the "
                             f"sweep, want {want} (steps x slots)")
    replay = m["d_replay"] = replay_whatif_sweep(
        sweeps.calls[0], on_card, WHATIF_REPLAY_STEPS)
    log(f"24(d) whatif_sweep {r['replicas']} replicas x {r['steps']} steps "
        f"of a random_mesh({r['nodes']}, {r['links']}): "
        f"{r['replicas_steps_per_s']} replica-steps/s, run "
        f"{r['run_s']} s, compile {r['compile_s']} s, virtual speedup "
        f"{r['virtual_speedup']}; baseline delivery "
        f"{r['baseline_delivery_ratio']}, worst {r['worst_delivery_ratio']}, "
        f"baseline p99 {r['baseline_p99_us']} us; K1 {k1_whatif} launches "
        f"over {replay['rows']} rows each; {replay['steps']} steps of its "
        f"sweep through K1 == plain, every metric bit for bit "
        f"({replay['k1_compare_launches']} compare launches); "
        f"{r['phase_s']:.1f} s ({card})")

    # (e) the sharded soak on 8 virtual shards of the card: K4 on every
    # dispatch's ring steps and the sampled exchange probe's
    k4_0, probe0, runs0 = pex.LAUNCHES["ring_step"], probe.launches, \
        probe.runs
    with ShardLog() as shards:
        r = m["e"] = run("sharded_soak")
    k4 = pex.LAUNCHES["ring_step"] - k4_0
    probe_k4, probe_runs = probe.launches - probe0, probe.runs - runs0
    check(len(shards.planes) == 1 and shards.first is not None,
          f"24(e): {len(shards.planes)} sharded planes, ring stepped: "
          f"{shards.first is not None}")
    plane = shards.planes[0]
    S = len(plane._shard_mesh)
    plan = len(pex.ring_plan(plane._shard_mesh))
    dispatches = plane._exchange_count
    check(r["mesh_shape"] == [8] and S == 8 and r["dropped"] == 0
          and r["tick_errors"] == 0 and r["xshard_frames_total"] > 0
          and sum(r["edges_per_shard"]) == int(plane.engine.state.num_active)
          and r["remote_dma"] == on_card and r["exchange_seconds"] > 0,
          f"24(e) sharded_soak: {json.dumps(r)}")
    check(shards.steps == (dispatches + probe_runs) * (S - 1),
          f"24(e): {shards.steps} ring steps, want ({dispatches} dispatches "
          f"+ {probe_runs} probe runs) x {S - 1}")
    want = on_card * dispatches * (S - 1) * plan
    check(k4 - probe_k4 == want,
          f"24(e): K4 launched {k4} times, {probe_k4} by the probe; the "
          f"plane's {k4 - probe_k4}, want {dispatches} dispatches x "
          f"{S - 1} ring steps x {plan} launches")
    blocks, mesh = shards.first
    before = pex.LAUNCHES["ring_step"]
    same(pex.ring_right_shift(blocks, mesh),
         pex.ring_right_shift_plain(blocks), "24(e) K4 vs plain")
    check(pex.LAUNCHES["ring_step"] - before == on_card * plan,
          "24(e): the compared ring step did not launch K4")
    m["e_k4"] = {"k4_launches": k4, "probe_k4": probe_k4,
                 "dispatches": dispatches, "probe_runs": probe_runs,
                 "mailbox_rows": int(blocks[0].shape[0])}
    log(f"24(e) sharded_soak {r['pairs']} pairs on {r['mesh_shape']} "
        f"virtual shards: single {r['single_device_frames_per_s']} frames/s "
        f"{r['single_rounds']}, sharded {r['sharded_frames_per_s']} "
        f"{r['sharded_rounds']}, sharded / single "
        f"{r['sharded_over_single']}; edges per shard "
        f"{r['edges_per_shard']}, imbalance {r['shard_imbalance']}, "
        f"colocated {r['colocated_frac']}, {r['xshard_frames_total']} "
        f"cross-shard frames, mailbox hwm {r['mailbox_hwm']}, exchange "
        f"{r['exchange_seconds']} s; K4 {k4} = {dispatches} dispatches x "
        f"{S - 1} x {plan} + {probe_k4} by {probe_runs} probe runs; K4 == "
        f"plain on one ring step of its mailbox ({blocks[0].shape[0]} x "
        f"{blocks[0].shape[1]} words a shard); {r['phase_s']:.1f} s "
        f"({card})")

    # (f) the noisy neighbour, over wire ingress, then over an shm ring
    for key, cut in (("f_ingress", "noisy_neighbor"),
                     ("f_shm", "noisy_neighbor_shm")):
        r = m[key] = run("noisy_neighbor", cut)
        check(r["in_guardrails"] and r["victim_lost"] == 0
              and r["aggressor_admitted"] + r["aggressor_queued_not_dropped"]
              == r["aggressor_fed"] and r["dropped"] == 0
              and (cut == "noisy_neighbor"
                   or r["shm"]["throttled_events"] > 0),
              f"24(f) noisy_neighbor {r['aggressor_transport']}: "
              f"{json.dumps(r)}")
        log(f"24(f) noisy_neighbor over {r['aggressor_transport']}, "
            f"{r['seconds']} s: victim {r['victim_fed']} fed, "
            f"{r['victim_delivered']} delivered, p99 {r['victim_p99_us']} "
            f"us, slo {r['victim_slo']['severity']}; aggressor "
            f"{r['aggressor_fed']} fed, {r['aggressor_admitted']} admitted "
            f"(cap {r['aggressor_budget_cap']}), "
            f"{r['aggressor_queued_not_dropped']} queued, "
            f"{r['throttle_events']} throttle events, slo "
            f"{r['aggressor_slo']['severity']}"
            + (f"; ring {r['shm']}" if "shm" in r else "")
            + f"; {r['phase_s']:.1f} s ({card})")

    # (g) a producer child SIGKILLed mid-burst
    r = m["g"] = run("shm_producer_crash")
    check(r["in_guardrails"], f"24(g) shm_producer_crash: {json.dumps(r)}")
    log(f"24(g) shm_producer_crash: killed at {r['reported_at_kill']} of "
        f"{r['frames_target']}, {r['delivered']} delivered (prefix "
        f"{r['delivered_prefix_ok']}, {r['committed_lost']} lost), "
        f"{r['torn_skipped']} torn skipped, {r['rings_retired']} ring "
        f"retired, {r['ring_traces_spanning']} of {r['ring_traces_seen']} "
        f"ring traces span received -> delivered; {r['phase_s']:.1f} s "
        f"({card})")

    # (h) 200,000 frames through a ring beside the gRPC ladder
    r = m["h"] = run("shm_soak")
    check(r["in_guardrails"], f"24(h) shm_soak: {json.dumps(r)}")
    log(f"24(h) shm_soak {r['shm_frames_ingested']} frames of "
        f"{r['frame_size']} B exactly once (producer rc "
        f"{r['producer_rc']}): shm {r['shm_frames_per_s']} frames/s "
        f"({r['shm_frames_per_dequeue']} a dequeue); gRPC unary "
        f"{r['grpc_unary_frames_per_s']}, stream "
        f"{r['grpc_stream_frames_per_s']}, bulk "
        f"{r['grpc_bulk_frames_per_s']}; shm / stream "
        f"{r['shm_over_grpc_stream']}, / bulk {r['shm_over_grpc_bulk']}; "
        f"{r['phase_s']:.1f} s ({card})")

    # (i) a real-time runner, an injector child per tenant
    r = m["i"] = run("tenant_soak")
    check(all(v["sustained_frames_per_s"] > 0
              and v["worst_window_frames_per_s"] > 0
              for v in r["per_tenant"].values())
          and r["dropped"] == 0 and r["tick_errors"] == 0,
          f"24(i) tenant_soak: {json.dumps(r)}")
    log(f"24(i) tenant_soak {r['tenants']} tenants x "
        f"{r['pairs_per_tenant']} pairs, {r['seconds']} s: plane "
        f"{r['plane_frames_per_s']} frames/s; per tenant "
        + ", ".join(f"{n} {v['sustained_frames_per_s']} (worst "
                    f"{v['worst_window_frames_per_s']}, p99 {v['p99_us']} "
                    f"us)" for n, v in r["per_tenant"].items())
        + f"; {r['phase_s']:.1f} s ({card})")

    k1_paths = {"whatif": k1_whatif}
    other = sum(k1_other.values())
    if other:
        k1_paths["probes"] = other
    m["k1_other_by_part"] = k1_other
    return m, k1_paths, k4


MP_PROCS = 2                # 25: child processes, each joining the mesh
MP_SHARDS = 2               # 25: virtual shards of the card a process holds
MP_SEED = 25                # 25: the step's uniforms, the router's shards
MP_CHILD_S = 300.0          # 25: bound on the children, rendezvous to exit


def mp_step_inputs(el, fresh, rng) -> list:
    """25(a)'s SH_STEPS steps: a SH_BATCH-row scattered UpdateLinks batch
    each (22(a)'s draw), 1,500 B on every row, every active row shaped;
    the uniforms drawn by each side from a generator seeded MP_SEED."""
    from kubedtn_tpu_torch.models.topologies import random_link_props

    E, n_rows, dev = fresh.capacity, 2 * el.n_links, fresh.device
    sizes = torch.full((E,), 1500.0, dtype=torch.float32, device=dev)
    t_arr = torch.zeros((E,), dtype=torch.float32, device=dev)
    have = fresh.active.clone()
    return [dict(rows=np.sort(rng.choice(n_rows, SH_BATCH, replace=False)
                              ).astype(np.int32),
                 props=random_link_props(SH_BATCH, 250 + i),
                 valid=np.ones(SH_BATCH, dtype=bool), sizes=sizes,
                 have=have, t_arr=t_arr)
            for i in range(SH_STEPS)]


def run_multiprocess_phase(el, fresh, dev, card, routed=None,
                           layout=None) -> tuple:
    """Phase 25: the scale path across processes. MP_PROCS children
    (parallel/multihost.py, torch and the port only) each join the run
    (init_distributed over a file rendezvous) and build make_multihost_mesh
    over `layout`[rank] (default MP_SHARDS virtual shards of `dev` each);
    (a) the sharded step on the churned Clos, (b) the sharded router on
    phase 11's routed fabric (`routed` = its (rs, spec, flow_dst), else
    built the same way), K1 counted from 0 around each in every child;
    the same steps run here on one process's mesh over the same shards.
    Every child's shards, ShapeResults and NodeStats == this process's,
    bit for bit. Returns (metrics, K1 launches of the children, K1
    launches of the one-process runs)."""
    import shutil
    import tempfile

    from kubedtn_tpu_torch import entry, router
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import multihost
    from kubedtn_tpu_torch.parallel import router as prouter
    from kubedtn_tpu_torch.parallel.mesh import make_mesh, shard_edge_state
    from kubedtn_tpu_torch.parallel.sharded import make_sharded_step

    t_phase = time.perf_counter()
    layout = layout or [[str(dev)] * MP_SHARDS] * MP_PROCS
    world = len(layout)
    mesh = make_mesh([d for devs in layout for d in devs])
    per = len(layout[0])
    n, m = el.n_nodes, {}
    if routed is None:
        leaves = np.arange(entry.N_SPINE, el.n_nodes)
        rs, spec, flow_dst, _ = entry.build_routed(
            el, fresh, leaves, seed=31, rate_bps=ROUTED_RATE_BPS, q=SIM_Q,
            k_fwd=ROUTED_K_FWD, max_hops=ROUTE_HOPS)
    else:
        rs, spec, flow_dst = routed
    steps = mp_step_inputs(el, fresh, np.random.default_rng(25))
    rparams = dict(n_nodes=n, q=SIM_Q, k_fwd=ROUTED_K_FWD, k_slots=SIM_K,
                   budget=SR_BUDGET, dt_us=SIM_DT_US, steps=SR_STEPS,
                   seed=MP_SEED)
    tmp = tempfile.mkdtemp(prefix="kdt-multiprocess-")
    try:
        job = multihost.write_job(
            tmp, {"step": dict(n_nodes=n, seed=MP_SEED), "router": rparams},
            {"step": dict(state=fresh, steps=steps),
             "router": dict(edges=rs.sim.edges, next_edge=rs.next_edge,
                            spec=spec, flow_dst=flow_dst)},
            world=world, init=f"file://{tmp}/rendezvous", devices=layout,
            timeout_s=MP_CHILD_S)
        t_spawn = time.time()
        try:
            res = multihost.spawn(job, world, MP_CHILD_S)
        except RuntimeError as e:
            fail(f"25: a child process failed: {e}")
        t_children = time.time() - t_spawn
        outs = multihost.load_outputs(job, world, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, info in enumerate(res):
        check(info["forbidden_modules"] == [],
              f"25: child {r} imported {info['forbidden_modules']}")
        check(info["shards"] == len(mesh) and info["world_size"] == world,
              f"25: child {r}'s mesh is {info['entries']}")
    backend = {(i["backend"], i["staging"]) for i in res}
    check(len(backend) == 1, f"25: the children chose {backend}")
    backend, staging = backend.pop()
    m["backend"], m["staging"] = backend, staging
    m["startup_s"] = [i["t_ready"] - t_spawn for i in res]
    m["children_s"] = t_children
    log(f"25: {world} processes x {per} shards of {layout[0][0]}: backend "
        f"{backend}, staging {staging}; start-up (spawn to rendezvous, "
        f"mesh, CUDA context and K1 loaded) "
        f"{', '.join(f'{s:.2f}' for s in m['startup_s'])} s; the children "
        f"{t_children:.2f} s in all ({card})")

    # (a) the one-process step on the same shards and draws
    card_k1 = int(dev.type == "cuda")
    ref_k1 = {}
    step = make_sharded_step(mesh, n)
    shards = shard_edge_state(fresh, mesh)
    gen = torch.Generator(device=mesh[0]).manual_seed(MP_SEED)
    k0 = shaping.LAUNCHES["shape_step_rows"]
    walls = []
    for i, x in enumerate(steps):
        _sync(dev)
        t0 = time.perf_counter()
        shards, want_res, want_stats = step(
            shards, x["rows"], x["props"], x["valid"], x["sizes"],
            x["have"], x["t_arr"], gen)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        for r, o in enumerate(outs):
            name = f"25(a) step {i} rank {r}"
            same(o["step"]["results"][i], want_res[r * per:(r + 1) * per],
                 f"{name} ShapeResult")
            same(o["step"]["stats"][i], want_stats, f"{name} NodeStats")
    ref_k1["step"] = shaping.LAUNCHES["shape_step_rows"] - k0
    for r, o in enumerate(outs):
        same(o["step"]["shards"], shards[r * per:(r + 1) * per],
             f"25(a) rank {r}'s shards")
    k1_a = sum(i["step"]["k1_launches"] for i in res)
    check(k1_a == ref_k1["step"] == card_k1 * len(mesh) * SH_STEPS,
          f"25(a): K1 {k1_a} launches in the children, {ref_k1['step']} in "
          f"one process")
    m["a"] = {"ms_per_step_children": [
        statistics.median(i["step"]["ms_per_step"]) for i in res],
        "ms_per_step_one_process": 1e3 * statistics.median(walls)}
    log(f"25(a) sharded step across {world} processes: every rank's "
        f"{per} shards, ShapeResults and NodeStats == one process on "
        f"{len(mesh)} shards, bit for bit, {SH_STEPS} steps of a "
        f"{SH_BATCH}-row scattered batch; NodeStats the same on every "
        f"rank; K1 {k1_a} launches in the children == {ref_k1['step']}; ms "
        f"per step {m['a']['ms_per_step_children']} across processes, "
        f"{m['a']['ms_per_step_one_process']:.3f} in one ({card})")

    # (b) the one-process router on the same shards and generators
    rstep = prouter.make_sharded_router_step(
        mesh, n, k_slots=SIM_K, k_fwd=ROUTED_K_FWD, budget=SR_BUDGET)
    rshards = prouter.shard_router_state(router.init_router(
        rs.sim.edges, rs.next_edge, n, q=SIM_Q, k_fwd=ROUTED_K_FWD), mesh)
    gens = prouter.shard_generators(mesh, MP_SEED)
    # fwd_dropped counts the exchange budget's overflow and the receiving
    # lanes' (as run_routed does); the former, counted here, must be 0
    bucket, over = prouter._bucket_by_shard, []

    def counted(*args):
        buf, dropped = bucket(*args)
        over.append(dropped)
        return buf, dropped

    prouter._bucket_by_shard = counted
    try:
        k0 = shaping.LAUNCHES["shape_step_rows"]
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(SR_STEPS):
            rshards = rstep(rshards, spec, flow_dst, gens, SIM_DT_US)
        _sync(dev)
        one_ms = 1e3 * (time.perf_counter() - t0) / SR_STEPS
    finally:
        prouter._bucket_by_shard = bucket
    ref_k1["router"] = shaping.LAUNCHES["shape_step_rows"] - k0
    for r, o in enumerate(outs):
        same(o["router"]["shards"], rshards[r * per:(r + 1) * per],
             f"25(b) rank {r}'s router shards")
    whole = prouter.gather_router_state(rshards)
    over_budget = float(sum(float(x) for x in over))
    check(len(over) == SR_STEPS * len(mesh) and over_budget == 0 and all(
        i["router"]["fwd_dropped"] == float(whole.fwd_dropped)
        for i in res),
          f"25(b): {over_budget} packets over the exchange budget; "
          f"fwd_dropped {[i['router']['fwd_dropped'] for i in res]}")
    k_shape = SIM_K + ROUTED_K_FWD
    k1_b = sum(i["router"]["k1_launches"] for i in res)
    check(k1_b == ref_k1["router"]
          == card_k1 * len(mesh) * k_shape * SR_STEPS,
          f"25(b): K1 {k1_b} launches in the children, {ref_k1['router']} "
          f"in one process")
    books = transit_books(whole, spec, SR_STEPS, "25(b) sharded router")
    a2a = sum(i["router"]["a2a_bytes_per_step"] for i in res)
    cross = sum(i["router"]["a2a_cross_process_bytes_per_step"]
                for i in res)
    m["b"] = dict(books=books, over_budget=over_budget,
                  a2a_bytes_per_step=a2a,
                  a2a_cross_process_bytes_per_step=cross,
                  ms_per_step_children=[
                      statistics.mean(i["router"]["ms_per_step"])
                      for i in res],
                  ms_per_step_one_process=one_ms)
    log(f"25(b) sharded router across {world} processes, {SR_STEPS} steps x "
        f"{k_shape} slots, budget {SR_BUDGET}: every rank's router shards "
        f"== one process on {len(mesh)} shards, bit for bit (generators "
        f"seeded by global shard); 0 packets over the budget, "
        f"fwd_dropped {books['fwd_dropped']:.0f} by the receiving lanes "
        f"on every rank (as run_routed counts them); K1 {k1_b} launches in "
        f"the children == {ref_k1['router']}; {a2a} B through "
        f"all_to_all_single a step ({cross} B across processes); ms per "
        f"step {[round(x, 3) for x in m['b']['ms_per_step_children']]} "
        f"across processes, {one_ms:.3f} in one ({card})")
    m["phase_s"] = time.perf_counter() - t_phase
    return m, k1_a + k1_b, ref_k1["step"] + ref_k1["router"]


PROBE_SHARDS = 4            # 26(b): virtual shards of the card


def run_dispatch_phase(dev, card) -> tuple:
    """Phase 26 (module docstring). Returns (metrics, K4 launches of the
    sharded probe plane, exchange probe included)."""
    from kubedtn_tpu_torch.analysis.verify import dispatch
    from kubedtn_tpu_torch.parallel import exchange as pex

    t_phase = time.perf_counter()
    m = {}

    def per_tick(r, name):
        # on the CPU (a rehearsal) nothing launches, syncs or profiles:
        # those checks pass vacuously
        on_card = r["launches"] is not None
        n = r["ticks"]
        calls = {k: v / n for k, v in r["calls"].items() if v}
        launches = {k: v / n for k, v in (r["launches"] or {}).items() if v}
        sites = r["syncs"] or []
        syncs = sum(s["count"] for s in sites) / n
        kernels = r["cuda_kernels"] or {}
        top = [(re.sub(r"void |at::native::|\(anonymous namespace\)::", "",
                       k)[:60], v / n)
               for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]]
        log(f"26{name}: per steady tick (a) wrapper calls {calls or 0}, "
            f"(b) launches {launches or 0}, (c) CUDA kernels "
            f"{r['cuda_kernels_per_tick'] or 0:.1f} (top {top}; copies "
            f"{r['cuda_copies_per_tick'] or 0:.1f}), (d) dispatch-side "
            f"syncs {syncs:.2f} at "
            f"{[(s['path'], s['line'], s['function']) for s in sites]}; "
            f"seconds {({k: round(v, 3) for k, v in r['seconds'].items()})}"
            f" ({card})")
        check(r["tick_errors"] == 0, f"26{name}: tick errors")
        check(not on_card or r["calls"] == r["launches"],
              f"26{name}: wrapper calls {r['calls']} != launches "
              f"{r['launches']}: a kernel gave way to its plain version")
        bad = [s for s in sites if s["waiver"] is None]
        check(not bad, f"26{name}: sync sites no sync-ok waiver covers: "
                       f"{bad}")
        return {"calls_per_tick": calls, "launches_per_tick": launches,
                "cuda_kernels_per_tick": r["cuda_kernels_per_tick"],
                "cuda_copies_per_tick": r["cuda_copies_per_tick"],
                "cuda_kernels": r["cuda_kernels"],
                "seconds": r["seconds"],
                "syncs_per_tick": syncs,
                "sync_sites": [{k: s[k] for k in ("path", "line",
                                                  "function", "count",
                                                  "waiver")}
                               for s in sites],
                "delivered": sum(len(e) for e in r["egress"])}

    runs = {}
    for depth in (1, 2):
        runs[depth] = dispatch.probe_plane(depth=depth, device=dev)
        m[f"a_depth{depth}"] = per_tick(runs[depth], f"(a) depth {depth}")

    def same(r, base, what):
        check(r["egress"] == base["egress"],
              f"26: delivered frames differ, {what}")
        for f, v in base["counters"].items():
            check(np.array_equal(r["counters"][f], v),
                  f"26: counter {f} differs, {what}")

    same(runs[2], runs[1], "depth 2 against depth 1")
    check(m["a_depth1"]["delivered"] > 0, "26(a): nothing delivered")
    t0 = time.perf_counter()
    cpu = dispatch.probe_plane(depth=1, shards=PROBE_SHARDS, device="cpu")
    m["cpu_probe_s"] = time.perf_counter() - t0
    pex.reset_launches()
    r4 = dispatch.probe_plane(depth=1, shards=PROBE_SHARDS, device=dev)
    k4 = pex.LAUNCHES["ring_step"]
    m["b_shards4"] = per_tick(r4, f"(b) {PROBE_SHARDS} shards")
    got = (r4["launches"] or r4["calls"])["ring_step"]
    check(got == cpu["calls"]["ring_step"] > 0,
          f"26(b): K4 launched {got} times in the counted ticks, the CPU "
          f"probe predicts {cpu['calls']['ring_step']}")
    same(r4, runs[1], f"{PROBE_SHARDS} shards against unsharded")
    m["b_shards4"]["k4_cpu_predicted"] = cpu["calls"]["ring_step"]
    m["phase_s"] = time.perf_counter() - t_phase
    return m, k4


ALL_PHASES = tuple(range(1, 27))
# phases that need the Clos state phase 3's main path leaves (the churned
# Clos and its fresh copy): selecting one runs phases 2 and 3 first
NEEDS_MAIN_PATH = {3, 4, 10, 11, 14, 22, 25}
LIVE_TICK_PHASES = {6, 7, 8}   # one run of run_live_tick


def parse_phases(argv) -> tuple[set, bool]:
    """The phases a call runs: every phase without arguments, else those
    of `--phases LIST` (e.g. `--phases 1-4,19`; ranges and single
    numbers, comma-separated), closed under what they need: phase 1
    always, phases 2 and 3 for any phase in NEEDS_MAIN_PATH, and 6, 7
    and 8 together; and whether `--daemon-rate` asks for
    run_daemon_rate after them (never in the default run)."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--phases", default="",
                    help="phases to run, e.g. 1-4,19 (default: all)")
    ap.add_argument("--daemon-rate", action="store_true",
                    help="then measure the daemon process's shaping rate "
                         "with and without --profile and telemetry")
    args = ap.parse_args(argv)
    spec = args.phases
    if not spec:
        return set(ALL_PHASES), args.daemon_rate
    want = {1}
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        try:
            rng = range(int(lo), int(hi or lo) + 1)
        except ValueError:
            ap.error(f"bad phase list {spec!r}")
        if not rng or rng.start < 1 or rng.stop - 1 > ALL_PHASES[-1]:
            ap.error(f"no phase {part!r}")
        want.update(rng)
    if want & NEEDS_MAIN_PATH:
        want |= {2, 3}
    if want & LIVE_TICK_PHASES:
        want |= LIVE_TICK_PHASES
    return want, args.daemon_rate


class ProbeK4:
    """The K4 launches of the sharded planes' sampled exchange probes
    (runtime.WireDataPlane._run_exchange_probe), counted while installed:
    each run must make (S - 1) ring steps of len(ring_plan(mesh))
    launches on the card. Each phase's sharded-plane K4 count is the
    planes' own launches plus this term, read around the phase."""

    def __init__(self) -> None:
        self.runs = 0
        self.launches = 0
        self._real = None

    def install(self) -> "ProbeK4":
        from kubedtn_tpu_torch import runtime
        from kubedtn_tpu_torch.parallel import exchange as pex

        real = self._real = runtime.WireDataPlane._run_exchange_probe
        counter = self

        def counted(plane, rows: int) -> None:
            k0 = pex.LAUNCHES["ring_step"]
            real(plane, rows)
            got = pex.LAUNCHES["ring_step"] - k0
            mesh = plane._shard_mesh
            want = ((len(mesh) - 1) * len(pex.ring_plan(mesh))
                    if mesh[0].type == "cuda" else 0)
            check(got == want, f"the exchange probe launched K4 {got} "
                               f"times on a mesh of {len(mesh)}, want "
                               f"{want}")
            counter.runs += 1
            counter.launches += got

        runtime.WireDataPlane._run_exchange_probe = counted
        return self

    def uninstall(self) -> None:
        from kubedtn_tpu_torch import runtime

        runtime.WireDataPlane._run_exchange_probe = self._real


def main(argv=None) -> int:
    want, daemon_rate = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from kubedtn_tpu_torch import _build, entry
    from kubedtn_tpu_torch.kernel_bench import Timer, card_line
    from kubedtn_tpu_torch.ops.cuda import shaping

    dev = torch.device("cuda")
    card = card_line()
    log(card)
    if want != set(ALL_PHASES):
        log(f"phases run: {sorted(want)} (of 1-{ALL_PHASES[-1]})")
    t_script = time.perf_counter()
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in libs:
        for line in _build.log_path(name).read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"ptxas {name}: {line.strip()}")
    log(f"built {libs} in {build_s:.1f} s")
    for line in toolchain_lines():
        log(line)
    from kubedtn_tpu_torch import native

    t0 = time.perf_counter()
    ext = native.kdt_ext()   # raises where the headers resolve and it fails
    log(f"kdt_ext: {native.kdt_ext_path().name} in "
        f"{time.perf_counter() - t0:.1f} s" if ext is not None
        else f"kdt_ext: not built, {native.kdt_ext_reason()}")

    detail = {"card": card, "build_s": build_s, "phases": sorted(want)}
    results = {}
    k1_paths = {}
    k4_paths = {"probe": 0}
    k1_compare = {}
    launches = {}
    phase_s = {}
    keep = {}
    probe = ProbeK4().install()

    def plane_k4(path: str, total: int, probe0: int) -> None:
        """A sharded-plane path's K4 count: its planes' own launches
        (which must be there) and the probes' launches, a term of its
        own (counted from probe0)."""
        probe_k4 = probe.launches - probe0
        k4_paths[path] = total - probe_k4
        k4_paths["probe"] += probe_k4
        log(f"{path}: K4 {total} launches = {k4_paths[path]} by the "
            f"sharded planes + {probe_k4} by their exchange probes")
        check(k4_paths[path] > 0, f"K4 never launched on the {path} path's "
                                  f"sharded planes (probes aside)")

    def clock(name, t0):
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s, script "
            f"{time.perf_counter() - t_script:.1f} s so far")

    if 2 in want:
        t0 = time.perf_counter()
        el, state, _ = entry.build_clos_100k()
        check(state.capacity == 1 << 18, "Clos capacity is not 2^18")
        check(int(state.num_active) == 200_000, "Clos is not 200,000 rows")
        clock("2", t0)
    if 3 in want:
        t0 = time.perf_counter()
        shaping.reset_launches()
        state, fresh, main_m = run_main_path(el, state, dev)
        launches = dict(shaping.LAUNCHES)
        log(f"main path launches {launches}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel of the main path never launched: {launches}")
        log(f"link-updates/s {main_m['link_updates_per_s']:.1f} contiguous, "
            f"{main_m['link_updates_scattered_per_s']:.1f} scattered "
            f"(100k-link Clos; {card})")
        k1_paths["main"] = launches["shape_step_rows"]
        detail["main_path"] = main_m
        clock("3", t0)
    gen = torch.Generator(device=dev).manual_seed(5)
    timer = Timer(dev)
    if 4 in want:
        t0 = time.perf_counter()
        results.update(K1=check_k1(state, dev, timer, gen),
                       K2=check_k2(state, dev, timer, gen),
                       K3=check_k3(fresh, dev, timer))
        k3 = results["K3"]
        log(f"K3 {k3['ms'] * 1e3:.2f} us at S = {STEPS}, "
            f"{k3['ms_one_step'] * 1e3:.2f} us at S = 1; bound "
            f"{k3['bound_ms'] * 1e3:.2f} us ({k3['bound_by']}; ops "
            f"{k3['ops_ms'] * 1e3:.2f} us) ({card})")
        clock("4", t0)
    if 5 in want:
        detail["entry_delivered"] = check_entry(dev)
    if 6 in want:
        t0 = time.perf_counter()
        detail["live_tick"], k4_paths["live_tick"] = run_live_tick(dev, card)
        clock("6-8", t0)
    if 9 in want:
        results["K4"] = check_k4(dev, timer)
    if 10 in want:
        t0 = time.perf_counter()
        detail["sim"], k1_paths["sim"] = run_sim_phase(el, fresh, dev, card)
        clock("10", t0)
    if 11 in want:
        t0 = time.perf_counter()
        detail["routed"], k1_paths["routed"] = run_routed_phase(
            el, fresh, dev, card, keep=keep)
        clock("11", t0)
    plane_m = None
    if 12 in want:
        t0 = time.perf_counter()
        shaping.reset_launches()
        p0 = probe.launches
        plane_m, k4_plane = run_live_plane_phase(dev, card)
        k1_paths["plane"] = shaping.LAUNCHES["shape_step_rows"]
        plane_k4("plane", k4_plane, p0)
        log(f"live plane path launches: K1 {k1_paths['plane']}, K4 "
            f"{k4_paths['plane']}")
        check(k1_paths["plane"] > 0,
              "K1 never launched on the live plane's path")
        detail["live_plane"] = plane_m
        clock("12", t0)
    if 13 in want:
        t0 = time.perf_counter()
        shaping.reset_launches()
        detail["cross_node"] = run_cross_node_phase(dev, card)
        k1_paths["cross_node"] = shaping.LAUNCHES["shape_step_rows"]
        log(f"cross-node path launches: K1 {k1_paths['cross_node']}")
        check(k1_paths["cross_node"] > 0,
              "K1 never launched on the cross-node path")
        clock("13", t0)
    if 14 in want:
        t0 = time.perf_counter()
        detail["twin"], twin_k1 = run_twin_phase(el, fresh, dev, card)
        check(all(v > 0 for v in twin_k1.values()),
              f"K1 never launched on a twin path: {twin_k1}")
        k1_paths["twin"] = sum(twin_k1.values())
        detail["twin_k1_launches"] = twin_k1
        clock("14", t0)
    ckpt_m = None
    if 15 in want:
        t0 = time.perf_counter()
        shaping.reset_launches()
        ckpt_m = run_checkpoint_phase(dev, card)
        k1_paths["checkpoint"] = shaping.LAUNCHES["shape_step_rows"]
        ckpt_m["phase_s"] = time.perf_counter() - t0
        log(f"15: phase {ckpt_m['phase_s']:.1f} s; checkpoint path "
            f"launches: K1 {k1_paths['checkpoint']}")
        check(k1_paths["checkpoint"] > 0,
              "K1 never launched on the checkpoint path")
        detail["checkpoint"] = ckpt_m
        clock("15", t0)
    if 16 in want:
        t0 = time.perf_counter()
        p0 = probe.launches
        ten_m, k1_paths["tenancy"], k4_ten = run_tenancy_phase(
            dev, card, plane_d1_drain_share=(
                plane_m["plane"]["stage_depth1"]["share"]["drain"]
                if plane_m else None))
        plane_k4("tenancy", k4_ten, p0)
        ten_m["phase_s"] = time.perf_counter() - t0
        log(f"16: phase {ten_m['phase_s']:.1f} s; tenancy path launches: "
            f"K1 {k1_paths['tenancy']}, K4 {k4_paths['tenancy']}")
        check(k1_paths["tenancy"] > 0 and k4_paths["tenancy"] > 0,
              "K1 or K4 never launched on the tenancy path")
        if plane_m is not None and "grpc" in plane_m:
            log(f"16(f) shm ring to egress {ten_m['f']['frames_per_s']:.1f} "
                f"frames/s against 12(e)'s gRPC "
                f"{plane_m['grpc']['frames_per_s']:.1f} frames/s ({card})")
        detail["tenancy"] = ten_m
        clock("16", t0)
    if 17 in want:
        t0 = time.perf_counter()
        ap_m, k1_paths["autopilot"] = run_autopilot_phase(dev, card)
        log(f"17: phase {ap_m['phase_s']:.1f} s; autopilot path launches: "
            f"K1 {k1_paths['autopilot']}")
        check(k1_paths["autopilot"] > 0,
              "K1 never launched on the autopilot path")
        detail["autopilot"] = ap_m
        clock("17", t0)
    kept = {} if 19 in want else None
    if 18 in want:
        t0 = time.perf_counter()
        p0 = probe.launches
        mig_m, k1_paths["migration"], k4_mig = \
            run_migration_phase(dev, card, keep=kept)
        plane_k4("migration", k4_mig, p0)
        log(f"18: phase {mig_m['phase_s']:.1f} s; migration path launches: "
            f"K1 {k1_paths['migration']} (warm_kernels), K4 "
            f"{k4_paths['migration']}")
        check(k1_paths["migration"] > 0 and k4_paths["migration"] > 0,
              "K1 or K4 never launched on the migration path")
        detail["migration"] = mig_m
        clock("18", t0)
    if 19 in want:
        t0 = time.perf_counter()
        p0 = probe.launches
        fl_m, k1_paths["fleet"], k4_fleet = run_fleet_phase(
            dev, card, reuse=kept or None)
        plane_k4("fleet", k4_fleet, p0)
        kept = None
        log(f"19: fleet path launches: K1 {k1_paths['fleet']} "
            f"(warm_kernels, fallback rows), K4 {k4_paths['fleet']}")
        check(k1_paths["fleet"] > 0 and k4_paths["fleet"] > 0,
              "K1 or K4 never launched on the fleet path")
        detail["fleet"] = fl_m
        clock("19", t0)
    if 20 in want:
        t0 = time.perf_counter()
        detail["daemon"] = run_daemon_phase(dev, card)
        clock("20", t0)
    if 21 in want:
        t0 = time.perf_counter()
        shaping.reset_launches()
        mgr_m = run_manager_phase(dev, card,
                                  verb=lambda: ManagerVerb(dev, card))
        k1_paths["manager"] = shaping.LAUNCHES["shape_step_rows"]
        check(k1_paths["manager"] == MGR_K1,
              f"K1 launched {k1_paths['manager']} times on the manager's "
              f"path, want {MGR_K1} (warm_kernels, ping)")
        _free_card(dev)
        mgr_m["ladder"], ladder_k1 = run_ladder_phase(dev, card, timer)
        k1_paths["ladder"] = sum(ladder_k1.values())
        mgr_m["ladder_k1_launches"] = ladder_k1
        mgr_m["phase_s"] = time.perf_counter() - t0
        log(f"21: phase {mgr_m['phase_s']:.1f} s; K1 launches: manager "
            f"path {k1_paths['manager']} (warm_kernels, ping), rungs "
            f"{ladder_k1}")
        detail["k8s"] = mgr_m
        _free_card(dev)
        clock("21", t0)
    if 22 in want:
        t0 = time.perf_counter()
        scale_m, scale_k1 = run_scale_phase(el, fresh, dev, card,
                                            routed=keep.get("routed"))
        k1_paths["sharded_step"] = scale_k1["sharded_step"]
        k1_paths["sharded_router"] = scale_k1["sharded_router"]
        k1_paths["ladder"] = k1_paths.get("ladder", 0) + scale_k1["rungs"]
        scale_m["phase_s"] = time.perf_counter() - t0
        log(f"22: phase {scale_m['phase_s']:.1f} s; K1 launches: sharded "
            f"step {scale_k1['sharded_step']}, sharded router "
            f"{scale_k1['sharded_router']}, chaos_flaps {scale_k1['rungs']}")
        detail["scale"] = scale_m
        clock("22", t0)
    if 23 in want:
        t0 = time.perf_counter()
        soak_m, k1_paths["soaks"] = run_soak_phase(dev, card)
        soak_m["phase_s"] = time.perf_counter() - t0
        log(f"23: phase {soak_m['phase_s']:.1f} s; K1 launches: the "
            f"soaks' update gates {k1_paths['soaks']}")
        check(k1_paths["soaks"] > 0, "K1 never launched on the soaks' path")
        detail["soaks"] = soak_m
        _free_card(dev)
        clock("23", t0)
    if 24 in want:
        t0 = time.perf_counter()
        p0 = probe.launches
        probe_m, k1_24, k4_24 = run_probe_phase(dev, card, probe)
        k1_paths.update(k1_24)
        plane_k4("sharded_soak", k4_24, p0)
        k1_compare["whatif_replay"] = \
            probe_m["d_replay"]["k1_compare_launches"]
        probe_m["phase_s"] = time.perf_counter() - t0
        log(f"24: phase {probe_m['phase_s']:.1f} s; K1 launches: whatif "
            f"{k1_paths['whatif']} (+ {k1_compare['whatif_replay']} "
            f"comparing its replay with the plain version, not counted), "
            f"elsewhere in the phase {probe_m['k1_other_by_part']}; K4: "
            f"sharded_soak {k4_paths['sharded_soak']}")
        check(k1_paths["whatif"] > 0, "K1 never launched on the whatif path")
        detail["probes"] = probe_m
        _free_card(dev)
        clock("24", t0)
    if 25 in want:
        t0 = time.perf_counter()
        mp_m, k1_paths["multiprocess"], k1_compare["multiprocess_one"] = \
            run_multiprocess_phase(el, fresh, dev, card,
                                   routed=keep.pop("routed", None))
        log(f"25: phase {mp_m['phase_s']:.1f} s; K1 launches: "
            f"{k1_paths['multiprocess']} in the children (+ "
            f"{k1_compare['multiprocess_one']} by the one-process runs "
            f"they are held against, not counted); backend "
            f"{mp_m['backend']}")
        check(k1_paths["multiprocess"] > 0,
              "K1 never launched on the multiprocess path")
        detail["multiprocess"] = mp_m
        _free_card(dev)
        clock("25", t0)
    if 26 in want:
        t0 = time.perf_counter()
        p0 = probe.launches
        disp_m, k4_disp = run_dispatch_phase(dev, card)
        plane_k4("dispatch_probe", k4_disp, p0)
        log(f"26: phase {disp_m['phase_s']:.1f} s; K4 launches: the "
            f"sharded probe plane {k4_paths['dispatch_probe']}")
        detail["dispatch_probe"] = disp_m
        clock("26", t0)
    if daemon_rate:
        t0 = time.perf_counter()
        detail["daemon_rate"] = run_daemon_rate(dev, card)
        clock("daemon-rate", t0)
    probe.uninstall()
    if k4_paths["probe"] == 0:
        del k4_paths["probe"]
    if plane_m is not None and ckpt_m is not None:
        release = plane_m["plane"]["stage_depth1"]["share"]["release"]
        log(f"12(b) depth-1 release share {release} with kdt_ext "
            f"{'loaded' if ckpt_m['kdt_ext'] else 'not loaded'} ({card})")
    log(f"K1 launches by path {k1_paths}")
    log(f"phase seconds {phase_s}; script "
        f"{time.perf_counter() - t_script:.1f} s ({card})")

    meta = {"K1": ("shape_step_rows", 220), "K2": ("shape_steps_cols", 250),
            "K3": ("shape_steps_cols_philox", 277)}
    kernels = []
    for k, (name, line) in meta.items():
        if k not in results:
            continue
        r = results[k]
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": SRC,
            "replaces": f"{PALLAS}:{line}", "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
        if k == "K1":
            # K1 carries several paths, each counted from 0: their sum,
            # and each
            kernels[-1].update(launches=sum(k1_paths.values()),
                               launches_by_path=k1_paths)
            if k1_compare:   # launches that compared K1 with plain
                kernels[-1]["compare_launches"] = k1_compare
            big = detail.get("k8s", {}).get("ladder", {}).get("k1_2m")
            if big and "ms" in big:   # scale_1m's 2^21 rows (21(c))
                kernels[-1]["at_rows"] = {
                    big["rows"]: {k2: big[k2] for k2 in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "max_abs_err")}}
    if "K4" in results:
        r = results["K4"][K4_ROWS[0]]   # the live tick's mailbox shape
        kernels.append({
            "name": "K4 ring_step", "route": "cuda", "source": K4_SRC,
            "replaces": K4_REPLACES, "launches": sum(k4_paths.values()),
            "launches_by_path": k4_paths,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    detail.update(phase_s=phase_s, kernels=results)
    log("detail " + json.dumps(detail))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit as e:
        if e.code in (0, None):
            raise
        # a failed check or a refusal: say why and leave at once. Each
        # phase has stopped its servers, planes and children on the way
        # out; the interpreter's own teardown after a failed phase has
        # crashed on the card (exit 139, torch.profiler's callbacks and
        # the peers' threads mid-way), which would hide the exit code.
        if not isinstance(e.code, int):
            print(e.code, file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(e.code if isinstance(e.code, int) else 1)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
