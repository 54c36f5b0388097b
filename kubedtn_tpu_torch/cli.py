"""tpudtn-torch CLI — operator entry point of the PyTorch/CUDA port.

Subsumes the reference's operator tooling: the daemon runtime (`daemon`,
the DaemonSet's process), scenario loading (`apply`, like kubectl apply
of the sample YAMLs), the ping smoke test (reference hack/test-3node.sh),
the physical-host join CLI (reference cmd/main.go) as `physical-join`,
plus the client verbs of every daemon surface and the ported scenarios.

Usage:
  python -m kubedtn_tpu_torch.cli apply config/samples/ring4.yaml
  python -m kubedtn_tpu_torch.cli ping sat-a sat-b --file ring4.yaml
  python -m kubedtn_tpu_torch.cli daemon --port 51111 --metrics-port 51112
  python -m kubedtn_tpu_torch.cli daemon --device cpu --port 0
  python -m kubedtn_tpu_torch.cli manager --leader-elect --probe-port 0 \\
      --metrics-port 0
  python -m kubedtn_tpu_torch.cli physical-join link.yml \\
      --daemon 127.0.0.1:51111
  (installed: `tpudtn-torch ...`)

Port of kubedtn_tpu/cli.py: the same subcommands, positionals, flags,
defaults and choices, and the same output (JSON keys, text tables, exit
codes), with these differences:

- Every verb that builds an engine, sweeps or serves (`daemon`,
  `manager`, `apply FILE`, `ping`, `trace --file`, `whatif --file`,
  `scenario`) takes
  `--device {cuda,cpu}`, default cuda. Without a card and without
  `--device cpu` it prints why on stderr and exits 2 before it builds or
  binds anything; nothing falls back to the CPU by itself.
- `daemon --profile DIR` captures the daemon's lifetime with torch's
  kineto profiler (utils/tracing.device_trace); `--jax-profile` is the
  same flag under the JAX CLI's name, so manifests written for it start
  unchanged. There is no compilation cache to set up: the kernels build
  at first use into kubedtn_tpu_torch/_build/. The daemon launches
  kernel K1 once at boot (`warm_kernels`), so its first tick does not
  pay the kernels' load.
- `manager` runs the controller manager (topology/manager.py) over a
  SimEngine on --device, with the JAX verb's flags and ready line.
- `bench` is not ported (the port's benchmark is its own). `scenario`
  runs scenarios.LADDER, the JAX ladder's 27 scenarios.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _rpc_code(e) -> str:
    """Short status-code name for a grpc.RpcError (shared by every verb
    that dials a daemon)."""
    try:
        return e.code().name
    except Exception:
        return type(e).__name__


def _json_safe(obj):
    """inf/nan are not valid JSON — emit null for unreachable values."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _device(args, verb: str):
    """The torch device a verb that builds an engine runs on (--device,
    cuda by default), or None after saying on stderr why not: no card
    and no `--device cpu`. The caller then exits 2 — nothing falls back
    to the CPU by itself."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{verb}: no CUDA device is available; pass --device cpu "
              f"to run on the host", file=sys.stderr)
        return None
    return torch.device(args.device)


def cmd_apply(args) -> int:
    if getattr(args, "plan", None):
        return _cmd_apply_plan(args)
    if not args.file:
        print("apply needs a topology YAML file, or --plan ID --daemon "
              "HOST:PORT to apply a staged plan", file=sys.stderr)
        return 1
    device = _device(args, "apply")
    if device is None:
        return 2
    from kubedtn_tpu_torch.api.types import load_yaml
    from kubedtn_tpu_torch.topology import (Reconciler, SimEngine,
                                            TopologyStore)

    store = TopologyStore()
    engine = SimEngine(store, device=device)
    topos = load_yaml(args.file)
    for t in topos:
        t.validate()
        store.create(t)
    for t in topos:
        engine.setup_pod(t.name, t.namespace)
    rec = Reconciler(store, engine)
    results = rec.drain()
    print(json.dumps({
        "topologies": len(topos),
        "links_realized": engine.num_active,
        "reconciles": len(results),
    }))
    return 0


def _cmd_apply_plan(args) -> int:
    """`kdt apply --plan ID --daemon HOST:PORT`: stage a previously
    verified plan through the daemon's live plane (watch windows +
    automatic rollback — Local.ApplyPlan)."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(args.daemon)
    try:
        resp = client.ApplyPlan(
            pb.ApplyPlanRequest(plan_id=int(args.plan),
                                observe_ticks=args.observe_ticks),
            timeout=args.timeout)
    except grpc.RpcError as e:
        print(f"apply: daemon {args.daemon} RPC failed: {_rpc_code(e)}",
              file=sys.stderr)
        return 1
    finally:
        client.close()
    out = {"ok": bool(resp.ok), "rounds_applied": resp.rounds_applied,
           "rolled_back": bool(resp.rolled_back),
           "reason": resp.reason or resp.error,
           "stage_s": resp.stage_s}
    print(json.dumps(_json_safe(out)))
    return 0 if resp.ok else 1


def cmd_plan(args) -> int:
    """`kdt plan topo.yml --daemon HOST:PORT`: declare each topology's
    desired links, get back the ordered schedule + the twin gate's
    verdict, and (when verified) a plan id for `kdt apply --plan`
    (Local.PlanUpdate)."""
    import grpc

    from kubedtn_tpu_torch.api.types import load_yaml
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    try:
        topos = load_yaml(args.file)
    except (OSError, ValueError) as e:
        print(f"plan: {e}", file=sys.stderr)
        return 1
    none_if = lambda v: None if v < 0 else v  # noqa: E731
    client = DaemonClient(args.daemon)
    results = []
    rc = 0
    try:
        for t in topos:
            req = pb.PlanUpdateRequest(
                name=t.name, kube_ns=t.namespace,
                links=[pb.link_to_proto(l) for l in t.spec.links],
                ticks=args.ticks, dt_us=args.dt_us,
                max_delivery_drop=args.max_delivery_drop,
                max_p99_factor=args.max_p99_factor,
                max_round_edits=args.max_round_edits, seed=args.seed)
            try:
                resp = client.PlanUpdate(req, timeout=args.timeout)
            except grpc.RpcError as e:
                print(f"plan: daemon {args.daemon} RPC failed: "
                      f"{_rpc_code(e)}", file=sys.stderr)
                return 1
            key = f"{t.namespace}/{t.name}"
            if not resp.ok:
                results.append({"topology": key, "ok": False,
                                "error": resp.error})
                rc = 1
                continue
            results.append({
                "topology": key,
                "ok": True,
                "verified": bool(resp.verified),
                "plan_id": int(resp.plan_id),
                "reject_reason": resp.reject_reason,
                "rounds": [{
                    "index": r.index, "adds": r.adds,
                    "changes": r.changes, "dels": r.dels,
                    "delivery_ratio": none_if(r.delivery_ratio),
                    "p99_us": none_if(r.p99_us),
                } for r in resp.rounds],
                "baseline_delivery_ratio": none_if(
                    resp.baseline_delivery_ratio),
                "baseline_p99_us": none_if(resp.baseline_p99_us),
                "gate_s": resp.gate_s,
                "skipped_adds": resp.skipped_adds,
            })
            if not resp.verified:
                rc = 1
    finally:
        client.close()
    if args.json:
        print(json.dumps(_json_safe({"plans": results})))
        return rc
    for r in results:
        if not r["ok"]:
            print(f"{r['topology']}: ERROR {r['error']}")
            continue
        if not r["rounds"]:
            print(f"{r['topology']}: no changes (empty diff)")
            continue
        verdict = ("VERIFIED" if r["verified"]
                   else f"REJECTED ({r['reject_reason']})")
        base = r["baseline_delivery_ratio"]
        base_s = f"{100 * base:.2f}%" if base is not None else "-"
        print(f"{r['topology']}: {verdict}  plan_id={r['plan_id']}  "
              f"rounds={len(r['rounds'])}  baseline_delivery={base_s}  "
              f"gate={r['gate_s']:.2f}s"
              + (f"  skipped_adds={r['skipped_adds']}"
                 if r["skipped_adds"] else ""))
        for rd in r["rounds"]:
            dr = rd["delivery_ratio"]
            dr_s = f"{100 * dr:.2f}%" if dr is not None else "-"
            p99 = rd["p99_us"]
            p99_s = f"{p99:.0f}us" if p99 is not None else "-"
            print(f"  round {rd['index'] + 1}: +{rd['adds']} "
                  f"~{rd['changes']} -{rd['dels']}  delivery={dr_s}  "
                  f"p99={p99_s}")
        if r["verified"]:
            print(f"  apply with: kdt apply --plan {r['plan_id']} "
                  f"--daemon {args.daemon}")
    return rc


def _engine_from_yaml(path, device):
    from kubedtn_tpu_torch.api.types import load_yaml
    from kubedtn_tpu_torch.topology import (Reconciler, SimEngine,
                                            TopologyStore)

    store = TopologyStore()
    engine = SimEngine(store, device=device)
    topos = load_yaml(path)
    for t in topos:
        store.create(t)
    for t in topos:
        engine.setup_pod(t.name, t.namespace)
    Reconciler(store, engine).drain()
    return engine, topos


def cmd_ping(args) -> int:
    device = _device(args, "ping")
    if device is None:
        return 2
    engine, topos = _engine_from_yaml(args.file, device)
    uid = args.uid
    if uid is None:
        for t in topos:
            if t.name != args.a:
                continue
            for l in t.spec.links:
                if l.peer_pod == args.b:
                    uid = l.uid
    if uid is None:
        print(f"no link between {args.a} and {args.b}", file=sys.stderr)
        return 1
    out = engine.ping(args.a, args.b, uid)
    print(json.dumps(_json_safe(out)))
    return 0 if out["reachable"] else 1


def cmd_trace(args) -> int:
    """Two modes sharing one verb:

    - path mode (`kdt trace a b --file topo.yml`): multi-hop route
      query across the fabric (ping's traceroute sibling);
    - flight-recorder mode (`kdt trace <trace-id|latest> --daemon A
      [--daemon B ...]`): reconstruct a SAMPLED FRAME's hop-by-hop
      lifecycle — ingress → bypass/shaped → delivered/dropped(cause) →
      staged-peer → outage-buffered/retried → peer-sent → received —
      by merging the flight-recorder events of every named daemon
      (cross-node trace correlation, Local.ObserveTrace)."""
    if args.daemon:
        return _cmd_trace_flight(args)
    if not args.file or args.b is None:
        print("trace needs `a b --file topo.yml` (path mode) or "
              "`<trace-id|latest> --daemon HOST:PORT` (flight-recorder "
              "mode)", file=sys.stderr)
        return 1
    device = _device(args, "trace")
    if device is None:
        return 2
    engine, _ = _engine_from_yaml(args.file, device)
    out = engine.trace(args.a, args.b, max_hops=args.max_hops)
    print(json.dumps(_json_safe(out)))
    return 0 if out["reachable"] else 1


def _cmd_trace_flight(args) -> int:
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    clients = []
    try:
        for addr in args.daemon:
            clients.append((addr, DaemonClient(addr)))

        def observe(client, tid):
            return client.ObserveTrace(
                pb.ObserveTraceRequest(trace_id=tid,
                                       limit=args.max_hops * 64),
                timeout=10.0)

        tid = 0
        if args.a != "latest":
            try:
                tid = int(args.a, 0)  # decimal or 0x-hex
            except ValueError:
                print(f"trace: {args.a!r} is not a trace id (use a "
                      f"decimal/hex id or 'latest')", file=sys.stderr)
                return 1
        events = []
        recents: list[int] = []
        for addr, client in clients:
            try:
                resp = observe(client, tid)
            except grpc.RpcError as e:
                print(f"trace: daemon {addr} RPC failed: "
                      f"{_rpc_code(e)}", file=sys.stderr)
                return 1
            if not resp.ok:
                print(f"trace: {addr}: {resp.error}", file=sys.stderr)
                return 1
            recents.extend(int(t) for t in resp.recent_traces)
            events.extend(
                {"trace_id": int(e.trace_id), "t": e.t, "node": e.node,
                 "stage": e.stage, "detail": e.detail}
                for e in resp.events)
        if tid == 0:
            # newest sampled trace across the daemons, preferring one
            # with a complete local story (an ingress event)
            have_ingress = {e["trace_id"] for e in events
                            if e["stage"] == "ingress"}
            pick = next((t for t in recents if t in have_ingress),
                        recents[0] if recents else 0)
            if not pick:
                print("trace: no sampled traces recorded yet",
                      file=sys.stderr)
                return 1
            tid = pick
        path = sorted((e for e in events if e["trace_id"] == tid),
                      key=lambda e: e["t"])
        if args.json:
            print(json.dumps(_json_safe({"trace_id": tid,
                                         "events": path})))
            return 0
        if not path:
            print(f"trace: no events for {tid:#x}", file=sys.stderr)
            return 1
        from kubedtn_tpu_torch.telemetry import render_trace

        print(render_trace(
            path, header=f"trace {tid:#018x} ({len(path)} events, "
                         f"{len(set(e['node'] for e in path))} "
                         f"node(s))"))
        return 0
    finally:
        for _addr, client in clients:
            client.close()


def cmd_top(args) -> int:
    """Live ranked per-link table from a daemon's link telemetry plane
    (Local.ObserveLinks): delivery rate, p50/p99 shaping latency, and
    drops BY CAUSE per link — the per-edge time-series view the
    reference daemon never had."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(args.daemon)
    try:
        for it in range(args.count):
            if it:
                time.sleep(args.interval)
            try:
                resp = client.ObserveLinks(
                    pb.ObserveLinksRequest(top_n=args.top,
                                           windows=args.windows),
                    timeout=10.0)
            except grpc.RpcError as e:
                print(f"top: daemon {args.daemon} RPC failed: "
                      f"{_rpc_code(e)}", file=sys.stderr)
                return 1
            if not resp.ok:
                print(f"top: {resp.error}", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(_json_safe({
                    "covered_seconds": resp.covered_seconds,
                    "windows_closed": resp.windows_closed,
                    "truncated": resp.truncated,
                    "links": [{
                        "pod": l.pod, "namespace": l.namespace,
                        "uid": l.uid, "delivered_pps": l.delivered_pps,
                        "bytes_ps": l.bytes_ps, "tx": l.tx,
                        "delivered": l.delivered,
                        "dropped_loss": l.dropped_loss,
                        "dropped_queue": l.dropped_queue,
                        "corrupted": l.corrupted,
                        "queue_depth": l.queue_depth,
                        "p50_us": None if l.p50_us < 0 else l.p50_us,
                        "p99_us": None if l.p99_us < 0 else l.p99_us,
                        "p99_censored": l.p99_censored,
                    } for l in resp.links]})))
                continue
            # censored quantile = clamped at the ladder's open top
            # bucket: the real value is >= it, so render ">5000.00ms"
            # — never an "=" that silently understates the tail
            fmt_us = lambda v, c=False: (  # noqa: E731
                "-" if v < 0 else f"{'>' if c else ''}{v / 1000:.2f}ms")
            print(f"links via {args.daemon} — window "
                  f"{resp.covered_seconds:.1f}s "
                  f"({resp.windows_closed} closed"
                  + (f", {resp.truncated} truncated" if resp.truncated
                     else "") + ")")
            hdr = (f"{'link':<24}{'rate/s':>10}{'p50':>10}{'p99':>10}"
                   f"{'loss':>8}{'queue':>8}{'corrupt':>8}{'qdepth':>8}")
            print(hdr)
            for l in resp.links:
                name = f"{l.pod}/uid{l.uid}"
                print(f"{name:<24}{l.delivered_pps:>10.1f}"
                      f"{fmt_us(l.p50_us):>10}"
                      f"{fmt_us(l.p99_us, l.p99_censored):>10}"
                      f"{l.dropped_loss:>8.0f}{l.dropped_queue:>8.0f}"
                      f"{l.corrupted:>8.0f}{l.queue_depth:>8.0f}")
    finally:
        client.close()
    return 0


def _slo_row_dict(t) -> dict:
    """One wire SloTenant row as a JSON-safe dict (shared by the
    single-daemon and fleet-merge paths)."""
    none_if = lambda v: None if v < 0 else v  # noqa: E731
    return {
        "tenant": t.tenant, "qos": t.qos,
        "spec": {
            "delivery_ratio_floor": t.delivery_ratio_floor,
            "p99_bound_us": t.p99_bound_us,
            "p999_bound_us": t.p999_bound_us,
            # burn-alerting half — omitted (0) fields fall back to
            # the SloSpec defaults in the client-side merge
            **({"fast_windows": t.fast_windows}
               if t.fast_windows else {}),
            **({"slow_windows": t.slow_windows}
               if t.slow_windows else {}),
            **({"warn_burn": t.warn_burn} if t.warn_burn else {}),
            **({"page_burn": t.page_burn} if t.page_burn else {}),
        },
        "window_seconds": t.window_seconds,
        "tx": t.tx, "delivered": t.delivered,
        "delivery_ratio": none_if(t.delivery_ratio),
        "p50_us": none_if(t.p50_us),
        "p99_us": none_if(t.p99_us),
        "p99_censored": t.p99_censored,
        "p999_us": none_if(t.p999_us),
        "tail_method": t.tail_method,
        "fast_burn": t.fast_burn, "slow_burn": t.slow_burn,
        "budget_remaining": t.budget_remaining,
        "throttle_backlog": t.throttle_backlog,
        "attainment_ok": t.attainment_ok,
        "latency_ok": t.latency_ok,
        "severity": t.severity,
        "hist": list(t.hist),
        "frozen": t.frozen, "plane": t.plane,
        "planes": list(t.planes),
        "frozen_planes": list(t.frozen_planes),
        "frozen_tx": t.frozen_tx,
        "frozen_delivered": t.frozen_delivered,
    }


def _render_slo_table(rows: list[dict], title: str) -> None:
    """Fixed-width per-tenant SLO table: attainment vs floor,
    estimated tails (a censored p99 renders `>Xms`), burn rates,
    remaining budget, severity."""
    fmt_ms = lambda v, c=False: (  # noqa: E731
        "-" if v is None else f"{'>' if c else ''}{v / 1000:.2f}ms")
    fmt_pct = lambda v: "-" if v is None else f"{100 * v:.3f}%"  # noqa: E731
    print(title)
    hdr = (f"{'tenant':<14}{'qos':<8}{'attain':>9}{'floor':>9}"
           f"{'p99(est)':>11}{'p99.9(est)':>12}{'fast':>7}{'slow':>7}"
           f"{'budget':>8}  status")
    print(hdr)
    for r in rows:
        status = r["severity"]
        if r.get("frozen"):
            status = "frozen"
        elif not (r["attainment_ok"] and r["latency_ok"]):
            status += " MISS"
        extra = ""
        if r.get("planes") or r.get("frozen_planes"):
            parts = list(r.get("planes") or ())
            parts += [f"{p}(frozen)" for p in
                      r.get("frozen_planes") or ()]
            extra = "  [" + ", ".join(parts) + "]"
        elif r.get("plane"):
            extra = f"  [{r['plane']}]"
        tail = fmt_ms(r["p999_us"],
                      r["tail_method"] == "censored-clamp")
        print(f"{r['tenant']:<14}{r['qos'] or '-':<8}"
              f"{fmt_pct(r['delivery_ratio']):>9}"
              f"{fmt_pct(r['spec']['delivery_ratio_floor']):>9}"
              f"{fmt_ms(r['p99_us'], r['p99_censored']):>11}"
              f"{tail:>12}"
              f"{r['fast_burn']:>7.2f}{r['slow_burn']:>7.2f}"
              f"{100 * r['budget_remaining']:>7.1f}%"
              f"  {status}{extra}")


def _autopilot_action_dict(a) -> dict:
    """One wire AutopilotAction as a JSON-safe dict."""
    return {
        "id": a.id, "t": a.t, "tenant": a.tenant, "kind": a.kind,
        "candidate": a.candidate, "verdict": a.verdict,
        "reason": a.reason, "staged": a.staged,
        "rejected": a.rejected, "rolled_back": a.rolled_back,
        "dry_run": a.dry_run, "candidates": a.candidates,
        "plans": a.plans, "baseline_burn": a.baseline_burn,
        "projected_burn": a.projected_burn, "compile_s": a.compile_s,
        "run_s": a.run_s, "gate_s": a.gate_s, "stage_s": a.stage_s,
        "time_to_green_s": a.time_to_green_s,
    }


def _autopilot_last_actions(addr: str, tenant: str,
                            timeout: float) -> list[dict] | None:
    """Each tenant's last autopilot action from one daemon, or None
    when the daemon has no autopilot attached / the RPC fails — the
    `kdt slo` audit column must never break the burn view."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(addr)
    try:
        resp = client.AutopilotStatus(
            pb.AutopilotStatusRequest(tenant=tenant or ""),
            timeout=timeout)
    except grpc.RpcError:
        return None
    finally:
        client.close()
    if not resp.ok:
        return None
    out = []
    for s in resp.states:
        if not s.HasField("last_action"):
            continue
        d = _autopilot_action_dict(s.last_action)
        d["tenant"] = d["tenant"] or s.tenant
        d["state"] = s.state
        out.append(d)
    return out


def _render_autopilot_actions(acts: list[dict],
                              title: str = "") -> None:
    if title:
        print(title)
    print(f"{'tenant':<14}{'id':>5}  {'candidate':<24}"
          f"{'verdict':<12}{'proj.burn':>10}{'ttg':>8}  reason")
    for a in acts:
        ttg = (f"{a['time_to_green_s']:.1f}s"
               if a.get("time_to_green_s") else "-")
        print(f"{a['tenant'] or '(fleet)':<14}{a['id']:>5}  "
              f"{a['candidate'] or '-':<24}{a['verdict'] or '-':<12}"
              f"{a['projected_burn']:>10.3f}{ttg:>8}"
              f"  {a['reason'][:60]}")


def cmd_autopilot(args) -> int:
    """`kdt autopilot status|enable|disable|dry-run|history` — the
    SLO autopilot's operator surface (Local.Autopilot* framework
    extensions): switch the remediation loop, audit the per-tenant
    state machine and every action it took (delta id, gate verdict,
    time-to-green)."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(args.daemon)
    try:
        if args.action in ("enable", "disable", "dry-run"):
            wire_action = args.action
            if args.action == "dry-run":
                wire_action = ("dry-run-on" if args.value != "off"
                               else "dry-run-off")
            resp = client.AutopilotCtl(
                pb.AutopilotCtlRequest(action=wire_action),
                timeout=args.timeout)
            if not resp.ok:
                print(f"autopilot: {resp.error}", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps({"enabled": resp.enabled,
                                  "dry_run": resp.dry_run}))
            else:
                print(f"autopilot enabled={resp.enabled} "
                      f"dry_run={resp.dry_run}")
            return 0
        history = (int(args.limit) if args.action == "history"
                   else 0)
        resp = client.AutopilotStatus(
            pb.AutopilotStatusRequest(tenant=args.tenant or "",
                                      history=history),
            timeout=args.timeout)
    except grpc.RpcError as e:
        print(f"autopilot: daemon RPC failed: {_rpc_code(e)}",
              file=sys.stderr)
        return 1
    finally:
        client.close()
    if not resp.ok:
        print(f"autopilot: {resp.error}", file=sys.stderr)
        return 1
    states = [{
        "tenant": s.tenant, "state": s.state, "pages": s.pages,
        "fails": s.fails, "hold_remaining_s": s.hold_remaining_s,
        **({"last_action": _autopilot_action_dict(s.last_action)}
           if s.HasField("last_action") else {}),
    } for s in resp.states]
    actions = [_autopilot_action_dict(a) for a in resp.actions]
    if args.json:
        print(json.dumps(_json_safe({
            "enabled": resp.enabled, "dry_run": resp.dry_run,
            "running": resp.running, "states": states,
            "actions": actions,
            "pages_seen": resp.pages_seen,
            "searches_run": resp.searches_run,
            "deltas_staged": resp.deltas_staged,
            "deltas_rejected": resp.deltas_rejected,
            "deltas_rolled_back": resp.deltas_rolled_back,
            "escalations": resp.escalations})))
        return 0
    if args.action == "history":
        if not actions:
            print("autopilot: no actions recorded yet")
            return 0
        _render_autopilot_actions(
            actions, title=f"autopilot history via {args.daemon} "
                           f"({len(actions)} action(s))")
        return 0
    print(f"autopilot via {args.daemon} — "
          f"enabled={resp.enabled} dry_run={resp.dry_run} "
          f"running={resp.running}")
    print(f"pages={resp.pages_seen} searches={resp.searches_run} "
          f"staged={resp.deltas_staged} "
          f"rejected={resp.deltas_rejected} "
          f"rolled_back={resp.deltas_rolled_back} "
          f"escalations={resp.escalations}")
    if not states:
        print("no tenants observed yet")
        return 0
    print(f"{'tenant':<14}{'state':<10}{'pages':>6}{'fails':>6}"
          f"{'hold':>8}  last action")
    for s in states:
        hold = (f"{s['hold_remaining_s']:.1f}s"
                if s["hold_remaining_s"] else "-")
        la = s.get("last_action")
        last = (f"#{la['id']} {la['candidate'] or la['kind']} "
                f"-> {la['verdict']}" if la else "-")
        print(f"{s['tenant']:<14}{s['state']:<10}{s['pages']:>6}"
              f"{s['fails']:>6}{hold:>8}  {last}")
    return 0


def cmd_slo(args) -> int:
    """`kdt slo [--tenant T] [--fleet]` — the SLO observability plane's
    operator surface (Local.ObserveSLO): per-tenant attainment vs
    objective, censored-tail-estimated p99/p99.9, multi-window burn
    rates and remaining error budget. With --fleet and SEVERAL
    --daemon addresses the answers are merged CLIENT-side on the
    shared bucket ladder (exact), stitching a migrated tenant's frozen
    pre-move slice with its live post-move window — the continuous
    fleet view; a single daemon with a fleet supervisor serves its
    server-side merge instead."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    daemons = args.daemon or ["127.0.0.1:51111"]
    if len(daemons) > 1 and not args.fleet:
        # without --fleet only one daemon's answer could be shown —
        # silently dropping the others would read as "tenant missing"
        print("slo: several --daemon addresses need --fleet (the "
              "cross-plane merge)", file=sys.stderr)
        return 1
    fleet_many = args.fleet and len(daemons) > 1
    fleet_local = args.fleet and len(daemons) == 1
    responses = []
    for addr in daemons:
        client = DaemonClient(addr)
        try:
            resp = client.ObserveSLO(
                pb.ObserveSLORequest(tenant=args.tenant or "",
                                     fleet=fleet_local),
                timeout=args.timeout)
        except grpc.RpcError as e:
            # a multi-daemon fleet merge TOLERATES a dead plane (the
            # supervisor's server-side merge does the same): the view
            # must stay available during exactly the outage the
            # operator is looking into — warn and merge the rest
            print(f"slo: daemon {addr} RPC failed: {_rpc_code(e)}"
                  + (" (merging the remaining planes)" if fleet_many
                     else ""), file=sys.stderr)
            if not fleet_many:
                return 1
            continue
        finally:
            client.close()
        if not resp.ok:
            print(f"slo: {addr}: {resp.error}", file=sys.stderr)
            if not fleet_many:
                return 1
            continue
        responses.append((addr, resp))
    if not responses:
        print("slo: no daemon answered", file=sys.stderr)
        return 1

    if args.fleet and len(daemons) > 1:
        # client-side merge over every daemon's answer: live rows per
        # plane + frozen journal slices, the same slo.fleet arithmetic
        # the supervisor runs server-side
        from kubedtn_tpu_torch.slo.fleet import fleet_slo as _merge

        per_plane: dict = {}
        frozen = []
        for addr, resp in responses:
            plane = resp.plane or addr
            for t in resp.tenants:
                d = _slo_row_dict(t)
                if d["frozen"]:
                    frozen.append((d["plane"] or plane, d["tenant"],
                                   {"tx": d["tx"],
                                    "delivered": d["delivered"],
                                    "window_seconds":
                                        d["window_seconds"],
                                    "hist": d["hist"]}, d["qos"]))
                else:
                    per_plane.setdefault(plane, []).append(d)
        merged = _merge(per_plane, frozen, tenant=args.tenant or "")
        rows = [merged[k] for k in sorted(merged)]
        title = (f"fleet SLO via {', '.join(daemons)} "
                 f"({len(rows)} tenant(s))")
    else:
        _addr, resp = responses[0]
        rows = [_slo_row_dict(t) for t in resp.tenants]
        if fleet_local and not resp.fleet:
            # the daemon has no fleet supervisor: it answered with its
            # own plane only — say so instead of mislabeling the view
            print("slo: daemon has no fleet supervisor — showing its "
                  "single-plane view", file=sys.stderr)
        where = ("fleet view via" if fleet_local and resp.fleet
                 else "SLO via")
        title = (f"{where} {daemons[0]} — {resp.windows_closed} "
                 f"windows closed, {resp.evaluations} evaluations")
    if args.tenant:
        rows = [r for r in rows if r["tenant"] == args.tenant]
    # the autopilot's audit trail rides the same command the operator
    # uses to see the burn: each tenant's last action (single-daemon
    # views only — the fleet merge has no one autopilot to ask)
    autopilot = None
    if len(daemons) == 1:
        autopilot = _autopilot_last_actions(
            daemons[0], args.tenant or "", args.timeout)
    if args.json:
        out = {"tenants": rows}
        if autopilot is not None:
            out["autopilot"] = autopilot
        print(json.dumps(_json_safe(out)))
        return 0
    if not rows:
        print("slo: no tenants evaluated yet (no tenancy registry, "
              "or no telemetry windows closed)", file=sys.stderr)
        return 1
    _render_slo_table(rows, title)
    if autopilot:
        _render_autopilot_actions(
            autopilot, title="autopilot last actions:")
    return 0


def _pauses_payload(resp) -> dict:
    """One wire ObservePausesResponse as a JSON-safe dict."""
    return {
        "enabled": resp.enabled,
        "uptime_s": resp.uptime_s,
        "total_pause_s": resp.total_pause_s,
        "dropped_events": resp.dropped_events,
        "tick_edges_s": list(resp.tick_edges_s),
        "causes": [{
            "cause": c.cause, "count": c.count, "seconds": c.seconds,
            "max_s": c.max_s, "last_s": c.last_s,
            "last_t_s": c.last_t_s, "rows": c.rows, "bytes": c.bytes,
            "tick_buckets": list(c.tick_buckets),
            "tick_count": c.tick_count, "tick_sum_s": c.tick_sum_s,
        } for c in resp.causes],
        "events": [{
            "cause": e.cause, "dur_s": e.dur_s, "t_s": e.t_s,
            "detail": e.detail,
        } for e in resp.events],
    }


def _render_pauses(resp, addr: str) -> None:
    share = (100.0 * resp.total_pause_s / resp.uptime_s
             if resp.uptime_s > 0 else 0.0)
    print(f"pauses via {addr} — uptime {resp.uptime_s:.1f}s, "
          f"total pause {resp.total_pause_s:.3f}s "
          f"({share:.2f}% of wall), "
          f"ledger {'on' if resp.enabled else 'OFF'}"
          + (f", {resp.dropped_events} events dropped"
             if resp.dropped_events else ""))
    # ranked worst cause first: cumulative seconds is the availability
    # cost, which is what the savail budget ceilings
    ranked = sorted(resp.causes, key=lambda c: -c.seconds)
    print(f"{'cause':<20}{'count':>7}{'seconds':>10}{'max':>9}"
          f"{'last':>9}{'rows':>10}{'bytes':>12}{'ticks':>7}")
    for c in ranked:
        if c.cause == "none" and not c.count:
            # clean ticks carry only the histogram row below
            print(f"{'(clean ticks)':<20}{'-':>7}{'-':>10}{'-':>9}"
                  f"{'-':>9}{'-':>10}{'-':>12}{c.tick_count:>7}")
            continue
        print(f"{c.cause:<20}{c.count:>7}{c.seconds:>10.3f}"
              f"{c.max_s:>9.3f}{c.last_s:>9.3f}{c.rows:>10}"
              f"{c.bytes:>12}{c.tick_count:>7}")
    for e in resp.events:
        det = f"  {e.detail}" if e.detail else ""
        print(f"  [{e.t_s:>9.3f}s] {e.cause:<18} "
              f"{e.dur_s * 1000:.2f}ms{det}")


def cmd_pauses(args) -> int:
    """`kdt pauses [--json] [--watch] [--events N]` — the pause/stall
    observability plane's operator surface (Local.ObservePauses): a
    ranked worst-cause table of every tick-lock barrier the plane paid
    (checkpoint / compact / staged update / migration / flush / shm
    stall / jit compile / GC), each with count, cumulative and worst
    duration, and rows/bytes touched — the answer to "why did tick
    latency spike at 14:02"."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(args.daemon)
    try:
        while True:
            try:
                resp = client.ObservePauses(
                    pb.ObservePausesRequest(cause=args.cause or "",
                                            events=args.events),
                    timeout=args.timeout)
            except grpc.RpcError as e:
                print(f"pauses: daemon {args.daemon} RPC failed: "
                      f"{_rpc_code(e)}", file=sys.stderr)
                return 1
            if not resp.ok:
                print(f"pauses: {resp.error}", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(_json_safe(_pauses_payload(resp))),
                      flush=True)
            else:
                _render_pauses(resp, args.daemon)
            if not args.watch:
                return 0
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0
            if not args.json:
                print()
    finally:
        client.close()


def cmd_tenant(args) -> int:
    """`kdt tenant create|list|quota|stats` — the multi-tenant plane's
    operator surface (Local.Tenant* framework extensions): register a
    tenant with QoS class / admission budgets / an optional reserved
    edge block, inspect per-tenant quotas and live stats."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(args.daemon)

    def info_dict(t) -> dict:
        return {
            "name": t.name, "qos": t.qos,
            "namespaces": list(t.namespaces),
            "frame_budget_per_s": t.frame_budget_per_s,
            "byte_budget_per_s": t.byte_budget_per_s,
            "block": ([t.block_lo, t.block_hi]
                      if t.block_lo >= 0 else None),
            "links": t.links,
        }

    try:
        if args.action in ("create", "quota"):
            spec = pb.TenantSpec(
                name=args.name, qos=args.qos or "",
                frame_budget_per_s=args.frames_per_s,
                byte_budget_per_s=args.bytes_per_s,
                block_edges=args.block_edges,
                namespaces=args.namespace or [])
            rpc = (client.TenantCreate if args.action == "create"
                   else client.TenantQuota)
            resp = rpc(spec, timeout=args.timeout)
            if not resp.ok:
                print(f"tenant {args.action}: {resp.error}",
                      file=sys.stderr)
                return 1
            print(json.dumps(_json_safe(info_dict(resp.tenant))))
            return 0
        if args.action == "list":
            resp = client.TenantList(pb.TenantQuery(name=args.name
                                                    or ""),
                                     timeout=args.timeout)
            if not resp.ok:
                print(f"tenant list: {resp.error}", file=sys.stderr)
                return 1
            print(json.dumps(_json_safe(
                {"tenants": [info_dict(t) for t in resp.tenants]})))
            return 0
        if args.action == "delete":
            if not args.name:
                print("tenant delete needs a tenant name",
                      file=sys.stderr)
                return 1
            resp = client.TenantDelete(pb.TenantQuery(name=args.name),
                                       timeout=args.timeout)
            if not resp.ok:
                print(f"tenant delete: {resp.error}", file=sys.stderr)
                return 1
            print(json.dumps({"deleted": args.name}))
            return 0
        # stats
        if not args.name:
            print("tenant stats needs a tenant name", file=sys.stderr)
            return 1
        resp = client.TenantStats(pb.TenantQuery(name=args.name),
                                  timeout=args.timeout)
        if not resp.ok:
            print(f"tenant stats: {resp.error}", file=sys.stderr)
            return 1
        none_if = lambda v: None if v < 0 else v  # noqa: E731
        out = {
            **info_dict(resp.tenant),
            "admitted_frames": resp.admitted_frames,
            "admitted_bytes": resp.admitted_bytes,
            "throttle_events": resp.throttle_events,
            "throttled_frame_ticks": resp.throttled_frame_ticks,
            "tx_packets": resp.tx_packets,
            "delivered_packets": resp.delivered_packets,
            "delivered_bytes": resp.delivered_bytes,
            "dropped_loss": resp.dropped_loss,
            "dropped_queue": resp.dropped_queue,
            "dropped_ring": resp.dropped_ring,
            "window_seconds": resp.window_seconds,
            "delivered_pps": resp.delivered_pps,
            "bytes_ps": resp.bytes_ps,
            "p50_us": none_if(resp.p50_us),
            "p99_us": none_if(resp.p99_us),
        }
        print(json.dumps(_json_safe(out)))
        return 0
    except grpc.RpcError as e:
        print(f"tenant: daemon {args.daemon} RPC failed: "
              f"{_rpc_code(e)}", file=sys.stderr)
        return 1
    finally:
        client.close()


def cmd_migrate(args) -> int:
    """`kdt migrate` — live tenant migration between federation planes
    (Local.MigrateTenant), plus `--status` over the journaled records
    (Local.MigrationStatus). Zero-loss: the state machine throttles,
    forks, restores, cuts over make-before-break and reconciles
    byte-exact delivery accounting across the move."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(args.daemon)

    def info_dict(m) -> dict:
        return {
            "migration_id": m.migration_id, "tenant": m.tenant,
            "src": m.src, "dst": m.dst, "state": m.state,
            "steps_done": list(m.steps_done),
            "resumed": m.resumed, "rollbacks": m.rollbacks,
            "transferred_frames": m.transferred_frames,
            "delivered_src_frames": m.delivered_src_frames,
            "delivered_src_bytes": m.delivered_src_bytes,
        }

    try:
        if args.status:
            resp = client.MigrationStatus(pb.MigrationStatusRequest(
                migration_id=args.migration_id, tenant=args.tenant),
                timeout=args.timeout)
            if not resp.ok:
                print(f"migrate status: {resp.error}", file=sys.stderr)
                return 1
            print(json.dumps(_json_safe(
                {"migrations": [info_dict(m)
                                for m in resp.migrations]})))
            return 0
        if args.resume:
            if not args.migration_id:
                print("migrate --resume needs --id", file=sys.stderr)
                return 1
        elif not (args.tenant and args.dst):
            print("migrate needs a tenant and --dst", file=sys.stderr)
            return 1
        resp = client.MigrateTenant(pb.MigrateRequest(
            tenant=args.tenant, src=args.src, dst=args.dst,
            migration_id=args.migration_id, resume=args.resume,
            reconcile_timeout_s=max(1.0, args.timeout - 5.0)),
            timeout=args.timeout)
        if not resp.ok:
            print(f"migrate: {resp.error}", file=sys.stderr)
            return 1
        print(json.dumps(_json_safe(info_dict(resp.migration))))
        return 0
    except grpc.RpcError as e:
        print(f"migrate: daemon {args.daemon} RPC failed: "
              f"{_rpc_code(e)}", file=sys.stderr)
        return 1
    finally:
        client.close()


def cmd_fleet(args) -> int:
    """`kdt fleet status|upgrade` — the fleet supervisor's operator
    surface (Local.FleetStatus / Local.FleetUpgrade): per-plane health
    + suspicion state + the placement ledger, and the rolling-upgrade
    driver (cordon → drain via live migration → restart →
    health-verify → refill, zero frame loss for every live-migrated
    tenant)."""
    import grpc

    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    client = DaemonClient(args.daemon)
    try:
        if args.action == "status":
            resp = client.FleetStatus(pb.FleetStatusRequest(),
                                      timeout=args.timeout)
            if not resp.ok:
                print(f"fleet status: {resp.error}", file=sys.stderr)
                return 1
            none_if = lambda v: None if v < 0 else v  # noqa: E731
            out = {
                "planes": [{
                    "name": p.name, "state": p.state,
                    "consecutive_failures": p.consecutive_failures,
                    "last_error": p.last_error or None,
                    "tenants_placed": p.tenants_placed,
                    "health": {
                        "running": p.health.running,
                        "serving": p.health.serving,
                        "heartbeat_age_s": none_if(
                            p.health.heartbeat_age_s),
                        "degrade_level": p.health.degrade_level,
                        "tick_errors": p.health.tick_errors,
                        "backlog": p.health.backlog,
                        "tenants": p.health.tenants,
                        "headroom_rows": p.health.headroom_rows,
                    } if p.health.ok else None,
                } for p in resp.planes],
                "placements": {e.tenant: e.plane
                               for e in resp.placements},
                "sweeps": resp.sweeps,
                "evacuations": resp.evacuations,
            }
            print(json.dumps(_json_safe(out)))
            return 0
        # upgrade
        resp = client.FleetUpgrade(pb.FleetUpgradeRequest(
            planes=args.plane or [],
            verify_probes=args.verify_probes),
            timeout=args.timeout)
        if not resp.ok and not resp.reports:
            print(f"fleet upgrade: {resp.error}", file=sys.stderr)
            return 1
        out = {
            "reports": [{
                "plane": r.plane,
                "drained_tenants": list(r.drained_tenants),
                "refilled_tenants": list(r.refilled_tenants),
                "restarted": bool(r.restarted),
                "healthy": bool(r.healthy),
                "error": r.error or None,
            } for r in resp.reports],
            "migrations": resp.migrations,
        }
        print(json.dumps(_json_safe(out)))
        return 0 if resp.ok else 1
    except grpc.RpcError as e:
        print(f"fleet: daemon {args.daemon} RPC failed: "
              f"{_rpc_code(e)}", file=sys.stderr)
        return 1
    finally:
        client.close()


def cmd_scenario(args) -> int:
    from kubedtn_tpu_torch.scenarios import LADDER

    if args.name == "all":
        if args.param:
            print("-p overrides are per-scenario; not supported with "
                  "'all'", file=sys.stderr)
            return 1
        device = _device(args, "scenario")
        if device is None:
            return 2
        for name, fn in LADDER.items():
            print(json.dumps(_json_safe(fn(device=device))))
        return 0
    if args.name not in LADDER:
        print(f"unknown scenario {args.name}; "
              f"choices: {', '.join(LADDER)} or all", file=sys.stderr)
        return 1
    fn = LADDER[args.name]
    device = _device(args, "scenario")
    if device is None:
        return 2
    import inspect

    try:
        kwargs = _coerce_params(fn, args.param)
        kwargs["device"] = device
        out = fn(**kwargs)
    except (TypeError, ValueError, AssertionError) as e:
        print(f"scenario {args.name}: {e}\nsignature: "
              f"{args.name}{inspect.signature(fn)}", file=sys.stderr)
        return 1
    print(json.dumps(_json_safe(out)))
    return 0


def _env_port(var: str, default: int) -> int:
    """Port from an env var that may be a bare port, ':port', or
    'host:port' (the reference's HTTP_ADDR forms, daemon/main.go:27-40)."""
    raw = os.environ.get(var, "")
    if not raw:
        return default
    try:
        return int(raw.rsplit(":", 1)[-1])
    except ValueError:
        raise SystemExit(f"{var}={raw!r}: not a port")


def cmd_daemon(args) -> int:
    """The daemon process (the DaemonSet's): the wire Daemon over a
    SimEngine on --device, its live WireDataPlane with the tenancy
    registry, the federation controller and fleet supervisor, and with
    telemetry on the SLO evaluator and the autopilot; gRPC on --port,
    Prometheus on --metrics-port; SIGTERM checkpoints and exits 0. The
    JAX CLI's cmd_daemon step for step."""
    device = _device(args, "daemon")
    if device is None:
        return 2
    import contextlib

    from kubedtn_tpu_torch.metrics.metrics import (MetricsServer,
                                                   make_registry)
    from kubedtn_tpu_torch.runtime import WireDataPlane
    from kubedtn_tpu_torch.topology import SimEngine, TopologyStore
    from kubedtn_tpu_torch.utils.logging import fields, get_logger, setup
    from kubedtn_tpu_torch.wire.server import Daemon, make_server

    # structured logs for the whole daemon (level: KUBEDTN_LOG_LEVEL),
    # the zap/logrus setup of the reference (main.go:61-78)
    setup()
    log = get_logger("daemon")
    log.info("daemon starting %s", fields(pid=os.getpid()))

    if args.port is None:
        args.port = _env_port("GRPC_PORT", 51111)
    if args.metrics_port is None:
        args.metrics_port = _env_port("HTTP_ADDR", 51112)

    ckpt_dir = getattr(args, "checkpoint_dir", None)
    store = engine = None
    restore_src = ckpt_dir
    if ckpt_dir:
        from kubedtn_tpu_torch import checkpoint

        t_load = time.perf_counter()
        try:
            # every loader below reads this one Generation: the
            # manifest is parsed once for the whole restore
            restore_src = checkpoint.Generation(ckpt_dir)
        except checkpoint.CheckpointError:
            pass  # load() below reports it

        # warm restart: topologies, realized links, and (below) the
        # delay line's in-flight frames all come back. load() resolves
        # the .prev generation a mid-save crash may have left; a
        # CORRUPT checkpoint cold-starts with a warning (clients /
        # the k8s bridge re-apply the CRs — the reconstruction path)
        # instead of crash-looping the daemon.
        try:
            store, engine = checkpoint.load(restore_src, device=device)
            engine.node_ip = args.node_ip
            log.info("restored from checkpoint %s", fields(
                path=ckpt_dir, topologies=len(store.list()),
                links=engine.num_active,
                load_s=round(time.perf_counter() - t_load, 3)))
        except checkpoint.CheckpointMissingError:
            pass  # no checkpoint yet: first start
        except checkpoint.CheckpointError:
            # corrupt, unsupported version, ... — cold-start LOUDLY so a
            # discarded warm state is never invisible (the next graceful
            # save will replace the unusable directory)
            log.exception("checkpoint unusable; cold-starting %s",
                          fields(path=ckpt_dir))
            store = engine = None
    if store is None:
        store = TopologyStore()
        engine = SimEngine(store, node_ip=args.node_ip, device=device)
    # the shaping kernel's first launch loads the kernel library: pay it
    # at boot, not on the first tick's frames
    engine.warm_kernels()
    daemon = Daemon(engine)
    if getattr(args, "capture", None):
        from kubedtn_tpu_torch.utils.pcap import CaptureManager

        daemon.capture = CaptureManager()
        daemon.capture.open(args.capture)
        log.info("capture on %s", fields(path=args.capture))
    dataplane = WireDataPlane(daemon)
    from kubedtn_tpu_torch.tenancy import TenantRegistry

    # multi-tenant serving plane: namespace→tenant mapping, admission
    # buckets, QoS drain weights, Local.Tenant* RPCs (empty registry =
    # zero enforcement until `kdt tenant create` tightens quotas).
    # A checkpointed registry restores quotas / QoS / block
    # entitlements / namespace bindings so a restart never silently
    # resets tenants to unenforced.
    tenancy = None
    if ckpt_dir:
        from kubedtn_tpu_torch import checkpoint as _ckpt

        try:
            tenancy = _ckpt.load_tenancy(restore_src, engine)
        except _ckpt.CheckpointError:
            log.exception("tenancy restore failed; starting with an "
                          "empty registry %s", fields(path=ckpt_dir))
        else:
            if tenancy is not None:
                log.info("tenant registry restored %s", fields(
                    tenants=len(tenancy.list())))
    if tenancy is None:
        tenancy = TenantRegistry(engine)
    dataplane.attach_tenancy(tenancy)
    # federation: this plane registers with a controller so
    # Local.MigrateTenant / MigrationStatus (and `kdt migrate`) can
    # move tenants between planes registered in this process
    from kubedtn_tpu_torch.federation import (FederationController,
                                              PlaneHandle)
    from kubedtn_tpu_torch.federation import \
        stats_for as migration_stats_for

    # SIBLING of the checkpoint dir, never inside it: checkpoint.save
    # replaces the directory wholesale (atomic swap), so a journal
    # nested in it would be deleted by every save — or make the save
    # refuse outright on a manifest-less mixed directory
    journal_root = (getattr(args, "migration_journal", None)
                    or (ckpt_dir.rstrip("/") + "-migrations"
                        if ckpt_dir else
                        os.path.join(os.path.expanduser("~"), ".cache",
                                     "kubedtn-migrations")))
    migration_stats = migration_stats_for(daemon)
    federation = FederationController(journal_root,
                                      stats=migration_stats)
    federation.register(PlaneHandle(name=args.node_ip, daemon=daemon,
                                    plane=dataplane, registry=tenancy,
                                    checkpoint_dir=ckpt_dir))
    # fleet supervision: plane health watching (Local.Health /
    # FleetStatus), the journaled placement ledger, and — on boot —
    # auto-resume of any migration journal a crash left `running`
    from kubedtn_tpu_torch.federation.supervisor import FleetSupervisor

    fleet_root = (ckpt_dir.rstrip("/") + "-fleet" if ckpt_dir else
                  os.path.join(os.path.expanduser("~"), ".cache",
                               "kubedtn-fleet"))
    fleet = FleetSupervisor(federation, fleet_root).attach()
    fleet.start(interval_s=2.0)
    slo_eval = autopilot = None
    if not getattr(args, "no_telemetry", False):
        # link telemetry plane: per-edge window ring + sampled flight
        # recorder, riding the fused tick (no extra device dispatch)
        dataplane.enable_telemetry(
            window_s=getattr(args, "telemetry_window", 1.0),
            sample_period=getattr(args, "telemetry_sample", 256),
            node=args.node_ip)
        log.info("link telemetry on %s", fields(
            window_s=getattr(args, "telemetry_window", 1.0),
            sample_period=getattr(args, "telemetry_sample", 256)))
        # SLO plane: per-tenant objectives evaluated at every telemetry
        # window rollover on a sidecar thread (zero tick-path work; the
        # Local.ObserveSLO / `kdt slo` / kubedtn_slo_* surface)
        from kubedtn_tpu_torch.slo import SloEvaluator

        slo_eval = SloEvaluator(tenancy, dataplane).attach(daemon)
        slo_eval.start()
        log.info("slo evaluation on %s", fields(
            window_s=getattr(args, "telemetry_window", 1.0)))
        # SLO autopilot: the closed loop from a paging burn verdict to
        # a twin-gated staged remediation (Local.Autopilot* / `kdt
        # autopilot` / kubedtn_autopilot_*). The sidecar always runs;
        # remediation stays OFF until `kdt autopilot enable` (or
        # --autopilot) flips it — observing is free, acting is opt-in.
        from kubedtn_tpu_torch.autopilot import Autopilot

        autopilot = Autopilot(tenancy, dataplane, slo_eval,
                              fleet=fleet).attach(daemon)
        if getattr(args, "autopilot", False):
            autopilot.enable()
        if getattr(args, "autopilot_dry_run", False):
            autopilot.set_dry_run(True)
        autopilot.start(poll_s=getattr(args, "autopilot_poll", 1.0))
        log.info("slo autopilot on %s", fields(
            enabled=autopilot.enabled, dry_run=autopilot.dry_run))
    shard = getattr(args, "shard_mesh", 0)
    if shard:
        # edge-sharded live plane: SoA columns block-shard across the
        # mesh (virtual shards of one card repeat it), cross-shard row
        # state rides the mailbox ring (kernel K4); -1 = largest
        # power-of-two count of local cards, 0 = off (guard above)
        mesh = dataplane.enable_sharding(
            n_devices=None if shard < 0 else shard)
        log.info("sharded live plane %s", fields(mesh_devices=len(mesh)))
    shm_ingest = None
    shm_dir = getattr(args, "shm_dir", None)
    if shm_dir:
        # shared-memory ingest plane: producer rings in this directory
        # feed drain_ingress directly (admission at the ring head);
        # gRPC stays up as the compatibility fallback + control surface
        from kubedtn_tpu_torch.shm import ShmIngest

        os.makedirs(shm_dir, exist_ok=True)
        shm_ingest = ShmIngest(shm_dir)
        dataplane.attach_shm(shm_ingest)
        log.info("shm ingest on %s", fields(dir=shm_dir))
    trace_out = getattr(args, "trace_out", None)
    trace_stop = None
    if trace_out:
        # Crash-safe trace capture: rotate (append + truncate buffer)
        # on a sidecar so a SIGKILL'd daemon loses at most one rotation
        # interval of spans, not the whole buffer. Truncate any stale
        # file first — rotate_out appends, and a previous run's dump
        # would otherwise corrupt the array.
        import threading as _threading

        from kubedtn_tpu_torch.utils.tracing import default_tracer

        open(trace_out, "w").close()
        trace_stop = _threading.Event()

        def _trace_rotator() -> None:
            tr = default_tracer()
            last = time.monotonic()
            while not trace_stop.wait(2.0):
                now = time.monotonic()
                if tr.pending() >= 20_000 or (
                        now - last >= 30.0 and tr.pending() > 0):
                    try:
                        n = tr.rotate_out(trace_out)
                        if n:
                            last = now
                    except Exception:
                        log.exception("trace rotation failed %s",
                                      fields(path=trace_out))
                        last = now  # don't hot-loop a broken path

        _threading.Thread(target=_trace_rotator, daemon=True,
                          name="trace-rotator").start()
    profile = contextlib.ExitStack()
    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        # opt-in profiler capture (the card's kernels, the CUDA calls)
        # for the daemon's whole lifetime, written at shutdown: the
        # device half of the host spans
        from kubedtn_tpu_torch.utils.tracing import device_trace

        try:
            t_prof = time.perf_counter()
            profile.enter_context(device_trace(profile_dir))
            log.info("profiler capturing %s", fields(
                dir=profile_dir,
                start_s=round(time.perf_counter() - t_prof, 3)))
        except Exception:
            log.exception("profiler start failed; continuing")
    if ckpt_dir:
        try:
            # the wire registry and cumulative per-edge counters come
            # back with the rows: clients need not re-register wires,
            # and the per-interface delivery series keep counting from
            # where the previous incarnation stopped
            n_wires = checkpoint.load_wires(restore_src, daemon)
            n_ingress = checkpoint.load_ingress(restore_src, daemon)
            if checkpoint.restore_plane_counters(restore_src,
                                                 dataplane):
                log.info("plane counters restored %s",
                         fields(wires=n_wires,
                                ingress_frames=n_ingress))
        except checkpoint.CheckpointError:
            log.exception("wire/counter restore failed; continuing "
                          "without %s", fields(path=ckpt_dir))
        try:
            n_pending = checkpoint.load_pending(restore_src, dataplane)
        except checkpoint.CheckpointError:
            # the file stays on disk: a transient read error (or a
            # fixed binary) can still restore these frames on the next
            # start — consuming here would destroy them unrestored
            log.exception("pending-frame restore failed; continuing "
                          "without %s", fields(path=ckpt_dir))
        else:
            if n_pending:
                log.info("restored in-flight frames %s",
                         fields(n=n_pending))
            # consume the pending file once RESTORED (from the SAME
            # generation load_pending resolved): a crash before the
            # next graceful checkpoint must NOT re-deliver these
            # frames again
            checkpoint.consume_pending(restore_src)
    restore_src = None  # the parsed manifest is not needed any more
    from kubedtn_tpu_torch.twin.query import stats_for
    from kubedtn_tpu_torch.updates.stager import \
        stats_for as update_stats_for

    registry, hist = make_registry(engine,
                                   sim_counters_fn=dataplane.counters_fn,
                                   dataplane=dataplane,
                                   whatif_stats=stats_for(daemon),
                                   update_stats=update_stats_for(daemon),
                                   tenancy=tenancy,
                                   migration_stats=migration_stats,
                                   fleet=fleet, slo=slo_eval,
                                   shm=shm_ingest, autopilot=autopilot)
    engine.stats.observer = hist
    daemon.hist = hist
    server, port = make_server(daemon, port=args.port)
    metrics = MetricsServer(registry, port=args.metrics_port)
    metrics.start()
    server.start()
    dataplane.start()
    autosaver = None
    interval = getattr(args, "checkpoint_interval", 0.0) or 0.0
    if ckpt_dir and interval > 0:
        # periodic crash-consistent autosave: capture at one flush
        # barrier off the tick path, write with the atomic staged swap.
        # This bounds the failover RPO — without it a SIGKILL loses
        # everything since start (state otherwise saves only on the
        # graceful SIGTERM path below).
        autosaver = checkpoint.Autosaver(ckpt_dir, store, engine,
                                         dataplane,
                                         interval_s=interval)
        autosaver.start()
        log.info("autosave on %s", fields(path=ckpt_dir,
                                          interval_s=interval))
    import signal as _signal

    def _on_term(*_):
        # a second SIGTERM during cleanup must not abort it
        _signal.signal(_signal.SIGTERM, _signal.SIG_IGN)
        raise KeyboardInterrupt

    try:
        # a DaemonSet pod stop is SIGTERM, not Ctrl-C: route it through
        # the same graceful-shutdown path (checkpoint, capture close,
        # plane stop). Registered inside the try and BEFORE the ready
        # line, so a supervisor reacting to that line can never land a
        # TERM that escapes the cleanup below.
        _signal.signal(_signal.SIGTERM, _on_term)
        log.info("daemon up %s", fields(grpc_port=port,
                                        metrics_port=metrics.port,
                                        node_ip=args.node_ip,
                                        device=str(device)))
        print(f"kubedtn-tpu daemon: gRPC on :{port}, "
              f"metrics on :{metrics.port}/metrics", flush=True)
        server.wait_for_termination()
    except KeyboardInterrupt:
        fleet.stop()
        if autopilot is not None:
            autopilot.stop()
        if slo_eval is not None:
            slo_eval.stop()
        if autosaver is not None:
            # a mid-shutdown autosave would race the final save below
            autosaver.stop()
        server.stop(0)
        dataplane.stop()
        if shm_ingest is not None:
            shm_ingest.close()
        if ckpt_dir:
            try:
                checkpoint.save(ckpt_dir, store, engine,
                                dataplane=dataplane)
                log.info("checkpoint written %s", fields(path=ckpt_dir))
            except Exception:
                # a full disk must not abort the remaining cleanup
                log.exception("checkpoint save failed %s",
                              fields(path=ckpt_dir))
        if daemon.capture is not None:
            daemon.capture.close_all()
        try:
            t_prof = time.perf_counter()
            profile.close()
            if profile_dir:
                log.info("profile written %s", fields(
                    dir=profile_dir,
                    s=round(time.perf_counter() - t_prof, 3)))
        except Exception:
            log.exception("profiler stop failed")
        if trace_out:
            # catapult/Perfetto JSON of the daemon's structured spans
            # (reconcile / checkpoint / barrier pauses) — the sidecar
            # already rotated periodically; this final rotation drains
            # whatever landed since, in the same array format
            from kubedtn_tpu_torch.utils.tracing import default_tracer

            if trace_stop is not None:
                trace_stop.set()
            try:
                n = default_tracer().rotate_out(trace_out)
                log.info("trace written %s", fields(
                    path=trace_out, spans=n))
            except Exception:
                log.exception("trace export failed %s",
                              fields(path=trace_out))
        from kubedtn_tpu_torch.ops.cuda import shaping as _shaping
        from kubedtn_tpu_torch.parallel import exchange as _exchange

        # the card's kernels launched by this process (0 on the CPU,
        # where the wrappers run their plain versions)
        log.info("kernel launches %s", fields(**_shaping.LAUNCHES,
                                              **_exchange.LAUNCHES))
        metrics.stop()
    return 0


def cmd_manager(args) -> int:
    """Run the controller manager standalone — the reference's controller
    binary (reference main.go:80-126): continuous reconcile with worker
    pool, healthz/readyz probes, optional leader election. The engine
    lives on --device (the card by default)."""
    device = _device(args, "manager")
    if device is None:
        return 2
    from kubedtn_tpu_torch.topology import SimEngine, TopologyStore
    from kubedtn_tpu_torch.topology.manager import ControllerManager
    from kubedtn_tpu_torch.utils.logging import fields, get_logger, setup

    setup()
    log = get_logger("manager")
    store = TopologyStore()
    engine = SimEngine(store, node_ip=args.node_ip, device=device)
    mgr = ControllerManager(store, engine, identity=args.identity,
                            workers=args.workers,
                            leader_election=args.leader_elect,
                            probe_port=args.probe_port,
                            metrics_port=args.metrics_port)
    mgr.start()
    log.info("manager up %s", fields(identity=args.identity,
                                     workers=args.workers,
                                     probe_port=mgr.probe_port,
                                     metrics_port=mgr.metrics_port,
                                     leader_election=args.leader_elect,
                                     device=str(device)))
    print(f"kubedtn-tpu manager: probes on :{mgr.probe_port} "
          f"(healthz/readyz), metrics on :{mgr.metrics_port}/metrics",
          flush=True)
    try:
        # short sleeps: Python runs a signal's handler only in the main
        # thread, and a SIGINT the kernel hands to another thread waits
        # until this thread next runs (JAX's verb sleeps an hour here)
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        mgr.stop()
    return 0


def cmd_physical_join(args) -> int:
    """Join a physical host to the twin (reference cmd/main.go:26-101):
    read {link, remote_ip} YAML and ask the daemon to realize the
    host-side end via Remote.Update."""
    import yaml

    from kubedtn_tpu_torch.api.types import Link
    from kubedtn_tpu_torch.topology.engine import vni_from_uid
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient

    with open(args.file) as f:
        q = yaml.safe_load(f)
    link = Link.from_dict(q["link"])
    if not link.is_physical():
        print("peer_pod must be physical/<ip>", file=sys.stderr)
        return 1
    client = DaemonClient(args.daemon)
    resp = client.Update(pb.RemotePod(
        net_ns="",
        intf_name=link.local_intf,
        intf_ip=link.local_ip,
        peer_vtep=q["remote_ip"],
        vni=vni_from_uid(link.uid),
        kube_ns="default",
        name=f"physical/{link.physical_peer_ip()}",
        properties=pb.props_to_proto(link.properties),
    ))
    print(json.dumps({"joined": bool(resp.response)}))
    client.close()
    return 0 if resp.response else 1


def _coerce_params(fn, params):
    """-p k=v strings → kwargs coerced by fn's signature: annotation
    first (tuple dims as 4x4x2, str passthrough), then the default
    value's type, then int/float/str guessing. One convention shared by
    `gen` and `scenario`. Raises ValueError on unknown names."""
    import inspect

    sig = inspect.signature(fn)
    kwargs = {}
    for kv in params or []:
        k, _, v = kv.partition("=")
        if k not in sig.parameters:
            raise ValueError(
                f"no parameter {k!r}; choices: {', '.join(sig.parameters)}")
        ann = str(sig.parameters[k].annotation)
        default = sig.parameters[k].default
        if "tuple" in ann or "list" in ann:  # torus dims as 4x4x2
            kwargs[k] = tuple(int(x) for x in v.split("x"))
        elif "bool" in ann or isinstance(default, bool):
            kwargs[k] = v.lower() in ("1", "true", "yes")
        elif "str" in ann:
            kwargs[k] = v
        elif "float" in ann:
            kwargs[k] = float(v)
        elif "int" in ann:
            kwargs[k] = int(v)
        elif isinstance(default, int):
            kwargs[k] = int(v)
        elif isinstance(default, float):
            kwargs[k] = float(v)
        else:
            try:
                kwargs[k] = int(v)
            except ValueError:
                try:
                    kwargs[k] = float(v)
                except ValueError:
                    kwargs[k] = v
    return kwargs


def cmd_gen(args) -> int:
    """Generate a topology-model family as Topology CR YAML (stdout or
    file) — the generated-scenario counterpart of the reference's
    hand-written sample files (reference config/samples/)."""
    import yaml

    from kubedtn_tpu_torch.models.topologies import FAMILIES

    fam = FAMILIES.get(args.family)
    if fam is None:
        print(f"unknown family {args.family!r}; choices: "
              f"{', '.join(sorted(FAMILIES))}", file=sys.stderr)
        return 1
    import inspect

    sig = inspect.signature(fam)
    try:
        kwargs = _coerce_params(fam, args.param)
        el = fam(**kwargs)
    except (TypeError, ValueError, AssertionError) as e:
        print(f"gen {args.family}: {e}\nsignature: "
              f"{args.family}{sig}", file=sys.stderr)
        return 1
    docs = [t.to_manifest() for t in el.to_topologies()]
    text = yaml.safe_dump_all(docs, sort_keys=False)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(json.dumps({"family": args.family, "nodes": el.n_nodes,
                          "links": el.n_links, "file": args.out}))
    else:
        print(text)
    return 0


def cmd_crd(args) -> int:
    """Print the Topology CRD manifest rendered from the API types
    (reference config/crd/bases/, rendered copy at cni.yaml:14-280)."""
    import yaml

    from kubedtn_tpu_torch.api.crd import render_crd

    print(yaml.safe_dump(render_crd(), sort_keys=False))
    return 0


def cmd_pcap(args) -> int:
    """Summarize a capture file written by --capture / CaptureManager:
    per-frame lines (ts offset, length, classified protocol when the
    native classifier is available) plus totals — the reading half of the
    reference's per-packet DecodeFrame debug logging (grpcwire.go:465-613).
    """
    import itertools
    from collections import Counter

    from kubedtn_tpu_torch.utils.pcap import read_pcap

    classify_batch = None
    try:
        from kubedtn_tpu_torch import native

        if native.have_native():
            classify_batch = native.classify_batch
    except Exception:
        pass

    totals: Counter[str] = Counter()
    n = 0
    t_first = None
    records = read_pcap(args.file)
    # classify in chunks: one native call per CHUNK frames, not per frame
    CHUNK = 1024
    while True:
        batch = list(itertools.islice(records, CHUNK))
        if not batch:
            break
        if classify_batch is not None:
            protos = classify_batch([rec.frame for rec in batch])
        else:
            protos = ["frame"] * len(batch)
        for rec, proto in zip(batch, protos):
            if t_first is None:
                t_first = rec.ts
            totals[proto] += 1
            n += 1
            if not args.quiet:
                print(f"{rec.ts - t_first:10.6f}s  {rec.orig_len:5d}B  "
                      f"{proto}")
    print(f"{args.file}: {n} frames "
          + " ".join(f"{k}={v}" for k, v in sorted(totals.items())))
    return 0


def _load_whatif_scenarios(path: str | None):
    """Scenario YAML → twin Scenario list. Layout:

      - name: spine0-slow
        perturbations:
          - {kind: degrade, uid: 1, properties: {latency: 50ms}}
          - {kind: scale, factor: 1.5}
      - name: leaf3-dead
        perturbations: [{kind: blackhole, node: leaf3}]
    """
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.twin.spec import Perturbation, Scenario

    if not path:
        return []
    import yaml

    with open(path) as f:
        docs = yaml.safe_load(f)
    if not isinstance(docs, list):
        raise ValueError("what-if spec must be a YAML list of scenarios")
    out = []
    for i, d in enumerate(docs):
        if not isinstance(d, dict):
            raise ValueError(
                f"what-if spec entry {i} must be a mapping with "
                f"name/perturbations, got {type(d).__name__}")
        perts = []
        for p in d.get("perturbations", []):
            if not isinstance(p, dict):
                raise ValueError(
                    f"scenario {d.get('name', i)!r}: perturbation must "
                    f"be a mapping, got {type(p).__name__}")
            props = p.get("properties")
            perts.append(Perturbation(
                kind=p.get("kind", "degrade"),
                uid=p.get("uid"),
                props=(LinkProperties.from_dict(props)
                       if props is not None else None),
                node=p.get("node"),
                factor=float(p.get("factor", 1.0)),
            ))
        out.append(Scenario(name=d.get("name", f"scenario{i}"),
                            perturbations=tuple(perts)))
    return out


def cmd_whatif(args) -> int:
    """Run a what-if sweep — against a LIVE daemon (snapshot of its
    running data plane; the real-time runner never stops) or locally
    from a topology YAML — and print the ranked scenario comparison."""
    from kubedtn_tpu_torch.api.parsers import parse_rate_bps
    from kubedtn_tpu_torch.twin.engine import SweepResult
    from kubedtn_tpu_torch.twin.report import rank_results, render_report
    from kubedtn_tpu_torch.twin.spec import Scenario

    from kubedtn_tpu_torch.twin.query import DEFAULT_RATE_BPS

    try:
        scenarios = _load_whatif_scenarios(args.spec)
    except (ValueError, OSError) as e:
        print(f"whatif spec: {e}", file=sys.stderr)
        return 1
    rate_bps = parse_rate_bps(args.rate) if args.rate else DEFAULT_RATE_BPS

    if args.daemon:
        from kubedtn_tpu_torch.wire import proto as pb
        from kubedtn_tpu_torch.wire.client import DaemonClient

        req = pb.WhatIfRequest(
            ticks=args.ticks, dt_us=args.dt_us,
            traffic_rate_bps=float(rate_bps), seed=args.seed,
            include_baseline=True,
            tenant=getattr(args, "tenant", "") or "")
        for sc in scenarios:
            msg = req.scenarios.add()
            msg.name = sc.name
            for p in sc.perturbations:
                pm = msg.perturbations.add()
                pm.kind = p.kind
                if p.uid is not None:
                    pm.uid = int(p.uid)
                if p.node is not None:
                    pm.node = str(p.node)
                pm.factor = float(p.factor)
                if p.props is not None:
                    pm.properties.CopyFrom(pb.props_to_proto(p.props))
        import grpc

        client = DaemonClient(args.daemon)
        try:
            resp = client.WhatIf(req, timeout=args.timeout)
        except grpc.RpcError as e:
            print(f"whatif: daemon {args.daemon} RPC failed: "
                  f"{_rpc_code(e)}", file=sys.stderr)
            return 1
        finally:
            client.close()
        if not resp.ok:
            print(f"whatif failed: {resp.error}", file=sys.stderr)
            return 1
        none_if = lambda v: None if v < 0 else v  # noqa: E731
        metrics = [{
            "tx_packets": m.tx_packets,
            "delivered_packets": m.delivered_packets,
            "delivered_bytes": m.delivered_bytes,
            "dropped_loss": m.dropped_loss,
            "dropped_queue": m.dropped_queue,
            "dropped_ring": m.dropped_ring,
            "throughput_bps": m.throughput_bps,
            "delivery_ratio": none_if(m.delivery_ratio),
            "p50_us": none_if(m.p50_us),
            "p90_us": none_if(m.p90_us),
            "p99_us": none_if(m.p99_us),
            "p99_censored": bool(m.p99_censored),
            "mean_queue_occupancy": m.mean_queue_occupancy,
            "latency_hist": list(m.latency_hist),
        } for m in resp.results]
        result = SweepResult(
            names=[m.name for m in resp.results], metrics=metrics,
            replicas=resp.replicas, ticks=resp.ticks,
            sim_seconds=resp.sim_seconds, compile_s=resp.compile_s,
            run_s=resp.run_s,
            replicas_steps_per_s=resp.replicas_steps_per_s)
        # the daemon already ranked server-side: display ITS ranks
        # rather than re-deriving (the two scorings must never drift)
        server_ranks = {m.name: m.rank for m in resp.results}
        title = f"what-if via {args.daemon}"
    else:
        if not args.file:
            print("whatif needs --daemon or --file", file=sys.stderr)
            return 1
        device = _device(args, "whatif")
        if device is None:
            return 2
        from kubedtn_tpu_torch.twin.engine import run_sweep
        from kubedtn_tpu_torch.twin.query import build_cbr_spec
        from kubedtn_tpu_torch.twin.snapshot import snapshot_from_engine

        engine, _topos = _engine_from_yaml(args.file, device)
        snap = snapshot_from_engine(engine)
        with engine._lock:
            pod_ids = dict(engine._pod_ids)
        # the daemon path's ONE spec construction (query.build_cbr_spec)
        # with --rate applied — both modes answer the same question for
        # the same flags by sharing the code, not by copies
        spec = build_cbr_spec(snap.sim.edges, rate_bps=float(rate_bps))
        try:
            result = run_sweep(
                snap, [Scenario(name="baseline"), *scenarios],
                steps=args.ticks, dt_us=args.dt_us, seed=args.seed,
                spec=spec, pod_ids=pod_ids)
        except ValueError as e:
            # same one-line reporting as the daemon path gives the
            # identical spec (bad uid / node / duplicate names)
            print(f"whatif failed: {e}", file=sys.stderr)
            return 1
        server_ranks = None
        title = f"what-if on {args.file}"

    if args.json:
        print(json.dumps(_json_safe({
            "replicas": result.replicas, "ticks": result.ticks,
            "sim_seconds": result.sim_seconds,
            "compile_s": result.compile_s, "run_s": result.run_s,
            "replicas_steps_per_s": result.replicas_steps_per_s,
            "ranked": [{"rank": r, "name": n, **m}
                       for n, m, r in rank_results(
                           result, ranks=server_ranks)],
        })))
    else:
        print(render_report(result, title=title, ranks=server_ranks))
    return 0


def _add_device(parser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the engine runs: the CUDA card "
                             "(default; exit 2 without one) or the host "
                             "CPU (the plain tensor path)")


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser (kubedtn_tpu/cli.py main) under prog
    `tpudtn-torch`, without `bench`, with `--device` on
    the verbs that build an engine and `daemon --profile` (alias
    `--jax-profile`)."""
    p = argparse.ArgumentParser(prog="tpudtn-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ap = sub.add_parser(
        "apply",
        help="load topology YAML and reconcile, or apply a staged "
             "plan (--plan ID --daemon)")
    ap.add_argument("file", nargs="?", default=None)
    ap.add_argument("--plan", type=int, default=None, metavar="ID",
                    help="apply a plan previously verified by "
                         "`kdt plan` (Local.ApplyPlan)")
    ap.add_argument("--daemon", default="127.0.0.1:51111",
                    metavar="HOST:PORT")
    ap.add_argument("--observe-ticks", type=int, default=0,
                    help="live ticks watched after each staged round "
                         "(0 = daemon default)")
    ap.add_argument("--timeout", type=float, default=300.0)
    _add_device(ap)
    ap.set_defaults(fn=cmd_apply)

    plp = sub.add_parser(
        "plan",
        help="build + twin-verify an update schedule for the YAML's "
             "desired links against a live daemon (Local.PlanUpdate)")
    plp.add_argument("file", help="topology YAML declaring the DESIRED "
                                  "link sets")
    plp.add_argument("--daemon", default="127.0.0.1:51111",
                     metavar="HOST:PORT")
    plp.add_argument("--ticks", type=int, default=0,
                     help="gate sweep horizon in virtual ticks "
                          "(0 = daemon default)")
    plp.add_argument("--dt-us", type=float, default=0.0)
    plp.add_argument("--max-delivery-drop", type=float, default=0.0,
                     help="guardrail: max absolute delivery-ratio drop "
                          "vs baseline (0 = daemon default)")
    plp.add_argument("--max-p99-factor", type=float, default=0.0,
                     help="guardrail: max p99 growth factor vs "
                          "baseline (0 = daemon default)")
    plp.add_argument("--max-round-edits", type=int, default=0,
                     help="split rounds to at most this many edits "
                          "(0 = one round per phase)")
    plp.add_argument("--seed", type=int, default=0)
    plp.add_argument("--timeout", type=float, default=300.0)
    plp.add_argument("--json", action="store_true")
    plp.set_defaults(fn=cmd_plan)

    pp = sub.add_parser("ping", help="ping-equivalent probe between pods")
    pp.add_argument("a")
    pp.add_argument("b")
    pp.add_argument("--uid", type=int, default=None)
    pp.add_argument("--file", required=True)
    _add_device(pp)
    pp.set_defaults(fn=cmd_ping)

    tp = sub.add_parser(
        "trace",
        help="path query (a b --file) or sampled-frame flight-recorder "
             "trace (<trace-id|latest> --daemon ...)")
    tp.add_argument("a", help="source pod, or a trace id / 'latest' "
                              "with --daemon")
    tp.add_argument("b", nargs="?", default=None)
    tp.add_argument("--file", default=None)
    tp.add_argument("--max-hops", type=int, default=16)
    tp.add_argument("--daemon", action="append", default=None,
                    metavar="HOST:PORT",
                    help="flight-recorder mode: merge this daemon's "
                         "trace events (repeat for cross-node "
                         "correlation)")
    tp.add_argument("--json", action="store_true")
    _add_device(tp)
    tp.set_defaults(fn=cmd_trace)

    top = sub.add_parser(
        "top",
        help="live ranked per-link table (rate, p50/p99, drops by "
             "cause) from a daemon's link telemetry plane")
    top.add_argument("--daemon", default="127.0.0.1:51111",
                     metavar="HOST:PORT")
    top.add_argument("-n", "--top", type=int, default=20,
                     help="links to show (busiest first)")
    top.add_argument("--windows", type=int, default=0,
                     help="closed telemetry windows to cover (0 = all "
                          "retained)")
    top.add_argument("--count", type=int, default=1,
                     help="refreshes to print (watch mode)")
    top.add_argument("--interval", type=float, default=2.0,
                     help="seconds between refreshes")
    top.add_argument("--json", action="store_true")
    top.set_defaults(fn=cmd_top)

    slp = sub.add_parser(
        "slo",
        help="per-tenant SLO attainment, censored-tail-estimated "
             "p99/p99.9, burn rates and error budgets "
             "(Local.ObserveSLO); --fleet merges across planes")
    slp.add_argument("--daemon", action="append", default=None,
                     metavar="HOST:PORT",
                     help="daemon(s) to query (repeat with --fleet for "
                          "a client-side cross-plane merge; default "
                          "127.0.0.1:51111)")
    slp.add_argument("--tenant", default="",
                     help="show only this tenant")
    slp.add_argument("--fleet", action="store_true",
                     help="fleet-merged view: exact histogram merge on "
                          "the shared bucket ladder, stitched with "
                          "frozen migration-journal slices (one daemon "
                          "= its supervisor's server-side merge; "
                          "several = client-side)")
    slp.add_argument("--json", action="store_true")
    slp.add_argument("--timeout", type=float, default=30.0)
    slp.set_defaults(fn=cmd_slo)

    pup = sub.add_parser(
        "pauses",
        help="barrier-pause attribution: ranked worst-cause table of "
             "every tick-lock pause the plane paid — checkpoint / "
             "compact / staged update / migration / flush / shm stall "
             "/ jit compile / GC (Local.ObservePauses)")
    pup.add_argument("--daemon", default="127.0.0.1:51111",
                     metavar="HOST:PORT")
    pup.add_argument("--cause", default="",
                     help="show only this cause")
    pup.add_argument("--events", type=int, default=0, metavar="N",
                     help="also list the N most recent attributed "
                          "pause events (0 = aggregates only)")
    pup.add_argument("--watch", action="store_true",
                     help="refresh every --interval seconds until "
                          "Ctrl-C")
    pup.add_argument("--interval", type=float, default=2.0)
    pup.add_argument("--json", action="store_true")
    pup.add_argument("--timeout", type=float, default=30.0)
    pup.set_defaults(fn=cmd_pauses)

    app = sub.add_parser(
        "autopilot",
        help="SLO autopilot: the burn-page → twin-gated staged "
             "remediation loop (Local.AutopilotCtl / AutopilotStatus)")
    app.add_argument("action",
                     choices=("status", "enable", "disable", "dry-run",
                              "history"))
    app.add_argument("value", nargs="?", default="on",
                     choices=("on", "off"),
                     help="dry-run only: on (gate + rank, stage "
                          "nothing) or off")
    app.add_argument("--daemon", default="127.0.0.1:51111",
                     metavar="HOST:PORT")
    app.add_argument("--tenant", default="",
                     help="restrict status/history to this tenant")
    app.add_argument("--limit", type=int, default=50,
                     help="history entries to show (newest first)")
    app.add_argument("--json", action="store_true")
    app.add_argument("--timeout", type=float, default=30.0)
    app.set_defaults(fn=cmd_autopilot)

    tnp = sub.add_parser(
        "tenant",
        help="multi-tenant plane: create/list/quota/stats against a "
             "live daemon (Local.Tenant*)")
    tnp.add_argument("action",
                     choices=("create", "list", "quota", "stats",
                              "delete"))
    tnp.add_argument("name", nargs="?", default="")
    tnp.add_argument("--daemon", default="127.0.0.1:51111",
                     metavar="HOST:PORT")
    tnp.add_argument("--qos", default=None,
                     choices=("gold", "silver", "bronze"),
                     help="QoS class → drain-budget weight 1/0.5/0.25")
    tnp.add_argument("--frames-per-s", type=float, default=-1.0,
                     help="admission frame budget (0 = unlimited; "
                          "omitted = leave unchanged)")
    tnp.add_argument("--bytes-per-s", type=float, default=-1.0,
                     help="admission byte budget (0 = unlimited; "
                          "omitted = leave unchanged)")
    tnp.add_argument("--block-edges", type=int, default=0,
                     help="reserve this many contiguous SoA rows for "
                          "the tenant (create only)")
    tnp.add_argument("--namespace", action="append", default=None,
                     help="bind these namespaces (default: the tenant "
                          "name itself)")
    tnp.add_argument("--timeout", type=float, default=30.0)
    tnp.set_defaults(fn=cmd_tenant)

    sp = sub.add_parser("scenario", help="run a BASELINE ladder scenario")
    sp.add_argument("name")
    sp.add_argument("-p", "--param", action="append", metavar="k=v",
                    help="scenario kwargs, e.g. -p n_spine=20 -p workers=8")
    _add_device(sp)
    sp.set_defaults(fn=cmd_scenario)

    # Env-var defaults keep the reference daemon's config surface
    # (reference daemon/main.go:27-40: GRPC_PORT, HTTP_ADDR, HOST_IP).
    # None defaults — the env is resolved inside cmd_daemon so a malformed
    # variable yields a daemon-scoped error, not a crash of every command.
    dp = sub.add_parser("daemon", help="serve the gRPC control plane")
    dp.add_argument("--port", type=int, default=None)
    dp.add_argument("--metrics-port", type=int, default=None)
    dp.add_argument("--node-ip",
                    default=os.environ.get("HOST_IP", "10.0.0.1"))
    dp.add_argument("--capture", default=None, metavar="PCAP",
                    help="record all wire traffic to this pcap file "
                         "(tcpdump/wireshark-readable)")
    dp.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="restore state from DIR on boot (if present) and "
                         "checkpoint to it on shutdown, incl. in-flight "
                         "delay-line frames")
    dp.add_argument("--checkpoint-interval", type=float, default=0.0,
                    metavar="SECONDS",
                    help="ALSO autosave a crash-consistent checkpoint "
                         "every N seconds at a flush barrier off the "
                         "tick path (0 = only on SIGTERM) — bounds the "
                         "fleet failover RPO")
    dp.add_argument("--no-telemetry", action="store_true",
                    help="disable the link telemetry plane (per-edge "
                         "window ring + sampled flight recorder; on by "
                         "default)")
    dp.add_argument("--telemetry-window", type=float, default=1.0,
                    metavar="SECONDS",
                    help="link-telemetry window length (default 1s)")
    dp.add_argument("--telemetry-sample", type=int, default=256,
                    metavar="N", help="flight-recorder sampling period: "
                                      "1 frame in N (default 256)")
    dp.add_argument("--shard-mesh", type=int, default=0,
                    metavar="N",
                    help="shard the live plane's edge state across N "
                         "devices (-1 = all local devices; 0 = off; "
                         "power of two)")
    dp.add_argument("--trace-out", default=None, metavar="JSON",
                    help="stream catapult/Perfetto trace JSON (spans "
                         "around reconcile / checkpoint / barrier "
                         "pauses); rotated to disk periodically so a "
                         "crash loses at most one rotation, with a "
                         "final rotation on stop/SIGTERM")
    dp.add_argument("--profile", "--jax-profile", dest="profile",
                    default=None, metavar="DIR",
                    help="opt-in profiler capture (the card's kernels "
                         "and CUDA calls) for the daemon's lifetime, "
                         "a Chrome trace written into DIR at shutdown "
                         "(TensorBoard/Perfetto-loadable); "
                         "--jax-profile is its JAX-CLI name")
    dp.add_argument("--shm-dir", default=None, metavar="DIR",
                    help="serve the shared-memory ingest plane from "
                         "this directory: every producer ring "
                         "(*.ring, see kubedtn_tpu_torch.shm.ShmSender) in "
                         "it feeds the data plane directly — "
                         "admission enforced at the ring head, gRPC "
                         "kept as the compatibility fallback")
    dp.add_argument("--autopilot", action="store_true",
                    help="enable the SLO autopilot sidecar at boot "
                         "(burn page → candidate sweep → twin-gated "
                         "staged remediation; attached but disabled "
                         "otherwise — flip live with `kdt autopilot "
                         "enable`)")
    dp.add_argument("--autopilot-dry-run", action="store_true",
                    help="autopilot evaluates and gates but stages "
                         "nothing (audit mode)")
    dp.add_argument("--autopilot-poll", type=float, default=1.0,
                    metavar="SECONDS",
                    help="autopilot control-loop poll period "
                         "(default 1s)")
    dp.add_argument("--migration-journal", default=None, metavar="DIR",
                    help="journal root for live tenant migrations "
                         "(default: <checkpoint-dir>-migrations — a "
                         "SIBLING, the checkpoint swap replaces its "
                         "own dir wholesale — or "
                         "~/.cache/kubedtn-migrations)")
    _add_device(dp)
    dp.set_defaults(fn=cmd_daemon)

    mgp = sub.add_parser(
        "migrate",
        help="live tenant migration between federation planes "
             "(Local.MigrateTenant / Local.MigrationStatus)")
    mgp.add_argument("tenant", nargs="?", default="")
    mgp.add_argument("--daemon", default="127.0.0.1:51111",
                     metavar="HOST:PORT",
                     help="daemon whose federation controller runs "
                          "the migration")
    mgp.add_argument("--src", default="",
                     help="source plane name (default: the serving "
                          "daemon's own plane)")
    mgp.add_argument("--dst", default="",
                     help="destination plane name")
    mgp.add_argument("--id", dest="migration_id", default="",
                     help="migration id (with --resume / --status)")
    mgp.add_argument("--resume", action="store_true",
                     help="resume the journaled migration named by "
                          "--id instead of starting a new one")
    mgp.add_argument("--status", action="store_true",
                     help="list journaled migrations (optionally "
                          "filtered by tenant / --id)")
    mgp.add_argument("--timeout", type=float, default=60.0)
    mgp.set_defaults(fn=cmd_migrate)

    flp = sub.add_parser(
        "fleet",
        help="fleet supervision: per-plane health + placement ledger "
             "(status), rolling upgrades with zero frame loss "
             "(upgrade) — Local.FleetStatus / Local.FleetUpgrade")
    flp.add_argument("action", choices=("status", "upgrade"))
    flp.add_argument("--daemon", default="127.0.0.1:51111",
                     metavar="HOST:PORT",
                     help="daemon whose fleet supervisor answers")
    flp.add_argument("--plane", action="append", default=None,
                     help="upgrade only these planes (default: every "
                          "healthy plane, one at a time)")
    flp.add_argument("--verify-probes", type=int, default=0,
                     help="consecutive clean health probes required "
                          "before refill (0 = supervisor default)")
    flp.add_argument("--timeout", type=float, default=600.0)
    flp.set_defaults(fn=cmd_fleet)

    pcp = sub.add_parser("pcap", help="summarize a capture file")
    pcp.add_argument("file")
    pcp.add_argument("-q", "--quiet", action="store_true",
                     help="totals only, no per-frame lines")
    pcp.set_defaults(fn=cmd_pcap)

    mp = sub.add_parser("manager",
                        help="run the topology controller manager "
                             "(reconcile loop + probes + leader election)")
    mp.add_argument("--workers", type=int, default=32,
                    help="concurrent reconcile workers (reference: 32)")
    mp.add_argument("--probe-port", type=int, default=8081,
                    help="healthz/readyz port (reference probe-addr :8081)")
    mp.add_argument("--metrics-port", type=int, default=8080,
                    help="controller metrics port (reference "
                         "metrics-bind-address :8080)")
    mp.add_argument("--leader-elect", action="store_true",
                    help="enable leader election (reference "
                         "--leader-elect)")
    mp.add_argument("--identity",
                    default=os.environ.get("POD_NAME", "manager-0"))
    mp.add_argument("--node-ip", default=os.environ.get("HOST_IP",
                                                        "10.0.0.1"))
    _add_device(mp)
    mp.set_defaults(fn=cmd_manager)

    cp = sub.add_parser("crd", help="render the Topology CRD manifest")
    cp.set_defaults(fn=cmd_crd)

    gp = sub.add_parser("gen", help="generate a topology family as YAML")
    gp.add_argument("family")
    gp.add_argument("-p", "--param", action="append", metavar="k=v",
                    help="generator kwargs, e.g. -p k=8, -p dims=4x4")
    gp.add_argument("-o", "--out", default=None)
    gp.set_defaults(fn=cmd_gen)

    jp = sub.add_parser("physical-join",
                        help="join a physical host via a daemon")
    jp.add_argument("file")
    jp.add_argument("--daemon", default="127.0.0.1:51111")
    jp.set_defaults(fn=cmd_physical_join)

    wp = sub.add_parser(
        "whatif",
        help="what-if sweep: fork a snapshot (live daemon or topology "
             "YAML), run perturbed replicas, print a ranked comparison")
    wp.add_argument("--daemon", default=None, metavar="HOST:PORT",
                    help="query a LIVE daemon (snapshot of its running "
                         "data plane)")
    wp.add_argument("--file", default=None,
                    help="topology YAML for a local (daemonless) sweep")
    wp.add_argument("--spec", default=None, metavar="YAML",
                    help="scenario spec file (see `whatif` docs); "
                         "omitted = baseline only")
    wp.add_argument("--tenant", default=None,
                    help="tenant-scoped fork: sweep only this "
                         "tenant's edge slice (daemon mode)")
    wp.add_argument("--ticks", type=int, default=1000)
    wp.add_argument("--dt-us", type=float, default=1000.0)
    wp.add_argument("--rate", default=None,
                    help="offered CBR per edge, e.g. 1Mbit (default)")
    wp.add_argument("--seed", type=int, default=0)
    wp.add_argument("--timeout", type=float, default=300.0)
    wp.add_argument("--json", action="store_true",
                    help="machine-readable output instead of the table")
    _add_device(wp)
    wp.set_defaults(fn=cmd_whatif)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # downstream pipe (e.g. `| head`) closed early — normal for a CLI
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
