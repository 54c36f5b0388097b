"""Update stager — land an approved plan on the LIVE plane, round by
round, with a watch window and bit-exact rollback.

Staging contract (ARCHITECTURE.md "Planned updates"):

- **Barrier placement**: every round applies through
  `WireDataPlane.stage_update_round` — under the tick lock, after a
  pipeline `flush()` (every in-flight dispatch's edge-state write-back
  lands first) and followed by an engine flush (the round's scatters
  are on device before the lock drops). A tick therefore shapes
  against round k or round k+1, never a half-applied mixture; the
  real-time runner pauses one barrier per round and never stops.
- **Watch window**: after each round the stager observes
  `observe_ticks` live ticks and evaluates the telemetry window ring
  (delivery-ratio delta, p99 from the bucket histogram) against the
  same `Guardrails` the verification gate used, plus the
  fault-domain signals (tick_errors, the degradation ladder): what the
  gate promised is what staging enforces.
- **Rollback journal**: BEFORE a round applies, the stager checkpoints
  a row-level image of every (pod_key, uid) endpoint the round will
  touch — exact row number, uid/src/dst, the props row bits, shaped
  flag, peer mapping, or recorded absence. On regression (or a
  dispatch failure mid-round) the journal replays in reverse inside
  ONE barrier: rows are reclaimed at their exact pre-round indices and
  re-applied with their exact pre-round bits, so the configuration
  state (uid/src/dst/active/props and the host registries) restores
  BIT-exactly. Dynamic shaping state follows `update_links`'
  qdisc-reinstall semantics — the same reset a direct apply-then-
  revert would perform (pinned by tests/test_updates.py).

Concurrent control-plane traffic: one staging runs at a time
(`_staging_key`); a reconcile that races a rollback and claims a
journaled row is detected and the restore falls back to a fresh row
with a loud log (never silent corruption).

Port of kubedtn_tpu/updates/stager.py. The row images read the engine's
columns on the host (one gather per column, wherever they lie).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from kubedtn_tpu_torch import telemetry as tele
from kubedtn_tpu_torch.contracts import guarded_by
from kubedtn_tpu_torch.updates.gate import Guardrails
from kubedtn_tpu_torch.updates.planner import UpdatePlan, UpdateRound
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger


class StagingBusyError(RuntimeError):
    """Another staged update holds the stager — a TRANSIENT condition
    (retry later), distinct from a staging failure. Callers must not
    catch bare RuntimeError to detect busy: device errors (a CUDA
    error, a failed kernel launch) are RuntimeErrors too and would be
    misclassified as busy."""


@dataclasses.dataclass
class StageResult:
    """One staging attempt's outcome."""

    ok: bool
    rounds_applied: int         # rounds that LANDED (0 after rollback)
    rolled_back: bool
    reason: str                 # "" on success
    observed: list              # per-round watch snapshots
    stage_s: float


@dataclasses.dataclass(frozen=True)
class _RowImage:
    """Pre-round checkpoint of one (pod_key, uid) endpoint. row=None
    records ABSENCE (the round added it; rollback deletes it)."""

    pod_key: str
    uid: int
    row: int | None
    src: int = 0
    dst: int = 0
    props: object = None        # np.float32[NPROP] — the exact row bits
    shaped: bool = False
    peer: tuple | None = None   # engine._peer[(pod_key, uid)] pre-round


class UpdateStats:
    """Cumulative counters behind the kubedtn_update_* series of the
    JAX package's exporter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.plans_built = 0
        self.plans_verified = 0
        self.plans_rejected = 0
        self.plan_errors = 0
        self.rounds_staged = 0
        self.rollbacks = 0
        self.applies = 0
        self.applies_failed = 0
        self.gate_s = 0.0
        self.stage_s = 0.0

    def record_plan(self, verdict) -> None:
        with self._lock:
            self.plans_built += 1
            if verdict.ok:
                self.plans_verified += 1
            else:
                self.plans_rejected += 1
            self.gate_s += verdict.gate_s

    def record_plan_error(self) -> None:
        with self._lock:
            self.plan_errors += 1

    def record_stage(self, result: StageResult) -> None:
        with self._lock:
            self.rounds_staged += result.rounds_applied
            if result.rolled_back:
                self.rollbacks += 1
            if result.ok:
                self.applies += 1
            else:
                self.applies_failed += 1
            self.stage_s += result.stage_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "plans_built": self.plans_built,
                "plans_verified": self.plans_verified,
                "plans_rejected": self.plans_rejected,
                "plan_errors": self.plan_errors,
                "rounds_staged": self.rounds_staged,
                "rollbacks": self.rollbacks,
                "applies": self.applies,
                "applies_failed": self.applies_failed,
                "gate_seconds": self.gate_s,
                "stage_seconds": self.stage_s,
            }


_ATTACH_LOCK = threading.Lock()


def stats_for(daemon) -> UpdateStats:
    """The daemon's UpdateStats, created on first use (the twin
    query-surface attachment pattern)."""
    with _ATTACH_LOCK:
        st = getattr(daemon, "update_stats", None)
        if st is None:
            st = daemon.update_stats = UpdateStats()
        return st


@guarded_by("_tick_lock", "_journal", "_staging_key",
            "_staging_rolled")
class UpdateStager:
    """Stages UpdatePlans through one WireDataPlane. `_tick_lock` IS
    the plane's tick lock (shared object): journal mutations and round
    applies happen at the same barrier the tick engine honors."""

    def __init__(self, plane, stats: UpdateStats | None = None) -> None:
        self.plane = plane
        self.engine = plane.engine
        self._tick_lock = plane._tick_lock
        self._journal: list = []        # [round images], oldest first
        self._staging_key: str | None = None
        # did THIS staging attempt replay a rollback? (set by _rollback
        # under the tick lock; stage()'s exception path reads it so an
        # in-barrier rollback performed by _apply_round still counts in
        # kubedtn_update_rollbacks)
        self._staging_rolled = False
        self.stats = stats
        self.log = get_logger("updates")

    # -- public entry ---------------------------------------------------

    def stage(self, plan: UpdatePlan, topo, *, observe_ticks: int = 2,
              observe_timeout_s: float = 30.0,
              guardrails: Guardrails | None = None,
              health_check=None, tick_driver=None) -> StageResult:
        """Apply `plan`'s rounds to the live plane. Between rounds,
        watch `observe_ticks` ticks and evaluate health (the built-in
        telemetry/fault-domain check, or `health_check(plane, base)` →
        (ok, reason, snapshot) when injected — tests and policy hooks).
        `tick_driver(n)` drives explicit-clock ticks instead of waiting
        on the real-time runner. Any regression or mid-round dispatch
        failure rolls every applied round back through the journal in
        one barrier and reports `rolled_back=True`."""
        g = guardrails or Guardrails()
        t0 = time.perf_counter()
        with self._tick_lock:
            if self._staging_key is not None:
                raise StagingBusyError(
                    f"another staged update ({self._staging_key}) is in "
                    f"progress")
            self._staging_key = plan.key
            self._staging_rolled = False
            stranded = len(self._journal)
        observed: list = []
        applied = 0
        try:
            if stranded:
                # a previous attempt's rollback replay failed and left
                # its journal behind (stage() re-raised): finish that
                # restore BEFORE staging anything new — discarding it
                # would strand the plane half-rolled-back forever, and
                # fresh images would checkpoint the corrupted state
                self.log.error("replaying stranded rollback journal %s",
                               _fields(topology=plan.key,
                                       rounds=stranded))
                self._rollback(topo)
            base = self._baseline()
            for rnd in plan.rounds:
                images = self._capture_images(topo, rnd)
                with self._tick_lock:
                    self._journal.append(images)
                ok = self._apply_round(topo, rnd)
                if not ok:
                    return self._abort(
                        topo, observed, t0,
                        f"dispatch failure staging round "
                        f"{rnd.index + 1}/{plan.n_rounds}")
                applied += 1
                if observe_ticks > 0:
                    ticks = self._observe(observe_ticks,
                                          observe_timeout_s, tick_driver)
                    if health_check is not None:
                        ok_h, why, snap = health_check(self.plane, base)
                    else:
                        ok_h, why, snap = self._health(base, g)
                    snap = dict(snap or {})
                    snap["round"] = rnd.index + 1
                    snap["ticks_observed"] = ticks
                    observed.append(snap)
                    if not ok_h:
                        return self._abort(
                            topo, observed, t0,
                            f"regression after round "
                            f"{rnd.index + 1}/{plan.n_rounds}: {why}")
            with self._tick_lock:
                self._journal = []
            result = StageResult(
                ok=True, rounds_applied=applied, rolled_back=False,
                reason="", observed=observed,
                stage_s=round(time.perf_counter() - t0, 3))
            if self.stats is not None:
                self.stats.record_stage(result)
            self.log.info("staged update %s", _fields(
                topology=plan.key, rounds=applied,
                edits=plan.n_edits, stage_s=result.stage_s))
            return result
        except Exception as e:
            # an unexpected failure mid-staging (image capture, engine
            # internals, ...) must not strand applied rounds: roll back
            # what landed, RECORD the rollback (operators alert on the
            # kubedtn_update_rollbacks counter — the unexpected-failure
            # class is the one most worth counting), then surface the
            # original error
            self._rollback(topo)  # no-op if _apply_round already replayed
            with self._tick_lock:
                rolled = self._staging_rolled
            if self.stats is not None:
                self.stats.record_stage(StageResult(
                    ok=False, rounds_applied=0, rolled_back=rolled,
                    reason=f"exception: {type(e).__name__}: {e}",
                    observed=observed,
                    stage_s=round(time.perf_counter() - t0, 3)))
            raise
        finally:
            with self._tick_lock:
                self._staging_key = None

    def _abort(self, topo, observed, t0, reason: str) -> StageResult:
        self._rollback(topo)
        result = StageResult(
            ok=False, rounds_applied=0, rolled_back=True,
            reason=reason, observed=observed,
            stage_s=round(time.perf_counter() - t0, 3))
        if self.stats is not None:
            self.stats.record_stage(result)
        self.log.warning("staged update rolled back %s", _fields(
            topology=topo.key, reason=reason))
        return result

    # -- apply / rollback ----------------------------------------------

    def _apply_round(self, topo, rnd: UpdateRound) -> bool:
        """One round at the flush barrier. Cross-node completion RPCs
        for adds are issued AFTER the barrier drops (the engine's
        unlock-before-RPC discipline): a slow peer must never stall the
        tick lock."""
        eng = self.engine

        def body():
            ok = True
            if rnd.dels:
                ok &= eng.del_links(topo, list(rnd.dels))
            remote = (eng._add_links_locked(topo, list(rnd.adds))
                      if rnd.adds else [])
            if rnd.changes:
                ok &= eng.update_links(topo, list(rnd.changes))
            return ok, remote

        with self._tick_lock:
            try:
                ok, remote_calls = self.plane.stage_update_round(
                    body, plan=topo.key,
                    rows=len(rnd.adds) + len(rnd.dels)
                    + len(rnd.changes))
            except Exception:
                # a raise mid-body leaves the round half-applied (the
                # registries moved; stage_update_round's finally put
                # the device in agreement): replay the journal INSIDE
                # this same lock hold so no tick ever shapes against
                # the mixture — the "round k or k+1, never a mixture"
                # barrier contract
                self._rollback(topo)
                raise
        remote_ok = eng.complete_remote(remote_calls, pod_key=topo.key,
                                        action="staged-add")
        return ok and remote_ok

    def _endpoints(self, topo, rnd: UpdateRound) -> list:
        """(pod_key, uid) endpoints a round touches. Changes touch the
        LOCAL end only (update_links semantics — journaling the peer
        row would make rollback reinstall a qdisc the round never
        touched); adds/dels touch both directed ends."""
        key = topo.key
        ns = topo.namespace or "default"
        out: list = []
        seen: set = set()

        def add(pk, uid):
            if (pk, uid) not in seen:
                seen.add((pk, uid))
                out.append((pk, uid))

        for link in (*rnd.adds, *rnd.dels):
            add(key, link.uid)
            if not (link.is_macvlan() or link.is_physical()):
                add(f"{ns}/{link.peer_pod}", link.uid)
        for link in rnd.changes:
            add(key, link.uid)
        return out

    def _capture_images(self, topo, rnd: UpdateRound) -> list:
        """Row-level pre-round checkpoint of every endpoint the round
        touches — ONE bulk device gather for the props bits."""
        eng = self.engine
        endpoints = self._endpoints(topo, rnd)
        with eng._lock:
            eng._flush_device_locked()
            st = eng._state
            rows = [eng._rows.get(ep) for ep in endpoints]
            present = [(ep, r) for ep, r in zip(endpoints, rows)
                       if r is not None]
            images: list = [
                _RowImage(pod_key=ep[0], uid=ep[1], row=None)
                for ep, r in zip(endpoints, rows) if r is None]
            if present:
                idx = torch.as_tensor([r for _ep, r in present],
                                      dtype=torch.int64, device=st.device)
                src = st.src.index_select(0, idx).cpu().numpy()
                dst = st.dst.index_select(0, idx).cpu().numpy()
                props = st.props.index_select(0, idx).cpu().numpy()
                for i, (ep, r) in enumerate(present):
                    images.append(_RowImage(
                        pod_key=ep[0], uid=ep[1], row=int(r),
                        src=int(src[i]), dst=int(dst[i]),
                        props=props[i],
                        shaped=r in eng._shaped_rows,
                        peer=eng._peer.get(ep)))
        return images

    def _rollback(self, topo) -> bool:
        """Replay the journal in reverse inside ONE barrier: every
        applied round's endpoints restore to their exact pre-round row,
        bits, and registry entries. Returns whether anything was
        rolled back.

        The journal clears only AFTER the replay completes: a failure
        inside the replay (an engine scatter in exactly the degraded
        environment that triggered the rollback) leaves the record
        intact, so the retry in stage()'s exception handler replays the
        same journal instead of no-opping over a half-restored plane
        (the image restores are idempotent)."""
        with self._tick_lock:
            entries = list(self._journal)
        if not entries:
            return False

        def body():
            eng = self.engine
            with eng._lock:
                for images in reversed(entries):
                    for im in images:
                        self._restore_image_locked(im)
                # reclaimed rows leave the free list in ONE vectorized
                # np.isin pass (FreeStack.remove_rows) — a per-row
                # list.remove() would make a large rollback
                # O(rows x free-list) inside the barrier, and even the
                # one-pass Python comprehension it replaced walked the
                # whole free list element-by-element (100k-link
                # engines pause the runner for seconds either way)
                owned = eng._row_owner
                eng._free.remove_rows(
                    np.fromiter(owned.keys(), np.int64, len(owned)))
            return True

        self.plane.stage_update_round(body)
        with self._tick_lock:
            self._journal = []
            self._staging_rolled = True
        self.log.warning("rollback complete %s", _fields(
            topology=topo.key, rounds=len(entries)))
        return True

    def _restore_image_locked(self, im: _RowImage) -> None:
        """Restore one endpoint (caller holds the engine lock, inside
        the staging barrier)."""
        eng = self.engine
        k = (im.pod_key, im.uid)
        cur = eng._rows.get(k)
        if im.row is None:
            # pre-round absence: the round added it — remove
            if cur is not None:
                eng._rows.pop(k, None)
                eng._row_owner.pop(cur, None)
                eng._peer.pop(k, None)
                eng._shaped_rows.discard(cur)
                eng._free.append(cur)
                eng._enqueue_delete([cur])
            return
        if cur is not None and cur != im.row:
            # re-allocated onto a different row mid-plan: clear it and
            # reclaim the journaled row below
            eng._rows.pop(k, None)
            eng._row_owner.pop(cur, None)
            eng._shaped_rows.discard(cur)
            eng._free.append(cur)
            eng._enqueue_delete([cur])
            cur = None
        row = im.row
        if cur is None:
            owner = eng._row_owner.get(row)
            if owner is not None and owner != k:
                # a concurrent reconcile claimed the journaled row: the
                # bit-exact contract cannot hold for THIS endpoint —
                # restore into a fresh row, loudly, never silently
                self.log.error("rollback row conflict %s", _fields(
                    pod_key=im.pod_key, uid=im.uid, row=row,
                    owner=str(owner)))
                # rows reclaimed by EARLIER images in this replay are
                # still sitting on _free (the single post-pass filter
                # removes them); popping one here would map two
                # endpoints onto one row — drop owned leftovers first
                eng._free.drop_top_while_in(eng._row_owner)
                if not eng._free:
                    eng._ensure_capacity(1)  # never IndexError
                row = eng._alloc(im.pod_key, im.uid)
            else:
                # the row may sit on the free list; _rollback's single
                # post-pass filter removes every reclaimed row at once
                eng._rows[k] = row
                eng._row_owner[row] = k
        eng._enqueue_apply([(row, im.uid, im.src, im.dst, im.props,
                             im.shaped)])
        if im.peer is not None:
            eng._peer[k] = im.peer
        else:
            eng._peer.pop(k, None)

    # -- watch window ---------------------------------------------------

    def _baseline(self) -> dict:
        """Pre-plan health reference: fault-domain counters plus the
        telemetry ring's current content (the service level rollback
        restores)."""
        p = self.plane
        base = {
            "tick_errors": p.tick_errors,
            "degrade_level": p.degrade_level,
            "shaped": p.shaped,
            "dropped": p.dropped,
            "ticks": p.ticks,
            "delivery_ratio": None,
            "p99_us": None,
            "tel_total": None,
        }
        tel = p.telemetry
        if tel is not None:
            total, _secs = tel.window_sum()
            agg = total.sum(axis=0)
            base["tel_total"] = agg
            if agg[tele.T_TX] >= 1.0:
                base["delivery_ratio"] = (float(agg[tele.T_DELIVERED])
                                          / float(agg[tele.T_TX]))
                pcts = tele.percentiles_from_hist(
                    agg[tele.T_HIST0:], qs=(0.99,))
                base["p99_us"] = pcts.get("p99_us")
                # censored: the baseline p99 clamped at the open top
                # bucket — the watch comparison still uses the clamp
                # (conservative: both sides clamp identically) but the
                # flag rides the record so a ">5000ms" baseline is
                # never rendered as "=5000ms"
                base["p99_censored"] = pcts.get("p99_censored", False)
        elif p.shaped >= 1:
            base["delivery_ratio"] = (p.shaped - p.dropped) / p.shaped
        return base

    def _observe(self, n: int, timeout_s: float, tick_driver) -> int:
        """Let `n` ticks elapse (driver-driven or real-time runner).
        Returns the ticks actually observed — 0 when no runner is live
        and no driver was given (the health check then sees no traffic
        delta and passes vacuously; callers staging against a stopped
        plane get exactly the direct-apply semantics)."""
        p = self.plane
        if tick_driver is not None:
            tick_driver(n)
            return n
        if not p.running:
            return 0
        start = p.ticks
        deadline = time.monotonic() + timeout_s
        pause = min(max(p.dt_us / 1e6, 1e-3), 0.05)
        while p.ticks - start < n and time.monotonic() < deadline:
            time.sleep(pause)
        return p.ticks - start

    def _health(self, base: dict, g: Guardrails):
        """(ok, reason, snapshot) from the fault-domain counters and
        the telemetry window ring's delta since `base`. The window-ring
        delta is clamped at zero per cell: a window evicted from the
        bounded ring mid-watch subtracts history, not the watch window
        (watches are short against the ring span; documented)."""
        p = self.plane
        snap: dict = {}
        if p.tick_errors > base["tick_errors"]:
            return (False, f"tick_errors {base['tick_errors']} -> "
                           f"{p.tick_errors} (dispatch failures)", snap)
        if p.degrade_level > base["degrade_level"]:
            return (False, f"degradation ladder stepped to level "
                           f"{p.degrade_level}", snap)
        tel = p.telemetry
        if tel is not None and base.get("tel_total") is not None:
            total, _secs = tel.window_sum()
            delta = np.maximum(total.sum(axis=0) - base["tel_total"],
                               0.0)
            tx = float(delta[tele.T_TX])
            delivered = float(delta[tele.T_DELIVERED])
            snap["tx"] = tx
            snap["delivered"] = delivered
            if tx >= 1.0:
                ratio = delivered / tx
                snap["delivery_ratio"] = ratio
                pcts = tele.percentiles_from_hist(
                    delta[tele.T_HIST0:], qs=(0.99,))
                p99 = pcts.get("p99_us")
                snap["p99_us"] = p99
                snap["p99_censored"] = pcts.get("p99_censored", False)
                ok, why = g.check(ratio, p99,
                                  base.get("delivery_ratio"),
                                  base.get("p99_us"))
                if not ok:
                    return False, why, snap
            return True, "", snap
        # no telemetry: cumulative counter fallback (ratio only)
        shaped_d = p.shaped - base["shaped"]
        dropped_d = p.dropped - base["dropped"]
        snap["shaped"] = shaped_d
        snap["dropped"] = dropped_d
        if shaped_d >= 1:
            ratio = (shaped_d - dropped_d) / shaped_d
            snap["delivery_ratio"] = ratio
            ok, why = g.check(ratio, None,
                              base.get("delivery_ratio"), None)
            if not ok:
                return False, why, snap
        return True, "", snap
