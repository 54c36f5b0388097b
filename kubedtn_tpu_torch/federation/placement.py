"""Placement — the fleet's tenant→plane ledger and scoring policy.

The ledger is the supervisor's durable memory of WHERE every tenant
lives: a single journaled record (`federation.journal`'s staged-save /
sha256 / `.prev` double-crash discipline — the checkpoint atomicity
contract) that survives a supervisor restart, so an evacuation after a
crash knows exactly which tenants the dead plane owed without trusting
the dead plane's own state. Every mutation commits before it returns;
a kill at any instant leaves the previous complete generation
readable.

The policy is deliberately simple and fully deterministic: a plane's
placement score blends capacity headroom (the dominant term — a plane
that cannot hold the tenant's rows must lose), current placement
pressure (admitted tenants weighted by their QoS drain share, so a
bronze tenant crowds a plane less than a gold one), and health
penalties (degradation-ladder rung, standing backlog). Rebalance
decisions come out as (tenant, src, dst) moves for the supervisor to
execute as live migrations (federation.migrate) — the ledger itself
never touches a plane.

Port of kubedtn_tpu/federation/placement.py: pure host arithmetic, the
same scores and plans to the bit, and the same ledger record, written
through this package's journal (either package loads the other's).
"""

from __future__ import annotations

import threading

from kubedtn_tpu_torch.contracts import guarded_by, requires_lock
from kubedtn_tpu_torch.federation import journal
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

# the one record id inside the ledger root (journal layout: one record
# directory per id; the ledger is a single logical record)
LEDGER_RECORD = "placement"

# QoS class → placement pressure (the drain-weight ladder of
# tenancy.registry: how much of a plane's drain budget the tenant can
# claim — the policy packs light tenants denser)
QOS_PRESSURE = {"gold": 1.0, "silver": 0.5, "bronze": 0.25}


class PlacementError(RuntimeError):
    """No legal placement exists (all planes dead/cordoned/full)."""


@guarded_by("_lock", "_placements", "_cordoned", "_qos")
class PlacementLedger:
    """Crash-safe tenant→plane ledger. Mutations journal BEFORE they
    return (`assign`/`remove`/`cordon`/`uncordon` are each one
    committed generation); readers get torn-free snapshots under the
    lock. Ledger ops are O(1) in-memory plus one O(placements) record
    serialization per commit."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.log = get_logger("fleet")
        self._lock = threading.Lock()
        self._placements: dict[str, str] = {}
        self._qos: dict[str, str] = {}
        self._cordoned: set[str] = set()
        try:
            rec = journal.load_record_meta(root, LEDGER_RECORD)
        except journal.JournalMissingError:
            rec = None
        except journal.JournalCorruptError:
            # both generations damaged: surface loudly but start empty
            # (the supervisor re-adopts placements from the live
            # registries on attach) rather than refusing to supervise
            self.log.exception("placement ledger unreadable; starting "
                               "empty %s", _fields(root=root))
            rec = None
        if rec is not None:
            self._placements = dict(rec.get("placements", {}))
            self._qos = dict(rec.get("qos", {}))
            self._cordoned = set(rec.get("cordoned", ()))

    @requires_lock("_lock")
    def _commit_locked(self) -> None:
        journal.save_record(self.root, LEDGER_RECORD, {
            "placements": dict(self._placements),
            "qos": dict(self._qos),
            "cordoned": sorted(self._cordoned),
        })

    def assign(self, tenant: str, plane: str,
               qos: str | None = None) -> None:
        with self._lock:
            self._placements[tenant] = plane
            if qos is not None:
                self._qos[tenant] = qos
            self._commit_locked()

    def remove(self, tenant: str) -> None:
        with self._lock:
            self._placements.pop(tenant, None)
            self._qos.pop(tenant, None)
            self._commit_locked()

    def get(self, tenant: str) -> str | None:
        with self._lock:
            return self._placements.get(tenant)

    def qos_of(self, tenant: str) -> str:
        with self._lock:
            return self._qos.get(tenant, "gold")

    def placements(self) -> dict[str, str]:
        with self._lock:
            return dict(self._placements)

    def on_plane(self, plane: str) -> list[str]:
        with self._lock:
            return sorted(t for t, p in self._placements.items()
                          if p == plane)

    def cordon(self, plane: str) -> None:
        """Mark a plane closed to NEW placements (upgrade/maintenance);
        existing tenants keep serving."""
        with self._lock:
            self._cordoned.add(plane)
            self._commit_locked()

    def uncordon(self, plane: str) -> None:
        with self._lock:
            self._cordoned.discard(plane)
            self._commit_locked()

    def cordoned(self) -> set[str]:
        with self._lock:
            return set(self._cordoned)


def plane_score(health: dict, pressure: float) -> float:
    """Placement desirability of one plane: capacity headroom fraction
    dominates, minus the QoS-weighted pressure already placed there,
    minus health penalties (a degraded rung or a standing backlog make
    a plane a worse target long before it turns suspect). Pure and
    deterministic — same inputs, same score."""
    cap = max(1, int(health.get("capacity", 0) or 0))
    headroom = float(health.get("headroom_rows", 0)) / cap
    degrade = float(health.get("degrade_level", 0) or 0)
    backlog = float(health.get("backlog", 0) or 0)
    score = headroom
    score -= 0.10 * pressure          # QoS-weighted tenants placed
    score -= 0.30 * degrade           # each ladder rung down
    score -= min(0.5, backlog / 65536.0)  # standing ingress backlog
    if not health.get("serving", True):
        score -= 1.0
    return score


def pressure_of(tenants: list[str], qos_of) -> float:
    """Sum of QOS_PRESSURE over `tenants` (`qos_of(tenant)` → class)."""
    return sum(QOS_PRESSURE.get(qos_of(t), 1.0) for t in tenants)


def choose_plane(healths: dict[str, dict],
                 placed: dict[str, list[str]], qos_of,
                 exclude=()) -> str:
    """The best placement target: highest `plane_score`, name as the
    deterministic tiebreak. `healths` maps candidate plane → health
    dict (dead/cordoned planes must already be excluded or listed in
    `exclude`); `placed` maps plane → tenants currently there."""
    best_name, best_score = None, None
    for name in sorted(healths):
        if name in exclude:
            continue
        score = plane_score(
            healths[name], pressure_of(placed.get(name, []), qos_of))
        if best_score is None or score > best_score:
            best_name, best_score = name, score
    if best_name is None:
        raise PlacementError(
            f"no placement candidate (excluded: {sorted(exclude)})")
    return best_name


def rebalance_plan(healths: dict[str, dict],
                   placed: dict[str, list[str]], qos_of,
                   exclude=(), min_gain: float = 0.25
                   ) -> list[tuple[str, str, str]]:
    """Score-driven moves (tenant, src, dst), greedy one-tenant-at-a-
    time: move a tenant when the destination's score exceeds its
    current plane's by at least `min_gain` AFTER accounting for the
    tenant's own pressure landing there (no oscillation: the gain
    threshold plus the self-pressure term make the reverse move
    strictly worse). Executed by the supervisor as live migrations."""
    placed = {p: list(ts) for p, ts in placed.items()}
    moves: list[tuple[str, str, str]] = []
    for src in sorted(placed):
        if src in exclude or src not in healths:
            continue
        for tenant in list(placed[src]):
            pressure = QOS_PRESSURE.get(qos_of(tenant), 1.0)
            src_score = plane_score(
                healths[src], pressure_of(placed[src], qos_of))
            best, best_score = None, None
            for dst in sorted(healths):
                if dst == src or dst in exclude:
                    continue
                # score as if the tenant already landed there
                dst_score = plane_score(
                    healths[dst],
                    pressure_of(placed.get(dst, []), qos_of)
                    + pressure)
                if best_score is None or dst_score > best_score:
                    best, best_score = dst, dst_score
            if best is not None and best_score >= src_score + min_gain:
                moves.append((tenant, src, best))
                placed[src].remove(tenant)
                placed.setdefault(best, []).append(tenant)
    return moves
