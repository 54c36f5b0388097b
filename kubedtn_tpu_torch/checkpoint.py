"""Checkpoint / resume + elastic recovery.

Port of kubedtn_tpu/checkpoint.py. The reference has no snapshot files:
its durable state is the Topology CR (Status.Links = last applied,
Status.SrcIP/NetNs = placement) plus the kernel devices themselves, and
crash recovery is *reconstruction* — a restarted daemon re-lists
topologies and rescans pod netnses to rebuild its managers (reference
daemon/kubedtn/kubedtn.go:107-121, daemon/vxlan/manager.go:25-55). This
module provides both halves:

- `rebuild_engine` — the reconstruction path: given only the store (the
  CR source of truth), re-derive the whole device realization, exactly
  like a daemon restart. Device tensors are rebuildable projections.
- `save` / `load` — a real checkpoint: store contents + engine registries
  as JSON, the edge state as npz. Restoring short-circuits reconstruction
  and preserves mutable shaping state (token buckets, correlation memory,
  counters) that reconstruction would reset — the same distinction as
  kernel qdiscs surviving a daemon restart vs being reinstalled.

The on-disk format is the JAX package's, byte for byte in layout: the
same FORMAT_VERSION, manifest keys, npz member names and dtypes (bool,
int32 and float32 columns; float64 remaining delays; the engine's uint64
key ids are re-derived from the rows, never stored). Either package
reads the other's checkpoint directories. The edge state goes device ->
host once per column at capture (inside the engine lock, after the
pending scatters are flushed) and host -> device once per column at load,
onto `device` (None = the CUDA card).

Crash consistency: `save` stages the whole checkpoint in a temp directory
beside the target — manifest carrying a sha256 per data file — fsyncs it,
then swaps it into place with atomic renames (old → `<path>.prev`, tmp →
path). A `kill -9` at ANY instant leaves either the new complete
checkpoint, the previous complete one (found at path or recovered from
`.prev`), or nothing valid — never a torn mix of generations; rewriting
the directory wholesale also means a re-save can never leak an earlier
generation's `pending_frames.npz`/`sim_state.npz` into a later restore.
The loaders verify the checksums and raise TYPED errors
(`CheckpointCorruptError`) on any damage; `load_or_rebuild` turns that
into the reference's reconstruction fallback.

With a tenancy registry on the engine (`engine.tenancy`), `save` writes
the JAX package's tenancy section (quotas, QoS, block entitlements,
namespace bindings, admitted meters) and appends the blocks' unused rows
to the saved free list, reverse-sorted; `load_tenancy` rebuilds the
registry from it, re-carving each block from the restored free list. A
load without tenancy keeps those rows in the global pool. Not ported:
the trace spans
around save/load (the port has no tracing module yet) and
`load_or_rebuild`'s mesh re-sharding (the port's plane splits the whole
state into shards per dispatch).

Two additions, each readable by the JAX loaders unchanged: the plane
section carries the wheel's `origin_s` next to `last_shaped_s` (a JAX
checkpoint without it restores with the origin at the restore clock),
and wire_ingress.npz holds a wire's seq-slots holdback frames ahead of
its queued ingress (the JAX capture leaves the holdback out, so those
accepted frames are lost on a JAX restart).

Layout of a checkpoint directory:
  manifest.json      — versioned metadata + engine registries + store
                       records + per-file sha256 checksums
  edge_state.npz     — EdgeState arrays
  sim_state.npz      — optional SimState arrays (inflight/counters/traffic)
  pending_frames.npz — optional in-flight delay-line frames
  wire_ingress.npz   — optional queued-but-undrained ingress frames
  plane_counters.npz — optional cumulative per-edge plane counters
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.api.types import Topology
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.topology.engine import SimEngine
from kubedtn_tpu_torch.topology.store import TopologyStore
from kubedtn_tpu_torch.utils.logging import fields, get_logger

FORMAT_VERSION = 2  # 2: per-file checksums + atomic directory swap

_PREV_SUFFIX = ".prev"
_TMP_PREFIX = ".ckpt-tmp-"
_CKPT_FILES = {"manifest.json", "edge_state.npz", "sim_state.npz",
               "pending_frames.npz", "plane_counters.npz",
               "wire_ingress.npz"}


class CheckpointError(Exception):
    """A checkpoint could not be used (missing, wrong version, ...)."""


class CheckpointMissingError(CheckpointError):
    """No checkpoint exists at the path (a fresh daemon's first start)
    — distinct from damage or an unsupported format, which callers must
    surface rather than silently cold-start over."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint exists but is damaged: truncated/unparseable
    manifest, unreadable npz, or a checksum mismatch. The documented
    recovery is `rebuild_engine` from the store (`load_or_rebuild`)."""


def _host(x) -> np.ndarray:
    """A column as a host numpy array (one device -> host copy)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host column as the port's tensor on `dev`: bool stays, integers
    are int32, floats float32 — the dtypes both packages save, so the
    bits pass unchanged."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dt = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dt = torch.int32
    else:
        dt = torch.float32
    return torch.as_tensor(np.array(a), dtype=dt, device=dev)


# -- store serialization ----------------------------------------------

def store_records(store: TopologyStore) -> list[dict]:
    """Full topology records incl. the metadata to_manifest omits."""
    return [{"manifest": t.to_manifest(),
             "finalizers": list(t.finalizers),
             "resource_version": t.resource_version,
             "deletion_requested": t.deletion_requested}
            for t in store.list()]


def restore_store(records: list[dict]) -> TopologyStore:
    store = TopologyStore()
    # Bypass create(): it resets resourceVersion/deletionRequested, but a
    # restore must preserve the optimistic-concurrency clocks so in-flight
    # clients conflict correctly against pre-checkpoint versions.
    with store._lock:
        for r in records:
            t = Topology.from_manifest(r["manifest"])
            t.finalizers = list(r.get("finalizers", []))
            t.deletion_requested = bool(r.get("deletion_requested", False))
            t.resource_version = int(r.get("resource_version", 1))
            store._objects[t.key] = t
            store._rv = max(store._rv, t.resource_version)
    return store


# -- elastic recovery (reconstruction) --------------------------------

def rebuild_engine(store: TopologyStore, capacity: int = 1024,
                   node_ip: str = "10.0.0.1", device=None) -> SimEngine:
    """Daemon-restart reconstruction: rebuild the full device
    realization from the store alone, on `device` (None = the card).

    Mirrors the reference's startup resync (kubedtn.go:107-121): list all
    topologies, seed the managers, and re-plumb every alive pod's links.
    add_links is idempotent per (pod, uid) like SetupVeth
    (common/veth.go:65-93), so plumbing both endpoint topologies converges
    to one realization. Mutable shaping state comes back fresh, exactly as
    reinstalled qdiscs would.
    """
    engine = SimEngine(store, capacity=capacity, node_ip=node_ip,
                       device=device)
    for topo in store.list():
        if topo.is_alive():
            engine.set_alive(topo.name, topo.namespace, topo.status.src_ip,
                             topo.status.net_ns)
    # second pass so peer-aliveness checks see every pod's restored status
    for topo in store.list():
        if topo.is_alive():
            engine.add_links(topo, topo.spec.links)
    return engine


# -- crash-consistent directory plumbing ------------------------------

def _pid_alive(pid: int) -> bool:
    """Is a process with this pid running (signal-0 probe)?"""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return True  # unknown: err on the side of not deleting
    return True


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_path(path: str) -> None:
    """Best-effort fsync of a file or directory (crash durability; not
    every filesystem supports directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _read_manifest(dirpath: str) -> dict:
    """Parse + structurally validate one directory's manifest, mapping
    every damage mode to a typed error."""
    mpath = os.path.join(dirpath, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        try:
            nonempty = bool(os.listdir(dirpath))
        except OSError:
            nonempty = False
        if nonempty:
            # data files without a manifest is DAMAGE (a partial restore
            # or manual deletion), not a fresh start
            raise CheckpointCorruptError(
                f"checkpoint directory {dirpath} has data files but no "
                f"manifest") from e
        raise CheckpointMissingError(
            f"no checkpoint manifest at {mpath}") from e
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {mpath}: {e}") from e
    if not isinstance(manifest, dict) or "format_version" not in manifest:
        raise CheckpointCorruptError(
            f"checkpoint manifest {mpath} lacks format_version")
    if manifest["format_version"] not in (1, FORMAT_VERSION):
        raise CheckpointError(
            f"unsupported checkpoint version {manifest['format_version']}")
    return manifest


def _resolve_dir(path: str) -> tuple[str, dict]:
    """The directory holding the newest COMPLETE checkpoint for `path`:
    `path` itself when its manifest is valid, else the `<path>.prev` a
    crash between save()'s two renames left behind. Read-only; every
    loader resolves through here, so a fallback restore reads one
    coherent generation."""
    try:
        return path, _read_manifest(path)
    except CheckpointError as primary:
        prev = path + _PREV_SUFFIX
        try:
            manifest = _read_manifest(prev)
        except CheckpointError:
            raise primary from None
        return prev, manifest


def _verify_checksum(dirpath: str, manifest: dict, fname: str) -> None:
    """Raise CheckpointCorruptError when `fname` does not match the
    manifest's recorded sha256 (v1 manifests carry none — skipped)."""
    want = manifest.get("checksums", {}).get(fname)
    if want is None:
        return
    fpath = os.path.join(dirpath, fname)
    try:
        got = _sha256_file(fpath)
    except OSError as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint file {fpath}: {e}") from e
    if got != want:
        raise CheckpointCorruptError(
            f"checksum mismatch for {fpath}: manifest {want[:12]}…, "
            f"file {got[:12]}…")


def _load_npz(dirpath: str, manifest: dict, fname: str):
    """Checksum-verified np.load with npz damage mapped to the typed
    error (np.load raises half a dozen exception types on truncation)."""
    _verify_checksum(dirpath, manifest, fname)
    fpath = os.path.join(dirpath, fname)
    try:
        return np.load(fpath)
    except Exception as e:
        raise CheckpointCorruptError(
            f"damaged checkpoint array file {fpath}: {e}") from e


# -- SimState npz codec -------------------------------------------------
#
# The ONE flatten/unflatten for the "<field>.<leaf>" layout, shared by the
# checkpoint's sim_state.npz (edges stored separately in edge_state.npz)
# and the twin's snapshot files (edges inlined).

def flatten_sim_arrays(sim, include_edges: bool = False) -> dict:
    names = (("edges",) if include_edges else ()) + (
        "inflight", "counters", "traffic")
    flat = {}
    for name in names:
        sub = getattr(sim, name)
        for fld in dataclasses.fields(sub):
            flat[f"{name}.{fld.name}"] = _host(getattr(sub, fld.name))
    flat["clock_us"] = _host(sim.clock_us)
    return flat


def unflatten_sim_arrays(z, edges=None, device=None):
    """SimState on `device` (None = the card) from a flattened npz
    mapping; `edges` supplies the EdgeState when the file excludes it
    (checkpoint layout)."""
    from kubedtn_tpu_torch.models.traffic import TrafficState
    from kubedtn_tpu_torch.ops.queues import EdgeCounters, InFlight
    from kubedtn_tpu_torch.sim import SimState

    dev = resolve_device(device)

    def sub(cls, prefix):
        return cls(**{f.name: _to_device(z[f"{prefix}.{f.name}"], dev)
                      for f in dataclasses.fields(cls)})

    return SimState(
        edges=edges if edges is not None else sub(es.EdgeState, "edges"),
        inflight=sub(InFlight, "inflight"),
        counters=sub(EdgeCounters, "counters"),
        traffic=sub(TrafficState, "traffic"),
        clock_us=_to_device(z["clock_us"], dev),
    )


# -- checkpoint save/load ---------------------------------------------

def save(path: str, store: TopologyStore, engine: SimEngine,
         sim=None, dataplane=None) -> None:
    """Write a checkpoint directory ATOMICALLY (module docstring). With
    `dataplane`, in-flight delay-line frames, queued ingress, wire
    definitions and the plane's cumulative per-edge counters are
    persisted too, so a restarted daemon completes the frames'
    remaining delays and keeps its delivery accounting. For a plane
    whose runner is STILL TICKING, use `save_live` (this entry refuses:
    an unsynchronized capture could double-deliver or lose frames)."""
    if dataplane is not None and getattr(dataplane, "running", False):
        raise RuntimeError(
            "stop() the data plane before checkpointing its pending "
            "frames, or use save_live() for a barrier-consistent "
            "autosave")
    pauses = getattr(dataplane, "pauses", None)
    if pauses is not None:
        # stopped plane, but the pause still lands in the ledger so a
        # restart-heavy fleet's checkpoint cost stays attributable
        with pauses.pause("checkpoint_save", path=path,
                          rows=int(engine._state.capacity)):
            cap = _capture(store, engine, sim, dataplane)
    else:
        cap = _capture(store, engine, sim, dataplane)
    _write_captured(path, cap)


def save_live(path: str, store: TopologyStore, engine: SimEngine,
              dataplane) -> None:
    """Crash-consistent checkpoint of a RUNNING plane — the periodic
    autosave entry. The capture happens at one `stage_update_round`
    flush barrier (every in-flight dispatch's write-back lands first; the
    runner pauses one barrier, cause `checkpoint_save`, rows = the
    engine's full column height), then the staging, fsync and atomic
    swap run OFF the tick path so disk I/O never blocks a tick."""
    cap = dataplane.stage_update_round(
        lambda: _capture(store, engine, None, dataplane),
        cause="checkpoint_save", path=path,
        rows=int(engine._state.capacity))
    _write_captured(path, cap)


def _capture(store: TopologyStore, engine: SimEngine,
             sim=None, dataplane=None) -> dict:
    """Consistent point-in-time cut of everything a checkpoint persists,
    as host arrays + JSON-ready manifest sections — no disk I/O. Runs
    with the plane stopped (`save`) or inside a tick-lock flush barrier
    (`save_live`); the engine lock is held across the state gather and
    the registry snapshot so the two can never show different
    generations."""
    cap: dict = {"sim": None, "pending": None, "counters": None,
                 "ingress": None}
    if dataplane is not None:
        cap["pending"] = dataplane.export_pending()
        cap["counters"] = {
            f.name: np.array(getattr(dataplane.counters, f.name))
            for f in dataclasses.fields(type(dataplane.counters))}
        # queued-but-undrained INGRESS frames: accepted from producers
        # but not yet shaped — without these a restart silently loses
        # every frame the plane accepted since its last drain
        # The seq-slots HOLDBACK (frames drained but deferred to the
        # next tick) is accepted-but-unshaped too: it goes first, ahead
        # of the wire's queue, the order the plane would shape them in
        from kubedtn_tpu_torch.wire.server import flatten_frames

        with dataplane._tick_lock:
            held = {wid: flatten_frames(h[2])
                    for wid, h in dataplane._holdback.items()}
        ingress = []
        for w in dataplane.daemon.wires.all():
            for frame in (held.get(w.wire_id, [])
                          + flatten_frames(w.ingress.snapshot_entries())):
                ingress.append((w.pod_key, int(w.uid), frame))
        cap["ingress"] = ingress
    with engine._lock:
        engine._flush_device_locked()
        st = engine._state
        cap["edge"] = {f.name: _host(getattr(st, f.name))
                       for f in dataclasses.fields(type(st))}
        manifest = {
            "format_version": FORMAT_VERSION,
            "node_ip": engine.node_ip,
            "capacity": st.capacity,
            "engine": {
                "pod_ids": dict(engine._pod_ids),
                "rows": [[k[0], k[1], v]
                         for k, v in engine._rows.items()],
                "peer": [[k[0], k[1], v[0], v[1]]
                         for k, v in engine._peer.items()],
                "free": engine._free.tolist(),
                "alive": sorted(engine._topology_manager),
            },
            "has_sim": sim is not None,
        }
    manifest["store"] = store_records(store)
    if sim is not None:
        cap["sim"] = flatten_sim_arrays(sim)
    if dataplane is not None:
        # wire definitions: the attachment registry is daemon state the
        # store cannot re-derive
        manifest["wires"] = [
            [w.pod_key, int(w.uid), w.peer_ip, int(w.peer_intf_id),
             w.node_iface_name]
            for w in dataplane.daemon.wires.all()]
        # the plane's clock: its shaping epoch, and (a key the JAX
        # package's format lacks and its loaders ignore) the wheel's
        # origin, so a plane resumed on the same explicit clock computes
        # every deadline from the same offsets (entry.restore_daemon)
        ls, origin = dataplane._last_shaped_s, dataplane._origin_s
        manifest["plane"] = {
            "last_shaped_s": None if ls is None else float(ls),
            "has_counters": True,
            "origin_s": None if origin is None else float(origin),
        }
    tenancy = getattr(engine, "tenancy", None)
    if tenancy is not None:
        # quotas / QoS / block entitlements / namespace bindings survive
        # the restart (load_tenancy); the blocks' unused rows go back
        # into the saved free list, or each restart would leak them
        # (gone from the global pool AND from the re-carved blocks)
        manifest["tenancy"] = tenancy.export_config()
        manifest["engine"]["free"] = (
            manifest["engine"]["free"]
            + sorted(tenancy.reserved_free_rows(), reverse=True))
    cap["manifest"] = manifest
    return cap


def _write_captured(path: str, cap: dict) -> None:
    """Stage a captured checkpoint beside `path` and swap it into place
    atomically (the write half of `save`/`save_live` — pure disk work,
    never touches live state)."""
    path = os.path.abspath(path)
    if (os.path.isdir(path) and os.listdir(path)
            and not os.path.exists(os.path.join(path, "manifest.json"))
            and not set(os.listdir(path)) <= _CKPT_FILES):
        # a manifest-less dir of ONLY checkpoint files is damaged debris
        # this save may replace; anything else is presumably the user's
        raise CheckpointError(
            f"refusing to replace {path}: non-empty directory without a "
            f"checkpoint manifest")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    # sweep staging dirs leaked by CRASHED saves: exact
    # `<prefix><basename>-<pid>` match only (a bare prefix match would
    # also hit a sibling checkpoint named `<basename>-x`), and a pid that
    # is still alive is another process's LIVE staging — never touched
    pat = re.compile(
        re.escape(f"{_TMP_PREFIX}{os.path.basename(path)}-") + r"(\d+)$")
    for entry in os.listdir(parent):
        m = pat.fullmatch(entry)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid != os.getpid() and _pid_alive(pid):
            continue
        shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)
    tmp = os.path.join(parent,
                       f"{_TMP_PREFIX}{os.path.basename(path)}-{os.getpid()}")
    os.makedirs(tmp)
    try:
        if cap["pending"] is not None:
            _pending_to_npz(os.path.join(tmp, "pending_frames.npz"),
                            cap["pending"])
        if cap["ingress"]:
            _frames_to_npz(os.path.join(tmp, "wire_ingress.npz"),
                           cap["ingress"])
        if cap["counters"] is not None:
            np.savez_compressed(os.path.join(tmp, "plane_counters.npz"),
                                **cap["counters"])
        np.savez_compressed(os.path.join(tmp, "edge_state.npz"),
                            **cap["edge"])
        if cap["sim"] is not None:
            np.savez_compressed(os.path.join(tmp, "sim_state.npz"),
                                **cap["sim"])
        checksums = {fname: _sha256_file(os.path.join(tmp, fname))
                     for fname in sorted(os.listdir(tmp))}
        manifest = dict(cap["manifest"])
        manifest["checksums"] = checksums
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            # the same text json.dump writes, from the C encoder: a
            # 2^18-row plane's manifest is ~70 MB, which json.dump's
            # chunked Python encoder writes several times slower (the
            # federation journal's records, likewise)
            f.write(json.dumps(manifest))
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
        for fname in checksums:
            _fsync_path(os.path.join(tmp, fname))
        _fsync_path(tmp)
        # -- atomic swap: each rename is atomic; between them `path` is
        # briefly absent but `.prev` holds the previous complete
        # generation, which load() falls back to. When `path` is ABSENT
        # (recovering from a prior mid-save crash) a leftover `.prev` is
        # the ONLY complete generation — pruned only at the end.
        prev = path + _PREV_SUFFIX
        if os.path.isdir(path):
            shutil.rmtree(prev, ignore_errors=True)  # superseded by path
            os.rename(path, prev)
        os.rename(tmp, path)
        _fsync_path(parent)
        shutil.rmtree(prev, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load(path: str, device=None) -> tuple[TopologyStore, SimEngine]:
    """Restore (store, engine) from a checkpoint directory, verifying
    checksums, with the edge state on `device` (None = the card). Falls
    back to the `<path>.prev` generation a mid-save crash may have left;
    raises `CheckpointError`/`CheckpointCorruptError` (typed — see
    `load_or_rebuild` for the reconstruction fallback) when neither
    generation is usable."""
    return _load_traced(path, resolve_device(device))


def _load_traced(path: str, dev: torch.device
                 ) -> tuple[TopologyStore, SimEngine]:
    path = os.path.abspath(path)
    dirpath, manifest = _resolve_dir(path)

    try:
        store = restore_store(manifest["store"])
        engine = SimEngine(store, capacity=manifest["capacity"],
                           node_ip=manifest["node_ip"], device=dev)
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"malformed checkpoint manifest in {dirpath}: {e}") from e

    with _load_npz(dirpath, manifest, "edge_state.npz") as z:
        try:
            engine.state = es.EdgeState(**{
                f.name: _to_device(z[f.name], dev)
                for f in dataclasses.fields(es.EdgeState)})
            # rebuild the host mirror the bypass guard consults: a
            # restored shaped link must NOT read as unshaped (that would
            # let same-node TCP flows skip its netem/TBF chain entirely)
            shaped = np.flatnonzero(
                z["active"] & np.asarray(z["props"]).any(axis=1))
        except Exception as e:
            raise CheckpointCorruptError(
                f"damaged edge_state.npz in {dirpath}: {e}") from e
        engine._shaped_rows = set(int(r) for r in shaped)

    try:
        from kubedtn_tpu_torch.topology.engine import link_key_id
        from kubedtn_tpu_torch.topology.freelist import FreeStack

        eng = manifest["engine"]
        engine._pod_ids = dict(eng["pod_ids"])
        engine._pod_names = {v: k for k, v in engine._pod_ids.items()}
        engine._rows = {(p, int(u)): int(r) for p, u, r in eng["rows"]}
        engine._row_owner = {r: k for k, r in engine._rows.items()}
        # per-row identity key ids are derivable state: re-derive the
        # column in the same registry pass (a restored link must keep
        # its identity-keyed PRNG stream)
        for (p, u), r in engine._rows.items():
            engine._row_keyid[r] = link_key_id(p, int(u))
        engine._peer = {(p, int(u)): (pp, int(pu))
                        for p, u, pp, pu in eng["peer"]}
        engine._free = FreeStack(eng["free"])
        engine._topology_manager = set(eng["alive"])
    except (KeyError, TypeError, ValueError, IndexError) as e:
        # IndexError: a manifest row beyond the stated capacity hits the
        # key-id write — damage, same typed contract
        raise CheckpointCorruptError(
            f"malformed engine registries in {dirpath}: {e}") from e
    return store, engine


def load_or_rebuild(path: str, store: TopologyStore | None = None,
                    capacity: int = 1024, node_ip: str = "10.0.0.1",
                    device=None) -> tuple[TopologyStore, SimEngine, str]:
    """`load` with the documented corruption fallback: on any
    CheckpointError, reconstruct via `rebuild_engine` from `store` (the
    CR source of truth — the reference's restart rescan) instead of
    raising mid-restore, and log the typed error. Returns (store,
    engine, source) with source in {"checkpoint", "rebuild"}; re-raises
    only when no fallback store was provided."""
    try:
        return (*load(path, device=device), "checkpoint")
    except CheckpointError as err:
        if store is None:
            raise
        get_logger("checkpoint").warning(
            "checkpoint unusable; rebuilding from store %s",
            fields(path=path, error=f"{type(err).__name__}: {err}"))
        return store, rebuild_engine(store, capacity=capacity,
                                     node_ip=node_ip,
                                     device=device), "rebuild"


def _blob_layout(frames) -> tuple[bytes, np.ndarray, np.ndarray]:
    """(blob, offsets int64, lengths int64) of a frame sequence."""
    lens = np.fromiter((len(f) for f in frames), np.int64)
    offs = np.zeros(len(lens), np.int64)
    if len(lens):
        np.cumsum(lens[:-1], out=offs[1:])
    return b"".join(frames), offs, lens


def _pending_to_npz(fpath: str, entries) -> None:
    """Serialize exported (pod_key, uid, frame, remaining_us) entries as
    the pickle-free pending_frames.npz layout."""
    blob, offs, lens = _blob_layout([e[2] for e in entries])
    np.savez_compressed(
        fpath,
        pod_keys=np.frombuffer(
            "\n".join(e[0] for e in entries).encode(), np.uint8),
        uids=np.array([e[1] for e in entries], np.int64),
        remaining_us=np.array([e[3] for e in entries], np.float64),
        offsets=offs, lengths=lens,
        blob=np.frombuffer(blob, np.uint8),
    )


def _frames_to_npz(fpath: str, entries) -> None:
    """Serialize (pod_key, uid, frame) tuples as the pickle-free
    wire_ingress.npz layout (the pending layout minus delays)."""
    blob, offs, lens = _blob_layout([e[2] for e in entries])
    np.savez_compressed(
        fpath,
        pod_keys=np.frombuffer(
            "\n".join(e[0] for e in entries).encode(), np.uint8),
        uids=np.array([e[1] for e in entries], np.int64),
        offsets=offs, lengths=lens,
        blob=np.frombuffer(blob, np.uint8),
    )


class Generation:
    """One checkpoint generation, resolved once: its directory, its
    parsed manifest, and readers of its files checked against that
    manifest (same-generation resolution as `load`). A caller that
    reads several files of one checkpoint resolves it once — the fleet
    supervisor's evacuation slices every tenant of a dead plane out of
    one Generation; the module-level readers open one per call. Raises
    CheckpointMissingError when there is no checkpoint at `path`."""

    def __init__(self, path: str) -> None:
        self.dirpath, self.manifest = _resolve_dir(os.path.abspath(path))

    def has(self, fname: str) -> bool:
        return os.path.exists(os.path.join(self.dirpath, fname))

    def npz(self, fname: str):
        """A checksum-verified npz of this generation (a context
        manager, as `_load_npz`)."""
        return _load_npz(self.dirpath, self.manifest, fname)

    def frames(self, fname: str, with_delay: bool) -> list:
        """The entries of a pending_frames.npz / wire_ingress.npz, as
        (pod_key, uid, frame[, remaining_us]) tuples. [] when the file
        is absent; corruption raises."""
        if not self.has(fname):
            return []
        with self.npz(fname) as z:
            try:
                keys = (bytes(z["pod_keys"]).decode().split("\n")
                        if len(z["pod_keys"]) else [])
                blob = bytes(z["blob"])
                uids = z["uids"].tolist()
                offs = z["offsets"].tolist()
                lens = z["lengths"].tolist()
                frames = [blob[o:o + n] for o, n in zip(offs, lens)]
                if with_delay:
                    return list(zip(keys, uids, frames,
                                    z["remaining_us"].tolist(),
                                    strict=True))
                return list(zip(keys, uids, frames, strict=True))
            except Exception as e:
                raise CheckpointCorruptError(
                    f"damaged {fname} in {self.dirpath}: {e}") from e

    def pending_entries(self) -> list:
        return self.frames("pending_frames.npz", with_delay=True)

    def ingress_entries(self) -> list:
        return self.frames("wire_ingress.npz", with_delay=False)

    def plane_counters(self):
        """The plane counter columns (field name → np.ndarray[E]), or
        None when this generation has no counters file."""
        if not self.has("plane_counters.npz"):
            return None
        with self.npz("plane_counters.npz") as z:
            try:
                return {k: np.asarray(z[k]) for k in z.files}
            except Exception as e:
                raise CheckpointCorruptError(
                    f"damaged plane_counters.npz in {self.dirpath}: "
                    f"{e}") from e


def _generation(path: str) -> Generation | None:
    try:
        return Generation(path)
    except CheckpointMissingError:
        return None


def read_ingress_entries(path: str) -> list:
    """The checkpointed queued-ingress frames as (pod_key, uid, frame)
    tuples, FIFO per wire. [] when absent; corruption raises."""
    gen = _generation(path)
    return [] if gen is None else gen.ingress_entries()


def load_ingress(path: str, daemon) -> int:
    """Re-queue the checkpointed ingress frames onto their wires (the
    wires must already exist — `load_wires` first). The extend fires the
    wire's notify, so restored frames mark hot and drain on the first
    tick. Returns frames restored."""
    by_wire: dict[tuple, list] = {}
    for pk, uid, frame in read_ingress_entries(path):
        by_wire.setdefault((pk, uid), []).append(frame)
    n = 0
    for (pk, uid), frames in by_wire.items():
        wire = daemon.wires.get_by_key(pk, uid)
        if wire is None:
            continue  # wire vanished from the topology: nothing owed
        wire.ingress.extend(frames)
        n += len(frames)
    return n


def save_pending(path: str, dataplane) -> int:
    """Persist the data plane's in-flight frames (pickle-free npz) — the
    delay-line analogue of kernel qdisc queues surviving a daemon
    restart. Returns the frame count. (Standalone callers lose the
    atomic-swap guarantee `save` provides.)"""
    entries = dataplane.export_pending()
    _pending_to_npz(os.path.join(path, "pending_frames.npz"), entries)
    return len(entries)


def read_pending_entries(path: str) -> list:
    """The checkpointed in-flight entries as (pod_key, uid, frame,
    remaining_us) tuples WITHOUT a plane to restore them into. [] when
    no checkpoint / no pending file; corruption raises."""
    gen = _generation(path)
    return [] if gen is None else gen.pending_entries()


def load_pending(path: str, dataplane, now_s: float | None = None) -> int:
    """Re-schedule checkpointed in-flight frames with their remaining
    delays. Returns the restored count — 0 when the checkpoint carried no
    pending file OR no checkpoint exists at all (a fresh daemon's first
    start); corruption and unsupported formats raise."""
    entries = read_pending_entries(path)
    if not entries:
        return 0
    return dataplane.restore_pending(entries, now_s=now_s)


def consume_pending(path: str) -> None:
    """Remove the restored generation's pending_frames.npz AND
    wire_ingress.npz (from the SAME directory the loaders resolved) so a
    crash before the next graceful checkpoint cannot re-deliver the same
    frames twice."""
    try:
        dirpath, _manifest = _resolve_dir(os.path.abspath(path))
    except CheckpointError:
        return  # nothing restorable: nothing to consume
    for fname in ("pending_frames.npz", "wire_ingress.npz"):
        p = os.path.join(dirpath, fname)
        if os.path.exists(p):
            os.remove(p)


def load_tenancy(path: str, engine: SimEngine):
    """Rebuild the TenantRegistry from a checkpoint's tenancy section
    against a restored engine: quotas, QoS class, namespace bindings,
    admitted meters, and each tenant's `block_rows` entitlement (the
    block re-carves from the restored free list — same rows when the
    layout is unchanged; the ENTITLEMENT, not the position, is the
    contract). None when the checkpoint (or its tenancy section) does
    not exist; a malformed section raises CheckpointCorruptError."""
    try:
        _dirpath, manifest = _resolve_dir(os.path.abspath(path))
    except CheckpointMissingError:
        return None
    section = manifest.get("tenancy")
    if section is None:
        return None
    from kubedtn_tpu_torch.tenancy import TenantRegistry

    try:
        registry = TenantRegistry(
            engine, default_qos=section.get("default_qos", "gold"))
        for t in section.get("tenants", ()):
            won = registry.create(
                t["name"], qos=t.get("qos"),
                frame_budget_per_s=t.get("frame_budget_per_s"),
                byte_budget_per_s=t.get("byte_budget_per_s"),
                block_edges=int(t.get("block_rows", 0)),
                namespaces=t.get("namespaces"))
            won.admitted_frames = int(t.get("admitted_frames", 0))
            won.admitted_bytes = int(t.get("admitted_bytes", 0))
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise CheckpointCorruptError(
            f"malformed tenancy section in {path}: {e}") from e
    return registry


def load_wires(path: str, daemon) -> int:
    """Re-register the checkpointed wire definitions on a daemon.
    Idempotent per (pod, uid) — `get_or_create` keeps whatever a faster
    client already registered. Returns wires (re)registered; 0 when no
    checkpoint or no wires section exists."""
    try:
        _dirpath, manifest = _resolve_dir(os.path.abspath(path))
    except CheckpointMissingError:
        return 0
    from kubedtn_tpu_torch.wire.server import Wire

    n = 0
    for pod_key, uid, peer_ip, peer_intf_id, ifname in \
            manifest.get("wires", ()):
        def build(wire_id: int, _pk=pod_key, _uid=uid, _peer=peer_ip,
                  _pid=peer_intf_id, _if=ifname):
            return Wire(wire_id=wire_id, uid=int(_uid), pod_key=_pk,
                        node_iface_name=_if, peer_intf_id=int(_pid),
                        peer_ip=_peer)

        daemon.wires.get_or_create(pod_key, int(uid), build)
        n += 1
    return n


def load_plane_counters(path: str):
    """The checkpointed plane counter columns as host arrays (field name
    → np.ndarray[E]), checksum-verified — None when the checkpoint (or
    its counters file) doesn't exist."""
    gen = _generation(path)
    return None if gen is None else gen.plane_counters()


def restore_plane_counters(path: str, plane) -> bool:
    """Install the checkpointed counter columns on a (restored) plane,
    padded/truncated to the plane's current capacity — a restart keeps
    its cumulative delivery accounting. False when nothing to restore."""
    arrays = load_plane_counters(path)
    if arrays is None:
        return False
    cap = int(plane.engine.state.capacity)

    def fit(a: np.ndarray) -> np.ndarray:
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        n = min(cap, a.shape[0])
        out[:n] = a[:n]
        return out

    cnt = plane.counters
    plane.counters = type(cnt)(**{
        f.name: fit(arrays[f.name]) if f.name in arrays
        else getattr(cnt, f.name)
        for f in dataclasses.fields(type(cnt))})
    return True


def plane_meta(path: str) -> dict:
    """The checkpoint's `plane` manifest section ({} when absent):
    `last_shaped_s` is the saved plane's shaping epoch on its clock,
    `origin_s` (written by this package only) its wheel's origin."""
    try:
        _dirpath, manifest = _resolve_dir(os.path.abspath(path))
    except CheckpointMissingError:
        return {}
    return dict(manifest.get("plane") or {})


class Autosaver:
    """Periodic crash-consistent autosave for a live daemon: every
    `interval_s`, `save_live` captures the full checkpoint at one flush
    barrier and writes it with the usual atomic staged swap. A failing
    save (full disk) is logged and counted, never fatal; the previous
    complete generation stays restorable throughout. `stop()` joins the
    thread with a bounded timeout."""

    def __init__(self, path: str, store: TopologyStore,
                 engine: SimEngine, dataplane,
                 interval_s: float = 30.0) -> None:
        self.path = path
        self.store = store
        self.engine = engine
        self.dataplane = dataplane
        self.interval_s = float(interval_s)
        self.saves = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def save_now(self) -> None:
        """One immediate barrier-consistent save (also the loop body)."""
        save_live(self.path, self.store, self.engine, self.dataplane)
        self.saves += 1

    def start(self) -> None:
        if self._thread is not None:
            return
        log = get_logger("checkpoint")

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.save_now()
                except Exception:
                    self.errors += 1
                    log.exception("autosave failed (continuing) %s",
                                  fields(path=self.path,
                                         errors=self.errors))

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="kdt-autosave")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(5.0, self.interval_s))
        self._thread = None


def load_sim(path: str, engine: SimEngine, device=None):
    """Restore the optional SimState against a restored engine, on
    `device` (None = the card; the engine's edge state is moved there if
    it lies elsewhere). Checksum-verified; a save without `sim` leaves no
    stale sim_state.npz behind. None when the checkpoint carries no sim
    state or no checkpoint exists; corruption and unsupported formats
    raise."""
    dev = resolve_device(device)
    try:
        dirpath, manifest = _resolve_dir(os.path.abspath(path))
    except CheckpointMissingError:
        return None
    if not os.path.exists(os.path.join(dirpath, "sim_state.npz")):
        return None
    with _load_npz(dirpath, manifest, "sim_state.npz") as z:
        try:
            edges = engine.state
            if edges.device != dev:
                edges = es.EdgeState(**{
                    f.name: getattr(edges, f.name).to(dev)
                    for f in dataclasses.fields(es.EdgeState)})
            return unflatten_sim_arrays(z, edges=edges, device=dev)
        except Exception as e:
            raise CheckpointCorruptError(
                f"damaged sim_state.npz in {dirpath}: {e}") from e
