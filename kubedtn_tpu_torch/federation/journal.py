"""Migration journal — crash-safe persistence for one live migration.

Every step of the migration state machine (federation.migrate) writes a
**migration record** here before the step counts as committed: a JSON
manifest (state machine position, captured identities, accounting
snapshots) plus an optional npz of captured device-row arrays, staged
in a temp directory with a per-file sha256 in the manifest and swapped
into place with atomic renames — the exact double-crash discipline of
`checkpoint.save` (old → `.prev`, tmp → path, `.prev` pruned only after
the new generation lands). A daemon killed at ANY instant leaves either
the new complete record, the previous complete one, or nothing — never
a torn mix — so a restarted coordinator resumes from the last COMMITTED
step, and the resume rules in federation.migrate make that safe.

Layout of one record directory (`<root>/<migration_id>/`):
  manifest.json — the record dict + per-file sha256 checksums
  fork.npz      — captured tenant row arrays (present once FORK commits)

Port of kubedtn_tpu/federation/journal.py, the same format: a record
either package writes, the other loads. The manifest is encoded in one
`json.dumps` call, byte for byte the text of the JAX package's
`json.dump`.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np

# one discipline, one implementation: the checkpoint module's staging /
# checksum / pid-sweep helpers are the audited originals
from kubedtn_tpu_torch.checkpoint import (_fsync_path, _pid_alive,
                                          _sha256_file)

_PREV_SUFFIX = ".prev"
_TMP_PREFIX = ".mig-tmp-"


class JournalError(Exception):
    """A migration record could not be read or written."""


class JournalMissingError(JournalError):
    """No record exists for the migration id (nothing to resume)."""


class JournalCorruptError(JournalError):
    """A record exists but neither generation passes validation."""


def record_dir(root: str, migration_id: str) -> str:
    return os.path.join(os.path.abspath(root), migration_id)


def list_records(root: str) -> list[str]:
    """Migration ids with a (possibly only-`.prev`) record under root."""
    root = os.path.abspath(root)
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    out = set()
    for e in entries:
        if e.startswith(_TMP_PREFIX):
            continue
        name = e[:-len(_PREV_SUFFIX)] if e.endswith(_PREV_SUFFIX) else e
        if os.path.isdir(os.path.join(root, e)):
            out.add(name)
    return sorted(out)


def _read_manifest(dirpath: str) -> dict:
    mpath = os.path.join(dirpath, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise JournalMissingError(f"no migration manifest at {mpath}") \
            from e
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise JournalCorruptError(
            f"unreadable migration manifest {mpath}: {e}") from e
    if not isinstance(manifest, dict) or "record" not in manifest:
        raise JournalCorruptError(
            f"migration manifest {mpath} lacks a record section")
    return manifest


def _resolve(dirpath: str) -> tuple[str, dict]:
    """The directory holding the newest COMMITTED record generation:
    the path itself when valid, else the `.prev` a crash between save's
    two renames left behind (same resolution rule as checkpoint)."""
    try:
        return dirpath, _read_manifest(dirpath)
    except JournalError as primary:
        prev = dirpath + _PREV_SUFFIX
        try:
            return prev, _read_manifest(prev)
        except JournalError:
            raise primary from None


def save_record(root: str, migration_id: str, record: dict,
                arrays: dict | None = None) -> None:
    """Commit one record generation atomically. `record` must be
    JSON-serializable; `arrays` (optional) lands in fork.npz. When
    `arrays` is None and the current committed generation carries a
    fork.npz, that file is CARRIED FORWARD into the new generation —
    a later step's journal write never drops the fork capture."""
    dirpath = record_dir(root, migration_id)
    parent = os.path.dirname(dirpath)
    os.makedirs(parent, exist_ok=True)
    # sweep staging leaked by crashed saves (exact <prefix><id>-<pid>,
    # live pids spared — the checkpoint.save sweep discipline)
    pat = re.compile(
        re.escape(f"{_TMP_PREFIX}{migration_id}-") + r"(\d+)$")
    for entry in os.listdir(parent):
        m = pat.fullmatch(entry)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid != os.getpid() and _pid_alive(pid):
            continue
        shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)
    tmp = os.path.join(parent,
                       f"{_TMP_PREFIX}{migration_id}-{os.getpid()}")
    os.makedirs(tmp)
    try:
        if arrays is not None:
            np.savez_compressed(os.path.join(tmp, "fork.npz"), **arrays)
        else:
            try:
                cur, cur_manifest = _resolve(dirpath)
            except JournalError:
                cur, cur_manifest = None, None
            if cur is not None and os.path.exists(
                    os.path.join(cur, "fork.npz")):
                _verify(cur, cur_manifest, "fork.npz")
                shutil.copy2(os.path.join(cur, "fork.npz"),
                             os.path.join(tmp, "fork.npz"))
        checksums = {
            fname: _sha256_file(os.path.join(tmp, fname))
            for fname in sorted(os.listdir(tmp))
        }
        manifest = {"record": record, "checksums": checksums}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            # the same text json.dump writes, from the C encoder: a
            # 66,400-row slice's record is tens of MB, which json.dump's
            # chunked Python encoder writes ~5x slower
            f.write(json.dumps(manifest))
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
        for fname in checksums:
            _fsync_path(os.path.join(tmp, fname))
        _fsync_path(tmp)
        prev = dirpath + _PREV_SUFFIX
        if os.path.isdir(dirpath):
            shutil.rmtree(prev, ignore_errors=True)
            os.rename(dirpath, prev)
        os.rename(tmp, dirpath)
        _fsync_path(parent)
        shutil.rmtree(prev, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _verify(dirpath: str, manifest: dict, fname: str) -> None:
    want = manifest.get("checksums", {}).get(fname)
    if want is None:
        raise JournalCorruptError(
            f"{fname} in {dirpath} has no recorded checksum")
    try:
        got = _sha256_file(os.path.join(dirpath, fname))
    except OSError as e:
        raise JournalCorruptError(
            f"unreadable migration file {dirpath}/{fname}: {e}") from e
    if got != want:
        raise JournalCorruptError(
            f"checksum mismatch for {dirpath}/{fname}: "
            f"manifest {want[:12]}…, file {got[:12]}…")


def load_record(root: str, migration_id: str
                ) -> tuple[dict, dict | None]:
    """(record, fork arrays or None) from the newest committed
    generation, checksum-verified. Raises JournalMissingError when no
    generation exists, JournalCorruptError on damage."""
    dirpath, manifest = _resolve(record_dir(root, migration_id))
    record = manifest["record"]
    arrays = None
    fpath = os.path.join(dirpath, "fork.npz")
    if os.path.exists(fpath):
        _verify(dirpath, manifest, "fork.npz")
        try:
            with np.load(fpath) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:
            raise JournalCorruptError(
                f"damaged fork.npz in {dirpath}: {e}") from e
    return record, arrays


def load_record_meta(root: str, migration_id: str) -> dict:
    """The record dict alone — no fork.npz read, no array checksum.
    The status/poll path: a MigrationStatus scrape over N historical
    records must not re-read and re-hash N fork captures it is going
    to discard."""
    _dirpath, manifest = _resolve(record_dir(root, migration_id))
    return manifest["record"]


def drop_record(root: str, migration_id: str) -> None:
    """Remove a finished migration's record (both generations)."""
    dirpath = record_dir(root, migration_id)
    shutil.rmtree(dirpath, ignore_errors=True)
    shutil.rmtree(dirpath + _PREV_SUFFIX, ignore_errors=True)


__all__ = ["JournalError", "JournalMissingError", "JournalCorruptError",
           "record_dir", "list_records", "save_record", "load_record",
           "load_record_meta", "drop_record"]
