"""Durable fit journal, partition checkpoints, and atomic model commit.

The port's copy of ``mmlspark_tpu/runtime/journal.py``, with the same
environment variable and on-disk layout (``journal.jsonl``, ``meta.json``,
checksummed checkpoints, versioned model files with CRC32 sidecars), so a
durable root means the same thing to both packages: a journal or model
store written by one is restored by the other.

Spark answers "the job died midway" with lineage plus checkpointing:
``rdd.checkpoint()`` persists a computed partition so recovery replays
nothing before it, and committed output is made visible atomically
(rename into place) so readers never observe a torn write. This module
is that durability plane for the thread runtime:

- :class:`FitJournal` — one directory per (journal root, job key)
  holding an append-only JSON-lines ``journal.jsonl`` of task
  completions plus one checksummed checkpoint file per finished
  partition. ``Scheduler.run(..., journal=...)`` restores completed
  partitions at startup (zero re-execution) and records each new
  completion durably: checkpoint first (tmp + fsync + atomic rename),
  journal line second, so a crash between the two at worst re-runs one
  task, never resurrects a torn checkpoint;
- :class:`ModelStore` — atomic model commit: the fitted model text is
  written to a versioned file via tmp+rename with a CRC32 sidecar, then
  a ``CURRENT`` pointer is atomically swapped. :meth:`ModelStore.latest`
  is the recovery scan a warm-restarting server runs at startup — it
  trusts ``CURRENT`` when valid and otherwise falls back to the highest
  checksummed version on disk, so a crash mid-commit can never serve a
  half-written model. :meth:`ModelStore.commit_artifact` writes a JSON
  artifact (the quality plane's reference profile) next to a version with
  the same discipline, and :meth:`ModelStore.read_artifact` verifies it;
- :func:`default_checkpoint_dir` — the ambient ``MMLSPARK_TPU_CHECKPOINT_DIR``
  root that activates all of this without API threading.

Checkpoint format: 4-byte big-endian CRC32 of the pickled payload,
then the pickle bytes. Loads verify the CRC and unpickle; a mismatch
(torn write, bit rot) drops the entry — the scheduler just recomputes
that partition, which is always safe.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import re
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.runtime.faults import check_write

logger = logging.getLogger("mmlspark_tpu_torch.runtime")

#: env var naming the durable root; unset disables checkpointing
CHECKPOINT_DIR_ENV = "MMLSPARK_TPU_CHECKPOINT_DIR"

_JOURNAL_NAME = "journal.jsonl"
_META_NAME = "meta.json"


def default_checkpoint_dir() -> Optional[str]:
    """The ambient durable root (``MMLSPARK_TPU_CHECKPOINT_DIR``), or None."""
    path = os.environ.get(CHECKPOINT_DIR_ENV, "").strip()
    return path or None


def result_crc(result: Any) -> int:
    """CRC32 of the pickled result — the end-to-end integrity token used
    by checkpoints AND the executor->scheduler corrupt-result check."""
    return zlib.crc32(pickle.dumps(result, protocol=4)) & 0xFFFFFFFF


def _safe_key(key: str) -> str:
    """A filesystem-safe directory name for a job key: readable prefix
    plus a hash so distinct keys never collide after sanitising."""
    slug = re.sub(r"[^A-Za-z0-9._-]+", "_", key)[:48].strip("_") or "job"
    digest = hashlib.sha256(key.encode("utf-8")).hexdigest()[:12]
    return f"{slug}-{digest}"


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename: the file at ``path`` is either the old
    content or the complete new content, never a prefix. The guarded-write
    gate (``FaultPlan.disk_full``) fires before the temp file opens, so an
    injected ENOSPC leaves no trace on disk."""
    check_write(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class FitJournal:
    """Append-only journal + checksummed checkpoints for one partitioned job.

    ``key`` identifies the job (estimator params + data fingerprint): a
    re-run with the same key under the same root resumes; a different
    key lands in a different subdirectory and starts clean. When the
    on-disk task count disagrees with ``num_tasks`` the journal resets —
    stale state from a differently-partitioned run must not leak in.
    """

    def __init__(self, root: str, key: str, num_tasks: Optional[int] = None):
        self.key = key
        self.dir = os.path.join(root, _safe_key(key))
        os.makedirs(self.dir, exist_ok=True)
        self.num_tasks = num_tasks
        self._lock = threading.Lock()
        self._recorded: Dict[int, str] = {}
        #: journal lines appended by THIS process (re-executions measure)
        self.appended = 0
        self._load_meta()
        self._fh = open(os.path.join(self.dir, _JOURNAL_NAME), "a", encoding="utf-8")

    def _load_meta(self) -> None:
        meta_path = os.path.join(self.dir, _META_NAME)
        meta = None
        try:
            with open(meta_path, "r", encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            meta = None
        stale = meta is not None and (
            meta.get("key") != self.key
            or (
                self.num_tasks is not None
                and meta.get("num_tasks") not in (None, self.num_tasks)
            )
        )
        if meta is None or stale:
            if stale:
                logger.warning(
                    "journal %s is stale (key/task-count mismatch); resetting",
                    self.dir,
                )
                for name in os.listdir(self.dir):
                    if name.endswith((".ckpt", ".tmp")) or name == _JOURNAL_NAME:
                        try:
                            os.remove(os.path.join(self.dir, name))
                        except OSError:
                            pass
            _atomic_write(
                meta_path,
                json.dumps({"key": self.key, "num_tasks": self.num_tasks}).encode(),
            )

    # -- recovery ------------------------------------------------------------

    def restore(self) -> Dict[int, Any]:
        """Completed task results from the journal, CRC-verified. Corrupt
        or missing checkpoints are skipped (their tasks just recompute);
        a malformed trailing journal line (crash mid-append) is ignored."""
        out: Dict[int, Any] = {}
        path = os.path.join(self.dir, _JOURNAL_NAME)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = fh.readlines()
        except OSError:
            return out
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                index, ckpt = int(rec["task"]), str(rec["ckpt"])
            except (ValueError, KeyError, TypeError):
                continue  # torn tail line
            result = self._load_checkpoint(os.path.join(self.dir, ckpt))
            if result is not _MISSING:
                out[index] = result
                with self._lock:
                    self._recorded[index] = ckpt
        return out

    @staticmethod
    def _load_checkpoint(path: str):
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return _MISSING
        if len(blob) < 4:
            return _MISSING
        (want,) = struct.unpack(">I", blob[:4])
        payload = blob[4:]
        if zlib.crc32(payload) & 0xFFFFFFFF != want:
            logger.warning("checkpoint %s failed CRC verification; dropping", path)
            return _MISSING
        try:
            return pickle.loads(payload)
        except Exception:  # noqa: BLE001 - a bad pickle is a bad checkpoint
            logger.warning("checkpoint %s failed to unpickle; dropping", path)
            return _MISSING

    # -- recording -----------------------------------------------------------

    def record(self, index: int, result: Any) -> bool:
        """Durably record task ``index`` as complete: checkpoint (atomic,
        checksummed) then journal line. Returns False when the task was
        already recorded (recovered or raced by a speculative sibling) —
        nothing is written, which is what "zero re-executions" means.
        An injected/real ENOSPC fires before the index is reserved, so a
        failed record leaves the journal state clean and the ``OSError``
        propagates to the caller (the epoch/task owner decides)."""
        index = int(index)
        check_write(os.path.join(self.dir, f"task-{index:05d}.ckpt"))
        with self._lock:
            if index in self._recorded:
                return False
            # reserve under the lock so concurrent completions of the same
            # task write one checkpoint; the file I/O happens outside
            self._recorded[index] = f"task-{index:05d}.ckpt"
            ckpt = self._recorded[index]
        payload = pickle.dumps(result, protocol=4)
        blob = struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF) + payload
        _atomic_write(os.path.join(self.dir, ckpt), blob)
        line = json.dumps({"task": index, "ckpt": ckpt, "bytes": len(payload)})
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appended += 1
        return True

    def completed(self) -> List[int]:
        with self._lock:
            return sorted(self._recorded)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None  # type: ignore[assignment]

    def __enter__(self) -> "FitJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Missing:
    __slots__ = ()


_MISSING = _Missing()

#: One commit lock per store directory in this process: two ModelStore
#: objects on one root (the fits of a tuner's thread pool) must never pick
#: the same version and its temp file.
_ROOT_LOCKS: Dict[str, threading.Lock] = {}
_ROOT_LOCKS_GUARD = threading.Lock()


def _root_lock(root: str) -> threading.Lock:
    with _ROOT_LOCKS_GUARD:
        return _ROOT_LOCKS.setdefault(os.path.realpath(root), threading.Lock())


class ModelStore:
    """Atomic, versioned model commits under a durable directory.

    ``commit`` writes ``<name>-<version>.txt`` (tmp + fsync + rename)
    with a CRC32 sidecar, then atomically swaps ``<name>.CURRENT`` to
    point at it. ``latest`` is the startup recovery scan: trust CURRENT
    when its target verifies, otherwise fall back to the newest version
    whose checksum holds — a crash at ANY point mid-commit leaves the
    previous committed model fully readable.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = _root_lock(root)

    def _current_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.CURRENT")

    def commit(self, text: str, name: str = "model") -> int:
        """Commit ``text`` as the next version of ``name``; returns the
        committed version number."""
        data = text.encode("utf-8")
        crc = zlib.crc32(data) & 0xFFFFFFFF
        with self._lock:
            versions = self._scan_versions(name)
            version = versions[-1][0] + 1 if versions else 1
            fname = f"{name}-{version:06d}.txt"
            _atomic_write(os.path.join(self.root, fname), data)
            _atomic_write(
                os.path.join(self.root, fname + ".crc32"),
                f"{crc:08x}".encode(),
            )
            _atomic_write(
                self._current_path(name),
                json.dumps({"file": fname, "crc32": f"{crc:08x}"}).encode(),
            )
        return version

    def _scan_versions(self, name: str) -> List[Tuple[int, str]]:
        pat = re.compile(re.escape(name) + r"-(\d{6})\.txt$")
        found = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for fname in names:
            m = pat.match(fname)
            if m:
                found.append((int(m.group(1)), fname))
        return sorted(found)

    def _read_verified(self, fname: str, want_crc: Optional[str] = None) -> Optional[str]:
        path = os.path.join(self.root, fname)
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return None
        crc = f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"
        if want_crc is None:
            try:
                with open(path + ".crc32", "r", encoding="utf-8") as fh:
                    want_crc = fh.read().strip()
            except OSError:
                return None
        if crc != want_crc:
            logger.warning("model file %s failed CRC verification", fname)
            return None
        return data.decode("utf-8")

    def current_version(self, name: str = "model") -> Optional[int]:
        """The version the ``CURRENT`` pointer names, or None — one small
        read, no model-text load or CRC verification, so a hot-swap
        watcher can poll it cheaply between requests (verification
        happens in :meth:`latest` when the watcher decides to load)."""
        try:
            with open(self._current_path(name), "r", encoding="utf-8") as fh:
                cur = json.load(fh)
            m = re.search(r"-(\d{6})\.txt$", str(cur["file"]))
            return int(m.group(1)) if m else None
        except (OSError, ValueError, KeyError):
            return None

    def _artifact_name(self, name: str, version: int, kind: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9_-]+", kind):
            raise ValueError(f"artifact kind must be a bare slug, got {kind!r}")
        return f"{name}-{version:06d}.{kind}.json"

    def commit_artifact(
        self, name: str, version: int, kind: str, payload: Dict[str, Any]
    ) -> str:
        """Commit a JSON artifact riding next to ``<name>-<version>`` —
        e.g. the quality plane's reference profile (``kind="quality"``).
        Written with the same tmp+fsync+rename discipline and CRC32
        sidecar as the model text itself; returns the artifact filename.
        Artifacts never touch the ``CURRENT`` pointer: a model version is
        live regardless of which sidecars it carries."""
        data = json.dumps(payload, sort_keys=True).encode("utf-8")
        crc = zlib.crc32(data) & 0xFFFFFFFF
        fname = self._artifact_name(name, version, kind)
        with self._lock:
            _atomic_write(os.path.join(self.root, fname), data)
            _atomic_write(
                os.path.join(self.root, fname + ".crc32"),
                f"{crc:08x}".encode(),
            )
        return fname

    def read_artifact(
        self, name: str, version: int, kind: str
    ) -> Optional[Dict[str, Any]]:
        """The verified JSON artifact for ``<name>-<version>``, or None
        when it is absent or fails its sidecar checksum (a torn artifact
        reads as missing, never as garbage)."""
        fname = self._artifact_name(name, version, kind)
        text = self._read_verified(fname)
        if text is None:
            return None
        try:
            payload = json.loads(text)
        except ValueError:
            logger.warning("artifact %s is not valid JSON", fname)
            return None
        return payload if isinstance(payload, dict) else None

    def latest(self, name: str = "model") -> Optional[Tuple[int, str]]:
        """(version, text) of the last committed model, or None. CURRENT
        is trusted when its target verifies; otherwise scan versions
        newest-first for one whose sidecar checksum holds."""
        try:
            with open(self._current_path(name), "r", encoding="utf-8") as fh:
                cur = json.load(fh)
            fname = str(cur["file"])
            text = self._read_verified(fname, str(cur.get("crc32")) or None)
            if text is not None:
                m = re.search(r"-(\d{6})\.txt$", fname)
                return (int(m.group(1)) if m else 0), text
        except (OSError, ValueError, KeyError):
            pass
        for version, fname in reversed(self._scan_versions(name)):
            text = self._read_verified(fname)
            if text is not None:
                return version, text
        return None
