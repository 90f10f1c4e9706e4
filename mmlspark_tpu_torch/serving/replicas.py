"""Replica supervision: serving endpoints as real, restartable processes.

``DistributedServingServer`` multiplies LISTENERS inside one process; the
reference deployment multiplies PROCESSES — each Spark worker hosts its
own serving endpoint, and the platform restarts a worker whose JVM dies.
:class:`ReplicaSupervisor` is that layer, built on the same primitives as
the training-side process gang (:mod:`mmlspark_tpu_torch.runtime.procgroup`):
scrubbed spawn environment, seeded port picking, heartbeat files,
structured :class:`~mmlspark_tpu_torch.runtime.procgroup.ExitStatus` records,
``ProcessStarted``/``ProcessLost`` events, and
:class:`~mmlspark_tpu_torch.runtime.health.HealthTracker` quarantine so a
crash-looping replica stops being restarted.

Unlike a fit gang, serving never "completes" and replicas never need a
collective: there is no rendezvous, no epochs, and loss of one replica
does not interrupt the others — ``poll()`` simply books the death and
respawns on a fresh port. A supervised replica process loads its model
itself (the ``factory`` entry point, typically wrapping
:func:`~mmlspark_tpu_torch.serving.server.recover_model` against the shared
checkpoint root), so a replica that died mid-serve comes back serving the
last atomically committed model version.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.runtime.procgroup import (
    ExitStatus,
    _Heartbeat,
    _resolve_entry,
    _write_json,
    pick_port,
    scrub_env,
)

logger = get_logger("mmlspark_tpu_torch.serving.replicas")


def demo_model_factory(spec: Dict[str, Any]):
    """A self-contained payload model for smoke tests and the chaos tool:
    ``prediction = 2 * input`` as a raw table->table callable."""
    import numpy as np

    from mmlspark_tpu_torch.data.table import Table

    in_col = spec.get("server_options", {}).get("input_col", "input")
    out_col = spec.get("server_options", {}).get("output_col", "prediction")

    def model(table: Table) -> Table:
        x = np.asarray(table.column(in_col), dtype=np.float64)
        return Table({out_col: 2.0 * x})

    return model


def _registry_post(base: str, path: str, payload: Dict[str, Any]) -> None:
    """One POST to the registration service (raises on HTTP error)."""
    url = base.rstrip("/") + path
    # net chaos on the replica->registry edge: a partition raises
    # EHOSTUNREACH, a drop times out — the reporter's backoff path
    from mmlspark_tpu_torch.runtime.faults import check_net

    check_net(url)
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    urllib.request.urlopen(req, timeout=5).read()


#: backoff ceiling, as a multiple of the heartbeat interval — a long
#: registry outage settles into a slow, jittered probe, not a tight loop
_BACKOFF_CAP_INTERVALS = 10.0


def _registry_reporter(server, registry_url: str, interval_s: float,
                       stop_evt: threading.Event) -> None:
    """Replica-side lease loop: register once, then heartbeat the live
    load metadata (``heartbeat_stats``) every ``interval_s``. A 404 means
    the lease expired (registry restart without a lease journal / TTL
    lapse while this process was stalled) — re-register from scratch. A
    down registry never stops the replica serving; the loop retries with
    seeded, jittered exponential backoff so a restarted registry gets the
    fleet's re-registrations spread out, not as one burst, and publishes
    :class:`~mmlspark_tpu_torch.observability.events.RegistryUnavailable` once
    per outage onset. Heartbeat periods themselves carry seeded ±20%
    jitter (``MMLSPARK_TPU_FAULT_SEED`` + the replica name), so the fleet
    never phase-locks."""
    from mmlspark_tpu_torch.observability.events import (
        RegistryRecovered,
        RegistryUnavailable,
        get_bus,
    )

    seed = int(os.environ.get("MMLSPARK_TPU_FAULT_SEED", "0") or 0)
    rng = random.Random(
        seed * 1_000_003 + zlib.crc32(server.info.name.encode())
    )
    registered = False
    down = False
    backoff = interval_s
    while not stop_evt.is_set():
        stats = server.heartbeat_stats()
        wait = interval_s * (1.0 + 0.2 * (2.0 * rng.random() - 1.0))
        try:
            if not registered:
                _registry_post(registry_url, "/register", stats)
                registered = True
            else:
                _registry_post(registry_url, "/heartbeat", stats)
            if down:
                down = False
                bus = get_bus()
                if bus.active:
                    bus.publish(RegistryRecovered(source="replica"))
                logger.info("replica %s regained the registry",
                            server.info.name)
            backoff = interval_s
        except urllib.error.HTTPError as e:
            if e.code == 404:
                # expired lease: re-register next tick, after a jittered
                # backoff (the whole fleet may have expired at once)
                registered = False
                wait = backoff * (0.5 + rng.random())
                backoff = min(backoff * 2.0,
                              _BACKOFF_CAP_INTERVALS * interval_s)
        except Exception as e:  # noqa: BLE001 - registry down; keep serving
            if not down:
                down = True
                bus = get_bus()
                if bus.active:
                    bus.publish(RegistryUnavailable(
                        source="replica", error=f"{type(e).__name__}: {e}",
                    ))
                logger.warning("replica %s lost the registry: %s",
                               server.info.name, e)
            wait = backoff * (0.5 + rng.random())
            backoff = min(backoff * 2.0, _BACKOFF_CAP_INTERVALS * interval_s)
        stop_evt.wait(wait)


def _replica_main(workdir: str, index: int) -> int:
    """One replica process: load the model via the factory entry, serve on
    the assigned port, heartbeat until the supervisor's stop file (global
    ``stop`` or the per-replica ``stop-<index>`` the retire path writes)."""
    from mmlspark_tpu_torch.serving.server import ServingServer

    wd = Path(workdir)
    spec = json.loads((wd / f"replica-{index}.json").read_text())
    hb = _Heartbeat(wd / f"hb-{index}", interval=spec.get("hb_interval_s", 0.5))
    hb.start()
    reg_stop = threading.Event()
    registry_url = spec.get("registry_url")
    try:
        model = _resolve_entry(spec["factory"])(spec)
        server = ServingServer(
            model,
            host=spec.get("host", "127.0.0.1"),
            port=int(spec["port"]),
            name=f"{spec.get('name', 'replica')}-{index}",
            **spec.get("server_options", {}),
        )
        with server:
            swap = spec.get("hot_swap")
            if swap:
                # the replica watches ModelStore CURRENT itself, so a
                # mid-campaign commit swaps every replica with no restart
                server.enable_hot_swap(
                    _resolve_entry(swap["loader"]),
                    root=swap.get("root"),
                    name=swap.get("name", "model"),
                    poll_s=float(swap.get("poll_s", 0.25)),
                )
            if registry_url:
                threading.Thread(
                    target=_registry_reporter,
                    args=(server, registry_url,
                          float(spec.get("registry_heartbeat_s", 0.5)),
                          reg_stop),
                    daemon=True, name=f"replica-registry-{index}",
                ).start()
            _write_json(wd / f"ready-{index}.json",
                        {"url": server.info.url, "pid": os.getpid(),
                         "port": server.info.port})
            while not (wd / "stop").exists() \
                    and not (wd / f"stop-{index}").exists():
                time.sleep(0.1)
            if registry_url:
                # graceful exit: release the lease now instead of letting
                # it ride out the TTL (the retire path also deregisters
                # supervisor-side; a second deregister is a harmless 404)
                reg_stop.set()
                try:
                    _registry_post(
                        registry_url, "/deregister",
                        {"name": server.info.name},
                    )
                except Exception:  # noqa: BLE001 - registry already gone
                    pass
        return 0
    except Exception as e:  # noqa: BLE001 - report, then die visibly
        import traceback

        _write_json(wd / f"failed-{index}.json",
                    {"error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()})
        return 1
    finally:
        reg_stop.set()
        hb.stop()


class ReplicaSupervisor:
    """Spawn and babysit N serving-replica processes.

    ``factory`` is a ``"module:function"`` entry resolved INSIDE each
    replica process; it receives the replica spec dict (with the entries
    of ``spec_extra``, such as a payload's ``{"sar": {...}}`` options) and
    returns the model (a ``Transformer`` or table->table callable) to
    serve. Call
    :meth:`poll` periodically (or :meth:`watch` for a bounded loop):
    dead or heartbeat-silent replicas are booked as
    :class:`ExitStatus` + ``ProcessLost`` and respawned on a fresh port
    unless the health tracker has quarantined them.
    """

    def __init__(
        self,
        factory: str,
        num_replicas: int = 2,
        workdir: Optional[str] = None,
        host: str = "127.0.0.1",
        name: str = "replica",
        server_options: Optional[Dict[str, Any]] = None,
        env: Optional[Dict[str, str]] = None,
        seed: int = 0,
        heartbeat_timeout_s: float = 10.0,
        ready_timeout_s: float = 30.0,
        health=None,
        registry_url: Optional[str] = None,
        registry_heartbeat_s: float = 0.5,
        hot_swap: Optional[Dict[str, Any]] = None,
        spec_extra: Optional[Dict[str, Any]] = None,
    ):
        from mmlspark_tpu_torch.observability.registry import get_registry
        from mmlspark_tpu_torch.runtime.health import HealthTracker

        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self.factory = factory
        self.num_replicas = int(num_replicas)
        if workdir is None:
            import tempfile

            workdir = tempfile.mkdtemp(prefix="mmlspark-tpu-replicas-")
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.host = host
        self.name = name
        self.server_options = dict(server_options or {})
        self.env = scrub_env(env)
        self.seed = int(seed)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.ready_timeout_s = float(ready_timeout_s)
        # serving default: 2 quick deaths quarantine the slot (the replica
        # is crash-looping; restarting it a third time serves nobody)
        self.health = health or HealthTracker(
            threshold=2.0, window_s=600.0, parole_s=600.0
        )
        #: replicas POST /register + /heartbeat (with load metadata) here;
        #: retire_replica POSTs /deregister — the fleet control plane
        self.registry_url = registry_url
        self.registry_heartbeat_s = float(registry_heartbeat_s)
        #: optional ModelStore hot-swap spec passed through to every
        #: replica: {"loader": "module:fn", "root": ..., "name": ...}
        self.hot_swap = dict(hot_swap) if hot_swap else None
        self.spec_extra = dict(spec_extra or {})
        self.exit_statuses: List[ExitStatus] = []
        self._procs: Dict[int, subprocess.Popen] = {}
        self._generations: Dict[int, int] = {}
        self._ports: Dict[int, int] = {}
        #: indices retired by the autoscaler: never respawned, never reused
        self._retired: set = set()
        self._next_index = int(num_replicas)
        reg = get_registry()
        self._metrics = {
            "started": reg.counter(
                "serving_replicas_started_total", "Replica processes spawned"
            ),
            "lost": reg.counter(
                "serving_replicas_lost_total", "Replica processes lost"
            ),
            "up": reg.gauge("serving_replicas_up", "Live serving replicas"),
        }

    # -- spawn ---------------------------------------------------------------

    def _spawn(self, index: int) -> None:
        from mmlspark_tpu_torch.observability import ProcessStarted
        from mmlspark_tpu_torch.observability.events import get_bus

        gen = self._generations.get(index, -1) + 1
        self._generations[index] = gen
        port = pick_port(
            seed=self.seed * 1000 + index * 100 + gen,
            exclude=set(self._ports.values()),
        )
        self._ports[index] = port
        # the predecessor's heartbeat file goes too: a respawn that takes
        # longer than heartbeat_timeout_s to start (a CUDA context) would
        # otherwise be judged by the dead process's last beat
        for stale in (f"ready-{index}.json", f"failed-{index}.json",
                      f"stop-{index}", f"hb-{index}"):
            try:
                (self.workdir / stale).unlink()
            except OSError:
                pass
        spec: Dict[str, Any] = {
            **self.spec_extra,
            "factory": self.factory, "host": self.host, "port": port,
            "name": self.name, "server_options": self.server_options,
        }
        if self.registry_url:
            spec["registry_url"] = self.registry_url
            spec["registry_heartbeat_s"] = self.registry_heartbeat_s
        if self.hot_swap:
            spec["hot_swap"] = self.hot_swap
        _write_json(self.workdir / f"replica-{index}.json", spec)
        log_fh = open(self.workdir / f"log-{index}-{gen}.txt", "wb")
        # per-process event-log federation: the child inherits the shared
        # MMLSPARK_TPU_EVENT_LOG base but writes its own
        # ``<base>@replica-<index>`` segment, so two replicas never clobber
        # one live file / rotation sequence (observability.events.collect
        # folds the segments back together)
        env = dict(self.env)
        env["MMLSPARK_TPU_EVENT_LOG_PROCESS"] = f"replica-{index}"
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "mmlspark_tpu_torch.serving.replicas",
                 "--replica", str(self.workdir), str(index)],
                env=env, stdout=log_fh, stderr=subprocess.STDOUT,
                cwd=str(self.workdir),
            )
        finally:
            log_fh.close()
        self._procs[index] = proc
        self._metrics["started"].inc()
        bus = get_bus()
        if bus.active:
            bus.publish(ProcessStarted(member=index, pid=proc.pid, epoch=gen))
        logger.info("replica %d spawned pid %d port %d (gen %d)",
                    index, proc.pid, port, gen)

    def start(self) -> "ReplicaSupervisor":
        for index in range(self.num_replicas):
            self._spawn(index)
        self.wait_ready()
        return self

    def wait_ready(self, timeout_s: Optional[float] = None) -> None:
        deadline = time.monotonic() + (timeout_s or self.ready_timeout_s)
        while time.monotonic() < deadline:
            if all(
                (self.workdir / f"ready-{i}.json").exists()
                or i not in self._procs
                for i in range(self.num_replicas)
            ):
                self._metrics["up"].set(len(self._procs))
                return
            for i, proc in list(self._procs.items()):
                if proc.poll() is not None:
                    failed = self.workdir / f"failed-{i}.json"
                    detail = failed.read_text() if failed.exists() else ""
                    raise RuntimeError(
                        f"replica {i} died during startup "
                        f"(rc={proc.returncode}): {detail[:500]}"
                    )
            time.sleep(0.05)
        raise TimeoutError(
            f"replicas not ready within {timeout_s or self.ready_timeout_s}s"
        )

    # -- liveness ------------------------------------------------------------

    def urls(self) -> Dict[int, str]:
        out = {}
        for i in list(self._procs):
            path = self.workdir / f"ready-{i}.json"
            if path.exists():
                out[i] = json.loads(path.read_text())["url"]
        return out

    def _hb_stale(self, index: int) -> bool:
        path = self.workdir / f"hb-{index}"
        try:
            age = time.time() - path.stat().st_mtime
        except OSError:
            return False  # not yet written; startup is wait_ready's job
        return age > self.heartbeat_timeout_s

    def poll(self) -> List[ExitStatus]:
        """One supervision pass: book losses, respawn eligible replicas.
        Returns the losses observed in THIS pass."""
        from mmlspark_tpu_torch.observability import ProcessLost
        from mmlspark_tpu_torch.observability.events import get_bus

        losses: List[ExitStatus] = []
        for index, proc in list(self._procs.items()):
            if index in self._retired:
                continue  # retire_replica owns this slot's teardown
            rc = proc.poll()
            if rc is None and not self._hb_stale(index):
                continue
            if rc is None:
                proc.kill()
                proc.wait(timeout=5.0)
                reason = "heartbeat"
                rc = proc.returncode
            else:
                reason = f"signal:{-rc}" if rc < 0 else f"exit:{rc}"
            loss = ExitStatus(index, proc.pid, rc, reason,
                              self._generations[index])
            losses.append(loss)
            self.exit_statuses.append(loss)
            self._metrics["lost"].inc()
            bus = get_bus()
            if bus.active:
                bus.publish(ProcessLost(
                    member=index, pid=proc.pid, reason=reason,
                    epoch=self._generations[index],
                ))
            self.health.note_failure(index, reason=reason)
            del self._procs[index]
            if self.health.is_quarantined(index):
                logger.warning("replica %d quarantined; not restarting", index)
            else:
                self._spawn(index)
        self._metrics["up"].set(len(self._procs))
        return losses

    def watch(self, duration_s: float, interval_s: float = 0.5) -> None:
        """Poll for ``duration_s`` — the smoke-test supervision loop."""
        deadline = time.monotonic() + duration_s
        while time.monotonic() < deadline:
            self.poll()
            time.sleep(interval_s)

    # -- fleet scaling (driven by FleetController) ---------------------------

    @property
    def live_count(self) -> int:
        return len(self._procs)

    def add_replica(self, ready_timeout_s: Optional[float] = None) -> int:
        """Scale up by one: spawn a replica on a fresh index and block
        until its ready file appears (or it dies trying). Returns the new
        index. Retired indices are never reused, so the registry name
        ``<name>-<index>`` stays unambiguous across the fleet's life."""
        index = self._next_index
        self._next_index += 1
        self._spawn(index)
        deadline = time.monotonic() + (ready_timeout_s or self.ready_timeout_s)
        ready = self.workdir / f"ready-{index}.json"
        while time.monotonic() < deadline:
            if ready.exists():
                self._metrics["up"].set(len(self._procs))
                return index
            proc = self._procs.get(index)
            if proc is not None and proc.poll() is not None:
                failed = self.workdir / f"failed-{index}.json"
                detail = failed.read_text() if failed.exists() else ""
                raise RuntimeError(
                    f"replica {index} died during scale-up "
                    f"(rc={proc.returncode}): {detail[:500]}"
                )
            time.sleep(0.05)
        raise TimeoutError(f"replica {index} not ready during scale-up")

    def retire_replica(self, index: int, grace_s: float = 5.0) -> ExitStatus:
        """Scale down by one: deregister ``<name>-<index>`` from the
        registration service FIRST (no router sends it another request),
        then signal the per-replica stop file and wait for a graceful
        exit. The index is marked retired so :meth:`poll` never respawns
        it — an intentional retire is not a loss."""
        if index not in self._procs:
            raise KeyError(f"replica {index} is not running")
        self._retired.add(index)
        if self.registry_url:
            try:
                _registry_post(
                    self.registry_url, "/deregister",
                    {"name": f"{self.name}-{index}"},
                )
            except Exception:  # noqa: BLE001 - registry down; retire anyway
                logger.warning("deregister of replica %d failed", index,
                               exc_info=True)
        _write_json(self.workdir / f"stop-{index}", {"at": time.time()})
        proc = self._procs.pop(index)
        deadline = time.monotonic() + grace_s
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        rc = proc.returncode
        status = ExitStatus(index, proc.pid, rc, "retired",
                            self._generations[index])
        self.exit_statuses.append(status)
        self._metrics["up"].set(len(self._procs))
        logger.info("replica %d retired (rc=%s)", index, rc)
        return status

    # -- teardown ------------------------------------------------------------

    def stop(self, grace_s: float = 5.0) -> List[ExitStatus]:
        _write_json(self.workdir / "stop", {"at": time.time()})
        deadline = time.monotonic() + grace_s
        final: List[ExitStatus] = []
        for index, proc in self._procs.items():
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10.0)
            rc = proc.returncode
            reason = f"signal:{-rc}" if rc and rc < 0 else f"exit:{rc}"
            final.append(ExitStatus(index, proc.pid, rc, reason,
                                    self._generations[index]))
        self._procs.clear()
        self._metrics["up"].set(0)
        return final

    def __enter__(self) -> "ReplicaSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _main(argv: List[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="mmlspark_tpu_torch.serving.replicas")
    parser.add_argument("--replica", required=True, metavar="WORKDIR")
    parser.add_argument("index", type=int)
    args = parser.parse_args(argv)
    return _replica_main(args.replica, args.index)


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    # canonical-module re-dispatch (same runpy identity trap as procgroup)
    from mmlspark_tpu_torch.serving import replicas as _canonical

    sys.exit(_canonical._main(sys.argv[1:]))
