"""Metrics-driven autoscaler over a supervised replica fleet.

The pieces existed separately — :class:`ReplicaSupervisor` process gangs,
:class:`RegistrationService` TTL leases, hot swap on ModelStore CURRENT,
admission control + breakers — and :class:`FleetController` is what turns
them into the reference's "load-balanced continuous serving" posture: a
control loop that reads ONLY the public registry (``/services`` plus the
load metadata replicas heartbeat into their leases) and resizes the fleet
within ``[min_replicas, max_replicas]``:

- **scale up** when the mean heartbeat ``inflight`` per replica crosses
  ``scale_up_inflight``, when sheds start flowing (``scale_up_shed_rate``
  429s/second fleet-wide), or when any replica's queue-wait p99 crosses
  ``p99_up_ms``;
- **scale down** when the fleet has been idle (mean inflight below
  ``scale_down_inflight`` and zero sheds) for ``down_sustain_s`` —
  a single quiet sample never retires capacity;
- every action waits out ``cooldown_s`` before the next (no flapping),
  retires via :meth:`ReplicaSupervisor.retire_replica` (explicit
  ``/deregister`` first, so no router sends the victim another request),
  and publishes :class:`~mmlspark_tpu_torch.observability.events.FleetScaled`.

The module also hosts the campaign payload factories (resolved by name
INSIDE replica processes, so they must live in an importable module):
:func:`store_model_factory` serves whatever the shared ModelStore's
CURRENT pointer names — the mid-storm hot-swap payload.

:func:`sar_demo_factory` fits a small seeded SAR in each replica and
serves top-k retrieval (:func:`sar_topk_model`) — the recommendation
payload.

The port's copy of ``mmlspark_tpu/serving/fleet.py``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.profiling import get_logger
from mmlspark_tpu_torch.observability.events import (
    FleetScaled,
    RegistryRecovered,
    RegistryUnavailable,
    get_bus,
)
from mmlspark_tpu_torch.observability.registry import get_registry
from mmlspark_tpu_torch.serving.replicas import ReplicaSupervisor
from mmlspark_tpu_torch.serving.router import _parse_services
from mmlspark_tpu_torch.serving.server import RegistrationService, ServiceInfo

logger = get_logger("mmlspark_tpu_torch.serving.fleet")


class FleetController:
    """Autoscaler: registry load metadata in, spawn/retire decisions out.

    The controller holds the supervisor (the process plane) and a view of
    the registry (the control plane) but NEVER a handle into a replica:
    every signal it steers by arrived via a replica's own heartbeat."""

    def __init__(
        self,
        supervisor: ReplicaSupervisor,
        registry: Optional[RegistrationService] = None,
        registry_url: Optional[str] = None,
        federator: Optional[Any] = None,
        min_replicas: int = 1,
        max_replicas: int = 4,
        scale_up_inflight: float = 4.0,
        scale_down_inflight: float = 1.0,
        scale_up_shed_rate: float = 0.5,
        p99_up_ms: Optional[float] = None,
        cooldown_s: float = 3.0,
        down_sustain_s: float = 2.0,
        interval_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        alert_advisor: Optional[Callable[[], Any]] = None,
    ):
        if registry is None and registry_url is None:
            raise ValueError("need registry= or registry_url=")
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.supervisor = supervisor
        self._registry = registry
        self._registry_url = registry_url.rstrip("/") if registry_url else None
        #: optional MetricsFederator — when set, every control pass swaps
        #: the heartbeat load metadata for live /metrics scrapes, so the
        #: autoscaler steers on fleet-wide truth instead of lease lag
        self.federator = federator
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_inflight = float(scale_up_inflight)
        self.scale_down_inflight = float(scale_down_inflight)
        self.scale_up_shed_rate = float(scale_up_shed_rate)
        self.p99_up_ms = p99_up_ms
        self.cooldown_s = float(cooldown_s)
        self.down_sustain_s = float(down_sustain_s)
        self.interval_s = float(interval_s)
        self.clock = clock
        #: advisory hook (e.g. ``AlertEvaluator.active_alerts``): while it
        #: returns a truthy value the fleet is pinned non-idle, so an
        #: actively-burning SLO defers scale-down until the alert resolves
        self.alert_advisor = alert_advisor
        self._last_action_at: Optional[float] = None
        self._low_since: Optional[float] = None
        #: (total shed counter, at) from the previous pass — the shed RATE
        #: is a delta, cumulative counters never come back down
        self._last_shed: Optional[Tuple[int, float]] = None
        #: last-known-good ``/services`` snapshot, used (stamped stale)
        #: while the registry is unreachable so the control loop keeps
        #: supervising instead of going blind
        self._last_services: List[ServiceInfo] = []
        self._stale = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        reg = get_registry()
        self._m_replicas = reg.gauge(
            "fleet_replicas", "Supervised serving replicas in the fleet"
        )
        self._m_ups = reg.counter(
            "fleet_scale_ups_total", "Autoscaler scale-up actions"
        )
        self._m_downs = reg.counter(
            "fleet_scale_downs_total", "Autoscaler scale-down actions"
        )
        self._m_replicas.set(supervisor.live_count)

    # -- signals -------------------------------------------------------------

    def _services(self) -> List[ServiceInfo]:
        if self._registry is not None:
            return list(self._registry.services)
        url = self._registry_url + "/services"
        # same net-chaos edge as the router's discovery fetch
        from mmlspark_tpu_torch.runtime.faults import check_net

        net = check_net(url)
        with urllib.request.urlopen(url, timeout=5) as resp:
            raw = resp.read()
        if net is not None and net.get("kind") == "corrupt":
            from mmlspark_tpu_torch.runtime.netchaos import corrupt_bytes

            raw = corrupt_bytes(raw)
        return _parse_services(json.loads(raw))

    def _federated(self, services: List[ServiceInfo]) -> List[ServiceInfo]:
        """Swap heartbeat load metadata for scraped signals where the
        federator has them; a failed scrape round keeps the heartbeat
        values (federation must never blind the control loop)."""
        import dataclasses

        try:
            signals = self.federator.fleet_signals(services=[
                {"name": s.name, "host": s.host, "port": s.port}
                for s in services
            ])
        except Exception as e:  # noqa: BLE001 - replicas mid-churn
            logger.debug("fleet signals scrape failed: %s", e)
            return services
        out: List[ServiceInfo] = []
        for svc in services:
            sig = signals.get(svc.name)
            if not sig:
                out.append(svc)
                continue
            out.append(dataclasses.replace(
                svc,
                inflight=int(sig["inflight"]),
                shed_total=int(sig["shed_total"]),
                p99_ms=float(sig["p99_ms"]),
            ))
        return out

    def decide(
        self, services: List[ServiceInfo], now: Optional[float] = None
    ) -> Optional[Tuple[str, str]]:
        """One scaling decision from one ``/services`` snapshot:
        ``("up"|"down", reason)`` or None. Pure in the signals (the
        snapshot is the only input) but stateful in the pacing — cooldown,
        shed-rate deltas, and the sustained-idle window live here."""
        now = self.clock() if now is None else now
        live = self.supervisor.live_count
        inflights = [s.inflight or 0 for s in services]
        mean_inflight = sum(inflights) / len(inflights) if inflights else 0.0
        shed_total = sum(s.shed_total or 0 for s in services)
        shed_rate = 0.0
        if self._last_shed is not None:
            prev, at = self._last_shed
            dt = now - at
            if dt > 0:
                # max(0, ·): a retired replica leaving /services can step
                # the summed counter down; that is not negative shedding
                shed_rate = max(0, shed_total - prev) / dt
        self._last_shed = (shed_total, now)
        p99 = max((s.p99_ms or 0.0 for s in services), default=0.0)

        alerting = False
        if self.alert_advisor is not None:
            try:
                alerting = bool(self.alert_advisor())
            except Exception as e:  # noqa: BLE001 - advisory must not blind
                logger.debug("alert advisor failed: %s", e)
        busy = (
            mean_inflight >= self.scale_up_inflight
            or shed_rate >= self.scale_up_shed_rate
            or (self.p99_up_ms is not None and p99 >= self.p99_up_ms)
        )
        # a firing SLO alert pins the fleet non-idle: retiring capacity
        # mid-incident can only deepen the burn
        idle = (
            mean_inflight <= self.scale_down_inflight
            and shed_rate == 0.0
            and not alerting
        )
        if not idle:
            self._low_since = None
        elif self._low_since is None:
            self._low_since = now

        in_cooldown = (
            self._last_action_at is not None
            and now - self._last_action_at < self.cooldown_s
        )
        if live < self.min_replicas and not in_cooldown:
            return "up", f"below min ({live} < {self.min_replicas})"
        if in_cooldown:
            return None
        if busy and live < self.max_replicas:
            if shed_rate >= self.scale_up_shed_rate:
                reason = f"shed rate {shed_rate:.1f}/s"
            elif mean_inflight >= self.scale_up_inflight:
                reason = (
                    f"inflight {mean_inflight:.1f} >= "
                    f"{self.scale_up_inflight:g}"
                )
            else:
                reason = f"p99 {p99:.1f}ms >= {self.p99_up_ms:g}ms"
            return "up", reason
        if (
            live > self.min_replicas
            and self._low_since is not None
            and now - self._low_since >= self.down_sustain_s
        ):
            return "down", (
                f"idle {now - self._low_since:.1f}s "
                f"(inflight {mean_inflight:.1f})"
            )
        return None

    # -- actions -------------------------------------------------------------

    def _pick_victim(self, services: List[ServiceInfo]) -> Optional[int]:
        """The replica index to retire: the least-loaded registered
        replica that maps back to a live supervised slot; highest index
        breaks ties (newest capacity goes first)."""
        prefix = f"{self.supervisor.name}-"
        candidates: List[Tuple[int, int]] = []
        for svc in services:
            if not svc.name.startswith(prefix):
                continue
            try:
                index = int(svc.name[len(prefix):])
            except ValueError:
                continue
            if index in self.supervisor._procs:
                candidates.append((svc.inflight or 0, index))
        if not candidates:
            # registry view is stale/empty; fall back to the process plane
            live = list(self.supervisor._procs)
            return max(live) if len(live) > 1 else None
        candidates.sort(key=lambda c: (c[0], -c[1]))
        return candidates[0][1]

    def step(self) -> Optional[Tuple[str, str]]:
        """One control pass: supervise (respawn the dead), read the
        registry, maybe scale. Returns the action taken, if any."""
        self.supervisor.poll()
        stale = False
        try:
            services = self._services()
            self._last_services = services
            if self._stale:
                self._stale = False
                bus = get_bus()
                if bus.active:
                    bus.publish(RegistryRecovered(
                        source="controller", replicas=len(services),
                    ))
                logger.info("fleet controller regained the registry")
        except Exception as e:  # noqa: BLE001 - registry down/unreachable
            # registry outage tolerance: keep steering on the last-known-
            # good snapshot (stamped stale) — supervision and below-min
            # respawn must not stop because discovery did
            stale = True
            if not self._stale:
                self._stale = True
                bus = get_bus()
                if bus.active:
                    bus.publish(RegistryUnavailable(
                        source="controller",
                        error=f"{type(e).__name__}: {e}",
                        stale_replicas=len(self._last_services),
                    ))
            logger.warning(
                "fleet controller lost the registry (%s); using stale "
                "snapshot of %d lease(s)", e, len(self._last_services),
            )
            services = self._last_services
        if self.federator is not None:
            services = self._federated(services)
        decision = self.decide(services)
        if stale and decision is not None and decision[0] == "down":
            # stale load metadata can only look idle (nobody refreshed
            # it); never retire live capacity on an outage artifact
            logger.info("suppressing scale-down on stale registry snapshot")
            decision = None
        if decision is None:
            self._m_replicas.set(self.supervisor.live_count)
            return None
        direction, reason = decision
        if direction == "up":
            try:
                index = self.supervisor.add_replica()
            except (RuntimeError, TimeoutError) as e:
                # the spawn IS the scale-up; a slow (or once-crashed)
                # replica is now the supervisor poll loop's to finish
                logger.warning("scale-up replica not ready yet: %s", e)
                index = self.supervisor._next_index - 1
            self._m_ups.inc()
        else:
            victim = self._pick_victim(services)
            if victim is None:
                return None
            # retire_replica deregisters over registry_url; an in-process
            # registry (tests) needs the explicit call
            if self._registry is not None:
                self._registry.deregister(f"{self.supervisor.name}-{victim}")
            self.supervisor.retire_replica(victim)
            index = victim
            self._m_downs.inc()
        self._last_action_at = self.clock()
        self._low_since = None
        replicas = self.supervisor.live_count
        self._m_replicas.set(replicas)
        logger.info("fleet scaled %s to %d replicas (%s)",
                    direction, replicas, reason)
        bus = get_bus()
        if bus.active:
            bus.publish(FleetScaled(
                direction=direction, replicas=replicas,
                replica=index, reason=reason,
            ))
        return decision

    # -- lifecycle -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 - the loop must survive a bad pass
                logger.warning("fleet controller step failed", exc_info=True)

    def start(self) -> "FleetController":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-controller"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- campaign payload factories (resolved inside replica processes) ----------


def store_model_loader(text: str):
    """ModelStore text -> affine model: the committed JSON
    ``{"scale": s, "bias": b}`` becomes ``prediction = s*input + b``.
    Distinguishable versions make the hot swap *observable*: the load
    generator knows which model version answered from the value alone.
    An optional ``work_ms`` stalls each micro-batch that long — the
    campaign's knob for making a replica saturable at small client
    counts without a heavyweight payload."""
    import numpy as np

    from mmlspark_tpu_torch.data.table import Table

    spec = json.loads(text)
    scale = float(spec.get("scale", 1.0))
    bias = float(spec.get("bias", 0.0))
    work_ms = float(spec.get("work_ms", 0.0))

    def model(table: Table) -> Table:
        if work_ms > 0:
            time.sleep(work_ms / 1e3)
        x = np.asarray(table.column("input"), dtype=np.float64)
        return Table({"prediction": scale * x + bias})

    return model


def store_model_factory(spec: Dict[str, Any]):
    """Replica factory: serve the ModelStore CURRENT named by the replica
    spec's ``hot_swap`` block. A replica respawned mid-campaign comes
    back already on the latest committed version — the same recovery
    contract as :func:`~mmlspark_tpu_torch.serving.server.recover_model`."""
    import os

    from mmlspark_tpu_torch.runtime.journal import ModelStore

    swap = spec["hot_swap"]
    store = ModelStore(os.path.join(swap["root"], "models"))
    latest = store.latest(swap.get("name", "model"))
    if latest is None:
        return store_model_loader("{}")  # identity until the first commit
    _, text = latest
    return store_model_loader(text)


def sar_topk_model(model, num_items: int = 5):
    """Wrap a fitted :class:`~mmlspark_tpu_torch.recommendation.sar.SARModel`
    as a serving callable: each request posts a user id, the reply is
    that user's top-``num_items`` item ids (unknown users get ``[-1...]``
    — cold start is an answer, not an error). Scores on the model's
    ``device``."""
    import numpy as np

    from mmlspark_tpu_torch.data.table import Table

    def serve(table: Table) -> Table:
        users = np.asarray(table.column("input"), dtype=np.int64)
        A = model.getUserAffinity()
        known = (users >= 0) & (users < A.shape[0])
        idx, _ = model._recommend(A[np.where(known, users, 0)], num_items)
        idx = np.where(known[:, None], idx, -1)
        return Table({"prediction": idx.astype(np.int64)})

    return serve


def sar_demo_factory(spec: Dict[str, Any]):
    """Replica factory for the recommendation payload: fit a small,
    seeded SAR inside the replica process and serve top-k retrieval.
    Every replica fits the identical model (same seed), so any replica
    answers any user — the stateless-replica property routing needs. The
    spec's ``sar.device`` names the device (the port's default, the card,
    when absent)."""
    import numpy as np

    from mmlspark_tpu_torch.data.table import Table
    from mmlspark_tpu_torch.recommendation.sar import SAR

    opts = spec.get("sar", {})
    n_users = int(opts.get("n_users", 64))
    n_items = int(opts.get("n_items", 32))
    events = int(opts.get("events", 1024))
    rng = np.random.default_rng(int(opts.get("seed", 0)))
    table = Table({
        "user": rng.integers(0, n_users, events).astype(np.int64),
        "item": rng.integers(0, n_items, events).astype(np.int64),
        "rating": rng.uniform(0.5, 5.0, events),
    })
    device = {"device": opts["device"]} if "device" in opts else {}
    model = SAR(userCol="user", itemCol="item", ratingCol="rating", **device).fit(table)
    return sar_topk_model(model, num_items=int(opts.get("num_items", 5)))
