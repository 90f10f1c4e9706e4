#!/usr/bin/env python
"""Chaos-under-load campaign against the port's serving fleet
(``mmlspark_tpu_torch.serving``); the port's copy of ``tools/loadgen.py``,
with the same phases, checks and verdict.

Stands up the WHOLE serving fleet with real processes — RegistrationService,
N supervised replica processes (self-registering, heartbeating live load
metadata), the deadline-aware FleetRouter in front, and the FleetController
autoscaler — then runs a scripted campaign of closed-loop clients through
the router while the chaos escalates:

  warmup   light load; every reply checked against the committed model;
  ramp     enough closed-loop clients to saturate the starting fleet —
           heartbeat inflight/shed climbs, the autoscaler scales up;
  kill     a replica process is SIGKILL'd mid-load: the router eats the
           dead hops (failover, breaker), the supervisor respawns it, the
           registry lease expires it out of rotation — clients never see
           a non-shed 5xx;
  storm    a seeded ``http_storm`` fault plan (``MMLSPARK_TPU_FAULT_SEED``)
           injects synthetic 503s at the router->replica edge until the
           victim's breaker trips; MID-STORM a new model version is
           committed to the shared ModelStore and every replica hot-swaps
           live — observed from the client side as the predictions flip;
  poison   (``--malformed``) a seeded flood of malformed requests — torn
           JSON, schema violations, NaN payloads, each directed by a
           ``FaultPlan.malformed_request`` directive — is thrown at the
           router as one poison client: every reply must be a structured
           400 carrying X-Trace-Id until the per-client breaker trips
           into 429 shedding, healthy clients stay served throughout,
           and after the reset window the poison client is admitted
           again (the breaker releases);
  drain    load drops to zero and the autoscaler retires capacity back
           down to the floor, deregistering each victim first.

Everything lands in ``--out``: the shared event log (router + controller
+ every replica append to it), ``slo.json``/``slo.md`` (the
:class:`SLOReport` fold plus per-phase client stats and the campaign
verdict), and ``report.html`` (the history-server render, Fleet section
included). Exit 0 iff every campaign check passed.

The affine payload is served through the port's ``store_model_factory``
and ``store_model_loader`` (``mmlspark_tpu_torch/serving/fleet.py``); its
replicas are host code and open no CUDA context. Two things differ from
the reference's harness, so that the campaign measures the fleet and not
its own process: the closed-loop clients post from a process of their own
on keep-alive connections (this process runs the router, the registry and
the controller under one interpreter lock), and the log is folded for the
breaker-trip and replica-shed counts only after the load stops. ``--payload sar`` exits
with a message: the SAR payload waits for the port of
``recommendation/``.

Usage:
  python tools/torch_loadgen.py --out /tmp/fleet-campaign --short
  python tools/torch_loadgen.py --short --malformed --out fleet-campaign
  python tools/torch_loadgen.py --quality --out quality-campaign
"""

import argparse
import json
import os
import random
import resource
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# runnable straight from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmlspark_tpu_torch.io.http.clients import ConnectionPool  # noqa: E402

AFFINE_V1 = {"scale": 2.0, "bias": 0.0, "work_ms": 3.0}
AFFINE_V2 = {"scale": 3.0, "bias": 1.0, "work_ms": 3.0}
# latency-storm model for the --quality campaign: same affine map (so the
# prediction DISTRIBUTION is unchanged and only the input shift can drift)
# but every micro-batch stalls long enough to burn the p99 budget
QUALITY_SLOW = {"scale": 2.0, "bias": 0.0, "work_ms": 120.0}


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


class _ClientPool:
    """Closed-loop client pool: each worker POSTs to the router, waits for
    the reply, and immediately sends the next request. Concurrency is the
    load knob; every outcome is recorded under the current phase label."""

    def __init__(self, url, deadline_ms=1500.0, payload="affine"):
        self.url = url
        self.deadline_ms = float(deadline_ms)
        self.payload = payload
        self.phase = "idle"
        #: covariate-shift knob for the "quality" payload: added to the
        #: FIRST feature only, so drift must land on input[0] and never
        #: on input[1]
        self.shift = 0.0
        self.records = []  # (phase, status, latency_s, input, output)
        self._lock = threading.Lock()
        self._workers = {}  # worker id -> (thread, stop_event)
        #: the workers' keep-alive connections to the router
        self._conns = ConnectionPool()

    def _one(self, x, pool=None):
        """One request; a worker passes its process's keep-alive
        :class:`ConnectionPool`, a probe none (a new connection)."""
        body = json.dumps({"input": x}).encode()
        headers = {
            "Content-Type": "application/json",
            "X-Deadline-Ms": str(int(self.deadline_ms)),
        }
        t0 = time.monotonic()
        if pool is not None:
            try:
                status, _, _, raw = pool.request(self.url, "POST", body, headers, 5.0)
                data = json.loads(raw) if status == 200 else None
            except Exception:
                status, data = -1, None  # transport failure to the ROUTER itself
        else:
            req = urllib.request.Request(self.url, data=body, method="POST",
                                         headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=5.0) as resp:
                    data = json.loads(resp.read())
                    status = resp.status
            except urllib.error.HTTPError as e:
                status, data = e.code, None
                e.read()
            except Exception:
                status, data = -1, None  # transport failure to the ROUTER itself
        latency = time.monotonic() - t0
        out = data.get("prediction") if isinstance(data, dict) else None
        with self._lock:
            self.records.append((self.phase, status, latency, x, out))
        return status, out

    def _worker(self, stop, worker_id):
        i = 0
        rng = random.Random(9000 + worker_id)  # per-worker, deterministic
        while not stop.is_set():
            if self.payload == "quality":
                x = [rng.gauss(self.shift, 1.0), rng.gauss(0.0, 1.0)]
            elif self.payload == "affine":
                x = float((worker_id * 7 + i) % 10)
            else:
                x = (worker_id * 7 + i) % 64
            self._one(x, self._conns)
            i += 1

    def set_workers(self, ids):
        """Run exactly the workers ``ids`` (a worker's id seeds its
        payloads)."""
        ids = set(ids)
        for worker_id in [k for k in self._workers if k not in ids]:
            self._workers.pop(worker_id)[1].set()
        for worker_id in sorted(ids - set(self._workers)):
            stop = threading.Event()
            t = threading.Thread(
                target=self._worker, args=(stop, worker_id),
                daemon=True, name=f"loadgen-{worker_id}",
            )
            self._workers[worker_id] = (t, stop)
            t.start()

    def stop(self):
        for _, stop in self._workers.values():
            stop.set()
        for t, _ in self._workers.values():
            t.join(timeout=10.0)
        self._workers.clear()
        self._conns.close()

    def phase_stats(self):
        with self._lock:
            records = list(self.records)
        out = {}
        for phase, status, latency, _, _ in records:
            s = out.setdefault(phase, {
                "requests": 0, "ok": 0, "shed": 0, "errors_5xx": 0,
                "transport": 0, "latencies": [],
            })
            s["requests"] += 1
            if status == 200:
                s["ok"] += 1
                s["latencies"].append(latency)
            elif status == 429:
                s["shed"] += 1
            elif status >= 500:
                s["errors_5xx"] += 1
            elif status == -1:
                s["transport"] += 1
        for s in out.values():
            lat = sorted(s.pop("latencies"))
            s["p50_ms"] = round(_quantile(lat, 0.50) * 1e3, 2)
            s["p95_ms"] = round(_quantile(lat, 0.95) * 1e3, 2)
            s["p99_ms"] = round(_quantile(lat, 0.99) * 1e3, 2)
        return out


#: processes the campaign's client workers are spread over (worker k runs
#: in process k mod CLIENT_PROCESSES)
CLIENT_PROCESSES = 4


class LoadClients(_ClientPool):
    """The campaign's clients. Their workers run in processes of their own
    (this script's ``--clients`` mode, CLIENT_PROCESSES of them), so that
    their HTTP and JSON work takes no interpreter lock from the router, the
    controller and the registry, which run in this process, nor from each
    other: with them in this process, this process's lock, not the fleet,
    set the clients' latency. Probes (:meth:`_one`) run here; phase labels,
    the shift and the concurrency go to the workers' processes on their
    stdin, and their records come back at :meth:`stop`."""

    def __init__(self, url, deadline_ms=1500.0, payload="affine"):
        self._procs = []
        super().__init__(url, deadline_ms=deadline_ms, payload=payload)
        self._procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--clients", json.dumps({
                    "url": url, "deadline_ms": deadline_ms, "payload": payload,
                    "index": index, "processes": CLIENT_PROCESSES})],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for index in range(CLIENT_PROCESSES)
        ]
        for proc in self._procs:  # each says when its imports are done
            proc.stdout.readline()

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name in ("phase", "shift") and getattr(self, "_procs", None):
            self._send({name: value})

    def _send(self, command):
        for proc in self._procs:
            proc.stdin.write(json.dumps(command) + "\n")
            proc.stdin.flush()

    def set_concurrency(self, n):
        self._send({"concurrency": int(n)})

    def stop(self):
        procs, self._procs = self._procs, []
        for proc in procs:
            proc.stdin.write(json.dumps({"stop": True}) + "\n")
            proc.stdin.flush()
        for proc in procs:
            try:
                line = proc.stdout.readline()
            finally:
                proc.stdin.close()
                try:
                    proc.wait(timeout=30.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            records = [tuple(r) for r in json.loads(line)] if line else []
            with self._lock:
                self.records.extend(records)


def _clients_main(spec):
    """One workers' process: a :class:`_ClientPool` running its share of
    the workers, driven by one JSON command a line on stdin. It says
    ``ready`` on stdout once it can take commands; on ``stop`` its records
    go to stdout as one JSON line."""
    pool = _ClientPool(spec["url"], deadline_ms=spec["deadline_ms"], payload=spec["payload"])
    print("ready", flush=True)
    for line in sys.stdin:
        command = json.loads(line)
        if "phase" in command:
            pool.phase = command["phase"]
        if "shift" in command:
            pool.shift = command["shift"]
        if "concurrency" in command:
            pool.set_workers(k for k in range(command["concurrency"])
                             if k % spec["processes"] == spec["index"])
        if command.get("stop"):
            break
    pool.stop()
    with pool._lock:
        records = list(pool.records)
    print(json.dumps(records), flush=True)

def _malformed_body(kind, i):
    """One poison payload of the FaultPlan-directed ``kind``: torn JSON,
    a schema violation (missing input column), or a non-finite value
    (parses fine; only the pre-admission validator can catch it)."""
    if kind == "json":
        return b'{"input": [1.0, not json'
    if kind == "schema":
        return json.dumps({"wrong_col": [float(i)]}).encode()
    return b'{"input": NaN}'


def _post_json(url, payload, client_id=None, timeout=5.0):
    headers = {"Content-Type": "application/json"}
    if client_id:
        headers["X-Client-Id"] = client_id
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers=headers,
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, None
    except Exception:
        return -1, None


def _malformed_storm(url, plan, client_id="poison-client", enough_shed=4):
    """Drain the plan's ``malformed_request`` directives as one poison
    client: each directive's kind picks the payload shape. Every reply is
    classified — a structured 400 must carry an error kind + rid in the
    body AND an X-Trace-Id header; 429s are the per-client breaker
    shedding us. Stops early once ``enough_shed`` 429s are observed
    (post-trip requests crawl behind Retry-After honoring)."""
    stats = {"sent": 0, "accepted": 0, "s400": 0, "s429": 0,
             "structured_400": 0, "missing_trace": 0, "other": 0}
    while stats["s429"] < enough_shed:
        kind = plan.take_malformed()
        if kind is None:
            break
        body = _malformed_body(kind, stats["sent"])
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "X-Client-Id": client_id},
        )
        stats["sent"] += 1
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                resp.read()
                stats["accepted"] += 1
        except urllib.error.HTTPError as e:
            data = e.read()
            if not e.headers.get("X-Trace-Id"):
                stats["missing_trace"] += 1
            if e.code == 400:
                stats["s400"] += 1
                try:
                    err = json.loads(data).get("error")
                    if isinstance(err, dict) and err.get("kind") \
                            and err.get("rid"):
                        stats["structured_400"] += 1
                except (ValueError, AttributeError):
                    pass
            elif e.code == 429:
                stats["s429"] += 1
            else:
                stats["other"] += 1
        except Exception:
            stats["other"] += 1
    return stats


def run_campaign(args):
    from mmlspark_tpu_torch import observability as obs
    from mmlspark_tpu_torch.observability.federation import MetricsFederator
    from mmlspark_tpu_torch.observability.registry import get_registry
    from mmlspark_tpu_torch.observability.slo import SLOReport, SLOTargets
    from mmlspark_tpu_torch.runtime.faults import FaultPlan, inject_faults
    from mmlspark_tpu_torch.runtime.journal import ModelStore
    from mmlspark_tpu_torch.serving.fleet import FleetController
    from mmlspark_tpu_torch.serving.replicas import ReplicaSupervisor
    from mmlspark_tpu_torch.serving.router import FleetRouter
    from mmlspark_tpu_torch.serving.server import RegistrationService

    seed = int(os.environ.get("MMLSPARK_TPU_FAULT_SEED", str(args.seed)))
    short = args.short
    min_replicas, max_replicas = 2, (3 if short else 4)
    ramp_clients = 12 if short else 20
    dur = (lambda s, f: s if short else f)

    workdir = tempfile.mkdtemp(prefix="mmlspark-tpu-torch-fleet-")
    store = ModelStore(os.path.join(workdir, "models"))
    # the affine payload only: main() refuses sar until recommendation/ is ported
    store.commit(json.dumps(AFFINE_V1), name="model")
    factory = "mmlspark_tpu_torch.serving.fleet:store_model_factory"
    hot_swap = {
        "loader": "mmlspark_tpu_torch.serving.fleet:store_model_loader",
        "root": workdir, "name": "model", "poll_s": 0.2,
    }

    registry = RegistrationService(ttl_s=2.0).start()
    sup = ReplicaSupervisor(
        factory,
        num_replicas=min_replicas,
        workdir=os.path.join(workdir, "replicas"),
        seed=seed,
        heartbeat_timeout_s=5.0,
        registry_url=registry.info.url,
        registry_heartbeat_s=0.2,
        hot_swap=hot_swap,
        server_options={
            "max_batch_size": 8, "max_latency_ms": 1.0,
            "max_pending": 32, "shed_retry_after_s": 0.05,
            # campaign-sized poison breaker: trips after a handful of
            # malformed requests, releases fast enough to re-probe
            "malformed_threshold": 6, "malformed_window_s": 10.0,
            "malformed_reset_s": 1.0,
        },
    )
    sup.start()
    deadline = time.monotonic() + 30.0
    while len(registry.services) < min_replicas:
        if time.monotonic() > deadline:
            raise TimeoutError("replicas never registered")
        time.sleep(0.1)

    router = FleetRouter(
        registry_url=registry.info.url, policy=args.policy,
        discovery_interval_s=0.1, hop_timeout_s=2.0,
    ).start()
    # federation: the controller steers on live /metrics scrapes instead
    # of heartbeat lag, and the flight recorder bundles the fleet snapshot
    federator = MetricsFederator(registry.info.url)
    recorder = obs.get_recorder()
    if recorder is not None:
        recorder.federator = federator
    controller = FleetController(
        sup, registry_url=registry.info.url, federator=federator,
        min_replicas=min_replicas, max_replicas=max_replicas,
        scale_up_inflight=1.5, scale_down_inflight=0.5,
        scale_up_shed_rate=1.0, cooldown_s=1.0,
        down_sustain_s=1.5, interval_s=0.2,
    ).start()

    clients = LoadClients(router.url, payload=args.payload)
    kill_windows = []
    checks = {}
    max_live = sup.live_count
    try:
        # -- warmup: light load, correctness spot-checks ---------------------
        clients.phase = "warmup"
        status, out = clients._one(4.0 if args.payload == "affine" else 4)
        assert status == 200, f"warmup request failed: {status}"
        if args.payload == "affine":
            want = AFFINE_V1["scale"] * 4.0 + AFFINE_V1["bias"]
            assert out == want, f"expected {want}, got {out}"
        else:
            assert isinstance(out, list) and len(out) == 5, out
        clients.set_concurrency(2)
        time.sleep(dur(2.0, 3.0))
        print(f"warmup: fleet={sup.live_count} first reply {out}")

        # -- ramp: saturate the floor fleet, watch the autoscaler ------------
        clients.phase = "ramp"
        clients.set_concurrency(ramp_clients)
        ramp_deadline = time.monotonic() + dur(8.0, 12.0)
        while time.monotonic() < ramp_deadline:
            max_live = max(max_live, sup.live_count)
            if max_live > min_replicas and time.monotonic() > \
                    ramp_deadline - dur(2.0, 3.0):
                break  # scaled; keep a little sustained post-scale load
            time.sleep(0.1)
        checks["scaled_up"] = max_live > min_replicas
        print(f"ramp: {ramp_clients} clients, fleet peaked at {max_live}")

        # -- kill: SIGKILL a replica under load ------------------------------
        clients.phase = "kill"
        victim = max(sup._procs)
        pid = sup._procs[victim].pid
        kill_start = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        t0 = time.monotonic()
        while not any(s.reason == "signal:9" for s in sup.exit_statuses):
            if time.monotonic() - t0 > 30.0:
                raise TimeoutError("supervisor never booked the kill")
            time.sleep(0.1)  # controller.step() runs poll() for us
        time.sleep(dur(2.0, 4.0))  # lease expiry + respawn under load
        kill_windows.append((kill_start, time.monotonic()))
        checks["kill_respawned"] = any(
            s.reason == "signal:9" for s in sup.exit_statuses
        )
        print(f"kill: replica {victim} (pid {pid}) SIGKILL'd, "
              f"fleet now {sup.live_count}")

        # -- storm: injected 503s trip a breaker; hot swap mid-storm ---------
        clients.phase = "storm"
        target = registry.services[0]
        plan = FaultPlan(seed=seed).http_storm(
            count=12, status=503, url_part=f":{target.port}/",
        )
        swap_seen = False
        with inject_faults(plan):
            time.sleep(dur(1.0, 2.0))
            if args.payload == "affine":
                store.commit(json.dumps(AFFINE_V2), name="model")
                want = AFFINE_V2["scale"] * 4.0 + AFFINE_V2["bias"]
                swap_deadline = time.monotonic() + 15.0
                while time.monotonic() < swap_deadline:
                    s, out = clients._one(4.0)
                    if s == 200 and out == want:
                        swap_seen = True
                        break
                    time.sleep(0.1)
            else:
                time.sleep(dur(1.0, 2.0))
        checks["storm_fired"] = bool(plan.fired)
        checks["hot_swap_observed"] = (
            swap_seen if args.payload == "affine" else None
        )
        # the breaker trips are counted from the log once the load is off:
        # folding the log here, in the router's process, stalls the
        # requests in flight
        print(f"storm: {len(plan.fired)} faults fired, "
              f"hot swap seen: {swap_seen}")
        # post-swap warm window, still labeled "storm" (excluded from the
        # steady fold): the swapped model's jitted apply recompiles per
        # batch shape, and the closed-loop load re-warms those shapes here
        # so the drain tail measures steady state, not cold compiles
        time.sleep(dur(2.0, 3.0))

        # -- poison: seeded malformed-request flood (--malformed) ------------
        if args.malformed:
            clients.phase = "poison"
            poison_plan = FaultPlan(seed=seed)
            for kind in ("json", "schema", "nan"):
                poison_plan.malformed_request(count=dur(8, 16), kind=kind)
            pstats = _malformed_storm(router.url, poison_plan)
            # a healthy client keeps being served while the poison client
            # is shed — the breaker is per X-Client-Id, not per replica
            s_h, _ = clients._one(4.0 if args.payload == "affine" else 4)
            # every tripped breaker must also RELEASE: after reset_s, a
            # valid request from the poison client probes each replica
            # directly (the router would stop at the first) so the
            # PoisonClientBlocked/Released event pairs all close
            time.sleep(1.2)
            released = 0
            for svc in list(registry.services):
                s_r, _ = _post_json(
                    svc.url,
                    {"input": 4.0 if args.payload == "affine" else 4},
                    client_id="poison-client",
                )
                released += 1 if s_r == 200 else 0
            checks["malformed_storm_fired"] = any(
                f[0] == "malformed_request" for f in poison_plan.fired
            )
            checks["malformed_none_accepted"] = pstats["accepted"] == 0
            checks["malformed_400s_structured"] = (
                pstats["s400"] > 0
                and pstats["structured_400"] == pstats["s400"]
                and pstats["missing_trace"] == 0
            )
            checks["poison_client_released"] = released > 0
            checks["healthy_during_poison"] = s_h == 200
            print(
                f"poison: {pstats['sent']} malformed sent -> "
                f"{pstats['s400']} structured 400s, {pstats['s429']} client "
                f"429s, healthy probe {s_h}, released on {released} replica(s)"
            )

        # -- drain: load off, autoscaler retires back to the floor -----------
        clients.phase = "drain"
        clients.set_concurrency(0)
        drain_deadline = time.monotonic() + dur(20.0, 30.0)
        while sup.live_count > min_replicas:
            if time.monotonic() > drain_deadline:
                break
            time.sleep(0.2)
        checks["scaled_down"] = sup.live_count == min_replicas
        print(f"drain: fleet back to {sup.live_count}")
    finally:
        clients.stop()
        controller.stop()
        router.stop()
        sup.stop()
        registry.stop()

    # -- fold ----------------------------------------------------------------
    # federate the per-process segments (router/controller in this
    # process's log, each replica in events.jsonl@replica-<i>) into one merged
    # fleet log — the file tools/check_eventlog.py validates
    merged_path = os.path.join(args.out, "fleet-events.jsonl")
    merged_count = obs.write_merged(event_log_path(), merged_path)
    events = obs.merge(event_log_path())
    segments = obs.collect(event_log_path())
    print(f"fleet log: {merged_count} events from "
          f"{len(segments)} processes -> {merged_path}")
    breaker_trips = sum(
        1 for e in events
        if type(e).__name__ == "BreakerTripped"
        and getattr(e, "process", "") == "driver"
    )
    print(f"storm: {breaker_trips} breaker trips")
    if args.malformed:
        # the router retries 429s onto untripped replicas (and the
        # short reset window re-admits the client between hops), so
        # the CLIENT may never see a 429 even while replicas shed —
        # count the replica-side RequestShed events as well
        replica_sheds = sum(
            1 for e in events
            if type(e).__name__ == "RequestShed"
            and getattr(e, "reason", "") == "malformed_rate"
        )
        checks["poison_breaker_shed"] = (
            pstats["s429"] + replica_sheds > 0
        )
        print(f"poison: {replica_sheds} replica shed(s)")
    targets = SLOTargets()
    report = SLOReport.fold(None, events=events, targets=targets)
    if not report.ok():
        obs.maybe_record("slo_budget", detail=(
            f"campaign SLO missed: apply p50 {report.apply_p50_ms:.2f}ms "
            f"p99 {report.apply_p99_ms:.2f}ms, error budget "
            f"{report.error_budget_consumed:.1%}"
        ))
    phases = clients.phase_stats()
    non_shed_5xx = sum(s["errors_5xx"] for s in phases.values())
    transport = sum(s["transport"] for s in phases.values())
    steady = sorted(
        lat for phase, status, lat, _, _ in clients.records
        if status == 200 and phase not in ("kill", "storm", "poison")
    )
    steady_p99_ms = _quantile(steady, 0.99) * 1e3
    # the affine payload is judged against the SLO's tail target; the SAR
    # payload (when its module is ported) gets the reference's looser budget
    p99_target_ms = args.p99_target or (
        targets.p99_ms if args.payload == "affine" else 250.0
    )
    fleet_events = [e for e in events if type(e).__name__ == "FleetScaled"]
    routed = [e for e in events if type(e).__name__ == "RequestRouted"]

    # trace continuity over the merged log: every successfully served
    # routed request's trace id must resolve to spans from BOTH sides of
    # the wire — the router's root/hop spans and the replica's serving
    # spans, distinct processes under one trace id
    spans_by_trace = {}
    for e in events:
        if type(e).__name__ == "SpanRecorded":
            spans_by_trace.setdefault(e.trace_id, []).append(e)

    def _chain_ok(trace_id):
        spans = spans_by_trace.get(trace_id, [])
        names = {s.name for s in spans}
        procs = {getattr(s, "process", "") for s in spans}
        return (
            "router.request" in names
            and "serving.request" in names
            and len(procs) >= 2
        )

    served_routed = [e for e in routed if e.status == 200 and e.trace_id]
    broken = [e.trace_id for e in served_routed if not _chain_ok(e.trace_id)]
    checks["trace_continuity"] = bool(served_routed) and not broken
    if broken:
        print(f"trace continuity broken for {len(broken)} of "
              f"{len(served_routed)} traces (e.g. {broken[:3]})")

    incident_dir = os.environ.get("MMLSPARK_TPU_INCIDENT_DIR", "")
    bundles = sorted(
        d for d in (os.listdir(incident_dir) if os.path.isdir(incident_dir)
                    else [])
        if not d.startswith(".")
    )
    checks["incident_recorded"] = bool(bundles)
    print(f"incidents: {len(bundles)} bundle(s) in {incident_dir}")

    checks["zero_non_shed_5xx"] = non_shed_5xx == 0 and transport == 0
    checks["steady_p99_within_target"] = steady_p99_ms <= p99_target_ms
    checks["fleet_events_logged"] = len(fleet_events) >= 2
    checks["routing_events_logged"] = len(routed) > 0
    checks["slo_ok"] = report.ok()
    ok = all(v for v in checks.values() if v is not None)

    campaign = {
        "seed": seed,
        "payload": args.payload,
        "policy": args.policy,
        "min_replicas": min_replicas,
        "max_replicas": max_replicas,
        "max_live": max_live,
        "steady_p99_ms": round(steady_p99_ms, 2),
        "p99_target_ms": p99_target_ms,
        "non_shed_5xx": non_shed_5xx,
        "router_transport_failures": transport,
        "fleet_scaled": [
            {"direction": e.direction, "replicas": e.replicas,
             "reason": e.reason} for e in fleet_events
        ],
        "requests_routed": len(routed),
        # this process (router, registry, controller): its CPU per routed
        # request says how near its interpreter lock is to saturation
        "campaign_process_cpu_s": round(sum(resource.getrusage(resource.RUSAGE_SELF)[:2]), 3),
        "merged_events": merged_count,
        "processes": sorted(segments),
        "traces_served": len(served_routed),
        "incident_bundles": bundles,
        "kill_windows_s": [round(b - a, 2) for a, b in kill_windows],
        "phases": phases,
        "checks": checks,
        "ok": ok,
    }

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "slo.json"), "w") as fh:
        json.dump({"slo": report.to_dict(), "campaign": campaign}, fh,
                  indent=2, sort_keys=True)
    md = [
        f"Chaos-under-load campaign: payload={args.payload} "
        f"policy={args.policy} seed={seed} "
        f"fleet {min_replicas}..{max_replicas} (peak {max_live}).",
        "",
        report.to_markdown(),
        "",
        "| phase | requests | ok | shed | 5xx | p50 | p99 |",
        "|---|---|---|---|---|---|---|",
    ]
    for phase in ("warmup", "ramp", "kill", "storm", "poison", "drain"):
        s = phases.get(phase)
        if s is None:
            continue
        md.append(
            f"| {phase} | {s['requests']} | {s['ok']} | {s['shed']} "
            f"| {s['errors_5xx']} | {s['p50_ms']:.2f} ms "
            f"| {s['p99_ms']:.2f} ms |"
        )
    md += [
        "",
        "| check | result |",
        "|---|---|",
    ]
    md += [
        f"| {name} | {'pass' if v else 'FAIL'} |"
        for name, v in checks.items() if v is not None
    ]
    with open(os.path.join(args.out, "slo.md"), "w") as fh:
        fh.write("\n".join(md) + "\n")
    from mmlspark_tpu_torch.observability.history import render_report

    with open(os.path.join(args.out, "report.html"), "w") as fh:
        fh.write(render_report(
            events, metrics=get_registry().summary(),
            title="serving fleet chaos campaign",
        ))

    print("\n".join(md))
    print(f"\ncampaign {'OK' if ok else 'FAILED'}; "
          f"artifacts in {args.out}")
    return 0 if ok else 1


def measure_bare_overhead(rows=1 << 20, iters=10, repeats=7):
    """The <5% ambient-gate guard: time ``PipelineModel.transform`` —
    which carries the tracing AND quality gates — against the raw stage
    loop (``ml_transform``) over the same table, and return the overhead
    in percent. Rounds interleave the two paths and each takes its
    best-of-``repeats`` so scheduler noise cancels instead of landing on
    one side. Must run before the campaign exports
    ``MMLSPARK_TPU_QUALITY_*`` so this process measures the bare,
    unconfigured posture every production transform pays."""
    import numpy as np

    from mmlspark_tpu_torch.core.pipeline import (
        Transformer,
        make_pipeline_model,
        ml_transform,
    )
    from mmlspark_tpu_torch.data.table import Table

    class _Affine(Transformer):
        def transform(self, table):
            x = np.asarray(table.column("input"), dtype=np.float64)
            return Table({"input": x, "prediction": x * 2.0 + 1.0})

    stage = _Affine()
    model = make_pipeline_model(stage)
    table = Table({"input": np.arange(rows, dtype=np.float64)})

    def timed(fn):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return time.perf_counter() - t0

    ml_transform(table, stage)  # warm both paths
    model.transform(table)
    bare = gated = float("inf")
    for _ in range(repeats):
        bare = min(bare, timed(lambda: ml_transform(table, stage)))
        gated = min(gated, timed(lambda: model.transform(table)))
    return max(0.0, (gated - bare) / bare * 100.0)


def run_quality_campaign(args):
    """Model-quality campaign: the same real-process
    fleet, judged by the live quality plane end to end. A fit-time
    reference profile is committed next to model version 1; every replica
    installs a QualityMonitor from the inherited environment and sketches
    its own traffic; this process runs the multi-window burn-rate
    AlertEvaluator over federated scrapes (wired into the FleetController
    as the scale-down advisory). The chaos is a seeded covariate-shift
    storm on input[0] only, then a latency storm hot-swapped in as a
    slow model version. Verdicts: drift fires on the shifted feature and
    never the stable one, onset/recovery events pair up, alerts fire in
    the storm and resolve after it, the incident bundle carries a drift
    table, and the bare-transform ambient gate stays under 5%."""
    from mmlspark_tpu_torch import observability as obs
    from mmlspark_tpu_torch.observability.alerts import AlertEvaluator
    from mmlspark_tpu_torch.observability.federation import MetricsFederator
    from mmlspark_tpu_torch.observability.quality import ReferenceProfile
    from mmlspark_tpu_torch.observability.registry import get_registry
    from mmlspark_tpu_torch.observability.slo import (
        SLOReport,
        SLOTargets,
        fleet_summary,
    )
    from mmlspark_tpu_torch.runtime.journal import ModelStore
    from mmlspark_tpu_torch.serving.fleet import FleetController
    from mmlspark_tpu_torch.serving.replicas import ReplicaSupervisor
    from mmlspark_tpu_torch.serving.router import FleetRouter
    from mmlspark_tpu_torch.serving.server import RegistrationService

    seed = int(os.environ.get("MMLSPARK_TPU_FAULT_SEED", str(args.seed)))
    checks = {}

    overhead_pct = measure_bare_overhead()
    checks["bare_overhead_under_5pct"] = overhead_pct < 5.0
    print(f"bare-transform gate overhead: {overhead_pct:.2f}% (budget 5%)")

    workdir = tempfile.mkdtemp(prefix="mmlspark-tpu-torch-quality-")
    store = ModelStore(os.path.join(workdir, "models"))
    store.commit(json.dumps(AFFINE_V1), name="model")  # version 1

    # fit-time reference for version 1: both features standard normal,
    # predictions the committed affine map of them
    rng = random.Random(seed)
    ref_rows = [[rng.gauss(0.0, 1.0), rng.gauss(0.0, 1.0)]
                for _ in range(768)]
    ref_preds = [
        [AFFINE_V1["scale"] * a + AFFINE_V1["bias"],
         AFFINE_V1["scale"] * b + AFFINE_V1["bias"]]
        for a, b in ref_rows
    ]
    ReferenceProfile.capture(
        "model", 1, {"input": ref_rows, "prediction": ref_preds}
    ).commit(store)

    # exported BEFORE the supervisor snapshots its spawn environment:
    # every replica self-installs a monitor against the shared store.
    # a small window so the campaign turns it over within seconds; the
    # min-window floor keeps small-sample PSI noise from false-firing.
    os.environ["MMLSPARK_TPU_QUALITY_STORE"] = os.path.join(workdir, "models")
    os.environ["MMLSPARK_TPU_QUALITY_MODEL"] = "model"
    os.environ["MMLSPARK_TPU_QUALITY_WINDOW"] = "256"
    os.environ["MMLSPARK_TPU_QUALITY_EVAL_EVERY"] = "32"
    os.environ["MMLSPARK_TPU_QUALITY_MIN_WINDOW"] = "192"

    min_replicas, max_replicas = 2, 3
    registry_svc = RegistrationService(ttl_s=2.0).start()
    sup = ReplicaSupervisor(
        "mmlspark_tpu_torch.serving.fleet:store_model_factory",
        num_replicas=min_replicas,
        workdir=os.path.join(workdir, "replicas"),
        seed=seed,
        heartbeat_timeout_s=5.0,
        registry_url=registry_svc.info.url,
        registry_heartbeat_s=0.2,
        hot_swap={
            "loader": "mmlspark_tpu_torch.serving.fleet:store_model_loader",
            "root": workdir, "name": "model", "poll_s": 0.2,
        },
        server_options={
            "max_batch_size": 8, "max_latency_ms": 1.0,
            "max_pending": 32, "shed_retry_after_s": 0.05,
        },
    )
    sup.start()
    deadline = time.monotonic() + 30.0
    while len(registry_svc.services) < min_replicas:
        if time.monotonic() > deadline:
            raise TimeoutError("replicas never registered")
        time.sleep(0.1)

    router = FleetRouter(
        registry_url=registry_svc.info.url, policy=args.policy,
        discovery_interval_s=0.1, hop_timeout_s=2.0,
    ).start()
    federator = MetricsFederator(registry_svc.info.url)
    recorder = obs.get_recorder()
    if recorder is not None:
        recorder.federator = federator
    # the live alerting edge, on short timescales (2 s / 8 s windows)
    targets = SLOTargets()
    evaluator = AlertEvaluator(
        targets=targets,
        source=lambda: fleet_summary(federator.scrape()),
        windows=(2.0, 8.0), threshold=1.0,
    ).start(interval_s=0.5)
    controller = FleetController(
        sup, registry_url=registry_svc.info.url, federator=federator,
        min_replicas=min_replicas, max_replicas=max_replicas,
        scale_up_inflight=4.0, scale_down_inflight=0.5,
        scale_up_shed_rate=4.0, cooldown_s=1.0,
        down_sustain_s=1.5, interval_s=0.2,
        alert_advisor=evaluator.active_alerts,
    ).start()

    clients = LoadClients(router.url, payload="quality")

    def quality_events(kind):
        return [e for e in obs.merge(event_log_path())
                if type(e).__name__ == kind]

    def wait_for(predicate, timeout_s, what):
        stop_at = time.monotonic() + timeout_s
        while time.monotonic() < stop_at:
            if predicate():
                return True
            time.sleep(0.5)
        print(f"timeout waiting for {what}")
        return False

    def all_cleared():
        det = {e.feature for e in quality_events("DriftDetected")}
        clr = {e.feature for e in quality_events("DriftCleared")}
        return bool(det) and det <= clr

    try:
        # -- warmup: correctness probe, then span the long alert window -----
        clients.phase = "warmup"
        status, out = clients._one([1.0, -1.0])
        assert status == 200, f"warmup request failed: {status}"
        want = [AFFINE_V1["scale"] * 1.0 + AFFINE_V1["bias"],
                AFFINE_V1["scale"] * -1.0 + AFFINE_V1["bias"]]
        assert out == want, f"expected {want}, got {out}"
        clients.set_concurrency(2)
        time.sleep(9.0)
        checks["no_false_drift"] = not quality_events("DriftDetected")
        checks["no_false_alert"] = not evaluator.active_alerts()
        print(f"warmup: fleet={sup.live_count}, reply {out}, "
              f"false drift/alerts: none" if checks["no_false_drift"]
              else f"warmup: FALSE drift {quality_events('DriftDetected')}")

        # -- shift: seeded covariate storm on input[0] only ------------------
        clients.phase = "shift"
        clients.shift = 4.0
        clients.set_concurrency(4)
        checks["drift_detected_on_shifted"] = wait_for(
            lambda: any(e.feature == "input[0]"
                        for e in quality_events("DriftDetected")),
            30.0, "DriftDetected(input[0])",
        )
        print("shift: drift onsets on "
              f"{sorted({e.feature for e in quality_events('DriftDetected')})}")

        # -- storm: slow model hot-swapped in burns the latency budget -------
        clients.phase = "storm"
        store.commit(json.dumps(QUALITY_SLOW), name="model")  # version 2
        checks["alert_fired_in_storm"] = wait_for(
            lambda: "latency" in evaluator.active_alerts(),
            25.0, "AlertFired(latency)",
        )
        print(f"storm: active alerts {evaluator.active_alerts()}")

        # -- recover: fast model back, shift off; every onset must pair ------
        clients.phase = "recover"
        store.commit(json.dumps(AFFINE_V1), name="model")  # version 3
        clients.shift = 0.0
        checks["alert_resolved"] = (
            checks["alert_fired_in_storm"]
            and wait_for(lambda: not evaluator.active_alerts(),
                         30.0, "AlertResolved")
        )
        checks["drift_cleared"] = (
            checks["drift_detected_on_shifted"]
            and wait_for(all_cleared, 60.0, "DriftCleared for every onset")
        )
        time.sleep(2.0)  # settle: no late re-fire may leave an open pair
        checks["drift_cleared"] = checks["drift_cleared"] and all_cleared()

        # -- drain -----------------------------------------------------------
        clients.phase = "drain"
        clients.set_concurrency(0)
        time.sleep(1.0)
    finally:
        clients.stop()
        controller.stop()
        evaluator.stop()
        router.stop()
        sup.stop()
        registry_svc.stop()

    # -- fold ----------------------------------------------------------------
    merged_path = os.path.join(args.out, "quality-events.jsonl")
    merged_count = obs.write_merged(event_log_path(), merged_path)
    events = obs.merge(event_log_path())
    segments = obs.collect(event_log_path())
    print(f"quality log: {merged_count} events from "
          f"{len(segments)} processes -> {merged_path}")
    report = SLOReport.fold(None, events=events, targets=targets)
    phases = clients.phase_stats()
    non_shed_5xx = sum(s["errors_5xx"] for s in phases.values())
    transport = sum(s["transport"] for s in phases.values())
    checks["zero_non_shed_5xx"] = non_shed_5xx == 0 and transport == 0

    detected = sorted({
        e.feature for e in events if type(e).__name__ == "DriftDetected"
    })
    checks["no_drift_on_stable"] = not any(
        f in ("input[1]", "prediction[1]") for f in detected
    )
    checks["alert_events_paired"] = (
        any(type(e).__name__ == "AlertFired" for e in events)
        and any(type(e).__name__ == "AlertResolved" for e in events)
    )

    incident_dir = os.environ.get("MMLSPARK_TPU_INCIDENT_DIR", "")
    bundles = sorted(
        d for d in (os.listdir(incident_dir) if os.path.isdir(incident_dir)
                    else [])
        if not d.startswith(".")
    )
    quality_bundles = []
    for b in bundles:
        try:
            with open(os.path.join(incident_dir, b, "quality.json")) as fh:
                if json.load(fh).get("drift"):
                    quality_bundles.append(b)
        except (OSError, ValueError):
            continue
    checks["bundle_has_drift_table"] = bool(quality_bundles)
    print(f"incidents: {len(bundles)} bundle(s), "
          f"{len(quality_bundles)} with a drift table")
    ok = all(v for v in checks.values() if v is not None)

    campaign = {
        "seed": seed,
        "payload": "quality",
        "policy": args.policy,
        "min_replicas": min_replicas,
        "max_replicas": max_replicas,
        "bare_overhead_pct": round(overhead_pct, 3),
        "drifted_features": detected,
        "active_alerts_at_exit": list(evaluator.active_alerts()),
        "non_shed_5xx": non_shed_5xx,
        "router_transport_failures": transport,
        "merged_events": merged_count,
        "processes": sorted(segments),
        "incident_bundles": bundles,
        "quality_bundles": quality_bundles,
        "phases": phases,
        "checks": checks,
        "ok": ok,
    }

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "slo.json"), "w") as fh:
        json.dump({"slo": report.to_dict(), "campaign": campaign}, fh,
                  indent=2, sort_keys=True)
    md = [
        f"Model-quality campaign: seed={seed} fleet {min_replicas}"
        f"..{max_replicas}, shift storm on input[0], "
        f"latency storm work_ms={QUALITY_SLOW['work_ms']:g}.",
        "",
        report.to_markdown(),
        "",
        "| check | result |",
        "|---|---|",
    ]
    md += [
        f"| {name} | {'pass' if v else 'FAIL'} |"
        for name, v in checks.items() if v is not None
    ]
    with open(os.path.join(args.out, "slo.md"), "w") as fh:
        fh.write("\n".join(md) + "\n")
    from mmlspark_tpu_torch.observability.history import render_report

    with open(os.path.join(args.out, "report.html"), "w") as fh:
        fh.write(render_report(
            events, metrics=get_registry().summary(),
            title="model-quality chaos campaign",
        ))

    print("\n".join(md))
    print(f"\ncampaign {'OK' if ok else 'FAILED'}; artifacts in {args.out}")
    return 0 if ok else 1


def event_log_path():
    return os.environ["MMLSPARK_TPU_EVENT_LOG"]


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="tools/torch_loadgen.py",
        description="Chaos-under-load campaign against the serving fleet.",
    )
    parser.add_argument("--out", default="fleet-campaign",
                        help="artifact directory (slo.json, slo.md, "
                             "report.html, events.jsonl)")
    parser.add_argument("--seed", type=int, default=11,
                        help="fault seed (MMLSPARK_TPU_FAULT_SEED wins)")
    parser.add_argument("--payload", choices=("affine", "sar"),
                        default="affine",
                        help="campaign model: hot-swappable affine, or "
                             "SAR top-k recommendation")
    parser.add_argument("--policy", choices=("least_loaded",
                                             "consistent_hash"),
                        default="least_loaded")
    parser.add_argument("--p99-target", type=float, default=None,
                        help="steady-state p99 budget in ms (default: the "
                             "SLO target for affine, 250 for sar)")
    parser.add_argument("--short", action="store_true",
                        help="short campaign (~30 s)")
    parser.add_argument("--quality", action="store_true",
                        help="model-quality campaign instead: covariate-"
                             "shift + latency storms judged by the "
                             "drift/alert plane")
    parser.add_argument("--malformed", action="store_true",
                        help="add a poison phase: a seeded malformed-"
                             "request flood (torn JSON / schema violation "
                             "/ NaN payloads) that must be answered with "
                             "structured, traced 400s and per-client 429 "
                             "shedding while healthy clients keep being "
                             "served")
    args = parser.parse_args(argv)
    if args.payload == "sar" and not args.quality:
        print("tools/torch_loadgen.py: the sar payload waits for the port of "
              "recommendation/ (mmlspark_tpu_torch has no recommendation.sar yet)",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    # shared across the router, the controller, and every replica process;
    # truncate so a re-run into the same --out folds only its own campaign.
    # Each replica writes its own events.jsonl@replica-<i> segment; clear
    # stale ones too or the merge would federate a previous run's ghosts.
    log = os.path.abspath(os.path.join(args.out, "events.jsonl"))
    open(log, "w").close()
    import glob

    for stale in glob.glob(glob.escape(log) + "@*"):
        os.unlink(stale)
    os.environ["MMLSPARK_TPU_EVENT_LOG"] = log
    os.environ.setdefault(
        "MMLSPARK_TPU_INCIDENT_DIR",
        os.path.abspath(os.path.join(args.out, "incidents")),
    )
    if args.quality:
        return run_quality_campaign(args)
    return run_campaign(args)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--clients":
        _clients_main(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
