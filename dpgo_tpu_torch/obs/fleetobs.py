"""Fleet-wide observability: cross-process harvest, merged generation
timelines, aggregated live endpoints, crash forensics — the port of
``dpgo_tpu.obs.fleetobs`` (the same functions and the same file formats,
so either package reads the other's run directories).

* **Generation-scoped run directories + harvest.**  ``launch_world``
  hands each rank its own run directory (``--telemetry-dir``); after each
  generation the parent's fail-open harvester reads every rank's
  ``events.jsonl`` tail (tail-tolerant: a SIGKILLed writer leaves a torn
  last line), the last published verdict word, and any ``blackbox.npz``,
  and folds them into one structured ``generation_postmortem`` event on
  the parent's run — the victim's forensics survive the victim.

* **Merged generation timeline.**  Workers stamp ``clock_sample`` pairs
  on the barrier round-trips, each process identifies itself with a
  fleet-plane actor id (``mh_rank_actor`` / ``proc_replica_actor``), and
  ``write_fleet_trace`` merges launcher + ranks into ONE
  Perfetto-loadable Chrome trace: barrier-wait spans, generation /
  respawn instants, and the kill as a ``process_lost`` instant on the
  victim's own track.

* **Aggregated live endpoints + resource sampling.**  ``FleetSidecar``
  serves fleet-level ``/metrics`` and ``/statusz`` (unreachable replicas
  *marked*, never fatal); ``ResourceSampler`` is a slow-cadence
  stdlib-only thread (RSS, open fds, thread count, queue depth).

Zero-overhead fence: the constructors are only reachable through the
``start_resource_sampler`` / ``attach_fleet_sidecar`` seams, which return
``None`` without a live run.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

from .events import read_events_meta
from .run import EVENTS_FILE, get_run

#: Default sampler cadence: slow — the point is soak trends over
#: minutes/hours, not per-request attribution.
DEFAULT_SAMPLE_INTERVAL_S = 5.0

#: Postmortem tail length: the victim's last N events, by name/time.
POSTMORTEM_TAIL = 8


# ---------------------------------------------------------------------------
# Resource sampling (stdlib only: no psutil in the image)
# ---------------------------------------------------------------------------

def sample_resources() -> dict:
    """One stdlib-only resource snapshot of THIS process: RSS bytes
    (``/proc/self/status`` VmRSS, falling back to ``ru_maxrss``), open
    fd count, and live thread count.  Fields are None where the platform
    offers no cheap reading."""
    rss = None
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                    break
    except (OSError, ValueError, IndexError):
        pass
    if rss is None:
        try:
            import resource

            # Linux reports ru_maxrss in KiB (peak, not current — still
            # monotone evidence for a leak gate).
            rss = int(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss) * 1024
        except Exception:
            rss = None
    fds = None
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    return {"rss_bytes": rss, "open_fds": fds,
            "threads": threading.active_count()}


class ResourceSampler:
    """Slow-cadence per-process resource sampler thread.

    Emits ``process_rss_bytes`` / ``process_open_fds`` /
    ``process_threads`` (and, with a ``queue_depth`` callable,
    ``serve_queue_depth``) both as labeled gauges on the run's registry
    (the fleet ``/metrics`` surface) and as ``metric`` events (the soak
    trend series ``regress.py --soak`` gates).  Construct only through
    ``start_resource_sampler`` — the telemetry fence (DPG002)."""

    def __init__(self, run, interval_s: float = DEFAULT_SAMPLE_INTERVAL_S,
                 queue_depth=None, **labels):
        self.run = run
        self.interval_s = float(interval_s)
        self._queue_depth = queue_depth
        self._labels = {k: str(v) for k, v in labels.items()
                        if v is not None}
        self._stop = threading.Event()
        self._g_rss = run.gauge("process_rss_bytes",
                                "resident set size of this process",
                                unit="B")
        self._g_fds = run.gauge("process_open_fds",
                                "open file descriptors of this process")
        self._g_thr = run.gauge("process_threads",
                                "live threads in this process")
        self._g_q = run.gauge("serve_queue_depth_sampled",
                              "sampled admission queue depth")
        self.samples = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dpgo-resource-sampler")
        self._thread.start()

    def sample_once(self) -> dict:
        s = sample_resources()
        if self._queue_depth is not None:
            try:
                s["queue_depth"] = int(self._queue_depth())
            except Exception:
                s["queue_depth"] = None
        if s["rss_bytes"] is not None:
            self._g_rss.set(float(s["rss_bytes"]), **self._labels)
            self.run.metric("process_rss_bytes", s["rss_bytes"], "B",
                            phase="fleet", **self._labels)
        if s["open_fds"] is not None:
            self._g_fds.set(float(s["open_fds"]), **self._labels)
            self.run.metric("process_open_fds", s["open_fds"],
                            phase="fleet", **self._labels)
        self._g_thr.set(float(s["threads"]), **self._labels)
        self.run.metric("process_threads", s["threads"], phase="fleet",
                        **self._labels)
        if s.get("queue_depth") is not None:
            self._g_q.set(float(s["queue_depth"]), **self._labels)
            self.run.metric("serve_queue_depth_sampled", s["queue_depth"],
                            phase="fleet", **self._labels)
        self.samples += 1
        return s

    def _loop(self) -> None:
        # First sample immediately: short-lived processes (one child per
        # generation) still leave at least one point in the series.
        while True:
            try:
                self.sample_once()
            except Exception:
                pass  # fail-open: sampling must never take the host down
            if self._stop.wait(self.interval_s):
                return

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "ResourceSampler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_resource_sampler(interval_s: float = DEFAULT_SAMPLE_INTERVAL_S,
                           queue_depth=None, run=None,
                           **labels) -> ResourceSampler | None:
    """The sampler's telemetry fence: None (and no thread) without a
    live run."""
    run = run if run is not None else get_run()
    if run is None:
        return None
    return ResourceSampler(run, interval_s=interval_s,
                           queue_depth=queue_depth, **labels)


# ---------------------------------------------------------------------------
# Cross-process harvest + crash forensics
# ---------------------------------------------------------------------------

def generation_run_dir(root, generation: int, rank) -> str:
    """The generation-scoped run directory layout one harvest pass
    globs: ``<root>/g<generation>-r<rank>`` (rank may be a replica id)."""
    return os.path.join(str(root), f"g{int(generation)}-r{rank}")


def harvest_run_dir(run_dir: str, tail: int = POSTMORTEM_TAIL) -> dict:
    """Fail-open post-mortem of one (possibly killed) process's run dir.

    Tail-tolerant: ``read_events_meta`` drops a torn final JSONL line (a
    SIGKILL mid-write) and reports ``truncated``.  Returns the event
    tally, the last ``tail`` events (name + stamps), the last published
    verdict word decoded (``rbcd.unpack_verdict``), and the blackbox
    pointer when the flight recorder dumped one.  Never raises."""
    out: dict = {"run_dir": str(run_dir), "events": 0, "truncated": False,
                 "tail": [], "last_verdict": None, "blackbox": None}
    try:
        events, truncated = read_events_meta(
            os.path.join(run_dir, EVENTS_FILE))
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    out["events"] = len(events)
    out["truncated"] = bool(truncated)
    out["tail"] = [
        {k: e[k] for k in ("event", "t_mono", "t_wall", "iteration",
                           "seq", "phase") if k in e}
        for e in events[-tail:]]
    for e in reversed(events):
        if e.get("event") == "verdict_publish":
            entry = {"seq": e.get("seq_boundary"),
                     "iteration": e.get("iteration"),
                     "word": e.get("word"), "key": e.get("key")}
            try:
                from ..models.rbcd import unpack_verdict

                entry["decoded"] = unpack_verdict(int(e["word"]))
            except Exception:
                pass
            out["last_verdict"] = entry
            break
    try:
        from .recorder import BLACKBOX_NPZ

        bb = os.path.join(run_dir, BLACKBOX_NPZ)
        if os.path.exists(bb):
            info: dict = {"path": bb}
            try:
                from .recorder import load_blackbox

                context, arrays = load_blackbox(bb)
                info["context"] = {
                    k: context[k] for k in ("reason", "iteration", "rank")
                    if isinstance(context, dict) and k in context}
                info["arrays"] = sorted(arrays) \
                    if hasattr(arrays, "__iter__") else None
            except Exception:
                pass
            out["blackbox"] = info
    except Exception:
        pass
    return out


def harvest_generation(run, generation: int, rank_dirs: dict,
                       outcomes: dict | None = None,
                       records: dict | None = None,
                       plane: str = "multihost",
                       lost_actor=None) -> dict | None:
    """Collect every rank's telemetry after one generation and emit the
    ``generation_postmortem`` event on the parent's run.

    ``rank_dirs`` maps rank/replica-id -> run dir; ``outcomes`` carries
    the launcher's ``_classify`` verdict per rank and ``records`` the
    per-rank result/fault JSON.  Dead ranks (``signal:*`` / ``crash:*``
    outcomes) additionally get a ``process_lost`` instant on their own
    timeline track (``lost_actor(rank) -> actor id``).  Entirely
    fail-open; returns the postmortem dict (None without a run)."""
    if run is None:
        return None
    from .trace import emit_span

    t0_mono, t0_wall = time.monotonic(), time.time()
    outcomes = outcomes or {}
    records = records or {}
    ranks: dict = {}
    for rank, d in sorted(rank_dirs.items(), key=lambda kv: str(kv[0])):
        entry = harvest_run_dir(d)
        entry["outcome"] = outcomes.get(rank)
        rec = records.get(rank)
        if isinstance(rec, dict):
            entry["record"] = {
                k: rec[k] for k in ("ok", "kind", "phase", "boundaries",
                                    "iterations", "final_cost",
                                    "host_syncs_per_100_rounds", "error")
                if k in rec}
            # The rank stamped its record at write time: the reverse
            # (rank -> parent) clock sample, paired with the spawn stamp
            # the worker recorded, makes the launcher<->rank offset
            # bidirectional.
            if "t_record_mono" in rec and lost_actor is not None:
                try:
                    from ..comms.protocol import ORIGIN_FLEET_PARENT

                    run.event("clock_sample", phase="comms",
                              src=int(lost_actor(rank)),
                              dst=ORIGIN_FLEET_PARENT,
                              channel="harvest", kind="record",
                              t_send_mono=float(rec["t_record_mono"]),
                              t_send_wall=float(rec.get("t_record_wall",
                                                        0.0)))
                except Exception:
                    pass
        lost = str(entry["outcome"] or "").startswith(("signal:", "crash:"))
        if lost and lost_actor is not None:
            try:
                last = entry["tail"][-1] if entry["tail"] else {}
                run.event("process_lost", phase="comms",
                          robot=int(lost_actor(rank)), rank=rank,
                          generation=int(generation),
                          outcome=entry["outcome"], plane=plane,
                          last_event=last.get("event"),
                          last_event_t_wall=last.get("t_wall"))
            except Exception:
                pass
        ranks[str(rank)] = entry
    post = {"generation": int(generation), "plane": plane, "ranks": ranks}
    try:
        run.event("generation_postmortem", phase="fleet", **post)
        # The harvest span doubles as the launcher stream's identity
        # anchor (its actor id homes the stream for the track mapper).
        from ..comms.protocol import ORIGIN_FLEET_PARENT

        emit_span(run, "harvest_generation", t0_mono, t0_wall,
                  time.monotonic() - t0_mono, phase="fleet",
                  robot=ORIGIN_FLEET_PARENT, generation=int(generation))
    except Exception:
        pass
    return post


def write_fleet_trace(paths: list, out_path: str) -> dict:
    """Merge launcher + rank/replica run dirs into ONE validated Chrome
    trace at ``out_path``; returns the validation counts plus the clock
    report.  Raises only on an invalid merged trace — missing streams
    are skipped (fail-open harvest of a partially-written fleet)."""
    from . import timeline

    live = [p for p in paths
            if os.path.exists(timeline._events_path(str(p)))]
    tl = timeline.merge([str(p) for p in live])
    timeline.write_chrome_trace(out_path, tl)
    counts = timeline.validate_chrome_trace(out_path)
    return {"trace": out_path, "streams": len(live), **counts,
            "clock": tl.offsets}


# ---------------------------------------------------------------------------
# Aggregated fleet endpoints
# ---------------------------------------------------------------------------

def _scrape(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", "replace")


class ReplicaFleetSource:
    """Snapshot provider over a ``ReplicaManager`` (anything with
    ``replicas()`` + ``status()``): per-replica status from the parent's
    own heartbeat surface plus each child sidecar's ``/metrics`` URL."""

    def __init__(self, manager):
        self.manager = manager

    def snapshot(self) -> dict:
        try:
            fleet = self.manager.status()
        except Exception as e:
            fleet = {"error": f"{type(e).__name__}: {e}"}
        replicas: dict = {}
        try:
            live = list(self.manager.replicas())
        except Exception:
            live = []
        for rep in live:
            server = getattr(rep, "server", rep)
            rid = str(getattr(rep, "replica_id",
                              getattr(server, "replica_id", None)))
            entry: dict = {"status": None,
                           "metrics_url": getattr(server, "metrics_url",
                                                  None)}
            try:
                entry["status"] = server.status()
            except Exception as e:
                entry["error"] = f"{type(e).__name__}: {e}"
            replicas[rid] = entry
        return {"fleet": fleet, "replicas": replicas}


class ServersFleetSource(ReplicaFleetSource):
    """Same surface over a plain list of servers (tests, ad-hoc CLI)."""

    def __init__(self, servers):
        self.servers = list(servers)

    def status(self):
        return {"replicas": len(self.servers)}

    def replicas(self):
        return self.servers

    @property
    def manager(self):
        return self

    @manager.setter
    def manager(self, _):
        pass


class FleetSidecar:
    """Fleet-level ``/metrics`` + ``/statusz`` on the launcher/manager.

    ``/metrics`` merges the parent run's registry (which already carries
    the per-replica heartbeat gauges) with each reachable child
    sidecar's scrape, every child sample tagged ``replica="<id>"``.
    ``/statusz`` is the per-replica status map with unreachable/dead
    replicas MARKED (``reachable: false``) instead of failing the whole
    payload — the contract ``report --live --fleet`` renders a partial
    fleet view from.  Construct only through ``attach_fleet_sidecar``
    (DPG002 fence)."""

    def __init__(self, source, run, host: str = "127.0.0.1",
                 port: int = 0, scrape_timeout_s: float = 2.0):
        from ..serve.statusz import MetricsSidecar  # route table reuse
        from ..obs.events import _jsonable
        from .exporters import merge_prometheus_texts, to_prometheus_text
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.source = source
        self.run = run
        self.scrape_timeout_s = float(scrape_timeout_s)
        sidecar = self
        del MetricsSidecar  # shape reference only; routes differ

        def metrics_body():
            snap = sidecar.source.snapshot()
            parts = {"": to_prometheus_text(sidecar.run.registry)}
            for rid, entry in snap.get("replicas", {}).items():
                url = entry.get("metrics_url")
                if not url:
                    continue
                try:
                    parts[rid] = _scrape(url, sidecar.scrape_timeout_s)
                except Exception:
                    # A replica dying mid-scrape must not fail the
                    # aggregate; its absence IS the signal (statusz
                    # marks it unreachable).
                    continue
            return merge_prometheus_texts(parts)

        def statusz_body():
            snap = sidecar.source.snapshot()
            replicas = {}
            for rid, entry in snap.get("replicas", {}).items():
                st = entry.get("status")
                reachable = bool(st) and not st.get("closed", False) \
                    and st.get("child_alive", True) is not False
                replicas[rid] = {"reachable": reachable, "status": st,
                                 **({"error": entry["error"]}
                                    if entry.get("error") else {})}
            return {"fleet": snap.get("fleet", {}),
                    "replicas": replicas,
                    "run": sidecar.run.run_id}

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                from ..serve.statusz import PROMETHEUS_CONTENT_TYPE

                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = metrics_body().encode("utf-8")
                        ctype, code = PROMETHEUS_CONTENT_TYPE, 200
                    elif path in ("/statusz", "/healthz"):
                        body = json.dumps(
                            _jsonable(statusz_body())).encode("utf-8")
                        ctype, code = "application/json", 200
                    else:
                        body = json.dumps(
                            {"error": f"unknown path {path!r}",
                             "paths": ["/metrics", "/statusz",
                                       "/healthz"]}).encode("utf-8")
                        ctype, code = "application/json", 404
                except Exception as e:  # never take the scrape loop down
                    body = json.dumps({"error": repr(e)}).encode("utf-8")
                    ctype, code = "application/json", 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        try:
            self._httpd.daemon_threads = True
            self.host, self.port = self._httpd.server_address[:2]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="dpgo-fleet-metrics")
            self._thread.start()
        except BaseException:
            # Never strand the bound socket on a failed start
            # (leakcheck-enforced contract, same as MetricsSidecar).
            self._httpd.server_close()
            raise

    def close(self) -> None:
        try:
            self._httpd.shutdown()
        finally:
            self._httpd.server_close()
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "FleetSidecar":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def attach_fleet_sidecar(source, host: str = "127.0.0.1", port: int = 0,
                         run=None, **kw) -> FleetSidecar | None:
    """The fleet sidecar's telemetry fence: None (no HTTP thread, no
    socket) without a live run."""
    run = run if run is not None else get_run()
    if run is None:
        return None
    return FleetSidecar(source, run, host=host, port=port, **kw)
