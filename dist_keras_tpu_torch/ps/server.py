"""Fault-tolerant center-variable parameter server (stdlib HTTP), a copy
of the JAX package's ``ps/server.py``: the same endpoints, verdicts,
events, metrics and checkpoint layout (a center either package's server
saved restores in the other).  The center stays on the host, in numpy;
a port model's params (torch tensors, on the card or not) are turned
into numpy at the door (``PSServer(params=...)``), so no tensor reaches
the center or the wire.

The async optimizer family's missing runtime half: a process holding
the authoritative weights (:class:`~dist_keras_tpu_torch.ps.center.
CenterVariable`) behind four endpoints, in the ``serving/server.py``
style — typed error mapping, graceful SIGTERM drain through the
EXISTING ``resilience.preemption`` path, ``/healthz`` + ``/metricsz``:

- ``POST /join``   — register a worker lease; the response doubles as
  the worker's first pull (late joiners pull-and-go).
- ``POST /pull``   — center + version (renews the caller's lease).
- ``POST /commit`` — apply one window delta with server-side DynSGD
  staleness scaling ``1/(1+staleness)``; over-cap staleness -> **409**
  (typed ``StaleCommit``), draining -> **503**, malformed -> **400**.
- ``GET /healthz`` — 200 serving / 503 draining;
  ``GET /metricsz`` — center stats + metrics registry (JSON;
  ``?format=prometheus`` answers 501 until ``observability/prometheus.py``
  is ported, ROADMAP queue 1, item 18).

**Elastic membership is the normal case.**  Workers hold leases
(``DK_PS_LEASE_S``); the reaper thread drops a lapsed worker from
staleness accounting instead of stalling the pod, and — when the
launcher exported a coordination plane (``DK_COORD_DIR`` /
``DK_COORD_WORLD``) — also lapses workers whose host the heartbeat
files convict (``coordination.dead_peers_at``: the same host-drop
evidence ``Job.supervise_run`` shrinks around).  A killed worker's
replacement just joins; a restarted worker's first commit auto-rejoins
with its staleness already discounting whatever it missed.

**The center variable survives the server.**  With ``ckpt_dir`` set,
the center checkpoints through the round-14 async ``Checkpointer``
pipeline every ``ckpt_every_commits`` commits (step = commit clock) and
once more on drain (waited — the durability barrier).  A restarted
server resumes from the latest PROMOTED VERIFIED step; workers'
in-flight commits tagged with a newer version than the restored clock
apply at staleness 0 (clamped — see ``center.py``), and everyone else
re-pulls and keeps going.
"""

from __future__ import annotations

import json
import pickle
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dist_keras_tpu_torch.observability import events, spans
from dist_keras_tpu_torch.observability import metrics as _metrics
from dist_keras_tpu_torch.resilience import preemption
from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.utils.bridge import params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_leaves
from dist_keras_tpu_torch.utils.serialization import (pickle_object,
                                                unpickle_object)
from dist_keras_tpu_torch.ps import compress
from dist_keras_tpu_torch.ps.center import CenterVariable, StaleCommit


def _host_params(params):
    """A port model's params (``torch.Tensor`` leaves, on any device) ->
    numpy, bit for bit; a numpy tree passes through.  The center and
    everything on the wire stay numpy: a CUDA tensor never goes into a
    pickle."""
    if any(isinstance(a, torch.Tensor) for a in tree_leaves(params)):
        return params_to_numpy(params)
    return params


def default_port(fallback=0):
    """The port a launched PS server binds: ``DK_PS_PORT``, else
    ``fallback``."""
    try:
        return int(knobs.raw("DK_PS_PORT") or fallback)
    except ValueError:
        return fallback


class _Handler(BaseHTTPRequestHandler):
    server_version = "dk-ps/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: the event log is the log
        pass

    def _reply_bytes(self, code, body, content_type):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code, payload, ):
        self._reply_bytes(code, json.dumps(payload).encode("utf-8"),
                          "application/json")

    def _reply_pickle(self, payload):
        self._reply_bytes(200, pickle_object(payload),
                          "application/octet-stream")

    def do_GET(self):
        srv = self.server
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            if srv.draining:
                self._reply_json(503, {"status": "draining"})
            else:
                st = srv.center.stats()
                self._reply_json(200, {"status": "serving",
                                       "clock": st["clock"],
                                       "workers": st["workers"]})
        elif path == "/metricsz":
            if "format=prometheus" in query:
                self._reply_json(501, {
                    "error": "not_implemented",
                    "detail": "/metricsz?format=prometheus "
                              "(observability/prometheus.py) is not "
                              "ported yet (ROADMAP queue 1, item 18)"})
            else:
                self._reply_json(200, {"ps": srv.center.stats(),
                                       "registry": _metrics.snapshot()})
        else:
            self._reply_json(404, {"error": "not_found",
                                   "path": self.path})

    def do_POST(self):
        srv = self.server
        path = self.path.split("?")[0]
        # the body is consumed BEFORE any early reply: this is an
        # HTTP/1.1 keep-alive server, and answering 404/503 with the
        # request body still unread would desynchronize the connection
        # framing (the unread pickled delta parses as the next
        # request line)
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            n = 0
        body = self.rfile.read(n)
        if path not in ("/join", "/pull", "/commit"):
            self._reply_json(404, {"error": "not_found",
                                   "path": self.path})
            return
        if srv.draining:
            # rejected at the door, typed: a draining/restarting server
            # is a RETRYABLE condition for the worker's policy
            self._reply_json(503, {"error": "draining"})
            return
        try:
            doc = unpickle_object(body)
            if not isinstance(doc, dict):
                raise ValueError("payload must be a dict")
        # pickle.UnpicklingError (corrupt/truncated body) and
        # AttributeError (version-skewed payload naming a class this
        # tree lacks) are caller bugs too: typed 400, never a dead
        # handler the client misreads as an unreachable server
        except (ValueError, KeyError, TypeError, EOFError,
                ImportError, AttributeError, IndexError,
                pickle.UnpicklingError) as e:
            self._reply_json(400, {"error": "bad_request",
                                   "detail": str(e)[:200]})
            return
        if path == "/join":
            self._join(srv, doc)
        elif path == "/pull":
            self._pull(srv, doc)
        else:
            self._commit(srv, doc)

    def _join(self, srv, doc):
        wid, version, center, rejoined = srv.center.join(
            wid=doc.get("wid"), rank=doc.get("rank"))
        st = srv.center.stats()
        _metrics.counter("ps.joins").inc()
        _metrics.gauge("ps.workers").set(st["workers"])
        # worker_rank, not rank: every event record already carries
        # the EMITTER's rank (the server's) — the schema field must
        # not be clobbered by the joining worker's identity
        events.emit("ps_worker_join", wid=wid,
                    worker_rank=doc.get("rank"), rejoined=rejoined,
                    version=version, workers=st["workers"])
        self._reply_pickle({"wid": wid, "version": version,
                            "center": center, "rejoined": rejoined,
                            "window": srv.window,
                            "lease_s": srv.center.lease_s})

    def _pull(self, srv, doc):
        version, center = srv.center.pull(wid=doc.get("wid"))
        _metrics.counter("ps.pulls").inc()
        events.emit("ps_pull", wid=doc.get("wid"), version=version)
        self._reply_pickle({"version": version, "center": center})

    def _commit(self, srv, doc):
        wid = doc.get("wid")
        try:
            version = int(doc["version"])
            delta = doc["delta"]
        except (KeyError, TypeError, ValueError) as e:
            self._reply_json(400, {"error": "bad_request",
                                   "detail": str(e)[:200]})
            return
        # in-flight accounting: drain() must not snapshot the final
        # checkpoint while a commit that passed the draining door is
        # still mutating the center — begin/end bracket the apply
        if not srv.commit_begin():
            self._reply_json(503, {"error": "draining"})
            return
        try:
            self._commit_inner(srv, doc, wid, version, delta)
        finally:
            srv.commit_end()

    def _commit_inner(self, srv, doc, wid, version, delta):
        try:
            with spans.span("ps.commit", wid=wid, version=version):
                # dequantize a DK_PS_COMPRESS wire delta to float32
                # BEFORE DynSGD scaling — the center-update algebra
                # (the dynsgd.py bit-parity surface) stays codec-blind;
                # a plain float32 tree passes through untouched
                delta = compress.decode_tree(delta)
                info = srv.center.commit(
                    wid, version, delta,
                    commit_id=doc.get("commit_id"),
                    rank=doc.get("rank"))
        except (KeyError, IndexError, ValueError, TypeError) as e:
            # a structurally-foreign delta (wrong pytree keys / leaf
            # shapes — a worker built against a different model, or a
            # malformed compressed record) is
            # the CALLER's bug: a typed 400, never a dead handler the
            # client would misread as an unreachable server
            self._reply_json(400, {
                "error": "bad_request",
                "detail": ("delta does not match the center "
                           f"variable's structure: {type(e).__name__}:"
                           f" {str(e)[:160]}")})
            return
        except StaleCommit as e:
            _metrics.counter("ps.rejected_stale").inc()
            # same kind as the applied-scaling event, distinguished by
            # rejected=True: both are "staleness shaped this commit"
            events.emit("ps_stale_scaled", wid=wid,
                        staleness=e.staleness, cap=e.cap,
                        rejected=True)
            self._reply_json(409, {"error": "stale_commit", "wid": wid,
                                   "staleness": e.staleness,
                                   "cap": e.cap})
            return
        if info["duplicate"]:
            # idempotent replay of a response-lost retry: nothing was
            # applied, so no commit metrics/events and no checkpoint
            # cadence — the reply is effectively a pull
            self._reply_pickle({"version": info["version"],
                                "staleness": info["staleness"],
                                "scale": info["scale"],
                                "center": info["center"],
                                "rejoined": info["rejoined"],
                                "duplicate": True})
            return
        _metrics.counter("ps.commits").inc()
        _metrics.gauge("ps.clock").set(info["version"])
        _metrics.histogram("ps.staleness").observe(info["staleness"])
        events.emit("ps_commit", wid=wid, version=info["version"],
                    staleness=info["staleness"], scale=info["scale"],
                    rejoined=info["rejoined"])
        if info["staleness"] > 0:
            _metrics.counter("ps.stale_scaled").inc()
            events.emit("ps_stale_scaled", wid=wid,
                        staleness=info["staleness"],
                        scale=info["scale"], rejected=False)
        srv.maybe_checkpoint(info["version"])
        self._reply_pickle({"version": info["version"],
                            "staleness": info["staleness"],
                            "scale": info["scale"],
                            "center": info["center"],
                            "rejoined": info["rejoined"],
                            "duplicate": False})


class PSServer(ThreadingHTTPServer):
    """Threaded HTTP server wrapping one :class:`CenterVariable`.

    ``params`` seeds the center variable; with ``ckpt_dir`` set and a
    promoted verified step on disk, the restored center WINS (server
    restart resumes the run — ``params`` is only the cold-start seed).
    ``port=None`` binds ``DK_PS_PORT`` (the launch export); ``port=0``
    picks a free one (tests).
    """

    daemon_threads = True

    def __init__(self, params=None, host="127.0.0.1", port=None,
                 ckpt_dir=None, ckpt_every_commits=50, window=None,
                 lease_s=None, staleness_cap=None, checkpointer=None):
        self.window = int(knobs.get("DK_PS_WINDOW")
                          if window is None else window)
        if self.window < 1:
            raise ValueError(
                f"communication window must be >= 1, got "
                f"{self.window} (window=0 would make every worker's "
                "training loop spin on empty commits forever)")
        self.ckpt_every_commits = max(1, int(ckpt_every_commits))
        self._ckptr = checkpointer
        if self._ckptr is None and ckpt_dir is not None:
            from dist_keras_tpu_torch.checkpoint import Checkpointer

            # rank/world pinned: the PS is ONE process regardless of
            # what DK_COORD_* the launcher exported for the workers.
            # diff=True routes the center's periodic saves through the
            # content-addressed DIFFERENTIAL path (round 18): the
            # center churns but its frozen leaves (integer RNG state,
            # frozen towers) hash identical save over save, so each
            # cadence rewrites only what moved — inert until leaves
            # cross DK_CKPT_CHUNK_MB, and DK_CKPT_VERIFY=0 disables
            # it with the hashing it needs.
            self._ckptr = Checkpointer(ckpt_dir, rank=0, world=1,
                                       diff=True)
        clock = 0
        restored_step = None
        if self._ckptr is not None:
            restored_step = self._ckptr.latest_verified_step()
            if restored_step is not None:
                _, state = self._ckptr.restore(step=restored_step)
                params = state["center"]
                clock = int(np.asarray(state["clock"]))
        if params is None:
            raise ValueError(
                "PSServer needs initial params (none given and no "
                "promoted verified checkpoint to resume from)")
        params = _host_params(params)
        self.center = CenterVariable(params, clock=clock,
                                     lease_s=lease_s,
                                     staleness_cap=staleness_cap)
        self.restored_step = restored_step
        self.preempted_signum = None
        self._stop_watch = None
        self._thread = None
        self._reaper_stop = threading.Event()
        self._reaper_thread = None
        # guards the async-save handle (written from handler threads
        # AND the drain path) and the last step already enqueued
        self._ckpt_lock = threading.Lock()
        self._last_handle = None
        self._ckpt_enqueued = clock
        # in-flight commit accounting: drain() waits for every commit
        # that passed the admission door before taking the FINAL
        # center snapshot (a late apply after the final save would make
        # the promoted checkpoint silently older than the live center)
        self._inflight_cv = threading.Condition()
        self._inflight_commits = 0
        # lifecycle guard — same contract as ServingServer: shutdown()
        # blocks forever unless serve_forever is running, and drain
        # must be safe from any thread at any lifecycle stage
        self._lifecycle = threading.Lock()
        self._serving = False
        self._stopping = False
        self._draining = False
        if port is None:
            port = default_port(fallback=0)
        super().__init__((host, int(port)), _Handler)

    @property
    def address(self):
        """(host, bound_port) — port resolved after bind."""
        return self.server_address[:2]

    @property
    def draining(self):
        with self._lifecycle:
            return self._draining

    # -- in-flight commit accounting -----------------------------------
    def commit_begin(self):
        """Admit one commit apply; -> False once draining (the caller
        answers a typed 503).  Every True is balanced by
        :meth:`commit_end` — what drain's final-snapshot wait counts.
        The draining check and the increment are ATOMIC under the
        condition: either this commit's increment is visible to
        drain's wait, or drain's flag was visible here and the commit
        was rejected — never a commit drain can miss."""
        with self._inflight_cv:
            if self.draining:
                return False
            self._inflight_commits += 1
        return True

    def commit_end(self):
        with self._inflight_cv:
            self._inflight_commits -= 1
            self._inflight_cv.notify_all()

    # -- checkpointing -------------------------------------------------
    def maybe_checkpoint(self, clock):
        """Enqueue an async center save when the commit clock crossed
        the cadence (called from handler threads after each commit;
        the loop never waits — the handle is the durability barrier,
        waited on drain).  No-op while draining: the drain path's
        FINAL save must not be superseded by a late cadence save."""
        if self._ckptr is None or self.draining:
            return
        with self._ckpt_lock:
            if clock - self._ckpt_enqueued < self.ckpt_every_commits:
                return
            self._ckpt_enqueued = clock
        self._save()

    def _save(self):
        """Snapshot-and-enqueue the center (step = its clock AT the
        snapshot — the commit that crossed the cadence and any that
        landed since are both covered by whatever state() reads)."""
        if self._ckptr is None:
            return None
        c, center = self.center.state()
        handle = self._ckptr.save(
            int(c), {"center": center, "clock": np.int64(c)})
        with self._ckpt_lock:
            self._last_handle = handle
        return handle

    def checkpoint_now(self, timeout_s=None):
        """Synchronous center save (drain path / tests): enqueue and
        WAIT the handle; -> the promoted step, or None without a
        checkpointer."""
        handle = self._save()
        if handle is None:
            return None
        if timeout_s is None:
            from dist_keras_tpu_torch.resilience import coordination

            timeout_s = coordination.default_timeout_s()
        return handle.wait(timeout_s=timeout_s)

    # -- lease reaper ---------------------------------------------------
    def _reap_once(self, now=None):
        """One reaper pass: TTL lapses + coordination-plane host-drop
        evidence.  -> [(wid, rank, reason)] lapsed this pass."""
        dead = [(wid, rank, "lease") for wid, rank
                in self.center.reap(now=now)]
        coord_dir = knobs.raw("DK_COORD_DIR")
        world = knobs.raw("DK_COORD_WORLD")
        if coord_dir and world:
            try:
                from dist_keras_tpu_torch.resilience import coordination

                # require_file: only beat-then-went-dark ranks convict
                # (the PeerLost evidence standard) — a worker still
                # importing jax is slow, not dead
                gone = coordination.dead_peers_at(
                    coord_dir, int(world), require_file=True)
                for wid, rank in self.center.workers_by_rank(gone):
                    if self.center.lapse(wid):
                        dead.append((wid, rank, "host_drop"))
            # dklint: ignore[broad-except] the evidence probe is best-effort — a torn heartbeat dir must not kill the reaper; TTL lapses still run
            except Exception:
                pass
        if dead:
            st = self.center.stats()
            _metrics.gauge("ps.workers").set(st["workers"])
            for wid, rank, reason in dead:
                _metrics.counter("ps.lapses").inc()
                events.emit("ps_worker_lapse", wid=wid,
                            worker_rank=rank, reason=reason,
                            workers=st["workers"])
        return dead

    def _reaper_loop(self):
        interval = max(0.05, min(1.0, self.center.lease_s / 4.0))
        while not self._reaper_stop.is_set():
            self._reap_once()
            self._reaper_stop.wait(interval)

    # -- lifecycle ------------------------------------------------------
    def serve_forever(self, poll_interval=0.5):
        with self._lifecycle:
            if self._stopping:
                return  # a drain/close already won the race: stay down
            self._serving = True
        try:
            super().serve_forever(poll_interval)
        finally:
            with self._lifecycle:
                self._serving = False

    def _stop_listener(self):
        with self._lifecycle:
            self._stopping = True
            serving = self._serving
        if serving:
            self.shutdown()
        self.server_close()

    def start(self):
        """Serve on a background thread; -> (host, port)."""
        self._reaper_thread = threading.Thread(
            target=self._reaper_loop, daemon=True, name="dk-ps-reaper")
        self._reaper_thread.start()
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="dk-ps-http")
        self._thread.start()
        return self.address

    def install_signal_drain(self, poll_s=0.05):
        """SIGTERM/SIGINT -> graceful drain via the existing
        ``resilience.preemption`` watcher path (flag-only handler)."""
        installed = preemption.install(strict=False)
        self._stop_watch = preemption.on_request(self._drain_on_signal,
                                                 poll_s=poll_s)
        return installed

    def _drain_on_signal(self, signum):
        self.preempted_signum = signum
        self.drain()

    def drain(self, timeout_s=None):
        """Stop admission (new RPCs answer typed 503), wait out every
        commit that already passed the door, take the final center
        checkpoint and WAIT it (the durability barrier), stop the
        reaper and the listener.  Idempotent.  -> the promoted final
        step (None without a checkpointer)."""
        with self._lifecycle:
            already = self._draining
            self._draining = True
        step = None
        if not already:
            if timeout_s is None:
                from dist_keras_tpu_torch.resilience import coordination

                timeout_s = coordination.default_timeout_s()
            # ONE deadline for the whole drain (the repo's SIGTERM→exit
            # contract): the in-flight wait and the final-save handle
            # wait share it — two stacked full timeouts would double
            # the grace window a scheduler actually grants
            deadline = _world.monotonic() + float(timeout_s)
            # a commit that read draining=False a moment ago may still
            # be applying: the final snapshot must include it (bounded
            # — a wedged handler degrades to draining what is there)
            with self._inflight_cv:
                self._inflight_cv.wait_for(
                    lambda: self._inflight_commits == 0,
                    timeout=max(0.0, deadline - _world.monotonic()))
            step = self.checkpoint_now(
                timeout_s=max(0.0, deadline - _world.monotonic()))
            self._reaper_stop.set()
        self._stop_listener()
        return step

    def run_forever(self):
        """Serve on the CALLING thread until stopped; after a
        signal-initiated drain re-raises :class:`Preempted` so the
        process exits ``128+signum``."""
        if self._reaper_thread is None:
            self._reaper_thread = threading.Thread(
                target=self._reaper_loop, daemon=True,
                name="dk-ps-reaper")
            self._reaper_thread.start()
        try:
            self.serve_forever()
        finally:
            self.server_close()
        if self.preempted_signum is not None:
            raise preemption.Preempted(self.preempted_signum)

    def close(self):
        if self._stop_watch is not None:
            self._stop_watch()
        self._reaper_stop.set()
        self._stop_listener()
        with self._ckpt_lock:
            handle = self._last_handle
        if handle is not None and not handle.done():
            handle.wait(timeout_s=30.0)
        if self._reaper_thread is not None:
            self._reaper_thread.join(timeout=5.0)
