"""Remote job deployment — parity with ``distkeras/job_deployment.py``;
a copy of the JAX package's ``launch/job.py`` (it is framework free) on
the port's ``world``, ``faults``, ``retry``, ``coordination``,
``supervisor``, ``elastic``, ``knobs`` and ``observability``.

The reference packages a job directory, rsyncs it to a cluster head node and
launches ``spark-submit`` over ssh (job_deployment.py:~30-110), with
``Punchcard`` (:~150) polling a JSON manifest of secret-authenticated jobs.

Here the target is a set of GPU hosts instead of a Spark head node; each
host gets the synced job directory and runs the same Python entrypoint,
which brings up its ``torch.distributed`` group through
``comm.initialize`` from the exported ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` (process id = host index,
coordinator = host 0; the names are the JAX package's, so one job
descriptor launches either package).  A JAX host process drives every
device of its host; a rank of the port holds one card, so a host with
several cards runs the per-card fan-out as its command
(``python="python3 -m dist_keras_tpu_torch.launch.local"``,
``launch/local.py``): one rank per card, ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` beside these variables, the host's exit code and
heartbeat kept one per host.  Transport is still rsync+ssh —
that part of the reference's design is infrastructure-agnostic and
survives unchanged.

``dry_run=True`` collects the command lines instead of executing them, which
is also how the unit tests exercise this layer without a cluster.

Transient-fault absorption: each per-host rsync/ssh command is
retried with backoff (``retries`` attempts beyond the first; the
``"job.rsync"`` / ``"job.ssh"`` fault points let tests fail exactly the
Nth command without a cluster), and ``Punchcard.read_manifest`` retries
torn reads (a writer mid-rewrite is a transient JSON error, not a dead
manifest).  A job that still fails after its retry budget keeps the
previous semantics: nonzero rc, re-attempted on the next poll.

Per-host liveness: a job with ``coord_dir`` (a shared path)
exports ``DK_COORD_DIR``/``DK_COORD_RANK``/``DK_COORD_WORLD`` to every
host, whose training process then heartbeats
``<coord_dir>/hb/rank_{i}`` (``resilience.coordination.Heartbeat``,
``"job.heartbeat"`` fault point) and gains real cluster consensus for
coordinated preemption.  ``Job.dead_hosts()`` reads the same files from
the launcher side and names WHICH host went dark.

Serving jobs + live monitoring: ``serve_port`` exports
``DK_SERVE_PORT`` per host (an entrypoint that starts
``dist_keras_tpu_torch.serving.server.ServingServer(port=None)`` binds it), and
``Job.monitor(interval_s)`` is the launcher-side live loop tailing
``dead_hosts()`` plus the merged observability report, printing only
transitions.

Launcher-side auto-resume: ``Job(supervise=N)`` (or a dict
of knobs) arms :meth:`supervise_run`, which watches ``dead_hosts()``
and, when any host is heartbeat-dead, RELAUNCHES the whole pod as a
fresh incarnation over the existing rsync/ssh retry surfaces, rotating
``DK_COORD_SESSION`` per wave so the new incarnation's FileCoordinator
rendezvous never mixes with the dead one's markers (membership is
fixed per incarnation — survivors of a dead peer are already dying of
``PeerLost``, so the recovery unit is the pod, torchelastic-style);
liveness is then judged in the NEW session's heartbeat directory.  The
entrypoint is expected to resume from the committed checkpoint itself
(``Trainer(resume=True)`` — restore verifies integrity manifests and
falls back past a corrupt step).  The relaunch budget is the same
rolling-window
:class:`~dist_keras_tpu_torch.resilience.supervisor.RestartBudget` the
in-process ``supervise()`` loop uses, one recording per WAVE: past it,
a typed ``CrashLoop`` with the window's evidence — a flapping host
never flaps forever.

ELASTIC world resize: a host that never comes back after a
relaunch wave (repeat evidence: nonzero recorded rc, or heartbeats
that beat and went dark again in the new session) is DROPPED instead
of burning the budget forever — the next wave launches the surviving
host set with ranks re-seated, ``DK_COORD_*`` re-exported and the
session rotated (``elastic_resize`` event + operator alert).  The
relaunched workers find ``saved_world != current_world`` at restore
and reshard through ``resilience.elastic``.  ``DK_ELASTIC`` /
``DK_ELASTIC_MIN_WORLD`` (or ``supervise={"elastic": ...,
"min_world": ...}``) govern it; membership still only changes across
incarnations, never mid-run.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import subprocess

from dist_keras_tpu_torch.resilience import world as _world
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.resilience.retry import RetryPolicy

_SAFE_NAME = re.compile(r"^[A-Za-z0-9._-]+$")
# user@host, hostnames, IPv4/IPv6 — must not start with '-' (ssh/rsync
# would parse it as an option)
_SAFE_HOST = re.compile(r"^[A-Za-z0-9_\[][A-Za-z0-9._@:\[\]-]*$")


class CommandFailed(OSError):
    """A per-host rsync/ssh command returned nonzero — retryable."""

    def __init__(self, cmd, rc):
        super().__init__(f"rc={rc}: {' '.join(map(str, cmd))}")
        self.cmd = cmd
        self.rc = int(rc)


class Job:
    """Package + ship + launch a training job on GPU hosts.

    Args (reference-parity where applicable, job_deployment.py:~30):
      secret: shared secret used by Punchcard authentication.
      job_name: name (used as the remote directory).
      job_dir: local directory containing the user's training code.
      entrypoint: python file (relative to job_dir) to run on every host.
      hosts: list of ssh-reachable host addresses (host 0 = coordinator).
      coordinator_port: port of the ``torch.distributed`` rendezvous
        (host 0).
      num_processes: defaults to len(hosts).
    """

    def __init__(self, secret, job_name, job_dir, entrypoint="main.py",
                 hosts=(), coordinator_port=8476, num_processes=None,
                 remote_root="~/jobs", python="python3", dry_run=False,
                 retries=2, retry_backoff=0.5, launch_retries=0,
                 coord_dir=None, coord_timeout_s=None, obs_dir=None,
                 serve_port=None, route_port=None, supervise=None,
                 metrics_port=None, obs_sample_s=None, trace_id=None,
                 slo=False, trace_sample=None, trace_retain=False,
                 ps_addr=None, ps_window=None, runner=None):
        self.secret = secret
        # job_name becomes a remote path component and Punchcard feeds it
        # from a JSON manifest — reject anything shell-/path-unsafe
        if not _SAFE_NAME.match(str(job_name)):
            raise ValueError(
                f"job_name {job_name!r} must match [A-Za-z0-9._-]+")
        self.job_name = job_name
        self.job_dir = os.path.abspath(job_dir)
        self.entrypoint = entrypoint
        self.hosts = list(hosts)
        for h in self.hosts:
            if not _SAFE_HOST.match(str(h)):
                raise ValueError(
                    f"host {h!r} is not a valid ssh destination")
        self.coordinator_port = int(coordinator_port)
        self.num_processes = (int(num_processes) if num_processes
                              else len(self.hosts))
        # remote_root is interpreted by the remote shell (both rsync and
        # ssh); restrict to path-safe characters
        if not re.match(r"^[A-Za-z0-9._/~-]+$", str(remote_root)):
            raise ValueError(
                f"remote_root {remote_root!r} must match [A-Za-z0-9._/~-]+")
        self.remote_root = remote_root
        self.python = python
        self.dry_run = dry_run
        # per-command retry budget: ``retries`` extra attempts with
        # exponential backoff from ``retry_backoff`` seconds — a flaky
        # rsync hop no longer needs an operator re-send.  The LAUNCH ssh
        # is NOT retried by default (``launch_retries=0``): its remote
        # ``nohup ... &`` is not idempotent, so a connection dropped
        # AFTER the fork would re-start a duplicate training process on
        # that host (two processes claiming one process-group rank).  A
        # failed launch surfaces as nonzero rc; Punchcard's next poll
        # re-sends the whole job — the operator-visible, job-granular
        # retry.  Raise ``launch_retries`` only if your entrypoint
        # guards itself against double-start.
        self.retry_policy = RetryPolicy(
            attempts=int(retries) + 1, backoff=float(retry_backoff),
            jitter=0.1, retryable=(CommandFailed,))
        self.launch_retry_policy = RetryPolicy(
            attempts=int(launch_retries) + 1, backoff=float(retry_backoff),
            jitter=0.1, retryable=(CommandFailed,))
        # coord_dir: a SHARED path (NFS/GCS-fuse) every host and the
        # launcher can reach.  When set, each host's env gets
        # DK_COORD_* so the training processes' FileCoordinator
        # heartbeats per-host liveness files there, and the launcher can
        # report WHICH host died via dead_hosts().  One directory per
        # job incarnation: the restart loop should rotate it (or export
        # DK_COORD_SESSION=<attempt>).
        if coord_dir is not None \
                and not re.match(r"^[A-Za-z0-9._/~-]+$", str(coord_dir)):
            raise ValueError(
                f"coord_dir {coord_dir!r} must match [A-Za-z0-9._/~-]+")
        self.coord_dir = coord_dir
        # coord_timeout_s: the cluster-wide collective deadline exported
        # as DK_COORD_TIMEOUT_S — coordination.default_timeout_s() and
        # comm.barrier's default both read it, so one launch-config knob
        # governs every "how long before a dead peer is a typed error"
        # decision on every host
        self.coord_timeout_s = (None if coord_timeout_s is None
                                else float(coord_timeout_s))
        # obs_dir: per-host event-log directory (DK_OBS_DIR) — the run
        # telemetry plane (observability subsystem).  Usually a path on
        # each host's local disk; collect_obs() rsyncs every host's
        # directory back so `python -m dist_keras_tpu_torch.observability`
        # can merge the timeline launcher-side.  A shared-fs path works
        # too (the event files are per-rank, so hosts never contend).
        if obs_dir is not None \
                and not re.match(r"^[A-Za-z0-9._/~-]+$", str(obs_dir)):
            raise ValueError(
                f"obs_dir {obs_dir!r} must match [A-Za-z0-9._/~-]+")
        self.obs_dir = obs_dir
        # serve_port: when set, every host's env gets DK_SERVE_PORT, so
        # an entrypoint that starts a serving front end
        # (dist_keras_tpu_torch.serving.ServingServer with port=None) binds
        # the same operator-chosen port on every host — one launch-config
        # knob turns a training job descriptor into a serving-job one
        self.serve_port = None if serve_port is None else int(serve_port)
        # route_port: the serving-FABRIC knob on top of serve_port.
        # When set (requires serve_port), every host's env additionally
        # gets DK_ROUTE_PORT plus DK_ROUTE_BACKENDS — the full pod's
        # host:serve_port list — so a router entrypoint
        # (python -m dist_keras_tpu_torch.serving.router) on any host fronts
        # the whole pod, and the supervisor's elastic shrink naturally
        # narrows the exported backend list on the next relaunch wave.
        if route_port is not None and serve_port is None:
            raise ValueError("route_port requires serve_port (the "
                             "backends the router would front)")
        self.route_port = None if route_port is None else int(route_port)
        # metrics_port: when set, every host's env gets DK_METRICS_PORT
        # and its training/serving process brings up the standalone
        # Prometheus exporter (observability.prometheus) on that port —
        # one scrape config covers the whole pod.  obs_sample_s exports
        # DK_OBS_SAMPLE_S, arming the per-host MetricsSampler (time
        # series + anomaly watchdog) at that cadence.
        self.metrics_port = (None if metrics_port is None
                             else int(metrics_port))
        self.obs_sample_s = (None if obs_sample_s is None
                             else float(obs_sample_s))
        # slo / trace_sample / trace_retain: the SLO plane.
        # slo=True exports DK_SLO=1 on every host (default objectives,
        # burn-rate watchdog rule, exemplar capture); trace_retain=True
        # exports DK_TRACE_RETAIN=1 (tail-based span retention);
        # trace_sample exports DK_TRACE_SAMPLE (healthy-trace
        # head-sampling rate for the retention policy).
        self.slo = bool(slo)
        self.trace_sample = (None if trace_sample is None
                             else float(trace_sample))
        self.trace_retain = bool(trace_retain)
        # ps_addr: the parameter-server training plane.  When set,
        # every host's env gets DK_PS_ADDR (host:port of the
        # center-variable server) so an entrypoint running
        # ps.PSWorkerTrainer(server_addr=None) finds it; ps_window
        # exports DK_PS_WINDOW, the workers' default communication
        # window.  The server itself is usually NOT one of the hosts —
        # it is the process on the launcher's side, as in the paper's
        # topology.
        if ps_addr is not None:
            if not re.match(r"^[A-Za-z0-9._-]+:\d+$", str(ps_addr)):
                raise ValueError(
                    f"ps_addr {ps_addr!r} must be host:port")
        self.ps_addr = None if ps_addr is None else str(ps_addr)
        if ps_window is not None and int(ps_window) < 1:
            raise ValueError(
                f"ps_window {ps_window!r} must be >= 1 (a 0-step "
                "window would make every worker loop forever)")
        self.ps_window = None if ps_window is None else int(ps_window)
        # trace_id: the job-wide trace identity exported as DK_TRACE_ID
        # alongside the event log — every host's root spans join it, so
        # the merged timeline stitches the whole pod into ONE trace.
        # Minted here (deterministically under DK_TRACE_SEED) unless
        # the operator passes an explicit id to correlate with an
        # outer system's trace.
        if trace_id is None:
            from dist_keras_tpu_torch.observability import spans

            trace_id = spans.new_trace_id()
        if not re.match(r"^[0-9a-f]{32}$", str(trace_id)):
            raise ValueError(
                f"trace_id {trace_id!r} must be 32 lowercase hex chars "
                "(the traceparent trace-id shape)")
        self.trace_id = str(trace_id)
        # supervise: arm supervise_run()'s pod-relaunch budget.
        # int N = N relaunch WAVES per rolling 600 s window; a dict
        # gives the full knobs {"max_restarts", "budget_window_s",
        # "interval_s", "grace_s"}.  None/False = supervise_run()
        # refuses (the operator must opt into automatic relaunches: a
        # relaunch against a half-dead pod is an action, not an
        # observation).
        # "elastic"/"min_world" default to None = resolve the
        # DK_ELASTIC / DK_ELASTIC_MIN_WORLD knobs at supervise_run
        # time (launcher-exported values win, same contract as every
        # other knob)
        if supervise is None or supervise is False:
            self.supervise = None
        elif isinstance(supervise, dict):
            unknown = set(supervise) - {"max_restarts",
                                        "budget_window_s", "interval_s",
                                        "grace_s", "elastic",
                                        "min_world"}
            if unknown:
                raise ValueError(
                    f"unknown supervise knob(s) {sorted(unknown)}; "
                    "valid: max_restarts, budget_window_s, interval_s, "
                    "grace_s, elastic, min_world")
            self.supervise = {
                "max_restarts": int(supervise.get("max_restarts", 3)),
                "budget_window_s":
                    float(supervise.get("budget_window_s", 600.0)),
                "interval_s": float(supervise.get("interval_s", 10.0)),
                "grace_s": float(supervise.get("grace_s", 30.0)),
                "elastic": supervise.get("elastic"),
                "min_world": supervise.get("min_world"),
            }
        else:
            # True -> the default budget; an int names it exactly
            self.supervise = {
                "max_restarts": (3 if supervise is True
                                 else int(supervise)),
                "budget_window_s": 600.0,
                "interval_s": 10.0, "grace_s": 30.0,
                "elastic": None, "min_world": None}
        # runner: the process spawn/kill seam.  A callable
        # ``runner(cmd) -> rc`` replaces subprocess.call for every
        # per-host command (rsync/ssh/launch/stop) — the cluster
        # simulator injects one that manipulates local rc/hb files
        # instead of reaching for a shell, so supervise_run's relaunch
        # waves run against simulated hosts.  None = real subprocess.
        self.runner = runner
        self.commands = []  # record of everything (to be) executed

    # -- internals -----------------------------------------------------
    def _run(self, cmd, point=None):
        self.commands.append(cmd)
        if self.dry_run:
            rc = 0
        elif self.runner is not None:
            rc = int(self.runner(cmd))
        else:
            rc = subprocess.call(cmd)
        if point is not None:
            # fault hook: a replace-fault forges the return code, so a
            # flaky transport is simulated without a cluster
            # dklint: fault-points=job.rsync,job.ssh
            rc = fault_point(point, value=rc)
        return rc

    def _run_retried(self, cmd, point, policy=None):
        """One per-host command under a retry policy; returns the last
        attempt's rc (0 on eventual success)."""
        def attempt():
            rc = self._run(cmd, point=point)
            if rc != 0:
                raise CommandFailed(cmd, rc)
            return 0

        try:
            return (policy or self.retry_policy).call(attempt)
        except CommandFailed as e:
            return e.rc

    def _remote_dir(self):
        return f"{self.remote_root}/{self.job_name}"

    # -- API (send ~ job_deployment.py:~60) ----------------------------
    def sync_host(self, host):
        """rsync the job directory to ONE host (retried with backoff);
        -> the final rc.  The per-host unit :meth:`supervise_run`
        re-runs when it relaunches a dead host."""
        return self._run_retried([
            "rsync", "-az", "--delete", self.job_dir + "/",
            f"{host}:{self._remote_dir()}/"], point="job.rsync")

    def sync(self):
        """rsync the job directory to every host (each host's command
        retried with backoff before counting as failed)."""
        rc = 0
        for host in self.hosts:
            rc |= self.sync_host(host)
        return rc

    def host_env(self, pid, session=None):
        """The process-group environment exported on host ``pid`` —
        exactly the variables ``comm.initialize`` consumes
        (``comm/backend.py``).  ``session`` (supervise_run's relaunch
        counter) additionally exports ``DK_COORD_SESSION``, rotating
        the FileCoordinator rendezvous per incarnation."""
        if not self.hosts:
            raise ValueError("Job needs at least one host")
        env = {
            "JAX_COORDINATOR_ADDRESS":
                f"{self.hosts[0]}:{self.coordinator_port}",
            "JAX_NUM_PROCESSES": str(self.num_processes),
            "JAX_PROCESS_ID": str(pid),
        }
        if self.coord_dir:
            # consensus + liveness plane (resilience.coordination):
            # rank mirrors the process id, so "which host died"
            # reports map 1:1 onto self.hosts
            env["DK_COORD_DIR"] = str(self.coord_dir)
            env["DK_COORD_RANK"] = str(pid)
            env["DK_COORD_WORLD"] = str(self.num_processes)
        if self.coord_timeout_s is not None:
            env["DK_COORD_TIMEOUT_S"] = str(self.coord_timeout_s)
        if self.obs_dir:
            # telemetry plane (observability): each host's event log
            # lands in <obs_dir>/events-rank_{pid}.jsonl (the writer
            # reads its rank from DK_COORD_RANK / JAX_PROCESS_ID).
            # DK_TRACE_ID rides along: every host's root spans join the
            # job's trace, so the pod's merged timeline is ONE trace.
            env["DK_OBS_DIR"] = str(self.obs_dir)
            env["DK_TRACE_ID"] = self.trace_id
        if self.serve_port is not None:
            # serving plane: ServingServer(port=None) binds this
            env["DK_SERVE_PORT"] = str(self.serve_port)
        if self.route_port is not None:
            # serving fabric: RouterServer(port=None) binds this, and
            # the backend list is the CURRENT pod (self.hosts shrinks
            # under supervise_run's elastic resize, so a relaunched
            # router fronts exactly the surviving hosts)
            env["DK_ROUTE_PORT"] = str(self.route_port)
            env["DK_ROUTE_BACKENDS"] = ",".join(
                f"{h}:{self.serve_port}" for h in self.hosts)
        if self.metrics_port is not None:
            # scrape plane: the per-host Prometheus exporter binds this
            env["DK_METRICS_PORT"] = str(self.metrics_port)
        if self.ps_addr is not None:
            # parameter-server plane: every worker's PSClient dials this
            env["DK_PS_ADDR"] = self.ps_addr
        if self.ps_window is not None:
            env["DK_PS_WINDOW"] = str(self.ps_window)
        if self.obs_sample_s is not None:
            # live-telemetry cadence: MetricsSampler + watchdog per host
            env["DK_OBS_SAMPLE_S"] = str(self.obs_sample_s)
        if self.slo:
            # SLO plane: default objectives + burn-rate rule +
            # exemplar capture on every host
            env["DK_SLO"] = "1"
        if self.trace_retain:
            # tail-based trace retention per host
            env["DK_TRACE_RETAIN"] = "1"
        if self.trace_sample is not None:
            env["DK_TRACE_SAMPLE"] = str(self.trace_sample)
        if session is not None:
            env["DK_COORD_SESSION"] = str(session)
        return env

    def dead_hosts(self, stale_after_s=None, session=None):
        """(rank, host) pairs whose liveness file under ``coord_dir`` is
        missing or stale — the launcher-side half of dead-peer
        detection, so an operator (or Punchcard) sees WHICH host died
        instead of a silent pod hang.  Requires ``coord_dir`` to be a
        path this process can read (shared filesystem); [] when no
        liveness info exists yet.  The default stale window is the
        workers' own (``DK_COORD_STALE_S``, 10s) so launcher and hosts
        judge liveness by the same clock.  ``session`` probes a rotated
        ``DK_COORD_SESSION`` incarnation (what :meth:`supervise_run`
        passes after a relaunch wave)."""
        if not self.coord_dir:
            raise ValueError("Job has no coord_dir: no liveness files "
                             "to inspect")
        from dist_keras_tpu_torch.resilience import coordination

        # dead_peers_at resolves session subdir and '~' exactly the way
        # the workers do, so launcher and hosts agree on the path
        dead = coordination.dead_peers_at(
            self.coord_dir, self.num_processes,
            stale_after_s=stale_after_s, session=session)
        return [(r, self.hosts[r] if r < len(self.hosts) else None)
                for r in dead]

    def monitor(self, interval_s=10.0, max_polls=None, out=print,
                obs_dir=None, stale_after_s=None):
        """Live monitor loop: tail :meth:`dead_hosts` and the merged
        observability report, printing TRANSITIONS only — a host going
        dark or coming back, a rank's event stream advancing (with its
        latest event kind) or appearing for the first time.  This is
        the launcher-side "is my pod alive and what is it doing"
        answer the ROADMAP asked for, without an operator re-running
        the report CLI in a shell loop.

        ``obs_dir``: a LAUNCHER-READABLE directory of event files — a
        shared-fs ``self.obs_dir`` works as-is; for per-host local
        obs dirs point this at a :meth:`collect_obs` destination (all
        ``host_*`` subdirs merged, or one of them).  Defaults to
        ``self.obs_dir``.  Either plane may be absent: with no
        ``coord_dir`` only the event tail is monitored and vice versa.

        ``max_polls`` bounds the loop (tests / one-shot probes); the
        default None polls forever.  Returns the list of transition
        strings printed (bounded runs; the forever loop only returns
        on KeyboardInterrupt)."""
        from dist_keras_tpu_torch.observability import report as obs_report

        transitions = []
        prev_dead = set()
        prev_ranks = {}

        def _note(line):
            transitions.append(line)
            if out is not None:
                out(line)

        polls = 0
        try:
            while max_polls is None or polls < max_polls:
                if self.coord_dir:
                    try:
                        dead = set(self.dead_hosts(
                            stale_after_s=stale_after_s))
                    except (OSError, ValueError):
                        dead = prev_dead  # unreadable poll: no verdict
                    for r, h in sorted(dead - prev_dead):
                        _note(f"[monitor] host {r} ({h}) went DARK")
                    for r, h in sorted(prev_dead - dead):
                        _note(f"[monitor] host {r} ({h}) is back")
                    prev_dead = dead
                d = self.obs_dir if obs_dir is None else obs_dir
                if d and os.path.isdir(os.path.expanduser(str(d))):
                    # re-reading the whole directory per poll is
                    # O(retained bytes), which rotation bounds at
                    # (keep+1) x cap per host — acceptable for a
                    # monitor cadence of seconds; offset-tailing is the
                    # upgrade path if an unrotated log ever matters
                    ranks = obs_report.summarize(
                        obs_report.read_events(d))["ranks"]
                    for rank in sorted(ranks):
                        row, prev = ranks[rank], prev_ranks.get(rank)
                        delta = (None if prev is None
                                 else row["events"] - prev["events"])
                        if prev is None:
                            _note(f"[monitor] rank {rank}: "
                                  f"{row['events']} events "
                                  f"(last: {row['last_kind']})")
                        elif delta > 0:
                            _note(f"[monitor] rank {rank}: "
                                  f"+{delta} events "
                                  f"(last: {row['last_kind']})")
                        elif (row["last_t"], row["last_kind"]) != \
                                (prev["last_t"], prev["last_kind"]):
                            # rotation trimmed the retained window so
                            # the COUNT dropped, but the tail moved:
                            # still an advance, never a bogus "+-N"
                            _note(f"[monitor] rank {rank}: advanced "
                                  f"(last: {row['last_kind']})")
                        # count shrank with an unchanged tail: rotation
                        # only — no transition
                    prev_ranks = {k: dict(v) for k, v in ranks.items()}
                polls += 1
                if max_polls is None or polls < max_polls:
                    _world.sleep(float(interval_s))
        except KeyboardInterrupt:  # pragma: no cover - operator ^C
            pass
        return transitions

    def collect_obs(self, dest):
        """rsync every host's ``obs_dir`` event log back to
        ``dest/host_{i}/`` on the launcher (each host's command retried
        with backoff, same as :meth:`sync`) — then
        ``python -m dist_keras_tpu_torch.observability dest/host_{i}`` (or a
        merge of the collected files) reconstructs the run timeline.
        Per-rank file names never collide, so merging all ``host_*``
        subdirectories into one directory is also safe."""
        if not self.obs_dir:
            raise ValueError("Job has no obs_dir: nothing to collect")
        dest = os.path.abspath(dest)
        rc = 0
        for pid, host in enumerate(self.hosts):
            hostdir = os.path.join(dest, f"host_{pid}")
            if not self.dry_run:
                os.makedirs(hostdir, exist_ok=True)
            rc |= self._run_retried([
                "rsync", "-az", f"{host}:{self.obs_dir}/",
                hostdir + "/"], point="job.rsync")
        return rc

    @staticmethod
    def _shq_path(path):
        """``shlex.quote`` for a path interpolated into a REMOTE shell
        command, preserving a leading ``~`` outside the quotes (quoted
        whole, the remote shell would take the tilde literally — the
        workers expanduser() the very same string in python, so both
        sides must resolve it to the same home-relative path)."""
        p = str(path)
        if p == "~":
            return '"$HOME"'
        if p.startswith("~/"):
            return '"$HOME"' + shlex.quote(p[1:])
        return shlex.quote(p)

    def _rc_remote_dir(self, session=None):
        """Remote-shell path of the per-incarnation exit-code directory
        under the SHARED ``coord_dir`` (mirrors the heartbeat layout:
        ``<coord_dir>[/<session>]/rc``); None without a coord_dir."""
        if not self.coord_dir:
            return None
        root = str(self.coord_dir)
        if session is not None:
            root = f"{root}/{session}"
        return f"{root}/rc"

    def launch_host(self, pid, session=None):
        """Start the entrypoint on ONE host under its process-group
        env; -> rc.  ``session`` rotates ``DK_COORD_SESSION`` (see
        :meth:`host_env`) and names a per-incarnation log file, so a
        relaunch wave never truncates the dead incarnation's
        post-mortem.

        The entrypoint runs under ``setsid`` in its OWN process group
        whose leader pid lands in ``job.pid`` INSIDE the job directory
        — the handle :meth:`stop_host` needs to retire a survivor
        before a wave (a plain ``nohup cmd & echo $!`` records the
        wrapper subshell forked for the backgrounded compound list, in
        the login cwd, and a TERM to it never reaches the python
        child).  With a ``coord_dir``, a wrapper shell in that group
        also records the entrypoint's EXIT CODE into the shared
        ``<coord_dir>[/<session>]/rc/rank_{pid}`` once it exits —
        :meth:`supervise_run`'s positive evidence that a
        heartbeat-silent rank COMPLETED (rc 0) or died typed (rc N)
        rather than went dark mid-run."""
        host = self.hosts[pid]
        env = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in self.host_env(pid,
                                                 session=session).items())
        # every manifest-sourced field is quoted before it reaches the
        # remote shell (Punchcard manifests are user-editable JSON)
        # python may be a multi-word command ("python3 -u"): split it,
        # then quote each word
        python = " ".join(shlex.quote(w)
                          for w in shlex.split(self.python))
        log = "job.log" if session is None else f"job.log.{session}"
        inner = f"{env} {python} {shlex.quote(self.entrypoint)}"
        rc_dir = self._rc_remote_dir(session)
        mkdir = ""
        if rc_dir is not None:
            # the rc write happens INSIDE the detached group: it
            # survives the launching ssh, but a stop_host group-TERM
            # (or machine death) kills the wrapper too — a dead-dark
            # incarnation leaves NO rc, exactly the no-evidence state
            # the heartbeat staleness verdict covers
            # quoted like every other manifest-sourced field above —
            # coord_dir may hold spaces or shell metacharacters
            rc_q = self._shq_path(rc_dir)
            inner = f"{inner}; echo $? > {rc_q}/rank_{pid}"
            mkdir = f"mkdir -p {rc_q} && "
        # non-idempotent (remote nohup fork): retried only when the
        # operator opted in via launch_retries — see __init__
        return self._run_retried([
            "ssh", host,
            f"cd {self._remote_dir()} && {mkdir}"
            f"{{ nohup setsid sh -c {shlex.quote(inner)} "
            f"> {log} 2>&1 & echo $! > job.pid; }}"], point="job.ssh",
            policy=self.launch_retry_policy)

    def stop_host(self, host):
        """Best-effort SIGTERM to the last-launched entrypoint's whole
        PROCESS GROUP on ONE host (negative-pid kill of the ``setsid``
        leader recorded in ``job.pid`` — the group, not just the
        wrapper, so the python child is reached); -> rc, which callers
        typically IGNORE — the host may be unreachable or the process
        already gone, and either way the caller's relaunch must
        proceed.  :meth:`supervise_run` sends this to every host
        before a relaunch wave: a SURVIVOR of a partial pod death is
        still alive (dying slowly of ``PeerLost`` at its next
        collective deadline, up to ``DK_COORD_TIMEOUT_S`` away) and
        must not keep writing into the checkpoint directory the new
        incarnation is about to own.  TERM, not KILL: the survivor's
        preemption handler gets its boundary-checkpoint attempt, which
        on a pod with a dead peer dies TYPED at the commit barrier
        without promoting — the two-phase protocol keeps a half-pod
        save invisible."""
        return self._run([
            "ssh", host,
            f"cd {self._remote_dir()} && test -f job.pid && "
            'kill -s TERM -- "-$(cat job.pid)" 2>/dev/null; true'])

    def host_rcs(self, session=None):
        """{rank: exit code} for every rank whose launch wrapper
        recorded one under ``coord_dir`` (see :meth:`launch_host`) —
        positive completed/crashed evidence, launcher-readable on the
        shared filesystem.  Unreadable or garbled entries are skipped
        (a torn ``echo`` mid-write is transient)."""
        if not self.coord_dir:
            raise ValueError("Job has no coord_dir: no rc files "
                             "to inspect")
        root = os.path.expanduser(str(self.coord_dir))
        if session is not None:
            root = os.path.join(root, str(session))
        rcs = {}
        try:
            names = os.listdir(os.path.join(root, "rc"))
        except OSError:
            return rcs
        for name in names:
            m = re.match(r"^rank_(\d+)$", name)
            if not m:
                continue
            try:
                with open(os.path.join(root, "rc", name)) as f:
                    rcs[int(m.group(1))] = int(f.read().strip())
            except (OSError, ValueError):
                continue
        return rcs

    def launch(self, session=None):
        """Start the entrypoint on every host under its process-group env."""
        if not self.hosts:
            raise ValueError("Job needs at least one host to launch")
        rc = 0
        for pid in range(len(self.hosts)):
            rc |= self.launch_host(pid, session=session)
        return rc

    def supervise_run(self, max_polls=None, out=print,
                      stale_after_s=None):
        """Launcher-side auto-resume loop: poll :meth:`dead_hosts` and,
        when any host is heartbeat-dead, relaunch the WHOLE pod as a
        fresh incarnation (re-sync + ssh launch per host, the same
        retried surfaces as :meth:`send`) under a rotated
        ``DK_COORD_SESSION``.  Whole-pod, not per-host: group
        membership is fixed per incarnation (a FileCoordinator world /
        ``torch.distributed`` group cannot admit a replacement member
        mid-stream — the survivors are already dying of ``PeerLost``),
        so the recovery unit is the incarnation, torchelastic-style.
        Subsequent polls judge liveness in the NEW session's heartbeat
        directory (``dead_hosts(session=...)``) after a ``grace_s``
        startup window, so one slow process start does not burn the
        budget.  Verdicts also weigh the launch wrappers' exit-code
        files (:meth:`host_rcs`): rc 0 exempts a COMPLETED rank —
        all-zero rcs end supervision, since a finished pod's stale
        heartbeats are not a death — while a nonzero rc convicts a
        rank even when it died before its first beat.  The
        relaunched entrypoint is expected to pass
        ``resume=True`` to its trainer — restore picks the latest
        VERIFIED committed step (``checkpoint.py`` integrity
        manifests), so a relaunch continues from the agreed chunk.

        ELASTIC (``DK_ELASTIC``, default on; ``supervise={"elastic":
        ..., "min_world": ...}`` overrides): a host that was dead at
        the previous wave's trigger and is dead AGAIN after that wave
        relaunched it — evidence-based: a nonzero recorded rc, or
        heartbeats that beat and went dark in the new session — never
        came back, and the next wave launches with the SURVIVING host
        set: ranks re-seated 0..M-1, ``DK_COORD_WORLD`` re-exported,
        session rotated, an ``elastic_resize`` event (+ operator
        alert) attributing the decision.  The relaunched workers see
        ``saved_world != current_world`` at restore and take the
        resharding path (``resilience.elastic``).  Never below
        ``min_world`` (default ``DK_ELASTIC_MIN_WORLD``, 1), and never
        when EVERY host is a repeat offender — a pod that never comes
        up at all still dies typed on the budget.  Membership still
        only changes ACROSS incarnations, never mid-run.

        Budget: ``Job(supervise=N)``'s rolling-window
        :class:`~dist_keras_tpu_torch.resilience.supervisor.RestartBudget`,
        one recording per relaunch WAVE (a single failure that
        cascades to whole-pod death is one event, not num_hosts of
        them) — a resize wave records like any other.  Past it, a
        typed ``CrashLoop`` carrying the window's evidence (which
        ranks, when) — flapping hardware becomes an operator page, not
        an infinite relaunch loop.  ``max_polls`` bounds the loop for
        tests/one-shot probes; the None default supervises until
        KeyboardInterrupt.
        -> list of ``(dead_ranks, session)`` waves performed."""
        from dist_keras_tpu_torch.observability import events
        from dist_keras_tpu_torch.resilience.supervisor import (
            CrashLoop,
            RestartBudget,
        )
        from dist_keras_tpu_torch.resilience.supervisor import (
            alert as supervisor_alert,
        )

        if self.supervise is None:
            raise ValueError(
                "Job was not armed for supervision — construct with "
                "supervise=N (relaunch budget) to opt in")
        if not self.coord_dir:
            raise ValueError(
                "supervise_run needs coord_dir: dead-host detection "
                "reads the heartbeat files there")
        budget = RestartBudget(self.supervise["max_restarts"],
                               self.supervise["budget_window_s"])
        interval_s = self.supervise["interval_s"]
        grace_s = self.supervise["grace_s"]
        from dist_keras_tpu_torch.resilience import elastic as _elastic
        from dist_keras_tpu_torch.utils import knobs as _knobs

        elastic_on = (self.supervise.get("elastic")
                      if self.supervise.get("elastic") is not None
                      else _knobs.get("DK_ELASTIC"))
        min_world = (self.supervise.get("min_world")
                     if self.supervise.get("min_world") is not None
                     else _knobs.get("DK_ELASTIC_MIN_WORLD"))
        relaunched = []
        session = 0
        last_wave = None  # monotonic t of the last relaunch wave
        last_wave_dead = set()  # hosts dead at the last wave's trigger
        polls = 0
        try:
            while max_polls is None or polls < max_polls:
                # world seam: wave grace windows and poll cadence run
                # on simulated time under the cluster simulator
                now = _world.monotonic()
                # the fresh incarnation needs grace_s before its first
                # heartbeats can exist — judging the new session's
                # empty directory immediately would read as all-dead
                if last_wave is None or now - last_wave >= grace_s:
                    try:
                        dead = self.dead_hosts(
                            stale_after_s=stale_after_s,
                            session=session if session else None)
                        if session and not dead and not os.path.isdir(
                                os.path.join(
                                    os.path.expanduser(
                                        str(self.coord_dir)),
                                    str(session), "hb")):
                            # dead_peers' absence-of-evidence rule
                            # (no hb dir -> no verdict) must not hide
                            # a wave that never came up: the launcher
                            # LAUNCHED this incarnation, so total
                            # heartbeat silence past grace_s IS
                            # evidence — an all-host rsync/ssh failure
                            # or instant crash would otherwise stall
                            # supervision forever with the pod down
                            dead = list(enumerate(self.hosts))
                    except OSError:
                        dead = []  # unreadable poll: no verdict
                    dead = [(r, h) for r, h in dead if h is not None]
                    # exit-code evidence from the launch wrappers (see
                    # launch_host): heartbeat staleness alone cannot
                    # tell a FINISHED run from a dead one — a rank
                    # whose wrapper recorded rc 0 COMPLETED, and its
                    # stale heartbeat is the normal end of a finished
                    # run, not a death; a NONZERO rc is positive crash
                    # evidence even when the pod died before its first
                    # beat (no hb dir -> heartbeats give no verdict)
                    rcs = self.host_rcs(
                        session=session if session else None)
                    dead = [(r, h) for r, h in dead
                            if rcs.get(r) != 0]
                    for r in sorted(rcs):
                        if rcs[r] != 0 and r < len(self.hosts) and \
                                all(r != dr for dr, _ in dead):
                            dead.append((r, self.hosts[r]))
                    if rcs and all(rcs.get(r) == 0
                                   for r in range(self.num_processes)):
                        if out is not None:
                            out("[supervise] every rank exited rc=0 "
                                "— run complete")
                        return relaunched
                else:
                    dead = []
                if dead:
                    names = ", ".join(f"rank {r} ({h})"
                                      for r, h in dead)
                    if not budget.record("hosts_dead", names):
                        events.emit(
                            "supervisor_giveup", reason="crash_loop",
                            ranks=[r for r, _ in dead],
                            restarts_in_window=len(budget.evidence),
                            window_s=budget.window_s)
                        supervisor_alert(
                            "supervisor_giveup", reason="crash_loop",
                            ranks=[r for r, _ in dead],
                            restarts_in_window=len(budget.evidence),
                            window_s=budget.window_s)
                        raise CrashLoop(
                            f"pod relaunch budget exhausted: "
                            f"{len(budget.evidence)} dead-host waves "
                            f"in the last {budget.window_s:.0f}s "
                            f"(budget "
                            f"{self.supervise['max_restarts']}) — "
                            f"last: {names}",
                            evidence=budget.evidence)
                    # the ELASTIC decision: a host that was dead at the
                    # trigger of the PREVIOUS wave and is dead again
                    # now — after a whole wave relaunched it (nonzero
                    # rc or beat-then-went-dark in the NEW session) —
                    # never came back; the next incarnation launches
                    # with the surviving host set instead of burning
                    # the budget against a dead machine
                    survivors, dropped = (
                        _elastic.choose_surviving_hosts(
                            self.hosts, {h for _, h in dead},
                            last_wave_dead, min_world=min_world)
                        if elastic_on else (None, ()))
                    last_wave_dead = {h for _, h in dead}
                    session += 1
                    if out is not None:
                        out(f"[supervise] dead: {names} — relaunching "
                            f"the pod (session {session})")
                    events.emit("supervisor_restart",
                                ranks=[r for r, _ in dead],
                                session=session)
                    # retire the OLD incarnation first: survivors are
                    # already dying of PeerLost but may be a full
                    # collective deadline away from noticing, and two
                    # incarnations must never write the checkpoint
                    # directory concurrently (rc ignored — best-effort
                    # by design, see stop_host).  On a resize wave the
                    # stop still covers every OLD host, dropped ones
                    # included.
                    for host in self.hosts:
                        self.stop_host(host)
                    if survivors is not None:
                        old_world = self.num_processes
                        dropped_ranks = [r for r, h in
                                         enumerate(self.hosts)
                                         if h in dropped]
                        # the resize IS this wave: ranks are re-seated
                        # 0..M-1 over the survivors, DK_COORD_* are
                        # re-exported by host_env from the updated
                        # world, and workers detect saved_world !=
                        # current_world at restore and reshard
                        self.hosts = list(survivors)
                        self.num_processes = len(survivors)
                        if out is not None:
                            out(f"[supervise] elastic resize: "
                                f"{old_world} -> {self.num_processes} "
                                f"hosts (dropped "
                                f"{', '.join(dropped)}) — they never "
                                f"came back after a relaunch wave")
                        events.emit("elastic_resize", session=session,
                                    old_world=old_world,
                                    new_world=self.num_processes,
                                    dropped_ranks=dropped_ranks,
                                    dropped_hosts=list(dropped))
                        supervisor_alert(
                            "elastic_resize", session=session,
                            old_world=old_world,
                            new_world=self.num_processes,
                            dropped_hosts=list(dropped))
                    rc = 0
                    for pid, host in enumerate(self.hosts):
                        rc_host = self.sync_host(host)
                        if rc_host == 0:
                            rc_host = self.launch_host(
                                pid, session=session)
                        rc |= rc_host
                    relaunched.append(
                        (tuple(r for r, _ in dead), session))
                    # grace runs from wave END: a slow multi-host
                    # rsync must not eat the new incarnation's
                    # startup window
                    last_wave = _world.monotonic()
                    if rc != 0 and out is not None:
                        out(f"[supervise] relaunch wave {session} "
                            f"returned rc={rc}; next poll retries")
                polls += 1
                if max_polls is None or polls < max_polls:
                    _world.sleep(interval_s)
        except KeyboardInterrupt:  # pragma: no cover - operator ^C
            pass
        return relaunched

    def send(self):
        """sync + launch (the reference's Job.send)."""
        rc = self.sync()
        if rc == 0:
            rc = self.launch()
        return rc


class Punchcard:
    """Poll a JSON manifest of authorized jobs and run them.

    Manifest format (reference-parity, job_deployment.py:~150): a list of
    job descriptors, each with a ``secret``; only jobs whose secret matches
    one of ``secrets`` are run.  Each descriptor's remaining keys are Job
    constructor kwargs.
    """

    def __init__(self, manifest_path, secrets=(), poll_interval=5.0,
                 dry_run=False, read_retries=2):
        self.manifest_path = os.path.abspath(manifest_path)
        self.secrets = set(secrets)
        self.poll_interval = float(poll_interval)
        self.dry_run = dry_run
        # a manifest mid-rewrite by its producer reads as missing or
        # truncated JSON — transient, absorbed here instead of killing
        # the poll daemon (ValueError covers json.JSONDecodeError)
        self.read_policy = RetryPolicy(
            attempts=int(read_retries) + 1, backoff=0.1, jitter=0.1,
            retryable=(OSError, ValueError))
        self.executed = []

    def read_manifest(self):
        def _read():
            fault_point("punchcard.read_manifest")
            with open(self.manifest_path) as f:
                return json.load(f)

        return self.read_policy.call(_read)

    def pending_jobs(self):
        jobs = []
        for spec in self.read_manifest():
            if spec.get("secret") in self.secrets:
                jobs.append(spec)
        return jobs

    def run_once(self):
        """Authenticate + run every pending job once; returns the jobs
        (each with ``last_rc`` set).  A job is only marked executed when
        its deployment succeeded — a failed rsync/ssh is retried on the
        next poll instead of being silently swallowed."""
        ran = []
        for spec in self.pending_jobs():
            spec = dict(spec)
            name = spec.get("job_name", "unnamed")
            if name in self.executed:
                continue
            job = Job(dry_run=self.dry_run, **spec)
            job.last_rc = job.send()
            if job.last_rc == 0:
                self.executed.append(name)
            ran.append(job)
        return ran

    def run(self, max_polls=None):
        """Poll loop (the reference's Punchcard.run).  With a finite
        ``max_polls``, returns every Job instance launched across the
        polls; the poll-forever daemon path keeps nothing (a retrying
        job would otherwise grow an unbounded Job list, and the return
        is unreachable anyway)."""
        polls = 0
        ran = [] if max_polls is not None else None
        while max_polls is None or polls < max_polls:
            launched = self.run_once()
            if ran is not None:
                ran.extend(launched)
            polls += 1
            if max_polls is None or polls < max_polls:
                _world.sleep(self.poll_interval)
        return ran or []
