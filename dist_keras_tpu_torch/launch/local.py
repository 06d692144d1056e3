"""The per-card fan-out — ``python -m dist_keras_tpu_torch.launch.local
[--nproc-per-host N] ENTRY [ARGS ...]``.

The JAX package's ``launch.Job`` starts one process per host, and that
process drives every device of its host.  A rank of the port holds one
card, so a host with several cards trains one rank per card:
``Job(python="python3 -m dist_keras_tpu_torch.launch.local")`` makes
this module each host's command (``Job.host_env`` and its commands stay
the JAX package's).  It starts one child ``python ENTRY ARGS`` per
card — every visible card, or ``--nproc-per-host N``; one CPU rank on a
host without a card, as ``comm.local_devices()`` counts — each with
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` beside the Job's ``JAX_*``
variables, unchanged: ``comm.initialize`` composes them into the rank
(host x local world + local rank) and the world (hosts x local world).
Run alone (no ``JAX_*`` variables), it is one host of one: the children
meet at a free local port.

How it ends: TERM and INT are forwarded to every child once (the
children run in a process group of their own and die with the fan-out,
so a group signal to the host's command reaches each of them once, not
twice: a second TERM would escalate past a trainer's graceful save).
When a child exits non-zero, the others are TERMed and the fan-out
exits with that child's code (a signal N as 128 + N); all children
exiting 0 is 0.  So the Job's one ``rc/rank_{host}`` file per host keeps
its meaning for ``Job.host_rcs`` and ``supervise_run``.

Liveness, with ``DK_COORD_DIR``: the children are the coordination
ranks — ``DK_COORD_RANK`` their global rank, ``DK_COORD_WORLD`` the
group's world (the trainers check it against the group) — in a
directory of their own, ``<coord_dir>/ranks`` (``DK_COORD_SESSION``
rotates under it as the Job rotates it), so no two ranks write one
heartbeat file.  The fan-out beats the host's file,
``<coord_dir>[/<session>]/hb/rank_{host}``, the one ``Job.dead_hosts``
reads, and stops beating once any of its ranks has beaten and gone
stale: a host is dead when any of its ranks is, and the Job's liveness
evidence stays one file per host.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

POLL_S = 0.05          # how often the children's exits are checked
BEAT_S = 1.0           # the host heartbeat's interval
DRAIN_S = 120.0        # how long a TERMed child may drain before a KILL


def visible_cards():
    """The number of cards this host's ranks can use (0 without one)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_envs(n, env=None):
    """-> the ``n`` children's environments: ``env`` (default this
    process's) with ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` and, under
    ``DK_COORD_DIR``, the children's coordination identity."""
    env = dict(os.environ if env is None else env)
    if not env.get("JAX_COORDINATOR_ADDRESS"):
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                   JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")
    out = []
    for i in range(n):
        e = dict(env, LOCAL_RANK=str(i), LOCAL_WORLD_SIZE=str(n))
        if env.get("DK_COORD_DIR"):
            host = int(env.get("DK_COORD_RANK") or 0)
            hosts = int(env.get("DK_COORD_WORLD") or 1)
            e.update(DK_COORD_DIR=os.path.join(env["DK_COORD_DIR"], "ranks"),
                     DK_COORD_RANK=str(host * n + i),
                     DK_COORD_WORLD=str(hosts * n))
        out.append(e)
    return out


def _exit_code(rc):
    return 128 - rc if rc < 0 else rc


def _die_with_parent():
    """In a child before exec: SIGKILL when the fan-out dies (Linux)."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


class _HostBeat:
    """The host's heartbeat under ``DK_COORD_DIR``, silenced for good
    once a rank of this host has beaten and gone stale."""

    def __init__(self, env):
        from dist_keras_tpu_torch.resilience import coordination
        from dist_keras_tpu_torch.utils import knobs

        self._co = coordination
        session = env.get("DK_COORD_SESSION") or ""
        base = os.path.expanduser(env["DK_COORD_DIR"])
        self.host = int(env.get("DK_COORD_RANK") or 0)
        self.beat = coordination.Heartbeat(os.path.join(base, session),
                                           self.host)
        self.ranks_root = os.path.join(base, "ranks", session)
        self.mine = []          # this host's global ranks, once known
        self.stale_s = float(knobs.raw("DK_COORD_STALE_S") or "10")
        self.next_t = 0.0
        self.dark = False

    def own(self, n):
        self.mine = list(range(self.host * n, (self.host + 1) * n))

    def tick(self):
        from dist_keras_tpu_torch.resilience.faults import FaultInjected

        now = time.monotonic()
        if self.dark or now < self.next_t:
            return
        self.next_t = now + BEAT_S
        if self.mine and self._co.dead_peers(
                self.ranks_root, len(self.mine), stale_after_s=self.stale_s,
                ranks=self.mine, require_file=True):
            self.dark = True
            return
        try:
            self.beat.beat_once()
        except FaultInjected:
            self.dark = True     # the injected death: dark for good
        except OSError:
            pass   # a transient liveness-file error: the next tick retries


def run(entry, args=(), n=None, env=None):
    """Start ``n`` children (default: every visible card, at least one)
    running ``python entry args``; -> the fan-out's exit code."""
    env = dict(os.environ if env is None else env)
    # the host beats before torch loads: a slow import is not a dead host
    beat = _HostBeat(env) if env.get("DK_COORD_DIR") else None
    if beat is not None:
        beat.tick()
    if n is None:
        n = max(1, visible_cards())
    envs = child_envs(n, env)
    if beat is not None:
        beat.own(n)
    kids, signalled = [], set()

    def forward(signum, frame):
        for i, p in enumerate(kids):
            if i not in signalled and p.poll() is None:
                signalled.add(i)
                p.send_signal(signum)

    old = {s: signal.signal(s, forward)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for e in envs:
            kids.append(subprocess.Popen(
                [sys.executable, entry, *args], env=e,
                start_new_session=True, preexec_fn=_die_with_parent))
        while True:
            rcs = [p.poll() for p in kids]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed:
                forward(signal.SIGTERM, None)
                for p in kids:
                    try:
                        p.wait(timeout=DRAIN_S)
                    except subprocess.TimeoutExpired:
                        p.kill()
                return _exit_code(failed[0])
            if all(rc == 0 for rc in rcs):
                return 0
            if beat is not None:
                beat.tick()
            time.sleep(POLL_S)
    finally:
        for s, h in old.items():
            # dklint: thread-root=preempt.restore
            signal.signal(s, h)
        for p in kids:
            if p.poll() is None:
                p.kill()
                # dklint: ignore[unbounded-wait] reaps a SIGKILLed child,
                # which cannot outlive the signal
                p.wait()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_keras_tpu_torch.launch.local",
        description="Start one rank of ENTRY per card of this host "
                    "(LOCAL_RANK / LOCAL_WORLD_SIZE beside the launcher's "
                    "JAX_* variables).")
    ap.add_argument("--nproc-per-host", type=int, default=None,
                    help="ranks on this host (default: every visible card, "
                         "one on a host without one)")
    ap.add_argument("entry", help="the Python file each rank runs")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="arguments passed on to ENTRY")
    a = ap.parse_args(argv)
    if a.nproc_per_host is not None and a.nproc_per_host < 1:
        ap.error("--nproc-per-host must be at least 1")
    return run(a.entry, a.args, a.nproc_per_host)


if __name__ == "__main__":
    sys.exit(main())
