"""Hot model reload — roll promoted checkpoints into a live engine.

A port of the JAX package's ``serving/reload.py``.  The one change: a
watcher given no ``template`` restores the whole training state, as the
JAX watcher does, and then places its ``"params"`` onto the engine's own
params (``checkpoint.apply_template``), so the leaves land with the
engine's dtypes and devices, uploaded from pinned memory, and
``set_params`` finds them already in place.  The rest of the state (a
trainer's optimizer state, rng, step counters) stays on the host.

A serving fleet must stay up across model updates: the trainer keeps
promoting new steps through ``checkpoint.Checkpointer`` (whose readers
only ever see FULLY COMMITTED steps — the two-phase promotion rename is
the cluster's single publish instant), and this watcher polls
``latest_step()`` from the serving side, restores any new step, and
swaps the params into every replica between batches via
``ServingEngine.set_params`` — zero dropped in-flight requests by the
engine's swap contract.

Failure semantics (the serving third of the resilience story):

- Restore I/O runs under a named retry policy (``"serve.reload"``
  surface: transient ``OSError`` absorbed with backoff, events/counters
  on every attempt).
- The ``"serve.reload"`` fault point fires per reload attempt, so tests
  inject a failing reload deterministically.  ``FaultInjected`` is not
  retryable (a simulated kill stays a kill).
- A reload that still fails is a TYPED error: :meth:`poll_once` raises
  it to a direct caller; the background loop records a
  ``serve_reload_error`` event + ``serve.reload.errors`` counter,
  keeps serving the OLD params, and keeps watching — a bad checkpoint
  must never take the fleet down or hang it.
- Every candidate step is INTEGRITY-VERIFIED before the swap
  (``Checkpointer.verify`` — a strictly read-only probe of the
  manifest hashes): a corrupt promoted step is SKIPPED with a typed
  ``reload_skipped_corrupt`` event + ``serve.reload.skipped_corrupt``
  counter and the NEWEST verifiable newer step is loaded instead
  (none at all: the engine keeps serving the old params; previously a
  rotted step would fail inside the restore mid-swap attempt and burn
  the reload loop's whole retry budget each poll).  The restore
  itself runs ``verify=False`` — the probe already passed, and the
  verified-restore path would quarantine (rename) inside the
  trainer's live directory, which a reader must never do.  A legacy
  pre-manifest checkpoint verifies "unverifiable" and reloads as
  before.
- A checkpoint written by a DIFFERENT world size than the server's —
  a world-1 serving host hot-loading a pod-written two-phase step —
  is an ELASTIC reload: the probe verifies EVERY host payload and the
  restore re-partitions through ``resilience.elastic.reshard_restore``
  (sharded leaves gathered by global index, replicated leaves from
  the leader) instead of failing the per-rank payload lookup.
- Remote tier: with ``DK_CKPT_REMOTE`` configured on the
  serving host, the watcher becomes a PULL-THROUGH cache — each poll
  first fetches any newly completed remote step missing locally
  (``Checkpointer.fetch_remote_newer``; the spot-serving host whose
  disk shares nothing with the trainer's), and a candidate convicted
  corrupt is re-fetched clean from the store ONCE before being
  skipped.  Both paths assume the watcher's checkpoint directory is
  this host's own cache dir, which is exactly the deployment that
  configures a remote tier.
- Async/chunked saves (``DK_CKPT_ASYNC`` / ``DK_CKPT_CHUNK_MB`` on the
  TRAINER side) need nothing special here: the watcher still only ever
  sees PROMOTED steps (async staging is invisible until the same
  atomic promote), and the verify probe walks the manifest's
  PER-CHUNK entries — each ``chunk_NNNN.KKKKK`` file of a large leaf
  hashes independently, so a single rotted chunk convicts the step
  exactly like a rotted whole-payload file, and the restore reads the
  chunked format transparently.
"""

from __future__ import annotations

import threading

from dist_keras_tpu_torch.observability import events, metrics
from dist_keras_tpu_torch.observability.spans import span
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.resilience.retry import RetryPolicy


class BlueGreenEngine:
    """Two engines, one traffic pointer — reload as an atomic cutover.

    :meth:`ServingEngine.set_params` already hot-swaps params with zero
    dropped requests, but the swap is gradual per replica and the new
    params serve from engines whose queues still hold old-params work.
    Blue/green makes the rollout a single atomic TRAFFIC decision
    instead: two :class:`~.engine.ServingEngine` instances share the
    same devices (the standby idles, so the device cost is memory, not
    compute); ``set_params`` loads the new params into the STANDBY,
    then flips the active index — one reference assignment, atomic
    under the GIL.  Requests admitted before the flip drain on the old
    params inside the old engine (its no-drop contract is untouched);
    requests after the flip land on the new ones.  Nothing is ever
    in-between, and a bad load never touches the serving color.

    The class quacks like a single engine everywhere the serving stack
    cares (``submit`` / ``predict`` / ``submit_generate`` /
    ``generate`` / ``set_params`` / ``resize`` / ``stats`` / ``drain``
    / ``close`` / ``draining`` / ``running``),
    so :class:`ServingServer`, :class:`CheckpointWatcher`, and the
    autoscaler compose with it unchanged.  Each cutover emits
    ``route_cutover`` + the ``route.cutovers`` counter.
    """

    def __init__(self, make_engine):
        """``make_engine`` builds one engine (called twice — the
        factory form keeps the two engines' construction identical
        without this class knowing the model/ladder/device args)."""
        self._engines = [make_engine(), make_engine()]
        self._active_idx = 0
        self._lock = threading.Lock()  # serializes cutovers, not reads
        self.cutovers = 0

    @property
    def active(self):
        return self._engines[self._active_idx]

    @property
    def standby(self):
        return self._engines[1 - self._active_idx]

    @property
    def params(self):
        return self._engines[self._active_idx].params

    # -- serving surface (active color) ---------------------------------
    def submit(self, row):
        # one atomic read of the index: a request races the flip into
        # exactly one color, and whichever engine admitted it delivers
        # it (the old color keeps draining after a flip)
        return self._engines[self._active_idx].submit(row)

    def predict(self, rows, timeout_s=None):
        return self._engines[self._active_idx].predict(
            rows, timeout_s=timeout_s)

    def submit_generate(self, tokens, max_new_tokens=None, eos_id=None,
                        on_token=None, deadline_s=None,
                        priority="interactive"):
        # decode passthrough (DecodeEngine colors): same atomic-read
        # race rule — a generation lands WHOLE in one color; after a
        # cutover the old color finishes every sequence it admitted on
        # the params they were admitted under (the engine pins them),
        # so a mid-decode rollout never drops a sequence
        return self._engines[self._active_idx].submit_generate(
            tokens, max_new_tokens=max_new_tokens, eos_id=eos_id,
            on_token=on_token, deadline_s=deadline_s,
            priority=priority)

    def generate(self, tokens, max_new_tokens=None, eos_id=None,
                 timeout_s=None):
        return self.submit_generate(
            tokens, max_new_tokens=max_new_tokens,
            eos_id=eos_id).result(timeout=timeout_s)

    # -- rollout --------------------------------------------------------
    def set_params(self, state, step=None):
        """Load ``state`` into the standby, then atomically cut traffic
        over to it.  The previous active keeps its queue and finishes
        every admitted request on the params they were admitted under,
        then becomes the next rollout's standby."""
        with self._lock:
            standby_idx = 1 - self._active_idx
            self._engines[standby_idx].set_params(state, step=step)
            self._active_idx = standby_idx  # THE cutover instant
            self.cutovers += 1
        metrics.counter("route.cutovers").inc()
        events.emit("route_cutover", step=step,
                    active_engine=standby_idx, cutovers=self.cutovers)

    def resize(self, n):
        """Fan to both colors: the standby must already be at size when
        it becomes active mid-incident."""
        with self._lock:
            for e in self._engines:
                e.resize(n)
        return n

    # -- lifecycle / introspection --------------------------------------
    def drain(self, timeout_s=None):
        outs = [e.drain(timeout_s=timeout_s) for e in self._engines]
        a = outs[self._active_idx]
        return {**a, "standby_delivered":
                outs[1 - self._active_idx]["delivered"]}

    def close(self, drain=True, timeout_s=None):
        for e in self._engines:
            e.close(drain=drain, timeout_s=timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def draining(self):
        return self._engines[self._active_idx].draining

    @property
    def running(self):
        return self._engines[self._active_idx].running

    def stats(self):
        st = self._engines[self._active_idx].stats()
        st["cutovers"] = self.cutovers
        st["active_engine"] = self._active_idx
        st["standby_outstanding"] = \
            self._engines[1 - self._active_idx].stats()["outstanding"]
        return st


class CheckpointWatcher:
    """Poll a ``Checkpointer`` for newly promoted steps and hot-swap
    them into a :class:`~dist_keras_tpu_torch.serving.engine.ServingEngine`.

    Args:
      engine: the live engine (anything with ``set_params``).
      checkpointer: ``checkpoint.Checkpointer`` (read-only use: a
        polling watcher can never interfere with the writer).
      poll_s: latest-step poll interval for the background loop.
      template: the tree each step is restored onto (its leaves give
        dtype and device); it must match the saved state's whole
        structure.  Default None: the whole state is restored to the
        host and its ``"params"`` are placed onto ``engine.params`` when
        the engine exposes them.
      initial_step: steps <= this are considered already served.
        Default: the latest step at construction, so a fresh watcher
        only reacts to NEW promotions.
      on_error: optional callback ``(step, exc)`` from the background
        loop after a reload fails (already recorded + old params kept).
    """

    def __init__(self, engine, checkpointer, poll_s=1.0, template=None,
                 initial_step=None, retry=None, on_error=None):
        self.engine = engine
        self.checkpointer = checkpointer
        self.poll_s = float(poll_s)
        self.template = template
        self.on_error = on_error
        self._retry = retry or RetryPolicy(
            attempts=3, backoff=0.05, jitter=0.0, retryable=(OSError,),
            name="serve.reload")
        self.last_step = (checkpointer.latest_step()
                          if initial_step is None else int(initial_step))
        self.reloads = 0
        self.errors = 0
        self.skipped_corrupt = 0
        # steps already convicted corrupt but not yet folded into
        # last_step (a restore failure on the chosen INTACT step keeps
        # last_step put so the restore is retried next poll — without
        # this set each such poll would re-hash the corrupt steps'
        # whole payloads and re-emit reload_skipped_corrupt for them)
        self._corrupt_seen = set()
        # steps whose rotted local copy was already re-fetched once
        # from the remote tier — a remote copy that convicts too must
        # not re-download every poll
        self._remote_healed = set()
        self._stop = threading.Event()
        self._thread = None

    def poll_once(self):
        """Check for a newer promoted step; reload it into the engine.

        -> the step reloaded (the NEWEST verifiable step newer than
        ``last_step`` — a rotted latest falls back to an intact
        intermediate promotion), or None when nothing new OR every
        newer step failed integrity verification (skipped, typed
        ``reload_skipped_corrupt`` event per corrupt step, old params
        kept — for both direct callers and the background loop; a
        rotted promoted step is an expected hazard of watching a live
        training directory, not an exception for every caller to
        re-handle).  Raises the (typed) reload error to a direct
        caller — the background loop is the path that absorbs it."""
        from dist_keras_tpu_torch.checkpoint import CheckpointCorrupt

        # remote tier first: a serving host whose checkpointer points
        # at its OWN local cache dir (the spot-serving deployment that
        # configures DK_CKPT_REMOTE) pulls newly completed remote
        # steps down before the local scan — the pull-through half of
        # the remote fallback.  Typed pull failures are absorbed (the
        # ckpt.pull retry surface already recorded them); the engine
        # keeps serving whatever it has.
        if self.checkpointer.has_remote():
            try:
                self.checkpointer.fetch_remote_newer(
                    self.last_step, skip=self._corrupt_seen)
            except (OSError, CheckpointCorrupt) as e:
                metrics.counter("serve.reload.errors").inc()
                events.emit("serve_reload_error",
                            error=type(e).__name__,
                            detail="remote fetch: " + str(e)[:160])
        # timeout_s=0 = a single non-blocking probe of the promoted
        # steps; the BLOCKING wait stays in wait_for_step_after for
        # direct callers, while this loop keeps its own stoppable
        # cadence (self._stop.wait between probes)
        newest = self.checkpointer.wait_for_step_after(
            step=self.last_step, timeout_s=0)
        if newest is None:
            return None
        # newest-first over EVERY promoted step newer than last_step:
        # a rotted latest must not shadow an intact intermediate
        # promotion (trainer promotes 5 then 6, 6 rots between polls —
        # serving step-4 params until step 7 lands would be one full
        # cadence of staleness the directory already has the cure for)
        candidates = [s for s in self.checkpointer.all_steps()
                      if s > (self.last_step or 0)] or [newest]
        step = None
        for cand in reversed(candidates):
            if cand in self._corrupt_seen:
                continue  # convicted on an earlier poll: dead bytes
            try:
                # read-only probe (never quarantines — this process is
                # a reader of someone else's training directory); "ok"
                # and the legacy "unverifiable" both proceed to the
                # swap.  A step written by a DIFFERENT world than this
                # server's (a world-1 server hot-loading a pod-written
                # checkpoint) is a RESHARD restore — it will read
                # EVERY host's payload, so the probe must cover them
                # all, and the restore below re-partitions via
                # resilience.elastic instead of failing the per-rank
                # payload lookup.
                _rank, world = self.checkpointer._coord_ids()
                if self.checkpointer.saved_world(cand) != world:
                    self.checkpointer.verify(cand, all_hosts=True)
                else:
                    self.checkpointer.verify(cand)
                step = cand
                break
            except CheckpointCorrupt as e:
                if cand not in self._remote_healed \
                        and self.checkpointer._remote_has_quiet(cand):
                    # the remote tier still holds this exact step:
                    # replace the rotted local copy with the clean
                    # remote bytes and re-verify ONCE — the serving
                    # analogue of restore()'s remote self-heal.
                    # (Assumes the watcher's directory is this host's
                    # own pull-through cache — the deployment that
                    # configures a remote tier.)
                    self._remote_healed.add(cand)
                    try:
                        self.checkpointer.fetch_remote(cand)
                        _r, world = self.checkpointer._coord_ids()
                        self.checkpointer.verify(
                            cand, all_hosts=self.checkpointer
                            .saved_world(cand) != world)
                        step = cand
                        break
                    except (OSError, CheckpointCorrupt):
                        pass  # remote copy unusable too: convict
                self._corrupt_seen.add(cand)
                self.skipped_corrupt += 1
                metrics.counter("serve.reload.skipped_corrupt").inc()
                events.emit("reload_skipped_corrupt", step=int(cand),
                            detail=str(e)[:200])
        # every newer step is now seen — loaded, or skipped as corrupt
        # bytes that cannot heal (hot-looping verification against
        # them would melt the poll loop; the trainer's NEXT promotion
        # supersedes them)
        if step is None:
            self._advance(max(candidates))
            return None
        with span("serve.reload", step=step):
            def attempt():
                fault_point("serve.reload")
                # verify=False: the read-only probe above already ran.
                # The default VERIFIED restore would, if the step rots
                # between probe and read, QUARANTINE it (a rename in
                # the trainer's live directory this reader must never
                # perform) and silently fall back — the engine would
                # then serve step-N-1 params stamped as step N.  With
                # verification pinned off the race window collapses to
                # a typed load error, absorbed like any reload failure.
                return self.checkpointer.restore(
                    step=step, template=self.template, verify=False)
            got, state = self._retry.call(attempt)
            self.engine.set_params(self._onto_engine(state), step=got)
        # max, not step: a corrupt candidate NEWER than the one loaded
        # is seen too, or the next poll would re-verify dead bytes
        self._advance(max(candidates))
        self.reloads += 1
        return step

    def _onto_engine(self, state):
        """``state``'s params placed onto the engine's own (its dtypes
        and devices), when no template was given and the engine exposes
        its params; else ``state`` as restored."""
        params = getattr(self.engine, "params", None)
        if self.template is not None or params is None:
            return state
        from dist_keras_tpu_torch.checkpoint import apply_template

        if isinstance(state, dict) and "params" in state:
            state = state["params"]
        return apply_template(state, params)

    def _advance(self, step):
        self.last_step = step
        # convictions at or below the new horizon are subsumed by
        # last_step; the sets only ever hold the (bounded) window of
        # corrupt steps newer than an intact one still being retried
        self._corrupt_seen = {s for s in self._corrupt_seen if s > step}
        self._remote_healed = {s for s in self._remote_healed
                               if s > step}

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            # dklint: ignore[broad-except] reload failure is typed + non-fatal; old params keep serving
            except Exception as e:
                # typed, recorded, non-fatal: keep serving old params
                self.errors += 1
                metrics.counter("serve.reload.errors").inc()
                events.emit("serve_reload_error",
                            error=type(e).__name__, detail=str(e)[:200])
                if self.on_error is not None:
                    try:
                        self.on_error(self.checkpointer.latest_step(), e)
                    # dklint: ignore[broad-except] user on_reload hook is best-effort
                    except Exception:  # pragma: no cover - user hook
                        pass
            self._stop.wait(self.poll_s)

    def start(self):
        """Start the background watch loop (daemon thread); -> self."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dk-serve-reload")
        self._thread.start()
        return self

    def stop(self, timeout_s=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
