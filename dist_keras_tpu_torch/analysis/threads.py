"""dklint thread-root registry of the port — which functions execute
off-main (counterpart of ``dist_keras_tpu/analysis/threads.py``).

The port starts its threads at the JAX package's sites, under the same
module and function names, so every row below is the JAX registry's and
resolves in the port; a root only the port had would get a row of its
own.  ``LOCK_ORDER`` is likewise the JAX declaration, naming the port's
locks.

The concurrency pass (``analysis/concurrency.py``) needs ground truth
for *where threads start*: every ``threading.Thread(target=...)`` /
``threading.Timer`` / ``signal.signal`` registration site in the tree
must resolve to a named root here (``thread-root-unknown`` otherwise;
a dead row is ``thread-root-unused``).  Like the fault/event/metric
registries, this is extracted from the AST — never imported — so
fixture trees lint exactly like the real package.

Value forms:

- ``"rel:Qualname"`` — the target function of a plain registration
  site (``rel`` is the path inside the package root).  The shared-state
  audit seeds reachability here: everything statically reachable from
  this function runs on that thread.
- ``"~rel:Qualname"`` / ``"~rel:Class.*"`` — a framework-dispatched
  root with no visible registration site (``ThreadingHTTPServer``
  spawns one handler thread per request; the registration lives inside
  the stdlib).  Validated to exist; seeds reachability; the
  registration site that *starts* the framework loop carries a
  ``# dklint: thread-root=<name>`` annotation instead.
- ``"external"`` — a foreign/restored handler the tree re-registers
  (``preemption.restore`` re-installs whatever handler was there
  before): nothing to seed, the annotated site is the whole story.

Signal handlers run ON the main thread (re-entrantly — the round-12
``signal-unsafe`` pass owns their purity story) but are inventoried
here too: the registry is the one place that answers "what executes
outside straight-line main-thread code".
"""

# name -> location (see module docstring for the value forms)
KNOWN_THREAD_ROOTS = {
    # async checkpoint pipeline (round 14)
    "ckpt.async_writer": "checkpoint.py:Checkpointer._writer_loop",
    # remote checkpoint tier (round 18)
    "ckpt.uploader": "resilience/store.py:CheckpointUploader._loop",
    "ckpt.store_http": "resilience/store.py:ObjectStoreServer"
                       ".serve_forever",
    "ckpt.store_http_handler": "~resilience/store.py:_StoreHandler.*",
    # streaming data plane
    "stream.socket_server": "data/streaming.py:SocketSource._serve",
    # serving tier
    "serve.batcher": "serving/engine.py:ServingEngine._batcher_loop",
    "serve.replica": "serving/engine.py:ServingEngine._replica_loop",
    "serve.reload_watcher": "serving/reload.py:CheckpointWatcher._loop",
    "serve.http": "serving/server.py:ServingServer.serve_forever",
    "serve.http_handler": "~serving/server.py:_Handler.*",
    "decode.worker": "serving/decode.py:DecodeEngine._worker_main",
    # survivability bench chaos timer (the Timer target is a lambda, so
    # the registration site carries the annotation and this row seeds
    # reachability at the function the lambda actually calls)
    "bench.kill_timer": "~serving/decode.py:DecodeEngine.kill_replica",
    # serving router tier + autoscaler
    "route.http": "serving/router.py:RouterServer.serve_forever",
    "route.http_handler": "~serving/router.py:_Handler.*",
    "route.health": "serving/router.py:RouterServer._health_loop",
    "route.hedge": "serving/router.py:RouterServer"
                   "._hedged_generate.run",
    "serve.autoscaler": "serving/autoscale.py:ReplicaAutoscaler._loop",
    # coordination plane
    "coord.deadline": "resilience/coordination.py:with_deadline.run",
    "coord.heartbeat": "resilience/coordination.py:Heartbeat._loop",
    # preemption
    "preempt.signal_handler": "resilience/preemption.py:_handler",
    "preempt.watcher": "resilience/preemption.py:on_request._watch",
    "preempt.restore": "external",
    # the per-card fan-out's TERM / INT forwarding
    "launch.fan_out_signal": "launch/local.py:run.forward",
    # telemetry plane (round 11)
    "obs.sampler": "observability/timeseries.py:MetricsSampler._loop",
    "obs.exporter": "~observability/prometheus.py:_Handler.*",
    # parameter-server training mode (round 17)
    "ps.http": "ps/server.py:PSServer.serve_forever",
    "ps.http_handler": "~ps/server.py:_Handler.*",
    "ps.lease_reaper": "ps/server.py:PSServer._reaper_loop",
}

# Declared-safe lock orderings: (outer, inner) pairs asserted ONCE, so
# the lock-order pass can convict a future acquisition that inverts
# them (the inverted edge closes a cycle through the declaration) even
# before both directions are observable statically.  Lock names are
# ``rel:Class.attr`` / ``rel:attr`` of the constructor-assignment the
# pass registers.
LOCK_ORDER = (
    # the serving engine updates registry instruments (gauge/counter
    # leaf locks) while holding its admission condition
    ("serving/engine.py:ServingEngine._cond",
     "observability/metrics.py:Gauge._lock"),
    ("serving/engine.py:ServingEngine._cond",
     "observability/metrics.py:Counter._lock"),
    # the decode engine does the same under its scheduler condition,
    # and additionally reads/updates the per-replica KV allocator
    # (strictly inner, never takes the engine lock back)
    ("serving/decode.py:DecodeEngine._cond",
     "observability/metrics.py:Gauge._lock"),
    ("serving/decode.py:DecodeEngine._cond",
     "observability/metrics.py:Counter._lock"),
    ("serving/decode.py:DecodeEngine._cond",
     "serving/kv_cache.py:PagedKVCache._lock"),
    # the async checkpoint writer may emit events between state
    # transitions; the event writer's lock is strictly inner
    ("checkpoint.py:Checkpointer._async_cv",
     "observability/events.py:EventWriter._lock"),
)
