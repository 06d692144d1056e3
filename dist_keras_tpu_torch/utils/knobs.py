"""Central registry of every ``DK_*`` environment knob — name, default,
parser, one-line doc.

The port's own copy of ``dist_keras_tpu/utils/knobs.py`` (stdlib-only),
with the same registry, so a knob means the same thing under both
packages.  Every ``DK_*`` read in the port resolves through :func:`raw`
/ :func:`get`: :func:`raw` is exactly ``os.environ.get(name)`` (re-read
per call, so launcher-exported values win regardless of import order)
plus a loud ``KeyError`` for unregistered names; :func:`get` adds the
registered default and parser, and ``on_error`` chooses between the
knob's documented malformed-value behaviour: ``"default"`` (telemetry
knobs degrade silently) or ``"raise"`` (schedule knobs like
``DK_FAULTS_RATE`` fail loudly at load time).  :func:`doc_table`
renders the registry as a markdown table.

The registry lists knobs of subsystems the port has not reached yet;
they are kept so the two copies stay one registry.
"""

from __future__ import annotations

import os


def _parse_bool(v):
    """The framework's uniform boolean-knob convention: only the
    explicit "off" spellings are False."""
    return v.strip().lower() not in ("0", "off", "no", "false")


class Knob:
    """One registered environment knob."""

    __slots__ = ("name", "default", "parse", "doc", "kind", "on_error")

    def __init__(self, name, default, parse, doc, kind=None,
                 on_error="default"):
        self.name = str(name)
        self.default = default
        self.parse = parse
        self.doc = str(doc)
        self.kind = kind or getattr(parse, "__name__", "str")
        if on_error not in ("default", "raise"):
            raise ValueError(f"on_error={on_error!r}")
        self.on_error = on_error


KNOBS = {}  # name -> Knob, insertion-ordered (doc_table renders in order)


def _register(name, default, parse, doc, kind=None, on_error="default"):
    if name in KNOBS:
        raise ValueError(f"knob {name!r} registered twice")
    KNOBS[name] = Knob(name, default, parse, doc, kind=kind,
                       on_error=on_error)


# -- the registry ------------------------------------------------------
# Grouped by subsystem; `kind` is the display type in `doc_table`.
# Adding a DK_* read anywhere?  Register it here first, and in the JAX
# package's registry too.

# coordination / multi-host
_register("DK_COORD_DIR", None, str,
          "filesystem-rendezvous directory: selects `FileCoordinator` "
          "(exported per host by `launch.Job(coord_dir=...)`)")
_register("DK_COORD_RANK", None, int,
          "this host's coordination rank — REQUIRED with `DK_COORD_DIR` "
          "(a silent rank-0 default would seat two leaders)")
_register("DK_COORD_WORLD", None, int,
          "world size — REQUIRED with `DK_COORD_DIR`")
_register("DK_COORD_SESSION", "", str,
          "job-incarnation subdirectory under `DK_COORD_DIR` (the "
          "auto-resume supervisor rotates it per relaunch wave)")
_register("DK_COORD_TIMEOUT_S", 120.0, float, kind="seconds",
          doc="default deadline for every consensus op, the checkpoint "
              "commit wait and `comm.barrier` (malformed -> 120)")
_register("DK_COORD_STALE_S", 10.0, float, kind="seconds",
          doc="heartbeat stale window for dead-peer verdicts — "
              "launcher and workers judge liveness by this same clock")

# checkpointing
_register("DK_CKPT_VERIFY", True, _parse_bool, kind="bool",
          doc="`0` opts out of BOTH integrity-manifest writing and "
              "restore-side verification")
_register("DK_CKPT_TWO_PHASE", True, _parse_bool, kind="bool",
          doc="`0` opts a pod with per-host LOCAL checkpoint dirs out "
              "of the shared-fs two-phase commit protocol")
_register("DK_CKPT_ASYNC", True, _parse_bool, kind="bool",
          doc="`0` makes `Checkpointer.save` fully synchronous again; "
              "default: snapshot at the step boundary, then serialize "
              "+ hash + commit on a background writer thread — the "
              "returned handle's `wait()` is the durability barrier")
_register("DK_CKPT_CHUNK_MB", 64.0, float, kind="MB",
          doc="streaming-writer chunk size: array leaves at least "
              "this large are written as per-file chunks whose "
              "SHA-256 is computed as the bytes stream out (one "
              "pass); `0` falls back to the legacy un-chunked "
              "orbax/pickle payload format")
_register("DK_CKPT_DIFF", False, _parse_bool, kind="bool",
          doc="`1` makes chunked saves DIFFERENTIAL: chunk bytes land "
              "once in the shared `chunks/` content-addressed store "
              "(named by their SHA-256) and a save skips any chunk "
              "whose hash is already there — unchanged leaves cost "
              "only the in-memory hash.  Needs hashing, so "
              "`DK_CKPT_VERIFY=0` disables it")
_register("DK_CKPT_GC_GRACE_S", 120.0, float, kind="seconds",
          doc="chunk GC never collects a CAS entry whose mtime is "
              "younger than this — the fence protecting an in-flight "
              "save's just-written or just-reused chunks (reuse "
              "touches the file)")
_register("DK_CKPT_REMOTE", None, str,
          "remote checkpoint store URL (`http://host:port[/prefix]`, "
          "`file:///dir` or a plain directory): promoted steps mirror "
          "out through the background uploader and "
          "restore/reshard/the serving watcher fall back to it when "
          "the local step is missing or convicted corrupt")
_register("DK_CKPT_REMOTE_PUSH", True, _parse_bool, kind="bool",
          doc="`0` keeps the remote tier READ-ONLY for this process: "
              "no background uploader is armed, restores still pull")
_register("DK_CKPT_REMOTE_POLL_S", 2.0, float, kind="seconds",
          doc="background uploader poll cadence for newly promoted "
              "steps")
_register("DK_CKPT_REMOTE_KEEP", None, int,
          "remote retention horizon: after each uploader poll, "
          "mirrored steps beyond the newest N are pruned "
          "(marker-first, then a conservative chunk sweep).  Unset = "
          "follow the local checkpointer's `max_to_keep`; `0` = never "
          "prune (the pre-round-20 accumulate-forever behavior)")

# elastic world resize
_register("DK_ELASTIC", True, _parse_bool, kind="bool",
          doc="`0` disables the elastic paths: a world-mismatched "
              "restore keeps the pre-elastic semantics and "
              "`supervise_run` never shrinks the pod")
_register("DK_ELASTIC_MIN_WORLD", 1, int,
          "the elastic supervisor never resizes below this many "
          "hosts (a would-be smaller pod dies typed on the restart "
          "budget instead)")

# fault injection / chaos
_register("DK_FAULTS", "", str,
          "semicolon-separated fault schedule "
          "`point[@at[xN]][:k=v,...]` (malformed entries fail loudly "
          "at load time)")
_register("DK_FAULTS_SEED", None, int, on_error="raise",
          doc="chaos mode: arm every `faults.KNOWN_POINTS` entry with "
              "a seeded random schedule (pure function of the seed)")
_register("DK_FAULTS_RATE", 0.25, float, on_error="raise",
          doc="chaos: per-point arming probability in [0, 1]")
_register("DK_FAULTS_HORIZON", 20, int, on_error="raise",
          doc="chaos: armed points fire at a random call index below "
              "this horizon")
_register("DK_FAULTS_POINTS", "", str,
          "chaos: comma list restricting the armed point set (unknown "
          "names fail loudly)")
_register("DK_FAULTS_HORIZON_S", None, float, kind="seconds",
          on_error="raise",
          doc="chaos: when set, armed points fire at a random TIME in "
              "[0, horizon_s) on the world clock instead of a call "
              "index — simulated seconds under the cluster simulator")

# cluster simulator
_register("DK_SIM_SEED", 0, int,
          "default scenario seed for the cluster simulator CLI and "
          "the sim gate — same seed + same scenario = bit-identical "
          "event trace")
_register("DK_SIM_HOSTS", 1000, int,
          "default simulated host count for scenarios that scale by "
          "world size (ps_churn, preemption_storm, ...)")
_register("DK_SIM_TIME_LIMIT_S", 3600.0, float, kind="seconds",
          doc="simulated-time budget per scenario: a scenario still "
              "running past this much SIM time is declared hung "
              "(typed verdict, never a wall-clock hang)")

# observability: event log
_register("DK_OBS_DIR", None, str,
          "event-log directory — each host appends "
          "`events-rank_{i}.jsonl`; unset = every emit is a no-op")
_register("DK_OBS_FLUSH", False, _parse_bool, kind="bool",
          doc="`1` = fsync after every event line (power-loss durable)")
_register("DK_OBS_ROTATE_MB", 0.0, float, kind="MB",
          doc="size cap per event file before rotation to `.jsonl.1...`;"
              " unset/0 = never rotate")
_register("DK_OBS_ROTATE_KEEP", 3, int,
          "rotated event segments retained per host")

# observability: tracing + flight recorder
_register("DK_TRACE_ID", None, str,
          "job-wide trace id (32 hex chars) adopted by every root span "
          "— exported per host by `launch.Job(obs_dir=...)` so a whole "
          "pod stitches into one trace")
_register("DK_TRACE_SEED", None, int,
          "seed for trace/span id minting: set = ids are a pure "
          "function of the seed (gate/test replay); unset = OS entropy")
_register("DK_TRACE_RING", 2048, int,
          "flight-recorder ring capacity (recent span/event records "
          "retained in memory per process, dumped on watchdog alerts, "
          "preemption, crash, or `/tracez`)")

# observability: SLO plane + tail-based trace retention (round 22)
_register("DK_SLO", False, _parse_bool, kind="bool",
          doc="`1` arms the request-level SLO plane: the default "
              "serving objectives register, every sampler tick "
              "evaluates multi-window burn rates, the `slo_burn_rate` "
              "watchdog rule joins the default set, histograms "
              "capture trace exemplars, and `/slz` appears in "
              "`/statusz`")
_register("DK_SLO_LATENCY_S", 0.5, float, kind="seconds",
          doc="latency-objective threshold: a `serve.request` span "
              "slower than this is a bad event for the "
              "`serve_latency` objective (also the default "
              "slow-request bar for tail-based trace retention)")
_register("DK_SLO_TTFT_S", 1.0, float, kind="seconds",
          doc="time-to-first-token threshold: a decode request whose "
              "first generated token lands slower than this is a bad "
              "event for the `generate_ttft` objective")
_register("DK_TRACE_SAMPLE", 0.0, float,
          kind="fraction",
          doc="head-sampling rate in [0, 1] for tail-based retention: "
              "this fraction of HEALTHY traces is kept anyway "
              "(decided by a pure hash of the trace id, so replays "
              "keep the same traces)")
_register("DK_TRACE_RETAIN", False, _parse_bool, kind="bool",
          doc="`1` arms tail-based trace retention: per-request span "
              "records are buffered per trace and only written to "
              "the event log when the request ends slow (over the "
              "retention bar), errored, or head-sampled "
              "(`DK_TRACE_SAMPLE`) — steady healthy traffic stops "
              "growing the log linearly while every incident keeps "
              "its trace")
_register("DK_TRACE_RETAIN_SLOW_S", None, float, kind="seconds",
          doc="retention slow-request bar: a root request span at "
              "least this slow is always retained; unset = follow "
              "`DK_SLO_LATENCY_S`")
_register("DK_TRACE_RETAIN_BUDGET", 256, int,
          "max in-flight traces buffered by the retention policy; "
          "past the budget the OLDEST buffer is flushed to the log "
          "(fail open — pressure can only make retention keep more, "
          "never lose an incident trace)")

# observability: telemetry plane
_register("DK_OBS_SAMPLE_S", None, float, kind="seconds",
          doc="metrics-sampler cadence; unset = no sampler thread, no "
              "series (malformed = sampler stays off)")
_register("DK_OBS_TS_WINDOW", 512, int,
          "time-series ring size per metric")
_register("DK_WATCHDOG", True, _parse_bool, kind="bool",
          doc="`0`/`off` = the auto-started sampler skips the default "
              "watchdog rule set")
_register("DK_METRICS_PORT", None, int, kind="port",
          doc="arm the standalone per-host Prometheus exporter on this "
              "port (`/metrics`, `/metricsz`, `/healthz`)")

# alerting
_register("DK_ALERT_CMD", None, str,
          "operator webhook: every alert is piped as one JSON line to "
          "this shell command's stdin (best-effort, never kills the "
          "run)")
_register("DK_ALERT_CMD_TIMEOUT_S", 10.0, float, kind="seconds",
          doc="webhook command timeout")

# speed push (round 19)
_register("DK_COMM_OVERLAP", False, _parse_bool, kind="bool",
          doc="`1` overlaps the windowed trainers' boundary collective "
              "with the next window's local compute: each window's "
              "summed delta is applied ONE window late (the paper's "
              "async one-window-stale center), so the `psum` has no "
              "consumer until the following boundary and executes "
              "concurrently with window k+1's steps.  Off (default) = "
              "bit-identical to the blocked merge")
_register("DK_FUSED_BWD", False, _parse_bool, kind="bool",
          doc="`1` routes `flash_attention`'s backward through the "
              "single-pass fused kernel — but only after a cached "
              "per-(shape, blocking, compiler) `selfcheck()` parity "
              "run against the two-kernel reference passes EXACT in "
              "this process; mismatch or an unverifiable backend "
              "falls back to the reference backward with a "
              "`fused_bwd_rejected` event, never silent corruption")
_register("DK_PS_COMPRESS", None, str,
          "PS commit-delta compression spec: `fp16` or `int8`, with "
          "an optional `@<topk_fraction>`, e.g. `int8@0.1` — the worker "
          "quantizes (and optionally top-k-sparsifies) each window "
          "delta before the commit RPC, keeps the compression error "
          "as a client-side residual folded into the next window "
          "(error feedback), and the server dequantizes to float32 "
          "BEFORE DynSGD scaling; unset = full float32 deltas")

# serving
_register("DK_SERVE_PORT", None, int, kind="port",
          doc="the port a launched serving job binds (exported per "
              "host by `launch.Job(serve_port=...)`)")

# decode serving (serving/decode.py)
_register("DK_DECODE_KERNEL", False, _parse_bool, kind="bool",
          doc="`1` routes the decode engine's paged attention through "
              "the single-query Pallas kernel — but only after a "
              "cached per-(shape, compiler) `selfcheck()` parity run "
              "against the pure-jax paged reference passes EXACT in "
              "this process; mismatch or an unverifiable backend "
              "falls back to the reference with a "
              "`decode_kernel_rejected` event, never silent "
              "corruption")
_register("DK_DECODE_SHED_WATERMARK", 0.85, float,
          "KV-page occupancy fraction above which the decode engine "
          "brownout-sheds `priority=\"batch\"` admissions (typed "
          "`Overloaded(\"shed_batch\")` -> 503 + Retry-After) so "
          "interactive traffic keeps its SLO; `batch` is also shed "
          "while any SLO objective is breaching")

# serving router tier (serving/router.py)
_register("DK_ROUTE_PORT", None, int, kind="port",
          doc="the port a launched `RouterServer(port=None)` binds "
              "(exported per host by `launch.Job(route_port=...)`)")
_register("DK_ROUTE_BACKENDS", None, str,
          "comma-separated `host:port` list of backend serving hosts "
          "the router spreads `POST /predict` across (exported per "
          "host by `launch.Job(route_port=...)` from the pod's "
          "serve ports)")
_register("DK_ROUTE_PROBE_S", 0.5, float, kind="seconds",
          doc="router health-probe cadence: how often the background "
              "prober hits each backend's `/healthz` + `/metricsz` "
              "and runs the eviction/re-admission sweep")
_register("DK_ROUTE_STALE_S", 3.0, float, kind="seconds",
          doc="a backend whose last good `/healthz` is older than "
              "this is evicted from rotation (also the "
              "`dead_peers_at` heartbeat staleness bound when the "
              "router watches a coordination dir)")
_register("DK_ROUTE_FAILS", 3, int,
          "consecutive connect/forward failures that evict a backend "
          "immediately, without waiting for the stale window")
_register("DK_ROUTE_READMIT_CHECKS", 2, int,
          "consecutive healthy probes a previously-evicted backend "
          "must pass before it re-enters rotation (hysteresis — one "
          "lucky probe never re-admits a flapping host)")
_register("DK_ROUTE_HEDGE_QUANTILE", 0.95, float,
          "latency quantile of `route.forward_s` past which a "
          "non-streaming `/generate` forward is HEDGED to a second "
          "backend (first answer wins, the loser is cancelled); `0` "
          "disables hedging, values are clamped to [0.5, 0.999]")
_register("DK_ROUTE_HEDGE_BUDGET", 0.1, float,
          "hedge retry budget as a token-bucket ratio: every primary "
          "forward deposits this many tokens (capped at 10x), each "
          "hedge spends one — hedges can never amplify an overload "
          "past this fraction of real traffic; denied hedges count "
          "`route.hedge_denied`")

# parameter-server training mode
_register("DK_PS_ADDR", None, str,
          "`host:port` of the center-variable parameter server every "
          "PS worker talks to (exported per host by "
          "`launch.Job(ps_addr=...)`)")
_register("DK_PS_PORT", None, int, kind="port",
          doc="the port a launched `PSServer(port=None)` binds")
_register("DK_PS_WINDOW", 32, int,
          "default communication window: local steps a PS worker "
          "trains between pull and commit (exported per host by "
          "`launch.Job(ps_window=...)`; an explicit "
          "`PSWorkerTrainer(communication_window=)` wins)")
_register("DK_PS_LEASE_S", 15.0, float, kind="seconds",
          doc="worker lease TTL: a worker silent this long lapses out "
              "of the server's staleness accounting (its next commit "
              "auto-rejoins)")
_register("DK_PS_STALENESS_CAP", 1000, int,
          "commits staler than this many center updates are refused "
          "with a typed `StaleCommit` (the worker re-pulls) instead "
          "of an arbitrarily-down-scaled apply")
_register("DK_PS_COMMIT_DEADLINE_S", 60.0, float, kind="seconds",
          doc="overall deadline of the `ps.commit` retry surface — a "
              "wedged server becomes a typed error at a bounded "
              "instant, never an unbounded worker stall")


# -- access ------------------------------------------------------------

def _lookup(name):
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(
            f"unregistered environment knob {name!r}: every DK_* knob "
            "must be declared in dist_keras_tpu_torch/utils/knobs.py "
            "(name, default, parser, doc)")
    return knob


def raw(name):
    """``os.environ.get(name)`` for a REGISTERED knob: the raw string,
    or None when unset.  Re-read per call (no caching) so launcher-
    exported values win regardless of import order.  Call sites with
    bespoke parsing/validation use this and keep their logic."""
    _lookup(name)
    return os.environ.get(name)


def get(name):
    """The knob's parsed value: registered default when unset/empty,
    else ``parse(value)``.  A malformed value either falls back to the
    default or raises a loud ValueError, per the knob's registered
    ``on_error`` policy."""
    knob = _lookup(name)
    value = os.environ.get(name)
    if value is None or not value.strip():
        return knob.default
    try:
        return knob.parse(value.strip())
    except (ValueError, TypeError):
        if knob.on_error == "raise":
            raise ValueError(
                f"malformed {name}={value!r}: expected {knob.kind}")
        return knob.default


def doc_table():
    """The registry rendered as a markdown table (knob, type, default,
    meaning), in registration order."""
    lines = ["| knob | type | default | meaning |", "|---|---|---|---|"]
    for knob in KNOBS.values():
        if knob.default is None:
            default = "—"
        elif knob.default == "":
            default = '`""`'
        else:
            default = f"`{knob.default}`"
        doc = " ".join(knob.doc.split())
        lines.append(
            f"| `{knob.name}` | {knob.kind} | {default} | {doc} |")
    return "\n".join(lines)
