"""Multi-host run report — merge per-host event logs into one timeline; a
copy of the JAX package's ``observability/report.py`` (stdlib only) on
the same event files, without its SLO section (``slo_summary`` /
``render_slo`` read ``trace_export.py``: ROADMAP queue 1, item 18).

The launcher (or anyone pointed at a ``DK_OBS_DIR`` after the fact, by
:func:`render` / :func:`write_report`; the CLI is item 18) merges the per-host
``events-rank_{i}.jsonl`` files into a single timeline ordered by
``(time, rank, seq)`` and summarizes it: per-phase durations (from
spans), coordination-op durations, retry counts, checkpoint commits,
nonfinite-step totals, preemption attribution (WHICH rank got the
signal, what step the cluster agreed to save), and the last-N events per
host — which is exactly the artifact needed to attribute a hang like the
r05 "backend unresponsive" bench failure or a ``BarrierTimeout`` to the
host that stalled: the dead host's file simply *stops*, and the merged
tail shows what every other host was waiting on.

Strictly read-only and import-light (stdlib only): safe to run from a
monitor loop against a live run's directory.
"""

from __future__ import annotations

import json
import os
import re
import time

_FILE_RE = re.compile(r"^events-rank_(\d+)\.jsonl(?:\.(\d+))?$")


def event_files(directory):
    """-> [(rank, path)] of the per-host event files, including rotated
    segments (``events-rank_{i}.jsonl.N`` — produced by the
    ``DK_OBS_ROTATE_MB`` size cap) and files one level down in
    ``host_{i}/`` subdirectories (the layout ``Job.collect_obs``
    rsyncs back, so a collect destination is directly monitorable).
    Ordered per rank OLDEST segment first (highest ``.N``, then the
    active file) so a sequential reader sees each host's history in
    emission order.  The merged timeline re-sorts by (t, rank, seq)
    anyway; this order is for humans cat-ing the list."""
    directory = os.path.abspath(os.path.expanduser(str(directory)))
    out = []

    def _scan(d):
        try:
            names = os.listdir(d)
        except OSError:
            return []
        return [(n, os.path.join(d, n)) for n in names]

    entries = _scan(directory)
    for name, path in list(entries):
        if re.match(r"^host_\d+$", name) and os.path.isdir(path):
            entries.extend(_scan(path))
    for name, path in entries:
        m = _FILE_RE.match(name)
        if m:
            seg = int(m.group(2)) if m.group(2) else 0
            out.append(((int(m.group(1)), -seg), path))
    return [(key[0], path) for key, path in sorted(out)]


def read_events(directory):
    """Merged timeline: every host's events ordered by (t, rank, seq).

    A torn final line (host killed mid-write — the atomic line writer
    makes this rare but a dying fs can still truncate) is skipped, not
    fatal: the report must work best exactly when the run died worst.
    """
    events = []
    for rank, path in event_files(directory):
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # torn tail line
            ev.setdefault("rank", rank)
            events.append(ev)
    events.sort(key=lambda e: (e.get("t", 0.0), e.get("rank", 0),
                               e.get("seq", 0)))
    return events


def _acc(table, key, dt):
    row = table.setdefault(key, {"count": 0, "total_s": 0.0,
                                 "max_s": 0.0})
    row["count"] += 1
    if dt is not None:
        row["total_s"] += float(dt)
        row["max_s"] = max(row["max_s"], float(dt))


def summarize(events):
    """-> structured summary of a merged timeline (JSON-ready)."""
    ranks = {}
    phases = {}       # span path -> {count, total_s, max_s}
    coord = {}        # coordination/barrier op -> {count, total_s, max_s}
    retries = {}      # retry-surface name -> {attempts, exhausted}
    faults = {}       # fault point -> fires
    saves = {}        # rank -> last ckpt_save step
    promoted = []
    restored = []
    epochs = {}       # rank -> epoch_end count
    signalled = {}    # rank -> signum (preemption attribution)
    dead = []         # peer-dead transitions [(rank reporting, peer)]
    resizes = []      # elastic world resizes, in timeline order
    reshards = []     # resharding restores [(rank, step, N -> M)]
    # parameter-server attribution (ps/): per-worker commit counts,
    # the server-side staleness histogram, membership transitions
    ps_commits = {}   # wid -> commits applied
    ps_staleness = {}  # staleness value -> count (the histogram)
    ps_joins = []     # [{wid, rank, rejoined}] in timeline order
    ps_lapses = []    # [{wid, rank, reason}] in timeline order
    ps_rejected = 0   # over-cap commits refused (typed StaleCommit)
    # decode survivability attribution (serving/decode.py): which
    # replica died, how many sequences it carried, where they landed
    dq = []           # quarantines [{replica, orphans, cause}]
    dr = {}           # recoveries: dst replica -> count
    dshed = {}        # brownout sheds: reason -> count
    ddl = {"infeasible": 0, "expired": 0}
    dleaks = 0        # self-check reclaimed pages
    nonfinite = 0
    for ev in events:
        rank = int(ev.get("rank", 0))
        kind = ev.get("kind", "?")
        row = ranks.setdefault(rank, {"events": 0, "first_t": None,
                                      "last_t": None, "last_kind": None})
        row["events"] += 1
        t = ev.get("t")
        if t is not None:
            if row["first_t"] is None:
                row["first_t"] = t
            row["last_t"] = t
        row["last_kind"] = kind
        if kind == "span_end":
            _acc(phases, ev.get("span", "?"), ev.get("duration_s"))
        elif kind in ("coord", "coord_error"):
            _acc(coord, ev.get("op", "?"), ev.get("duration_s"))
        elif kind == "barrier":
            _acc(coord, f"comm.barrier({ev.get('tag', '?')})",
                 ev.get("duration_s"))
        elif kind == "retry":
            r = retries.setdefault(ev.get("name", "?"),
                                   {"attempts": 0, "exhausted": 0})
            r["attempts"] += 1
        elif kind == "retry_exhausted":
            r = retries.setdefault(ev.get("name", "?"),
                                   {"attempts": 0, "exhausted": 0})
            r["exhausted"] += 1
        elif kind == "fault":
            point = ev.get("point", "?")
            faults[point] = faults.get(point, 0) + 1
        elif kind == "ckpt_save":
            if ev.get("step") is not None:
                saves[rank] = int(ev["step"])
        elif kind == "ckpt_promote":
            if ev.get("step") is not None:
                promoted.append(int(ev["step"]))
        elif kind == "ckpt_restore":
            if ev.get("step") is not None:
                restored.append(int(ev["step"]))
        elif kind == "epoch_end":
            epochs[rank] = epochs.get(rank, 0) + 1
            nonfinite += int(ev.get("nonfinite_steps", 0) or 0)
        elif kind in ("preempt_signal", "preempt"):
            # attribution, not participation: every host emits a
            # "preempt" at the boundary where it honors the cluster
            # vote, but a host that merely ADOPTED the verdict
            # (adopted=True) did not receive the OS signal — only the
            # genuinely-signalled rank(s) belong here
            if not ev.get("adopted"):
                signalled.setdefault(rank, ev.get("signum"))
        elif kind == "peer_dead":
            dead.append((rank, ev.get("peer")))
        elif kind == "elastic_resize":
            resizes.append({
                "session": ev.get("session"),
                "old_world": ev.get("old_world"),
                "new_world": ev.get("new_world"),
                "dropped_ranks": ev.get("dropped_ranks"),
                "dropped_hosts": ev.get("dropped_hosts")})
        elif kind == "ps_commit":
            wid = ev.get("wid", "?")
            ps_commits[wid] = ps_commits.get(wid, 0) + 1
            s = ev.get("staleness")
            if s is not None:
                ps_staleness[int(s)] = ps_staleness.get(int(s), 0) + 1
        elif kind == "ps_worker_join":
            ps_joins.append({"wid": ev.get("wid"),
                             "rank": ev.get("worker_rank"),
                             "rejoined": bool(ev.get("rejoined"))})
        elif kind == "ps_worker_lapse":
            ps_lapses.append({"wid": ev.get("wid"),
                              "rank": ev.get("worker_rank"),
                              "reason": ev.get("reason")})
        elif kind == "ps_stale_scaled":
            if ev.get("rejected"):
                ps_rejected += 1
        elif kind == "decode_quarantine":
            dq.append({"replica": ev.get("replica"),
                       "orphans": ev.get("orphans"),
                       "cause": ev.get("cause")})
        elif kind == "decode_recover":
            dst = ev.get("dst", "?")
            dr[dst] = dr.get(dst, 0) + 1
        elif kind == "decode_shed":
            why = ev.get("reason", "?")
            dshed[why] = dshed.get(why, 0) + 1
        elif kind == "decode_deadline":
            if ev.get("phase") == "admission":
                ddl["infeasible"] += 1
            else:
                ddl["expired"] += 1
        elif kind == "decode_kv_leak":
            dleaks += int(ev.get("pages", 0) or 0)
        elif kind == "reshard_restore":
            reshards.append({
                "rank": rank, "step": ev.get("step"),
                "saved_world": ev.get("saved_world"),
                "world": ev.get("world"),
                "n_sharded": ev.get("n_sharded"),
                "bytes_in": ev.get("bytes_in")})
    # the "agreed save step": under coordinated preemption every rank
    # saves the same step — report it when the saves agree
    agreed = None
    if saves and len(set(saves.values())) == 1:
        agreed = next(iter(saves.values()))
    return {
        "n_events": len(events),
        "ranks": ranks,
        "phases": phases,
        "coord": coord,
        "retries": retries,
        "faults": faults,
        "checkpoints": {"last_save_by_rank": saves,
                        "agreed_step": agreed,
                        "promoted": sorted(set(promoted)),
                        "restored": sorted(set(restored))},
        "epochs_by_rank": epochs,
        "nonfinite_steps": nonfinite,
        "preempt_signalled": signalled,
        "peer_dead": dead,
        "elastic_resizes": resizes,
        "reshard_restores": reshards,
        "ps": {"commits_by_worker": ps_commits,
               "staleness_hist": ps_staleness,
               "joins": ps_joins, "lapses": ps_lapses,
               "rejected_stale": ps_rejected},
        "decode": {"quarantines": dq,
                   "recoveries_by_replica": dr,
                   "sheds_by_reason": dshed,
                   "deadline": ddl,
                   "kv_pages_reclaimed": dleaks},
    }


def perf_summary(events):
    """-> perf-attribution view of a merged timeline: per-rank retrace/
    dispatch/transfer totals + per-phase host-wall breakdown (from each
    rank's LAST registry snapshot, falling back to its last
    ``perf_sample``), plus every ``watchdog_alert``/``watchdog_clear``
    in timeline order.  The CLI's ``--perf`` section."""
    last_metrics = {}   # rank -> last "metrics" registry snapshot
    last_sample = {}    # rank -> last "perf_sample" payload
    alerts, clears = [], []
    for ev in events:
        rank = int(ev.get("rank", 0))
        kind = ev.get("kind")
        if kind == "metrics":
            last_metrics[rank] = ev
        elif kind == "perf_sample":
            last_sample[rank] = ev
        elif kind == "watchdog_alert":
            alerts.append(ev)
        elif kind == "watchdog_clear":
            clears.append(ev)
    per_rank = {}
    for rank in sorted(set(last_metrics) | set(last_sample)):
        snap = last_metrics.get(rank)
        samp = last_sample.get(rank)
        # take whichever record is NEWER: a process that trains and
        # then serves keeps emitting perf_sample long after its last
        # epoch-boundary snapshot — preferring the snapshot
        # unconditionally would freeze --perf at train-end totals
        if snap is not None and samp is not None \
                and samp.get("t", 0.0) > snap.get("t", 0.0):
            snap = None
        if snap is not None:
            counters = snap.get("counters", {}) or {}
            hists = snap.get("histograms", {}) or {}
            phases = {}
            for name, h in hists.items():
                if not name.startswith("perf.phase."):
                    continue
                count = h.get("count", 0) or 0
                total = h.get("total", 0.0) or 0.0
                phases[name[len("perf.phase."):]] = {
                    "count": count, "total_s": round(total, 4),
                    "mean_s": (round(total / count, 6) if count
                               else None)}
            per_rank[rank] = {
                "retraces": counters.get("perf.retraces", 0),
                "dispatches": counters.get("perf.dispatches", 0),
                "h2d_bytes": counters.get("perf.h2d_bytes", 0),
                "d2h_bytes": counters.get("perf.d2h_bytes", 0),
                "phases": phases,
            }
        else:  # no epoch boundary, or the sampler ran past the last one
            s = last_sample[rank]
            per_rank[rank] = {
                "retraces": s.get("retraces", 0),
                "dispatches": s.get("dispatches", 0),
                "h2d_bytes": s.get("h2d_bytes", 0),
                "d2h_bytes": s.get("d2h_bytes", 0),
                "phases": s.get("phases", {}) or {},
            }
    return {"per_rank": per_rank, "watchdog_alerts": alerts,
            "watchdog_clears": clears}


def render_perf(directory, events=None):
    """Human-readable perf/watchdog section for ``--perf``."""
    if events is None:
        events = read_events(directory)
    p = perf_summary(events)
    lines = ["# perf attribution"]
    if not p["per_rank"] and not p["watchdog_alerts"]:
        lines.append("no perf telemetry recorded (retrace/dispatch "
                     "counters ride registry snapshots — was the run "
                     "instrumented with DK_OBS_DIR, and did it reach "
                     "an epoch boundary or a perf_sample tick?)")
        return "\n".join(lines)
    for rank in sorted(p["per_rank"]):
        row = p["per_rank"][rank]
        lines.append(
            f"rank {rank}: retraces={row['retraces']} "
            f"dispatches={row['dispatches']} "
            f"h2d={row['h2d_bytes']}B d2h={row['d2h_bytes']}B")
        for name in ("data", "step", "comm", "ckpt"):
            ph = row["phases"].get(name)
            if not ph:
                continue
            mean = ph.get("mean_s")
            lines.append(
                f"  phase {name}: n={ph.get('count', 0)} "
                f"total={ph.get('total_s', 0.0):.3f}s"
                + (f" mean={mean * 1e3:.2f}ms" if mean else ""))
    t0 = events[0].get("t", 0.0) if events else 0.0
    if p["watchdog_alerts"]:
        lines.append("watchdog alerts:")
        for a in p["watchdog_alerts"]:
            ts = a.get("t", 0.0)
            extras = _fmt_fields(
                a, skip=("t", "seq", "rank", "kind", "rule"))
            lines.append(f"  +{ts - t0:9.3f}s rank {a.get('rank', 0)} "
                         f"{a.get('rule', '?')}: {extras}")
        for c in p["watchdog_clears"]:
            ts = c.get("t", 0.0)
            lines.append(f"  +{ts - t0:9.3f}s rank {c.get('rank', 0)} "
                         f"{c.get('rule', '?')}: cleared")
    else:
        lines.append("watchdog alerts: none")
    return "\n".join(lines)


def _fmt_fields(ev, skip=("t", "seq", "rank", "kind")):
    parts = []
    for k, v in ev.items():
        if k in skip:
            continue
        if isinstance(v, float):
            v = round(v, 4)
        parts.append(f"{k}={v}")
    return " ".join(parts)


def slo_summary(events):
    """SLO-plane digest from the merged timeline — for ``--slo``.

    Objective status and burn rates come from the ``slo_transition``
    and ``watchdog_alert`` (rule ``slo_burn_rate``) payloads, which
    carry the registry's evaluation at alert time: ``perf_sample``
    records don't ship the serving counters, so the offline report
    reads the burns the live evaluator published rather than
    recomputing them.
    """
    per_rank = {}

    def _row(rank):
        return per_rank.setdefault(
            int(rank), {"firing": [], "objectives": {}})

    n_transitions = 0
    for ev in events:
        kind = ev.get("kind")
        if kind == "slo_transition":
            n_transitions += 1
            row = _row(ev.get("rank", 0))
            row["firing"] = sorted(ev.get("firing", ()) or ())
        elif (kind == "watchdog_alert"
                and ev.get("rule") == "slo_burn_rate"):
            row = _row(ev.get("rank", 0))
            row["objectives"][str(ev.get("objective", "?"))] = {
                "t": ev.get("t", 0.0),
                "page": ev.get("page"),
                "target": ev.get("target"),
                "burn": {"5m": ev.get("burn_5m"),
                         "1h": ev.get("burn_1h"),
                         "6h": ev.get("burn_6h")},
            }
        elif (kind == "watchdog_clear"
                and ev.get("rule") == "slo_burn_rate"):
            for o in _row(ev.get("rank", 0))["objectives"].values():
                o["cleared"] = True
    return {"per_rank": per_rank, "transitions": n_transitions}


def _fmt_burn(v):
    return "?" if v is None else f"{v:g}"


def render_slo(directory, events=None, worst=5):
    """Human-readable SLO section for ``--slo``: per-rank objective
    status with the burn rates at alert time, then the worst-``worst``
    retained requests with their cross-host critical-path
    attribution (queue wait vs forward hop vs replica compute vs
    reload stall)."""
    from dist_keras_tpu_torch.observability import trace_export

    if events is None:
        events = read_events(directory)
    s = slo_summary(events)
    lines = ["# SLO report"]
    t0 = events[0].get("t", 0.0) if events else 0.0
    if not s["per_rank"] and not s["transitions"]:
        lines.append("no SLO telemetry recorded (burn-rate evaluation "
                     "rides the sampler tick — was the run armed with "
                     "DK_SLO=1 and a DK_OBS_SAMPLE_S cadence?)")
    for rank in sorted(s["per_rank"]):
        row = s["per_rank"][rank]
        firing = ", ".join(row["firing"]) if row["firing"] else "none"
        lines.append(f"rank {rank}: firing objectives: {firing}")
        for name in sorted(row["objectives"]):
            o = row["objectives"][name]
            b = o["burn"]
            status = ("cleared" if o.get("cleared")
                      else f"{o.get('page', '?')} page")
            lines.append(
                f"  {name}: target={o.get('target')} burn "
                f"5m={_fmt_burn(b['5m'])} 1h={_fmt_burn(b['1h'])} "
                f"6h={_fmt_burn(b['6h'])} "
                f"[{status}, alerted +{o['t'] - t0:.3f}s]")
    paths = trace_export.request_paths(events, worst=worst)
    if paths:
        lines.append(f"worst {len(paths)} retained request(s) by "
                     "end-to-end latency:")
        for p in paths:
            crit = p["critical"]
            lines.append(
                f"  trace {p['trace_id']}: {p['total_s'] * 1e3:.1f}ms "
                f"root {p['root']} (rank {p['rank']}) — critical hop "
                f"{crit['span']} ({crit['category']}) on rank "
                f"{crit['rank']}, self {crit['self_s'] * 1e3:.1f}ms")
            for hop in p["path"]:
                lines.append(
                    f"    {hop['span']:<20} rank {hop['rank']} "
                    f"{hop['category']:<16} "
                    f"total={hop['duration_s'] * 1e3:8.1f}ms "
                    f"self={hop['self_s'] * 1e3:8.1f}ms")
            cats = ", ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in
                sorted(p["by_category"].items(),
                       key=lambda kv: -kv[1]))
            lines.append(f"    attribution: {cats}")
    else:
        lines.append("retained requests: none (tail-based retention "
                     "keeps span records only for slow/errored/head-"
                     "sampled requests — was DK_TRACE_RETAIN=1 armed?)")
    return "\n".join(lines)


def render(directory, last_n=10):
    """Human-readable report: summary + the last-N events per host."""
    events = read_events(directory)
    lines = [f"# dist_keras_tpu run report — {directory}"]
    if not events:
        lines.append("no events found (is DK_OBS_DIR right? did the "
                     "run export it?)")
        return "\n".join(lines)
    s = summarize(events)
    t0 = events[0].get("t", 0.0)
    lines.append(f"{s['n_events']} events from "
                 f"{len(s['ranks'])} host(s), spanning "
                 f"{events[-1].get('t', t0) - t0:.1f}s")
    for rank in sorted(s["ranks"]):
        row = s["ranks"][rank]
        stale = ""
        if row["last_t"] is not None:
            age = events[-1].get("t", row["last_t"]) - row["last_t"]
            if age > 1.0:
                stale = (f"  << went quiet {age:.1f}s before the end "
                         f"(last: {row['last_kind']})")
        lines.append(f"  rank {rank}: {row['events']} events, "
                     f"last kind {row['last_kind']}{stale}")
    if s["preempt_signalled"]:
        for rank, signum in sorted(s["preempt_signalled"].items()):
            lines.append(f"preemption: rank {rank} got signal {signum}")
        if s["checkpoints"]["agreed_step"] is not None:
            lines.append("agreed save step: "
                         f"{s['checkpoints']['agreed_step']}")
    if s["checkpoints"]["last_save_by_rank"]:
        lines.append(f"checkpoints: last save by rank "
                     f"{s['checkpoints']['last_save_by_rank']}, "
                     f"promoted {s['checkpoints']['promoted']}, "
                     f"restored {s['checkpoints']['restored']}")
    if s["phases"]:
        lines.append("phases (spans):")
        for name in sorted(s["phases"]):
            p = s["phases"][name]
            lines.append(f"  {name}: n={p['count']} "
                         f"total={p['total_s']:.3f}s "
                         f"max={p['max_s']:.3f}s")
    if s["coord"]:
        lines.append("coordination ops:")
        for name in sorted(s["coord"]):
            p = s["coord"][name]
            lines.append(f"  {name}: n={p['count']} "
                         f"total={p['total_s']:.3f}s "
                         f"max={p['max_s']:.3f}s")
    if s["retries"]:
        lines.append("retries: " + ", ".join(
            f"{k} x{v['attempts']}"
            + (f" (EXHAUSTED x{v['exhausted']})" if v["exhausted"]
               else "")
            for k, v in sorted(s["retries"].items())))
    if s["faults"]:
        lines.append("faults fired: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(s["faults"].items())))
    if s["nonfinite_steps"]:
        lines.append(f"nonfinite steps: {s['nonfinite_steps']}")
    if s["peer_dead"]:
        lines.append("dead-peer reports: " + ", ".join(
            f"rank {r} saw peer {p} die" for r, p in s["peer_dead"]))
    for rz in s["elastic_resizes"]:
        lines.append(
            f"elastic resize: world {rz['old_world']} -> "
            f"{rz['new_world']} at session {rz['session']} (dropped "
            f"ranks {rz['dropped_ranks']}: {rz['dropped_hosts']})")
    for rs in s["reshard_restores"]:
        lines.append(
            f"reshard restore: rank {rs['rank']} loaded step "
            f"{rs['step']} written by world {rs['saved_world']} as "
            f"world {rs['world']} ({rs['n_sharded']} sharded leaves, "
            f"{rs['bytes_in']} bytes gathered)")
    ps = s["ps"]
    if ps["commits_by_worker"] or ps["joins"] or ps["lapses"]:
        commits = ", ".join(
            f"{wid} x{n}" for wid, n in
            sorted(ps["commits_by_worker"].items()))
        lines.append(f"parameter server: commits by worker: "
                     f"{commits or 'none'}")
        if ps["staleness_hist"]:
            hist = " ".join(
                f"{s_}:{n}" for s_, n in
                sorted(ps["staleness_hist"].items()))
            lines.append(f"  staleness histogram (value:count): {hist}")
        for j in ps["joins"]:
            lines.append(
                f"  worker join: {j['wid']}"
                + (f" (rank {j['rank']})" if j["rank"] is not None
                   else "")
                + (" [rejoin]" if j["rejoined"] else ""))
        for lp in ps["lapses"]:
            lines.append(
                f"  worker lapse: {lp['wid']}"
                + (f" (rank {lp['rank']})" if lp["rank"] is not None
                   else "")
                + f" — {lp['reason']}")
        if ps["rejected_stale"]:
            lines.append(f"  over-cap commits refused (typed): "
                         f"{ps['rejected_stale']}")
    dc = s["decode"]
    if (dc["quarantines"] or dc["recoveries_by_replica"]
            or dc["sheds_by_reason"] or any(dc["deadline"].values())
            or dc["kv_pages_reclaimed"]):
        lines.append("decode survivability:")
        for q in dc["quarantines"]:
            landed = sum(dc["recoveries_by_replica"].values())
            lines.append(
                f"  replica {q['replica']} quarantined "
                f"({q['cause']}): {q['orphans']} in-flight "
                f"sequence(s), {landed} recovered onto "
                + (", ".join(
                    f"replica {d} x{n}" for d, n in
                    sorted(dc["recoveries_by_replica"].items(),
                           key=lambda kv: str(kv[0])))
                   or "nobody"))
        if dc["sheds_by_reason"]:
            lines.append("  brownout sheds: " + ", ".join(
                f"{k} x{v}" for k, v in
                sorted(dc["sheds_by_reason"].items())))
        if any(dc["deadline"].values()):
            lines.append(
                f"  deadlines: {dc['deadline']['infeasible']} "
                f"rejected at the door, "
                f"{dc['deadline']['expired']} expired mid-decode")
        if dc["kv_pages_reclaimed"]:
            lines.append(f"  KV LEAK: self-check reclaimed "
                         f"{dc['kv_pages_reclaimed']} page(s)")
    # the tail per host — what each host was doing when the run ended
    by_rank = {}
    for ev in events:
        by_rank.setdefault(int(ev.get("rank", 0)), []).append(ev)
    for rank in sorted(by_rank):
        lines.append(f"last {last_n} events, rank {rank}:")
        for ev in by_rank[rank][-last_n:]:
            ts = ev.get("t")
            stamp = (f"+{ts - t0:9.3f}s" if ts is not None
                     else " " * 11)
            lines.append(f"  {stamp} {ev.get('kind', '?'):<14} "
                         f"{_fmt_fields(ev)}")
    return "\n".join(lines)


def write_report(directory, out_path=None, last_n=10):
    """Render and write ``report.txt`` beside the event files (or to
    ``out_path``); returns the path.  The leader calls this at the end
    of a run so the artifact exists without any post-hoc CLI step."""
    text = render(directory, last_n=last_n)
    if out_path is None:
        out_path = os.path.join(
            os.path.abspath(os.path.expanduser(str(directory))),
            "report.txt")
    tmp = f"{out_path}.tmp.{os.getpid()}.{int(time.time() * 1e6)}"
    with open(tmp, "w") as f:
        f.write(text + "\n")
    os.replace(tmp, out_path)
    return out_path
