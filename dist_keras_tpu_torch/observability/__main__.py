"""CLI for the run report — ``python -m dist_keras_tpu_torch.observability``.

  # human-readable timeline summary + last-N events per host
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir [--last 20]

  # machine-readable: the merged summary (or the full merged timeline)
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir --json
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir --json --raw

  # perf attribution: dispatches/transfers per rank, each phase's
  # host-wall (and card) breakdown, watchdog alerts
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir --perf

  # SLOs: objective status + burn rates per window at alert time, and
  # the worst-N retained requests with critical-path attribution
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir --slo \
      [--worst 5]

  # tracing: stitch the multi-host timeline into Perfetto-loadable
  # Chrome trace JSON (open at ui.perfetto.dev), or summarize trace
  # connectivity per trace_id
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir \
      --perfetto trace.json [--trace <trace_id>]
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir --traces
  # --dumps sources records from the flight-recorder dumps
  # (flightrec-*.json) instead of the event log — the crash-time tail
  # when the run died before flushing its log
  python -m dist_keras_tpu_torch.observability /path/to/obs_dir \
      --dumps --perfetto crash.json

Point it at the directory a run exported as ``DK_OBS_DIR`` (for a pod
job launched with ``Job(obs_dir=...)``, the launcher's
``collect_obs(dest)`` rsyncs every host's directory back first).
Exit code 1 when the directory holds no events — a monitoring loop can
distinguish "nothing recorded" from an empty-but-healthy run.
"""

from __future__ import annotations

import argparse
import json
import sys

from dist_keras_tpu_torch.observability import report


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_keras_tpu_torch.observability",
        description="Merge per-host DK_OBS_DIR event logs into one "
                    "timeline and summarize the run.")
    ap.add_argument("obs_dir", help="directory holding "
                                    "events-rank_*.jsonl files")
    ap.add_argument("--last", type=int, default=10,
                    help="events per host in the tail section "
                         "(default 10)")
    ap.add_argument("--json", action="store_true",
                    help="print the merged summary as JSON")
    ap.add_argument("--raw", action="store_true",
                    help="with --json: print the full merged event "
                         "timeline instead of the summary")
    ap.add_argument("--perf", action="store_true",
                    help="append the perf-attribution section: per-"
                         "rank dispatch/transfer totals, each "
                         "phase's host-wall (and card) breakdown, "
                         "and every watchdog alert in the timeline "
                         "(with --json: a 'perf' key on the summary)")
    ap.add_argument("--slo", action="store_true",
                    help="append the SLO section: per-objective "
                         "burn-rate status from the slo_burn_rate "
                         "alerts in the timeline plus the worst-N "
                         "retained requests with critical-path "
                         "attribution (with --json: a 'slo' key on "
                         "the summary)")
    ap.add_argument("--worst", type=int, default=5,
                    help="requests in the --slo critical-path section "
                         "(default 5)")
    ap.add_argument("--perfetto", metavar="PATH",
                    help="write the merged timeline as Chrome trace-"
                         "event JSON (Perfetto-loadable) to PATH")
    ap.add_argument("--dumps", action="store_true",
                    help="source records from the flight-recorder "
                         "dumps (flightrec-*.json, deduplicated and "
                         "stitched across hosts) instead of the "
                         "event log")
    ap.add_argument("--trace", metavar="TRACE_ID",
                    help="restrict --perfetto to one trace id")
    ap.add_argument("--traces", action="store_true",
                    help="print the per-trace connectivity summary "
                         "(roots, orphans, thread/host handoffs)")
    args = ap.parse_args(argv)

    if args.dumps:
        from dist_keras_tpu_torch.observability import flight

        events = flight.read_dumps(args.obs_dir)
    else:
        events = report.read_events(args.obs_dir)

    if args.perfetto or args.traces:
        from dist_keras_tpu_torch.observability import trace_export

        if args.perfetto:
            n = trace_export.write_chrome_trace(
                args.perfetto, events, trace_id=args.trace)
            print(f"wrote {n} trace events to {args.perfetto} "
                  "(open at ui.perfetto.dev)")
        if args.traces:
            print(trace_export.render_traces(events))
        return 0 if events else 1

    if args.json:
        doc = events if args.raw else report.summarize(events)
        if args.perf and not args.raw:
            doc["perf"] = report.perf_summary(events)
        if args.slo and not args.raw:
            doc["slo"] = report.slo_summary(events)
        json.dump(doc, sys.stdout, indent=1, default=str)
        print()
    else:
        print(report.render(args.obs_dir, last_n=args.last))
        if args.perf:
            print()
            print(report.render_perf(args.obs_dir, events=events))
        if args.slo:
            print()
            print(report.render_slo(args.obs_dir, events=events,
                                    worst=args.worst))
    return 0 if events else 1


if __name__ == "__main__":
    sys.exit(main())
