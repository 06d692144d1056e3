"""The harness: cells found by name, the step clock, rank processes, and
the result line.

A cell of ``BENCHMARK.json`` names a configuration
(``port_bench/configs/<config>.json``) and a traffic mix
(``port_bench/traffic/<traffic>.json``); the mix's ``kind`` names the
module (``port_bench/kinds/<kind>.py``) that runs it, and each
per-layer metric is read by ``port_bench/metrics/<name>.py``.  The
numbers that decide ``correct`` are held to
``port_bench/limits/<cell>.json``.  A kind's ``run(Run)`` returns one
rank's record; :func:`assemble` turns the ranks' records into the line
that the benchmark prints last.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

from port_bench.reference.numbers import gaps

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dist_keras_tpu")
RESULT_TAG = "PORT_BENCH_RANK_RESULT "
RANK_TIMEOUT_S = 330


def load_json(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules=None):
    """The top-level names of ``sys.modules`` (compared whole) that are
    JAX's or the JAX package's."""
    names = {m.split(".")[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name, overrides=None):
    """The workload ``name`` of ``BENCHMARK.json`` with its files;
    ``overrides`` ({"config": {...}, "traffic": {...}}) replace keys, for
    the tests' small sizes."""
    bench = load_json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))

    def here(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if here(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, int(w["chips"]), config, traffic,
                load_json(BENCH / "limits" / f"{name}.json"), e2e,
                per_layer)


def load_reader(metric):
    """The per-layer reader ``port_bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """One process's share of a run."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float          # the run's start, wall clock (time.time())
    rank: int = 0
    world: int = 1


class StepClock:
    """Marks after each step on the step's stream (CUDA events; host
    clock on the CPU), read once the window has closed: no host sync
    inside the window."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            import torch

            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def per_layer_values(cell, view):
    """{metric: value or None} of the cell's per-layer readers."""
    return {m["name"]: load_reader(m["name"]).read(view)
            for m in cell.per_layer}


def kind(cell):
    """The module that runs the cell's traffic ``kind``."""
    return importlib.import_module(
        f"port_bench.kinds.{cell.traffic['kind']}")


def run_ranks(run, ranks, module="port_bench", extra=None):
    """Start ``ranks`` rank processes (``python -m <module> --rank-of``),
    one a card, met at a free local port; -> their records in rank
    order.  Any rank failing stops the others."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(ranks):
        role = {"workload": run.cell.name, "seed": run.seed,
                "seconds": run.seconds, "trace": run.trace,
                "device": run.device, "t_start": run.t_start, "rank": r,
                "world": ranks,
                "overrides": {"config": run.cell.config,
                              "traffic": run.cell.traffic},
                **(extra or {})}
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(ranks),
                   RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(ranks))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--rank-of", json.dumps(role)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True))
    outs = [None] * ranks

    def drain(r):
        outs[r] = procs[r].stdout.read()

    readers = [threading.Thread(target=drain, args=(r,), daemon=True)
               for r in range(ranks)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        pending = set(range(ranks))
        while pending:
            for r in sorted(pending):
                if procs[r].poll() is not None:
                    pending.discard(r)
                    if procs[r].returncode != 0:
                        raise RuntimeError(
                            f"rank {r} exited {procs[r].returncode}")
            if pending and time.monotonic() > deadline:
                raise RuntimeError(f"ranks {sorted(pending)} still running "
                                   f"after {RANK_TIMEOUT_S} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in readers:
            t.join(timeout=30)
        for p in procs:
            p.stdout.close()
    records = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
        if not lines:
            raise RuntimeError(f"rank {r} printed no record")
        records.append(json.loads(lines[-1][len(RESULT_TAG):]))
    return records


def role_run(role):
    """The :class:`Run` of a rank process's role."""
    if role["device"] == "cpu":
        import torch

        torch.set_num_threads(1)   # ranks sharing the CPU: no oversubscription
    cell = load_cell(role["workload"], role["overrides"])
    return Run(cell, int(role["seed"]), float(role["seconds"]),
               bool(role["trace"]), role["device"], float(role["t_start"]),
               int(role["rank"]), int(role["world"]))


def rank_main(role):
    """A rank process: run its share and print its record."""
    run = role_run(role)
    record = kind(run.cell).run(run)
    record["forbidden"] = forbidden_modules()
    print(RESULT_TAG + json.dumps(record), flush=True)
    return 0


def run_cell(run, module="port_bench"):
    """Every rank's record of ``run`` (in this process for one rank)."""
    ranks = int(run.cell.traffic.get("ranks", 1))
    if ranks == 1:
        return [kind(run.cell).run(run)]
    return run_ranks(run, ranks, module)


def percentile(values, q):
    """The ``q``-th percentile (Python's inclusive quantiles)."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def power_limit():
    """``nvidia-smi``'s name and power limit of the cards, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().replace("\n", " | ") or None


_COMBINE = {"rank0": lambda v: v[0], "max": max,
            "mean": lambda v: sum(v) / len(v)}


def assemble(run, records):
    """The result line (a dict) of a run from its ranks' records, and the
    lines to print on standard error before it."""
    cell, r0 = run.cell, records[0]
    notes = []
    values = {
        "train_samples_per_s": sum(r["samples"] / r["window_s"]
                                   for r in records),
        "step_ms.p95": percentile(r0["step_ms"], 95),
        "setup_s": max(r["setup_s"] for r in records),
    }
    notes.append(f"setup_s {values['setup_s']!r}; window: {r0['steps']} "
                 f"steps in {r0['window_s']:.3f} s "
                 f"(rank 0), step_ms.p95 over {len(r0['step_ms'])} step "
                 f"times, median {statistics.median(r0['step_ms']):.4f} ms")
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            got = [r["per_layer"].get(m["name"]) for r in records]
            got = [v for v in got if v is not None]
            if got:
                metrics[m["name"]] = {
                    "value": _COMBINE[load_reader(m["name"]).COMBINE](got),
                    "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    numbers = [gaps(r["program"], r0["reference"]) for r in records]
    compared = {k: {"value": max(n[k] for n in numbers), "limit": limit}
                for k, limit in cell.limits.items()}
    failed = sum(r["failed"] for r in records)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in compared.values())
    device = {"platform": r0["platform"], "kind": r0["device_kind"],
              "count": len(records),
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in records)}
    line = {"correct": correct, "attempted": r0["steps"], "failed": failed,
            "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = sum(r["busy_s"] for r in records) / len(records)
        device["window_s"] = r0["trace_window_s"]
        line["breakdown"] = r0["breakdown"]
        notes.append("per rank: " + "; ".join(
            f"busy {r['busy_s']:.6f} s of {r['trace_window_s']:.6f} s, "
            f"{r['trace_steps']} steps, trace read in "
            f"{r['trace_read_s']:.2f} s" for r in records))
    line["compared"] = compared
    notes += [f"compared {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in compared.items()]
    return line, notes
