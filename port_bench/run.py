"""The command: ``python3 -m port_bench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

One run is one process (and, for a cell of several ranks, one process a
card that it starts and waits for).  It makes the weights and data from
the seed on the card, warms up the cell's own shapes, measures for about
``--seconds`` seconds, with ``--trace 1`` then profiles a short window
for the per-layer metrics, frees the program's state, runs the plain
reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown``), and last
``compared``, each number that decided ``correct`` beside its limit.

It exits non-zero and prints no result when there is no card or fewer
cards than the cell asks for, when the program or its kernels cannot be
found, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import harness


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m port_bench")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of is None and None in (args.workload, args.seed,
                                         args.seconds):
        ap.error("--workload, --seed and --seconds are required")
    return args


def measure(run, module="port_bench"):
    """Run ``run`` and -> (result line, stderr notes, forbidden modules)."""
    records = harness.run_cell(run, module)
    line, notes = harness.assemble(run, records)
    found = set(harness.forbidden_modules())
    for r in records:
        found.update(r.get("forbidden", ()))
    return line, notes, sorted(found)


def main(argv=None, t_start=None):
    t_start = time.time() if t_start is None else t_start
    args = _args(argv)
    if args.rank_of is not None:
        return harness.rank_main(json.loads(args.rank_of))
    cell = harness.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    if cell.chips > 1:
        # build the kernels once, before the ranks start
        from dist_keras_tpu_torch.ops import _build

        _build.build(getattr(harness.kind(cell), "KERNELS", ()))
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    line, notes, found = measure(run)
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}; the port's "
              "benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    power = harness.power_limit()
    if power:
        notes.insert(0, f"cards (name, power.limit): {power}")
    for n in notes:
        print(n, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
