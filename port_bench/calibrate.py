"""The readings that a cell's ``correct`` limits are set from.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out FILE]
        [--save-programs FILE | --programs FILE]

For each seed it runs the cell's set-up up to and including the check's
steps (the program's numbers, as a benchmark run reads them) and the
float32 reference, and prints the three gaps.  On the control seeds it
also puts the reference in the program's place computed in fp8 (the
control, ``reference/precision.py``), and with faults planted in it:
each step on half of its batch's rows (the mean over the rest), and in
a cell of several ranks each rank's share of the rows alone (the
exchange between the cards left out).  A state left unchanged reads 1
on ``change_gap`` by the measure itself and needs no run.  The summary
gives each number's lower reading (the largest over the seeds) and the
control's and each fault's smallest.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from port_bench import harness
from port_bench.reference import cnn, vit
from port_bench.reference.numbers import excluded, gaps
from port_bench.reference.precision import FP8

REFERENCES = {"vit_train": vit, "adag": cnn}


def program_numbers(run, seeds):
    """{seed: the program's record} from the cell's set-up."""
    import torch

    drv, out = harness.kind(run.cell), {}
    for seed in seeds:
        run.seed = seed
        s = drv.prepare(run)
        out[seed] = s.program
        del s
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def readings(cell, programs, control_seeds, device):
    """The gaps of every seed's program records (one a rank) and of the
    control and the faults on ``control_seeds``."""
    ref_mod = REFERENCES[cell.traffic["kind"]]
    cfg, tr = cell.config, cell.traffic
    out = {"program": {}, "control": {}, "half_batch": {},
           "no_exchange": {}, "excluded": []}
    for seed in sorted(set(programs) | set(control_seeds)):
        t0 = time.perf_counter()
        ref = ref_mod.check_numbers(cfg, tr, seed, device)
        out["reference_s"] = time.perf_counter() - t0
        out["excluded"] = excluded(ref)
        if seed in programs:
            per_rank = [gaps(p, ref) for p in programs[seed]]
            out["program"][seed] = {k: max(g[k] for g in per_rank)
                                    for k in per_rank[0]}
        if seed in control_seeds:
            out["control"][seed] = gaps(
                ref_mod.check_numbers(cfg, tr, seed, device, prec=FP8), ref)
            out["half_batch"][seed] = gaps(
                ref_mod.check_numbers(cfg, tr, seed, device, rows=0.5), ref)
            if tr.get("ranks", 1) > 1:
                out["no_exchange"][seed] = gaps(ref_mod.check_numbers(
                    cfg, tr, seed, device, rows=1 / tr["ranks"]), ref)
        print(f"seed {seed}: " + json.dumps(
            {k: out[k][seed] for k in ("program", "control", "half_batch",
                                       "no_exchange") if seed in out[k]}),
            file=sys.stderr, flush=True)
    summary = {}
    for kind, pick in (("program", max), ("control", min),
                       ("half_batch", min), ("no_exchange", min)):
        if out[kind]:
            summary[kind] = {k: pick(r[k] for r in out[kind].values())
                             for k in ("loss_gap", "grad_gap", "change_gap")}
    out["summary"] = summary
    return out


def rank_main(role):
    run = harness.role_run(role)
    record = {"programs": program_numbers(run, role["seeds"])}
    if run.world > 1:
        from dist_keras_tpu_torch.comm import backend as comm

        comm.shutdown()
    print(harness.RESULT_TAG + json.dumps(record), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    ap.add_argument("--save-programs", help="write the program's records "
                    "there and stop (the reference half can then run on "
                    "one card with --programs)")
    ap.add_argument("--programs", help="read the program's records from "
                    "a --save-programs file instead of running them")
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of:
        return rank_main(json.loads(args.rank_of))
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    ranks = int(cell.traffic.get("ranks", 1))
    run = harness.Run(cell, 0, 0.0, False, "cuda", time.time())
    t0 = time.perf_counter()
    if args.programs:
        with open(args.programs) as f:
            programs = {int(k): v for k, v in json.load(f).items()}
    elif ranks == 1:
        programs = {k: [v] for k, v in program_numbers(run, seeds).items()}
    else:
        records = harness.run_ranks(run, ranks, "port_bench.calibrate",
                                    {"seeds": seeds})
        programs = {int(seed): [r["programs"][seed] for r in records]
                    for seed in records[0]["programs"]}
    program_s = time.perf_counter() - t0
    if args.save_programs:
        with open(args.save_programs, "w") as f:
            json.dump(programs, f)
        return 0
    out = readings(cell, programs, control, "cuda")
    out["program_s"] = program_s
    text = json.dumps(out, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps(out["summary"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
