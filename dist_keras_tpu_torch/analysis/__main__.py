"""``python -m dist_keras_tpu_torch.analysis`` — the dklint CLI over the
port (counterpart of ``dist_keras_tpu/analysis/__main__.py``).

Exit 0 when every finding is waived or baselined; exit 1 otherwise,
printing one ``rule path:line message`` line per fresh finding.

    python -m dist_keras_tpu_torch.analysis                 # lint the package
    python -m dist_keras_tpu_torch.analysis --json          # machine-readable
    python -m dist_keras_tpu_torch.analysis --rules broad-except,knob-read
    python -m dist_keras_tpu_torch.analysis --write-baseline  # grandfather
    python -m dist_keras_tpu_torch.analysis --knob-table    # README knob table

The rules and their text are the JAX analyzer's, so one README rules
table serves both; ``--knob-table`` prints the port's copy of the knob
registry (the same table).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from dist_keras_tpu_torch.analysis import core


def _default_root():
    """The installed ``dist_keras_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default_readme(root):
    """``README.md`` next to (or one level above) the analyzed root."""
    for cand in (os.path.join(root, "README.md"),
                 os.path.join(os.path.dirname(root), "README.md")):
        if os.path.exists(cand):
            return cand
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_keras_tpu_torch.analysis",
        description="dklint: AST invariant checker for the "
                    "fault/knob/event/metric registries and "
                    "signal-safe seams")
    ap.add_argument("--root", default=None,
                    help="package tree to lint (default: the installed "
                         "dist_keras_tpu_torch package)")
    ap.add_argument("--readme", default=None,
                    help="markdown file for the doc-sync rules "
                         "(default: auto-discovered next to --root)")
    ap.add_argument("--no-readme", action="store_true",
                    help="skip the doc-sync rules")
    ap.add_argument("--baseline", default=None,
                    help="baseline file of grandfathered findings "
                         "(default: <root>/analysis/baseline.json "
                         "when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report baselined findings as failures too")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding into the "
                         "baseline file and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma list restricting which rules report")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--knob-table", action="store_true",
                    help="print the README knob table generated from "
                         "utils/knobs.py and exit")
    ap.add_argument("--rules-table", action="store_true",
                    help="print the README rules table generated from "
                         "the --list-rules vocabulary and exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.knob_table:
        from dist_keras_tpu_torch.utils import knobs

        print(knobs.doc_table())
        return 0
    if args.rules_table:
        print(core.rules_table())
        return 0
    if args.list_rules:
        for rule, doc in core.RULES.items():
            print(f"{rule}: {' '.join(doc.split())}")
        return 0

    root = os.path.abspath(args.root or _default_root())
    if args.no_readme:
        readme = None
    else:
        readme = args.readme or _default_readme(root)
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)

    baseline_path = args.baseline
    if baseline_path is None:
        cand = os.path.join(root, "analysis", "baseline.json")
        baseline_path = cand if os.path.exists(cand) else None

    timings = {}
    findings = core.run_analysis(root, readme=readme, rules=rules,
                                 timings=timings)

    if args.write_baseline:
        # ALWAYS grandfather from an unfiltered run: writing a baseline
        # narrowed by --rules would silently drop every other rule's
        # fingerprints and turn them into fresh failures next full run
        if rules is not None:
            findings = core.run_analysis(root, readme=readme)
        out = baseline_path or os.path.join(root, "analysis",
                                            "baseline.json")
        core.write_baseline(out, findings)
        print(f"wrote {len(findings)} fingerprint(s) to {out}")
        return 0

    grandfathered = (set() if args.no_baseline
                     else core.load_baseline(baseline_path))
    fresh = core.apply_baseline(findings, grandfathered)

    if args.as_json:
        counts = {}
        for f in fresh:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        print(json.dumps({
            "root": root,
            "readme": readme,
            "baseline": baseline_path,
            "total": len(findings),
            "baselined": len(findings) - len(fresh),
            "fresh": len(fresh),
            "counts": counts,
            # per-pass wall seconds: a slow cross-module graph walk
            # is visible here, chip_smoke.py's phase 20b prints them
            # and tests/test_torch_dklint.py budgets the sum
            "pass_seconds": {k: round(v, 4)
                             for k, v in timings.items()},
            "findings": [f.to_dict() for f in fresh],
        }, indent=1))
    else:
        for f in fresh:
            print(f"{f.rule} {f.path}:{f.line} {f.message}")
        n_base = len(findings) - len(fresh)
        suffix = f" ({n_base} baselined)" if n_base else ""
        if fresh:
            print(f"dklint: {len(fresh)} finding(s){suffix}")
        else:
            print(f"dklint: clean{suffix}")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
