"""dklint core — findings, waivers, baselines, source loading
(counterpart of ``dist_keras_tpu/analysis/core.py``; ``RULES`` is that
module's dict word for word, so one README rules table serves both).

The analyzer is a plain AST walk over the package tree: no imports of
the analyzed code (fixture trees lint exactly like the real one), no
third-party dependencies, no I/O beyond reading sources and the
README.  Three building blocks live here:

- :class:`Finding` — one violation: rule, file, line, message, and a
  line-number-FREE fingerprint (rule + file + a stable key, normally
  the stripped source line), so a baseline survives unrelated edits
  above a grandfathered site.
- :class:`SourceFile` — a parsed module plus its ``# dklint:``
  comment maps.  Two comment forms, both honored on the flagged line
  or the line directly above it:

  - ``# dklint: ignore[rule-a,rule-b] <reason>`` — waive findings of
    those rules at this site (the reason is required by convention,
    ignored by the parser).
  - ``# dklint: key=a,b`` — an ANNOTATION feeding a pass: e.g.
    ``# dklint: fault-points=job.rsync,job.ssh`` declares the names a
    dynamic ``fault_point(var)`` call site can take, and
    ``# dklint: metrics=span.*`` names the registered pattern a
    dynamic metric name belongs to.

- the baseline — a checked-in JSON list of fingerprints for
  grandfathered findings, so a new rule lands incrementally: old
  findings are reported as "baselined" and do not fail the run, new
  ones do.  ``--write-baseline`` regenerates it; the shipped baseline
  (``dist_keras_tpu_torch/analysis/baseline.json``) is kept EMPTY — every
  finding at introduction was fixed or explicitly waived in place.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize

# rule -> one-line description (the README rule table is this dict)
RULES = {
    "syntax-error":
        "a source file failed to parse (every other pass skipped it); "
        "always reported, never filtered out by --rules",
    "fault-point-unknown":
        "a fault_point(\"name\") call site names a point missing from "
        "faults.KNOWN_POINTS (chaos mode could never arm it)",
    "fault-point-dynamic":
        "a fault_point call with a computed name lacks a "
        "`# dklint: fault-points=a,b` annotation declaring its names",
    "fault-point-unused":
        "a faults.KNOWN_POINTS entry has no call site (dead registry "
        "row: the chaos gate arms a point that never fires)",
    "knob-read":
        "a DK_* environment variable is read via os.environ/os.getenv "
        "instead of resolving through utils/knobs.py",
    "knob-unregistered":
        "knobs.raw()/knobs.get() is called with a DK_* name that the "
        "registry does not declare",
    "knob-undocumented":
        "a registered knob appears in no README table row",
    "knob-doc-drift":
        "a README table row documents a DK_* name that is not "
        "registered in utils/knobs.py",
    "event-unregistered":
        "an emit(\"kind\") call site names an event missing from "
        "events.KNOWN_EVENTS",
    "event-dynamic":
        "an emit call with a computed kind lacks a "
        "`# dklint: events=a,b` annotation",
    "event-undocumented":
        "a registered event kind is missing from the README "
        "event-schema table",
    "event-doc-drift":
        "the README event-schema table names a kind that is not in "
        "events.KNOWN_EVENTS",
    "metric-unregistered":
        "a counter/gauge/histogram name (or its kind) does not match "
        "metrics.KNOWN_METRICS",
    "metric-dynamic":
        "a metric call with a computed name lacks a "
        "`# dklint: metrics=<registered name or pattern>` annotation",
    "metric-collision":
        "two registered metric names collide after Prometheus "
        "sanitization (their scrape series would merge)",
    "metric-undocumented":
        "a registered metric is missing from the README metrics table",
    "metric-doc-drift":
        "the README metrics table names a metric that is not in "
        "metrics.KNOWN_METRICS",
    "slo-undocumented":
        "a slo.KNOWN_SLOS objective is missing from the README SLO "
        "table (the objective vocabulary is registry-closed like "
        "events and metrics)",
    "slo-doc-drift":
        "the README SLO table names an objective that is not in "
        "slo.KNOWN_SLOS",
    "span-unregistered":
        "a span(...)/span_at(...) call site names a span missing from "
        "spans.KNOWN_SPANS (the report, the Perfetto export and "
        "operator tooling treat the registry as the closed phase "
        "vocabulary)",
    "span-dynamic":
        "a span call with a computed name lacks a "
        "`# dklint: spans=<registered name or pattern>` annotation",
    "signal-unsafe":
        "a lock acquisition, event emission or blocking I/O call is "
        "reachable from a registered signal handler (handlers run "
        "re-entrantly on the main thread and must stay lock-free and "
        "emit-free)",
    "obs-must-not-raise":
        "a never-throws observability entry point lacks the broad "
        "handler its contract promises (it could raise into training "
        "code)",
    "broad-except":
        "`except Exception`/bare `except` without a waiver naming why "
        "the swallow is intentional",
    "untyped-raise":
        "`raise RuntimeError/Exception` in a module with a typed-error "
        "contract, without a waiver naming why no typed class applies",
    "jit-impure":
        "time.time()/perf_counter or random-module calls inside a "
        "jit-compiled function (traced once, frozen forever)",
    "thread-root-unknown":
        "a threading.Thread/Timer target or signal.signal handler does "
        "not resolve to a named root in analysis/threads.py "
        "KNOWN_THREAD_ROOTS (dynamic sites annotate "
        "`# dklint: thread-root=<name>`)",
    "thread-root-unused":
        "a KNOWN_THREAD_ROOTS entry matches no registration site (dead "
        "registry row), or a ~declared root names code that does not "
        "exist",
    "lock-order-cycle":
        "the acquires-while-holding graph (observed `with lock:` "
        "nesting and .acquire() reachability, plus the LOCK_ORDER "
        "declarations) contains a cycle — a potential deadlock",
    "unguarded-shared-write":
        "an instance attribute written from >= 2 distinct thread roots "
        "without a common guarding lock (and it is not a sync "
        "primitive) — waive only with the safety argument (e.g. "
        "reference assignment is atomic under the GIL)",
    "unbounded-wait":
        ".join()/.wait()/.wait_for()/lock.acquire()/future.result()/"
        "queue.get() on a cross-thread seam without a timeout/deadline "
        "— a wedged peer thread must cost one deadline, never a hang",
    "blocking-under-lock":
        "time.sleep, subprocess, socket/HTTP or a fault_point call "
        "(chaos delay = a sleep) reachable while holding a registered "
        "lock — every other acquirer stalls behind it",
    "unused-waiver":
        "a `# dklint: ignore[rule]` waiver whose rule no longer fires "
        "at that site — stale waivers must not accumulate",
    "rule-undocumented":
        "the README has no `<!-- dklint: rules-table -->` marked table, "
        "or a rule in core.RULES has no row in it",
    "rule-doc-drift":
        "the README rules table is out of sync with core.RULES "
        "(regenerate with `python -m dist_keras_tpu.analysis "
        "--rules-table`)",
}


def rules_table():
    """The README rules table, generated from :data:`RULES` (the same
    vocabulary ``--list-rules`` prints) — paste below the
    ``<!-- dklint: rules-table -->`` marker; the ``rule-undocumented`` /
    ``rule-doc-drift`` checks keep it strictly in sync both ways."""
    lines = ["| rule | meaning |", "|---|---|"]
    for rule, doc in RULES.items():
        lines.append(f"| `{rule}` | {' '.join(doc.split())} |")
    return "\n".join(lines)


class Finding:
    """One lint violation."""

    def __init__(self, rule, path, line, message, key=None):
        assert rule in RULES, rule
        self.rule = rule
        self.path = path          # rel path within the analyzed root
        self.line = int(line)
        self.message = message
        self.key = key if key is not None else message
        self.baselined = False

    @property
    def fingerprint(self):
        """Line-number-free identity for the baseline."""
        return f"{self.rule}::{self.path}::{self.key}"

    def sort_key(self):
        return (self.path, self.line, self.rule, self.message)

    def to_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "baselined": self.baselined}

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Finding({self.rule}, {self.path}:{self.line})"


_WAIVER_RE = re.compile(r"#\s*dklint:\s*ignore\[([a-z\-,\s]+)\]")
_ANNOT_RE = re.compile(
    r"#\s*dklint:\s*([a-z][a-z\-]*)=([A-Za-z0-9_.,*\s\-]+)")


class SourceFile:
    """One parsed module plus its dklint comment maps."""

    def __init__(self, path, rel, text):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.split("\n")
        self.tree = ast.parse(text)  # SyntaxError handled by load_tree
        self.waivers = {}      # lineno (1-based) -> set of rule names
        self.annotations = {}  # lineno -> {key: [values]}
        self.used_waivers = set()  # (waiver lineno, rule) that fired
        for i, line in self._comments():
            m = _WAIVER_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                self.waivers.setdefault(i, set()).update(rules)
            m = _ANNOT_RE.search(line)
            if m and not line[:m.start()].rstrip().endswith("ignore"):
                values = [v.strip() for v in m.group(2).split(",")
                          if v.strip()]
                self.annotations.setdefault(i, {})[m.group(1)] = values

    def _comments(self):
        """-> (lineno, text) of every real ``#`` comment, via tokenize —
        a docstring or string literal that merely *mentions*
        ``dklint: ignore[...]`` (the analyzer's own docs do) must
        neither waive anything nor trip the ``unused-waiver`` sweep."""
        try:
            return [(tok.start[0], tok.string) for tok in
                    tokenize.generate_tokens(
                        io.StringIO(self.text).readline)
                    if tok.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError):
            # the file parsed (SourceFile requires it), so this is an
            # exotic edge — fall back to the line scan rather than
            # silently dropping every waiver in the file
            return list(enumerate(self.lines, start=1))

    def _comment_block(self, lineno):
        """The flagged line plus the contiguous run of comment-only
        lines directly above it — where a waiver/annotation may sit
        (multi-line rationale comments are the norm in this tree)."""
        yield lineno
        ln = lineno - 1
        while ln >= 1 and self.lines[ln - 1].lstrip().startswith("#"):
            yield ln
            ln -= 1

    def waived(self, rule, lineno):
        """A waiver applies on the flagged line or anywhere in the
        comment block immediately above it.  A match records the waiver
        line as USED — the ``unused-waiver`` sweep flags the rest."""
        for ln in self._comment_block(lineno):
            if rule in self.waivers.get(ln, ()):
                self.used_waivers.add((ln, rule))
                return True
        return False

    def annotation(self, key, lineno):
        """-> the annotated value list at this site, or None."""
        for ln in self._comment_block(lineno):
            values = self.annotations.get(ln, {}).get(key)
            if values is not None:
                return values
        return None

    def line_text(self, lineno):
        """Stripped source text of ``lineno`` — the default stable
        fingerprint key for AST findings."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


class Project:
    """The analyzed tree: parsed sources + optional README text."""

    def __init__(self, root, files, readme_path=None, readme=None,
                 parse_findings=()):
        self.root = root
        self.files = files
        self.readme_path = readme_path
        self.readme = readme
        self.parse_findings = list(parse_findings)


def load_tree(root, readme=None):
    """Parse every ``*.py`` under ``root`` -> :class:`Project`.

    ``readme`` is a path to the markdown file the doc-sync rules check
    (None disables them).  An unparseable source file is itself a
    finding (the tree must at minimum be syntactically valid), not a
    crash.
    """
    root = os.path.abspath(root)
    files, parse_findings = [], []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            try:
                files.append(SourceFile(path, rel, text))
            except SyntaxError as e:
                parse_findings.append(Finding(
                    "syntax-error", rel, e.lineno or 1,
                    f"unparseable source: {e.msg}", key="syntax-error"))
    readme_text = None
    if readme is not None and os.path.exists(readme):
        with open(readme, encoding="utf-8") as f:
            readme_text = f.read()
    return Project(root, files, readme_path=readme, readme=readme_text,
                   parse_findings=parse_findings)


def run_analysis(root, readme=None, rules=None, timings=None):
    """Run every pass over ``root`` -> sorted list of :class:`Finding`.

    ``readme``: path for the doc-sync rules (None = skipped).
    ``rules``: optional iterable restricting which rule names report.
    ``timings``: optional dict filled with per-pass wall seconds
    (``tests/test_torch_dklint.py`` budgets the total so the
    cross-module graph walks cannot quietly slow tier-1's self-check).
    """
    import time as _time

    # late imports: the passes import this module for Finding
    from dist_keras_tpu_torch.analysis import (
        concurrency,
        hygiene,
        registries,
        purity,
    )

    if timings is None:
        timings = {}
    t0 = _time.perf_counter()
    project = load_tree(root, readme=readme)
    timings["load"] = _time.perf_counter() - t0
    findings = list(project.parse_findings)
    for name, pass_run in (("registries", registries.run),
                           ("purity", purity.run),
                           ("hygiene", hygiene.run),
                           ("concurrency", concurrency.run)):
        t0 = _time.perf_counter()
        findings += pass_run(project)
        timings[name] = _time.perf_counter() - t0
    # the unused-waiver sweep runs LAST: only after every pass consulted
    # its waivers do we know which `# dklint: ignore[...]` lines fired
    t0 = _time.perf_counter()
    findings += _unused_waivers(project)
    timings["waivers"] = _time.perf_counter() - t0
    if rules is not None:
        # syntax-error is never filterable: a --rules run that silently
        # skipped an unparseable file would report "clean" on a tree
        # the other passes never even read
        allowed = set(rules) | {"syntax-error"}
        unknown = allowed - set(RULES)
        if unknown:
            raise ValueError(f"unknown rule name(s): {sorted(unknown)}")
        findings = [f for f in findings if f.rule in allowed]
    return sorted(findings, key=Finding.sort_key)


def _unused_waivers(project):
    """A waiver whose rule never fired at its site is itself a finding
    — stale ``ignore[...]`` comments must not accumulate as the code
    under them is fixed or moves away."""
    findings = []
    for sf in project.files:
        for lineno in sorted(sf.waivers):
            for rule in sorted(sf.waivers[lineno]):
                if (lineno, rule) in sf.used_waivers:
                    continue
                if rule == "unused-waiver":
                    # the meta-waiver is consulted right below, never
                    # by a pass — it cannot be "used" in the pass sense
                    continue
                if sf.waived("unused-waiver", lineno):
                    continue
                findings.append(Finding(
                    "unused-waiver", sf.rel, lineno,
                    f"waiver ignore[{rule}] no longer matches a "
                    f"{rule} finding at this site — remove the stale "
                    "waiver (or fix the drifted rule name)",
                    key=f"unused-waiver:{rule}:{sf.line_text(lineno)}"))
    return findings


def import_bindings(tree):
    """-> {local name: binding} for every import in ``tree`` — the one
    extraction both cross-module call-graph walkers (the round-12
    signal-safety pass and the round-15 concurrency pass) resolve
    through.  ``import pkg.mod as m`` binds a dotted-module string;
    ``from pkg import name`` / ``from pkg.mod import fn`` bind a
    ``(module, name)`` tuple."""
    bindings = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bindings[alias.asname
                         or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                bindings[alias.asname or alias.name] = \
                    (node.module, alias.name)
    return bindings


_BROAD_NAMES = ("Exception", "BaseException")


def is_broad_handler(handler):
    """``except:``, ``except Exception``/``BaseException``, or a tuple
    containing either — the one predicate both the ``broad-except``
    rule (hygiene) and the ``obs-must-not-raise`` rule (purity) share.
    BaseException counts: an even-broader swallow must not be the
    evasion route around the audit invariant."""
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name) and t.id in _BROAD_NAMES:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in _BROAD_NAMES
                   for e in t.elts)
    return False


# -- baseline ----------------------------------------------------------

def load_baseline(path):
    """-> set of grandfathered fingerprints (empty for a missing or
    empty file)."""
    if path is None or not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("findings", []), list):
        raise ValueError(
            f"malformed baseline {path!r}: expected "
            '{"version": 1, "findings": [fingerprints...]}')
    return set(doc.get("findings", []))


def write_baseline(path, findings):
    """Persist ``findings`` as the new grandfathered set."""
    doc = {"version": 1,
           "findings": sorted({f.fingerprint for f in findings})}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def apply_baseline(findings, fingerprints):
    """Mark findings whose fingerprint is grandfathered; -> the list of
    findings that still FAIL (not baselined)."""
    fresh = []
    for f in findings:
        if f.fingerprint in fingerprints:
            f.baselined = True
        else:
            fresh.append(f)
    return fresh
