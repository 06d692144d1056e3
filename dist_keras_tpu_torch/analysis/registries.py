"""dklint pass 1 — registry consistency.

Every runtime registry the framework keeps is mirrored by a source
invariant this pass enforces, WITHOUT importing the analyzed code (the
registries are extracted from the AST, so fixture trees lint exactly
like the real one):

- ``faults.KNOWN_POINTS``  <->  every ``fault_point("name")`` call site
  (dynamic-name sites declare their names via
  ``# dklint: fault-points=a,b``), in BOTH directions: an unlisted call
  site is invisible to chaos mode, a dead registry row arms a point
  that never fires.
- ``utils/knobs.py``  <->  every ``DK_*`` environment read.  Reading
  ``os.environ`` with a ``DK_*`` literal anywhere else is a finding;
  so is passing an unregistered name to ``knobs.raw``/``knobs.get``.
  The README knob tables are checked against the registry both ways.
- ``events.KNOWN_EVENTS``  <->  every ``emit("kind")`` call site, and
  the README event-schema table (marked
  ``<!-- dklint: events-table -->``) both ways.
- ``metrics.KNOWN_METRICS``  <->  every ``counter``/``gauge``/
  ``histogram`` name (kind included; dynamic families annotate their
  registered pattern), pairwise collision-freedom of the registered
  names after Prometheus sanitization, and the README metrics table
  (``<!-- dklint: metrics-table -->``) both ways.  The README serves
  both packages: a row marked :data:`JAX_ONLY` documents a metric that
  only the JAX package registers, and is no drift here.
- ``spans.KNOWN_SPANS``  <->  every ``span("name")`` /
  ``span_at("name", ...)`` call site (wildcard entries match via
  fnmatch; dynamic names annotate ``# dklint: spans=<pattern>``) —
  the span vocabulary the report, the Perfetto export and operator
  tooling attribute against is registry-closed like the others.
- ``slo.KNOWN_SLOS``  <->  the README SLO objective table (marked
  ``<!-- dklint: slos-table -->``) both ways — an objective nobody
  documented cannot page anyone usefully.
"""

from __future__ import annotations

import ast
import fnmatch
import re

from dist_keras_tpu_torch.analysis.core import Finding, rules_table

# the README metrics table's mark on a row of the JAX package's alone
JAX_ONLY = "(JAX package only)"

_METRIC_KINDS = ("counter", "gauge", "histogram")
_DK_RE = re.compile(r"DK_[A-Z0-9_]+")
_BACKTICK_RE = re.compile(r"`([^`]+)`")
# prometheus.metric_name's sanitization, mirrored (a unit test pins the
# two implementations together)
_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name, kind):
    n = _PROM_NAME_RE.sub("_", str(name))
    if n and n[0].isdigit():
        n = "_" + n
    return "dk_" + n + ("_total" if kind == "counter" else "")


def _str_const(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_name(func):
    """'f' for ``f(...)``, 'a.f' resolved to ('a', 'f') for
    ``a.f(...)`` — returns (base_or_None, attr)."""
    if isinstance(func, ast.Name):
        return None, func.id
    if isinstance(func, ast.Attribute):
        base = func.value.id if isinstance(func.value, ast.Name) else None
        return base, func.attr
    return None, None


# -- registry extraction (AST only) ------------------------------------

def _extract_tuple_assign(sf, target_name):
    """-> (values, lineno) for ``TARGET = ("a", "b", ...)``, else None."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if target_name not in names:
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            values = [_str_const(e) for e in node.value.elts]
            if all(v is not None for v in values):
                return values, node.lineno
    return None


def _extract_dict_assign(sf, target_name):
    """-> ({key: value}, lineno) for ``TARGET = {"k": "v", ...}``."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if target_name not in names:
            continue
        if isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                ks, vs = _str_const(k), _str_const(v)
                if ks is None or vs is None:
                    return None
                out[ks] = vs
            return out, node.lineno
    return None


def _extract_registries(project):
    regs = {"faults": None, "events": None, "metrics": None,
            "knobs": None, "spans": None, "slos": None}
    for sf in project.files:
        if regs["faults"] is None:
            found = _extract_tuple_assign(sf, "KNOWN_POINTS")
            if found:
                regs["faults"] = (found[0], sf, found[1])
        if regs["events"] is None:
            found = _extract_tuple_assign(sf, "KNOWN_EVENTS")
            if found:
                regs["events"] = (found[0], sf, found[1])
        if regs["spans"] is None:
            found = _extract_tuple_assign(sf, "KNOWN_SPANS")
            if found:
                regs["spans"] = (found[0], sf, found[1])
        if regs["metrics"] is None:
            found = _extract_dict_assign(sf, "KNOWN_METRICS")
            if found:
                regs["metrics"] = (found[0], sf, found[1])
        if regs["slos"] is None:
            found = _extract_dict_assign(sf, "KNOWN_SLOS")
            if found:
                regs["slos"] = (found[0], sf, found[1])
        if sf.rel.endswith("knobs.py"):
            knob_names = []
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                _, attr = _call_name(node.func)
                if attr in ("_register", "register") and node.args:
                    name = _str_const(node.args[0])
                    if name is not None and name.startswith("DK_"):
                        knob_names.append((name, node.lineno, node))
            if knob_names and regs["knobs"] is None:
                regs["knobs"] = (knob_names, sf)
    return regs


# -- environ access detection ------------------------------------------

def _is_environ(node):
    """``os.environ`` (or a bare ``environ`` import)."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return isinstance(node.value, ast.Name) \
            and node.value.id == "os"
    return isinstance(node, ast.Name) and node.id == "environ"


def _environ_read_name(node):
    """The DK_* literal read by this node, or None.

    Forms: ``os.environ.get("DK_X", ...)``, ``os.getenv("DK_X")``,
    ``os.environ["DK_X"]`` (Load), ``"DK_X" in os.environ`` —
    setdefault/pop count as reads too (they return the value)."""
    if isinstance(node, ast.Call):
        base, attr = _call_name(node.func)
        if attr in ("get", "setdefault", "pop") \
                and isinstance(node.func, ast.Attribute) \
                and _is_environ(node.func.value) and node.args:
            return _str_const(node.args[0])
        if base == "os" and attr == "getenv" and node.args:
            return _str_const(node.args[0])
    if isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, ast.Load) \
            and _is_environ(node.value):
        return _str_const(node.slice)
    if isinstance(node, ast.Compare) and len(node.ops) == 1 \
            and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
            and _is_environ(node.comparators[0]):
        return _str_const(node.left)
    return None


# -- README table parsing ----------------------------------------------

def _table_rows(readme):
    """Every markdown table row line -> (lineno, text)."""
    return [(i, line) for i, line in
            enumerate(readme.split("\n"), start=1)
            if line.lstrip().startswith("|")]


def _marked_table_tokens(readme, marker):
    """Backticked first-column tokens of the table following
    ``<!-- dklint: MARKER -->`` -> {token: lineno}, or None when the
    marker is absent.  Built on the same table walk as the strict
    row comparison so the two doc-sync paths cannot drift."""
    rows = _marked_table_data_lines(readme, marker)
    if rows is None:
        return None
    tokens = {}
    for lineno, row in rows:
        cells = row.split("|")
        first = cells[1] if len(cells) > 1 else ""
        for tok in _BACKTICK_RE.findall(first):
            tokens.setdefault(tok.strip(), lineno)
    return tokens


def _knob_table_rows(knob_reg):
    """Reconstruct ``knobs.doc_table()``'s data rows from the AST of
    the ``_register`` calls (all-literal by construction), or None when
    any piece is not statically resolvable.  A unit test pins this
    mirror to the real ``doc_table()`` output."""
    rows = []
    for name, _lineno, call in knob_reg[0]:
        kwargs = {kw.arg: kw.value for kw in call.keywords}
        try:
            default = ast.literal_eval(call.args[1])
        except (ValueError, IndexError):
            return None
        parse = call.args[2] if len(call.args) > 2 else None
        kind_node = kwargs.get("kind")
        if kind_node is not None:
            kind = _str_const(kind_node)
        elif isinstance(parse, ast.Name):
            kind = parse.id
        else:
            kind = None
        doc_node = call.args[3] if len(call.args) > 3 \
            else kwargs.get("doc")
        doc = _str_const(doc_node) if doc_node is not None else None
        if kind is None or doc is None:
            return None
        if default is None:
            default_s = "—"
        elif default == "":
            default_s = '`""`'
        else:
            default_s = f"`{default}`"
        doc = " ".join(doc.split())
        rows.append(f"| `{name}` | {kind} | {default_s} | {doc} |")
    return rows


def _marked_table_data_lines(readme, marker):
    """The data rows (lineno, text) of the table after the marker —
    header and |---| separator skipped — or None when absent."""
    lines = readme.split("\n")
    start = None
    for i, line in enumerate(lines):
        if f"dklint: {marker}" in line:
            start = i + 1
            break
    if start is None:
        return None
    rows, in_table, seen_header = [], False, False
    for i in range(start, len(lines)):
        line = lines[i]
        if line.lstrip().startswith("|"):
            in_table = True
            cells = line.split("|")
            first = cells[1] if len(cells) > 1 else ""
            if set(first.strip()) <= set("-: "):
                continue
            if not seen_header:
                seen_header = True  # the header row
                continue
            rows.append((i + 1, line.strip()))
        elif in_table:
            break
    return rows


# -- the pass ----------------------------------------------------------

def run(project):
    findings = []
    regs = _extract_registries(project)
    fault_reg = regs["faults"]
    event_reg = regs["events"]
    metric_reg = regs["metrics"]
    knob_reg = regs["knobs"]
    span_reg = regs["spans"]

    fault_points = set(fault_reg[0]) if fault_reg else None
    event_names = set(event_reg[0]) if event_reg else None
    metric_names = dict(metric_reg[0]) if metric_reg else None
    metric_patterns = ({n: k for n, k in metric_names.items()
                        if "*" in n} if metric_names else {})
    knob_names = ({entry[0] for entry in knob_reg[0]} if knob_reg
                  else None)
    span_names = set(span_reg[0]) if span_reg else None
    span_patterns = ([n for n in span_names if "*" in n]
                     if span_names else [])

    def span_known(name):
        return (name in span_names
                or any(fnmatch.fnmatchcase(name, p)
                       for p in span_patterns))

    used_fault_points = set()

    def emit_finding(rule, sf, lineno, message, key=None):
        if not sf.waived(rule, lineno):
            findings.append(Finding(rule, sf.rel, lineno, message,
                                    key=key or sf.line_text(lineno)))

    for sf in project.files:
        defines_fault_point = any(
            isinstance(n, ast.FunctionDef) and n.name == "fault_point"
            for n in ast.walk(sf.tree))
        defines_span = any(
            isinstance(n, ast.FunctionDef) and n.name == "span"
            for n in ast.walk(sf.tree))
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.Call, ast.Subscript,
                                     ast.Compare)):
                continue
            # DK_* environ reads outside knobs.py
            dk = _environ_read_name(node)
            if dk and dk.startswith("DK_") \
                    and not sf.rel.endswith("knobs.py"):
                emit_finding(
                    "knob-read", sf, node.lineno,
                    f"{dk} read bypasses utils/knobs.py — register "
                    "the knob and resolve through knobs.raw/get",
                    key=f"knob-read:{dk}")
            if not isinstance(node, ast.Call):
                continue
            base, attr = _call_name(node.func)

            # knobs.raw / knobs.get with a literal name
            if base == "knobs" and attr in ("raw", "get") and node.args:
                name = _str_const(node.args[0])
                if name and knob_names is not None \
                        and name not in knob_names:
                    emit_finding(
                        "knob-unregistered", sf, node.lineno,
                        f"knobs.{attr}({name!r}) but {name} is not "
                        "registered in utils/knobs.py",
                        key=f"knob-unregistered:{name}")

            # fault_point call sites (not the definition module's def)
            if attr == "fault_point" and not defines_fault_point:
                name = _str_const(node.args[0]) if node.args else None
                if name is not None:
                    used_fault_points.add(name)
                    if fault_points is not None \
                            and name not in fault_points:
                        emit_finding(
                            "fault-point-unknown", sf, node.lineno,
                            f"fault_point({name!r}) is not listed in "
                            "faults.KNOWN_POINTS — chaos mode can "
                            "never arm it",
                            key=f"fault-point:{name}")
                else:
                    declared = sf.annotation("fault-points",
                                             node.lineno)
                    if declared is None:
                        emit_finding(
                            "fault-point-dynamic", sf, node.lineno,
                            "fault_point with a computed name needs "
                            "`# dklint: fault-points=a,b` declaring "
                            "the names this site can take")
                    else:
                        for name in declared:
                            used_fault_points.add(name)
                            if fault_points is not None \
                                    and name not in fault_points:
                                emit_finding(
                                    "fault-point-unknown", sf,
                                    node.lineno,
                                    f"annotated fault point {name!r} "
                                    "is not in faults.KNOWN_POINTS",
                                    key=f"fault-point:{name}")

            # emit("kind") call sites
            if attr == "emit" and event_names is not None:
                kind = _str_const(node.args[0]) if node.args else None
                if node.args and kind is not None:
                    if kind not in event_names:
                        emit_finding(
                            "event-unregistered", sf, node.lineno,
                            f"emit({kind!r}) is not in "
                            "events.KNOWN_EVENTS",
                            key=f"event:{kind}")
                elif node.args:
                    declared = sf.annotation("events", node.lineno)
                    if declared is None:
                        emit_finding(
                            "event-dynamic", sf, node.lineno,
                            "emit with a computed kind needs "
                            "`# dklint: events=a,b`")
                    else:
                        for kind in declared:
                            if kind not in event_names:
                                emit_finding(
                                    "event-unregistered", sf,
                                    node.lineno,
                                    f"annotated event {kind!r} is not "
                                    "in events.KNOWN_EVENTS",
                                    key=f"event:{kind}")

            # counter/gauge/histogram names
            if attr in _METRIC_KINDS and metric_names is not None \
                    and node.args:
                name = _str_const(node.args[0])
                if name is not None:
                    kind = metric_names.get(name)
                    if kind is None:
                        kind = next(
                            (k for p, k in metric_patterns.items()
                             if fnmatch.fnmatchcase(name, p)), None)
                    if kind is None:
                        emit_finding(
                            "metric-unregistered", sf, node.lineno,
                            f"metric {name!r} is not in "
                            "metrics.KNOWN_METRICS",
                            key=f"metric:{name}")
                    elif kind != attr:
                        emit_finding(
                            "metric-unregistered", sf, node.lineno,
                            f"metric {name!r} is registered as a "
                            f"{kind}, not a {attr}",
                            key=f"metric-kind:{name}")
                else:
                    declared = sf.annotation("metrics", node.lineno)
                    if declared is None:
                        emit_finding(
                            "metric-dynamic", sf, node.lineno,
                            f"{attr} with a computed name needs "
                            "`# dklint: metrics=<registered name or "
                            "pattern>`")
                    else:
                        for pat in declared:
                            kind = metric_names.get(pat)
                            if kind is None:
                                emit_finding(
                                    "metric-unregistered", sf,
                                    node.lineno,
                                    f"annotated metric {pat!r} is not "
                                    "a registered KNOWN_METRICS entry",
                                    key=f"metric:{pat}")
                            elif kind != attr:
                                emit_finding(
                                    "metric-unregistered", sf,
                                    node.lineno,
                                    f"annotated metric {pat!r} is "
                                    f"registered as a {kind}, not a "
                                    f"{attr}",
                                    key=f"metric-kind:{pat}")

            # span("name") / span_at("name", ...) call sites — the
            # span vocabulary is registry-closed like events/metrics
            # (the defining module's own internals are exempt)
            if attr in ("span", "span_at") and span_names is not None \
                    and not defines_span and node.args:
                name = _str_const(node.args[0])
                if name is not None:
                    if not span_known(name):
                        emit_finding(
                            "span-unregistered", sf, node.lineno,
                            f"span {name!r} is not in "
                            "spans.KNOWN_SPANS",
                            key=f"span:{name}")
                else:
                    declared = sf.annotation("spans", node.lineno)
                    if declared is None:
                        emit_finding(
                            "span-dynamic", sf, node.lineno,
                            "span with a computed name needs "
                            "`# dklint: spans=<registered name or "
                            "pattern>`")
                    else:
                        for pat in declared:
                            if pat not in span_names:
                                emit_finding(
                                    "span-unregistered", sf,
                                    node.lineno,
                                    f"annotated span {pat!r} is not a "
                                    "registered KNOWN_SPANS entry",
                                    key=f"span:{pat}")

    # registry -> call-site direction for fault points
    if fault_reg is not None:
        values, sf, lineno = fault_reg
        for name in values:
            if name not in used_fault_points \
                    and not sf.waived("fault-point-unused", lineno):
                findings.append(Finding(
                    "fault-point-unused", sf.rel, lineno,
                    f"KNOWN_POINTS entry {name!r} has no fault_point "
                    "call site (dead registry row)",
                    key=f"fault-point-unused:{name}"))

    # collision-freedom of registered metric names after sanitization
    if metric_reg is not None:
        names, sf, lineno = metric_reg
        seen = {}
        for name, kind in names.items():
            if "*" in name:
                continue
            pn = prom_name(name, kind)
            if pn in seen:
                findings.append(Finding(
                    "metric-collision", sf.rel, lineno,
                    f"metrics {seen[pn]!r} and {name!r} both render "
                    f"as Prometheus series {pn!r}",
                    key=f"metric-collision:{pn}"))
            else:
                seen[pn] = name

    findings += _check_readme(project, knob_reg, event_reg, metric_reg,
                              regs["slos"])
    return findings


def _check_readme(project, knob_reg, event_reg, metric_reg,
                  slo_reg=None):
    findings = []
    readme = project.readme
    if readme is None:
        return findings
    rel = project.readme_path or "README.md"

    # knobs <-> any table row mentioning a DK_* name
    if knob_reg is not None:
        registered = {entry[0] for entry in knob_reg[0]}
        documented = {}
        for lineno, row in _table_rows(readme):
            for m in _DK_RE.finditer(row):
                tok = m.group().rstrip("_")
                if row[m.end():m.end() + 1] == "*":
                    continue  # a DK_FOO_* wildcard, not a knob name
                documented.setdefault(tok, lineno)
        sf_knobs = knob_reg[1]
        for name, lineno, _node in knob_reg[0]:
            if name not in documented:
                findings.append(Finding(
                    "knob-undocumented", sf_knobs.rel, lineno,
                    f"registered knob {name} appears in no README "
                    "table row", key=f"knob-doc:{name}"))
        for name, lineno in sorted(documented.items()):
            if name not in registered:
                findings.append(Finding(
                    "knob-doc-drift", rel, lineno,
                    f"README table documents {name} but "
                    "utils/knobs.py does not register it",
                    key=f"knob-doc-drift:{name}"))
        # strict sync of the GENERATED consolidated table: when the
        # `<!-- dklint: knobs-table -->` marker is present, every row
        # (kind, default, doc — not just the name) must match the
        # registry exactly, in registry order
        expected = _knob_table_rows(knob_reg)
        actual = _marked_table_data_lines(readme, "knobs-table")
        if expected is not None and actual is not None:
            actual_rows = [row for _, row in actual]
            if actual_rows != expected:
                missing = [r for r in expected
                           if r not in actual_rows]
                extra = [(ln, r) for ln, r in actual
                         if r not in expected]
                for row in missing:
                    name = row.split("`")[1]
                    findings.append(Finding(
                        "knob-doc-drift", rel,
                        actual[0][0] if actual else 1,
                        f"consolidated knob table is out of sync "
                        f"with utils/knobs.py for {name}: expected "
                        f"row {row!r} (regenerate with "
                        "`python -m dist_keras_tpu_torch.analysis "
                        "--knob-table`)",
                        key=f"knob-table-sync:{name}"))
                for ln, row in extra:
                    findings.append(Finding(
                        "knob-doc-drift", rel, ln,
                        f"consolidated knob table row {row!r} does "
                        "not match any registry entry (regenerate "
                        "with --knob-table)",
                        key=f"knob-table-extra:{row}"))
                if not missing and not extra:
                    findings.append(Finding(
                        "knob-doc-drift", rel, actual[0][0],
                        "consolidated knob table rows are out of "
                        "ORDER vs the registry (regenerate with "
                        "--knob-table)", key="knob-table-order"))

    # events <-> the marked event-schema table
    if event_reg is not None:
        names, sf_events, reg_line = event_reg
        tokens = _marked_table_tokens(readme, "events-table")
        if tokens is None:
            findings.append(Finding(
                "event-undocumented", rel, 1,
                "README has no `<!-- dklint: events-table -->` marker "
                "before the event-schema table",
                key="events-table-marker"))
        else:
            for name in names:
                if name not in tokens:
                    findings.append(Finding(
                        "event-undocumented", sf_events.rel, reg_line,
                        f"event {name!r} has no row in the README "
                        "event-schema table", key=f"event-doc:{name}"))
            for tok, lineno in sorted(tokens.items()):
                if re.fullmatch(r"[a-z0-9_]+", tok) \
                        and tok not in names:
                    findings.append(Finding(
                        "event-doc-drift", rel, lineno,
                        f"README event-schema table names {tok!r} "
                        "which is not in events.KNOWN_EVENTS",
                        key=f"event-doc-drift:{tok}"))

    # the analyzer's OWN rule table <-> core.RULES (marked, strict,
    # generated by --rules-table — the five concurrency rules can never
    # drift from the docs any more than the knobs/events/metrics can)
    expected = rules_table().splitlines()[2:]
    actual = _marked_table_data_lines(readme, "rules-table")
    if actual is None:
        findings.append(Finding(
            "rule-undocumented", rel, 1,
            "README has no `<!-- dklint: rules-table -->` marker "
            "before the static-analysis rule table",
            key="rules-table-marker"))
    else:
        actual_rows = [row for _, row in actual]
        if actual_rows != expected:
            missing = [r for r in expected if r not in actual_rows]
            extra = [(ln, r) for ln, r in actual
                     if r not in expected]
            for row in missing:
                name = row.split("`")[1]
                findings.append(Finding(
                    "rule-undocumented", rel,
                    actual[0][0] if actual else 1,
                    f"README rules table is missing/stale for rule "
                    f"{name!r}: expected row {row!r} (regenerate with "
                    "`python -m dist_keras_tpu_torch.analysis "
                    "--rules-table`)", key=f"rule-doc:{name}"))
            for ln, row in extra:
                findings.append(Finding(
                    "rule-doc-drift", rel, ln,
                    f"README rules table row {row!r} matches no rule "
                    "in core.RULES (regenerate with --rules-table)",
                    key=f"rule-doc-drift:{row}"))
            if not missing and not extra:
                findings.append(Finding(
                    "rule-doc-drift", rel, actual[0][0],
                    "README rules table rows are out of ORDER vs "
                    "core.RULES (regenerate with --rules-table)",
                    key="rules-table-order"))

    # metrics <-> the marked metrics table
    if metric_reg is not None:
        names, sf_metrics, reg_line = metric_reg
        tokens = _marked_table_tokens(readme, "metrics-table")
        if tokens is None:
            findings.append(Finding(
                "metric-undocumented", rel, 1,
                "README has no `<!-- dklint: metrics-table -->` "
                "marker before the metrics table",
                key="metrics-table-marker"))
        else:
            for name in names:
                if name not in tokens:
                    findings.append(Finding(
                        "metric-undocumented", sf_metrics.rel,
                        reg_line,
                        f"metric {name!r} has no row in the README "
                        "metrics table", key=f"metric-doc:{name}"))
            lines = readme.split("\n")
            for tok, lineno in sorted(tokens.items()):
                if re.fullmatch(r"[a-z0-9_.*]+", tok) \
                        and tok not in names \
                        and JAX_ONLY not in lines[lineno - 1]:
                    findings.append(Finding(
                        "metric-doc-drift", rel, lineno,
                        f"README metrics table names {tok!r} which is "
                        "not in metrics.KNOWN_METRICS",
                        key=f"metric-doc-drift:{tok}"))

    # SLO objectives <-> the marked SLO table (both ways, like events)
    if slo_reg is not None:
        names, sf_slos, reg_line = slo_reg
        tokens = _marked_table_tokens(readme, "slos-table")
        if tokens is None:
            findings.append(Finding(
                "slo-undocumented", rel, 1,
                "README has no `<!-- dklint: slos-table -->` marker "
                "before the SLO objective table",
                key="slos-table-marker"))
        else:
            for name in names:
                if name not in tokens:
                    findings.append(Finding(
                        "slo-undocumented", sf_slos.rel, reg_line,
                        f"objective {name!r} has no row in the README "
                        "SLO table", key=f"slo-doc:{name}"))
            for tok, lineno in sorted(tokens.items()):
                if re.fullmatch(r"[a-z0-9_]+", tok) \
                        and tok not in names:
                    findings.append(Finding(
                        "slo-doc-drift", rel, lineno,
                        f"README SLO table names {tok!r} which is not "
                        "in slo.KNOWN_SLOS",
                        key=f"slo-doc-drift:{tok}"))
    return findings
