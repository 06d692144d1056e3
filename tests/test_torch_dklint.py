"""The port's dklint (``dist_keras_tpu_torch/analysis``) against the JAX
package's (``dist_keras_tpu/analysis``).

- every rule, on a violating and a clean fixture tree built like
  ``tests/test_dklint.py``'s (``lint``): both analyzers give the same
  findings (rule, path, line, message, the package name normalised);
- the JAX package's tree: the same findings from both (none);
- the port's tree: the JAX analyzer finds exactly what the port's does,
  plus one ``untyped-raise`` at ``ops/_build.py`` — F5, the JAX pass's
  substring scope test, which puts ``ops/`` under ``ps/``'s typed-error
  contract and which the port fixes (pinned on a fixture below) — and
  the README metrics rows marked ``(JAX package only)``: the JAX
  package's retrace counters, which the port does not register;
- the port's tree is clean with the shipped, empty baseline, in process
  and through ``python -m dist_keras_tpu_torch.analysis --json``
  (rc 0, no jax loaded);
- ``jit-impure`` reads ``torch.compile``'s forms in the port;
- the runtime budget of ``tests/test_dklint.py``.

Each real tree is analysed once per module (module-scoped fixture).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from dist_keras_tpu.analysis import RULES as JAX_RULES
from dist_keras_tpu.analysis import rules_table as jax_rules_table
from dist_keras_tpu.analysis import run_analysis as jax_run
from dist_keras_tpu_torch.analysis import (
    RULES,
    apply_baseline,
    load_baseline,
    rules_table,
    run_analysis,
)
from dist_keras_tpu_torch.analysis.__main__ import main as dklint_main
from dist_keras_tpu_torch.analysis.registries import JAX_ONLY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "dist_keras_tpu")
PORT = os.path.join(REPO, "dist_keras_tpu_torch")
README = os.path.join(REPO, "README.md")
BUDGET_S = 20.0   # tests/test_dklint.py::test_analyzer_runtime_budget
# registered by the JAX package and not by the port (eager PyTorch
# compiles nothing)
JAX_ONLY_METRICS = ("perf.compile_s", "perf.retraces", "perf.traces")


def write_tree(root, files, readme=None):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    if readme is None:
        return None
    path = root / "README.md"
    path.write_text(textwrap.dedent(readme))
    return str(path)


def norm(findings):
    return [(f.rule, f.path, f.line,
             f.message.replace("dist_keras_tpu_torch", "dist_keras_tpu"))
            for f in findings]


def both(root, readme=None):
    """-> (the JAX analyzer's findings, the port's), normalised."""
    return (norm(jax_run(str(root), readme=readme)),
            norm(run_analysis(str(root), readme=readme)))


# -- fixtures per rule: (violating, clean), each (files, readme) --------

FAULTS = """
    KNOWN_POINTS = ("a.save", "b.load")


    def fault_point(name, value=None):
        return value
"""
EVENTS = """
    KNOWN_EVENTS = ("boot", "halt")


    def emit(kind, **fields):
        try:
            pass
        # dklint: ignore[broad-except] the never-throws contract
        except Exception:
            pass
"""
METRICS = """
    KNOWN_METRICS = {"a.b": "counter", "q.depth": "gauge",
                     "span.*": "histogram"}
"""
KNOBS = """
    KNOBS = {}


    def _register(name, default, parse, doc):
        KNOBS[name] = (default, parse, doc)


    _register("DK_A", None, str, "knob a")
    _register("DK_B_S", 1.0, float, "knob b")
"""
SPANS = """
    KNOWN_SPANS = ("train.run", "perf.*")


    def span(name, **fields):
        pass
"""
SLOS = """
    KNOWN_SLOS = {"serve_availability": "answered without error",
                  "serve_latency": "under the latency threshold"}
"""
THREADS = """
    KNOWN_THREAD_ROOTS = {
        "work.loop": "w.py:Worker._loop",
    }
    LOCK_ORDER = ()
"""
WORKER = """
    import threading


    class Worker:
        def _loop(self):
            pass

        def _rogue(self):
            pass

        def start(self):
            threading.Thread(target=self.{target}).start()
"""
KNOB_TABLE = """
    | knob | meaning |
    |---|---|
    | `DK_A` | documented |
    {extra}
"""
EVENT_TABLE = """
    <!-- dklint: events-table -->
    | kind | emitted by |
    |---|---|
    | `boot` | somewhere |
    {extra}
"""
METRIC_TABLE = """
    <!-- dklint: metrics-table -->
    | metric | kind |
    |---|---|
    | `a.b` | counter |
    | `span.*` | histogram |
    {extra}
"""
SLO_TABLE = """
    <!-- dklint: slos-table -->
    | objective | meaning |
    |---|---|
    | `serve_availability` | answered |
    {extra}
"""
SHARED = """
    import threading


    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.state = None

        def _loop(self):
            {thread_write}

        def start(self):
            threading.Thread(target=self._loop).start()

        def poke(self):
            {main_write}
"""
LOCKS = """
    import threading


    class A:
        def __init__(self):
            self._lock_a = threading.Lock()
            self._lock_b = threading.Lock()

        def one(self):
            with self._lock_a:
                with self._lock_b:
                    pass

        def two(self):
            with self._lock_b:
                {body}
"""
GUARDED = "with self._lock:\n                self.state = {v}"


def _signal(body):
    return {"p.py": """
        import os
        import signal
        import threading
        import time

        _lock = threading.Lock()


        def _handler(signum, frame):
            %s


        def install():
            signal.signal(signal.SIGTERM, _handler)
    """ % body}


CASES = {
    "syntax-error": (({"broken.py": "def f(:\n"}, None),
                     ({"ok.py": "x = 1\n"}, None)),
    "fault-point-unknown": (
        ({"faults.py": FAULTS, "x.py": """
            from faults import fault_point

            fault_point("c.boom")
        """}, None),
        ({"faults.py": FAULTS, "x.py": """
            from faults import fault_point

            fault_point("a.save")
            fault_point("b.load")
        """}, None)),
    "fault-point-dynamic": (
        ({"faults.py": FAULTS, "x.py": """
            from faults import fault_point


            def go(point):
                fault_point(point)
        """}, None),
        ({"faults.py": FAULTS, "x.py": """
            from faults import fault_point


            def go(point):
                # dklint: fault-points=a.save,b.load
                fault_point(point)
        """}, None)),
    "fault-point-unused": (
        ({"faults.py": FAULTS, "x.py": """
            from faults import fault_point

            fault_point("a.save")
        """}, None),
        ({"faults.py": FAULTS, "x.py": """
            from faults import fault_point

            fault_point("a.save")
            fault_point("b.load")
        """}, None)),
    "knob-read": (
        ({"utils/knobs.py": KNOBS, "x.py": """
            import os

            a = os.environ.get("DK_A")
            b = os.getenv("DK_B_S")
            c = os.environ["DK_A"]
            d = "DK_A" in os.environ
        """}, None),
        ({"utils/knobs.py": KNOBS, "x.py": """
            import os

            from pkg.utils import knobs

            a = knobs.raw("DK_A")
            e = os.environ.get("OTHER_VAR")
        """}, None)),
    "knob-unregistered": (
        ({"utils/knobs.py": KNOBS, "x.py": """
            from pkg.utils import knobs

            bad = knobs.get("DK_NOPE")
        """}, None),
        ({"utils/knobs.py": KNOBS, "x.py": """
            from pkg.utils import knobs

            ok = knobs.get("DK_B_S")
        """}, None)),
    "knob-undocumented": (
        ({"utils/knobs.py": KNOBS}, KNOB_TABLE.format(extra="")),
        ({"utils/knobs.py": KNOBS},
         KNOB_TABLE.format(extra="| `DK_B_S` | documented |"))),
    "knob-doc-drift": (
        ({"utils/knobs.py": KNOBS},
         KNOB_TABLE.format(extra="| `DK_GHOST` | never registered |")),
        ({"utils/knobs.py": KNOBS},
         KNOB_TABLE.format(extra="| `DK_B_S` | documented |"))),
    "event-unregistered": (
        ({"events.py": EVENTS, "x.py": """
            from events import emit

            emit("mystery")
        """}, None),
        ({"events.py": EVENTS, "x.py": """
            from events import emit

            emit("boot")
        """}, None)),
    "event-dynamic": (
        ({"events.py": EVENTS, "x.py": """
            from events import emit

            emit(kind)
        """}, None),
        ({"events.py": EVENTS, "x.py": """
            from events import emit

            # dklint: events=boot,halt
            emit(kind)
        """}, None)),
    "event-undocumented": (
        ({"events.py": EVENTS}, EVENT_TABLE.format(extra="")),
        ({"events.py": EVENTS},
         EVENT_TABLE.format(extra="| `halt` | elsewhere |"))),
    "event-doc-drift": (
        ({"events.py": EVENTS},
         EVENT_TABLE.format(extra="| `phantom` | nowhere |")),
        ({"events.py": EVENTS},
         EVENT_TABLE.format(extra="| `halt` | elsewhere |"))),
    "metric-unregistered": (
        ({"metrics.py": METRICS, "x.py": """
            from observability import metrics

            metrics.counter("zz.unknown").inc()
            metrics.gauge("a.b").set(1)
        """}, None),
        ({"metrics.py": METRICS, "x.py": """
            from observability import metrics

            metrics.counter("a.b").inc()
            metrics.histogram("span.train.step").observe(1.0)
        """}, None)),
    "metric-dynamic": (
        ({"metrics.py": METRICS, "x.py": """
            from observability import metrics

            metrics.histogram(f"span.{p}").observe(1.0)
        """}, None),
        ({"metrics.py": METRICS, "x.py": """
            from observability import metrics

            # dklint: metrics=span.*
            metrics.histogram(f"span.{p}").observe(1.0)
        """}, None)),
    "metric-collision": (
        ({"metrics.py": """
            KNOWN_METRICS = {"a.b": "gauge", "a_b": "gauge"}
        """}, None),
        ({"metrics.py": """
            KNOWN_METRICS = {"a.b": "gauge", "a_c": "gauge"}
        """}, None)),
    "metric-undocumented": (
        ({"metrics.py": METRICS}, METRIC_TABLE.format(extra="")),
        ({"metrics.py": METRICS},
         METRIC_TABLE.format(extra="| `q.depth` | gauge |"))),
    "metric-doc-drift": (
        ({"metrics.py": METRICS},
         METRIC_TABLE.format(extra="| `ghost.metric` | counter |")),
        ({"metrics.py": METRICS},
         METRIC_TABLE.format(extra="| `q.depth` | gauge |"))),
    "slo-undocumented": (
        ({"slo.py": SLOS}, SLO_TABLE.format(extra="")),
        ({"slo.py": SLOS},
         SLO_TABLE.format(extra="| `serve_latency` | fast |"))),
    "slo-doc-drift": (
        ({"slo.py": SLOS},
         SLO_TABLE.format(extra="| `phantom_slo` | nowhere |")),
        ({"slo.py": SLOS},
         SLO_TABLE.format(extra="| `serve_latency` | fast |"))),
    "span-unregistered": (
        ({"spans.py": SPANS, "x.py": """
            from spans import span

            span("mystery.phase")
        """}, None),
        ({"spans.py": SPANS, "x.py": """
            from spans import span

            span("train.run")
            span("perf.step")
        """}, None)),
    "span-dynamic": (
        ({"spans.py": SPANS, "x.py": """
            from spans import span

            span(name)
        """}, None),
        ({"spans.py": SPANS, "x.py": """
            import spans

            # dklint: spans=perf.*
            spans.span(name)
        """}, None)),
    "signal-unsafe": (
        (_signal("with _lock:\n                pass"), None),
        (_signal("os.kill(os.getpid(), signum)"), None)),
    "obs-must-not-raise": (
        ({"events.py": """
            def emit(kind, **fields):
                _writer.emit(kind, **fields)
        """}, None),
        ({"events.py": EVENTS}, None)),
    "broad-except": (
        ({"x.py": """
            try:
                work()
            except Exception:
                pass
            try:
                work()
            except (ValueError, BaseException):
                pass
        """}, None),
        ({"x.py": """
            try:
                work()
            # dklint: ignore[broad-except] best-effort probe
            except Exception:
                pass
        """}, None)),
    "untyped-raise": (
        ({"serving/x.py": """
            def go():
                raise RuntimeError("untyped")
        """, "checkpoint.py": """
            def save():
                raise Exception("untyped")
        """}, None),
        ({"serving/x.py": """
            def ok():
                raise ValueError("config contract: fine")
        """, "data/y.py": """
            def elsewhere():
                raise RuntimeError("out of the typed-contract scope")
        """}, None)),
    "jit-impure": (
        ({"x.py": """
            import time

            import jax


            @jax.jit
            def step(x):
                return x * time.time()


            fast = jax.jit(lambda x: x + random.random())
        """}, None),
        ({"x.py": """
            import time


            def clean(x):
                return time.time(), x
        """}, None)),
    "thread-root-unknown": (
        ({"analysis/threads.py": THREADS,
          "w.py": WORKER.format(target="_rogue")}, None),
        ({"analysis/threads.py": THREADS,
          "w.py": WORKER.format(target="_loop")}, None)),
    "thread-root-unused": (
        ({"analysis/threads.py": """
            KNOWN_THREAD_ROOTS = {
                "work.loop": "w.py:Worker._loop",
                "ghost.loop": "w.py:Worker._ghost",
                "http.phantom": "~w.py:Phantom.*",
            }
        """, "w.py": WORKER.format(target="_loop")}, None),
        ({"analysis/threads.py": THREADS,
          "w.py": WORKER.format(target="_loop")}, None)),
    "lock-order-cycle": (
        ({"locks.py": LOCKS.format(
            body="with self._lock_a:\n                    pass")}, None),
        ({"locks.py": LOCKS.format(body="pass")}, None)),
    "unguarded-shared-write": (
        ({"shared.py": SHARED.format(thread_write="self.state = 1",
                                     main_write="self.state = 2")}, None),
        ({"shared.py": SHARED.format(thread_write=GUARDED.format(v=1),
                                     main_write=GUARDED.format(v=2))},
         None)),
    "unbounded-wait": (
        ({"waits.py": """
            def bad(t, ev, cv, fut, lock, inbox):
                t.join()
                ev.wait()
                cv.wait_for(lambda: True)
                fut.result()
                lock.acquire()
                item = inbox.get()
        """}, None),
        ({"waits.py": """
            def good(t, ev, cv, fut, lock, inbox, cfg):
                t.join(5.0)
                ev.wait(timeout=2.0)
                cv.wait_for(lambda: True, timeout=1.0)
                fut.result(timeout=5)
                lock.acquire(timeout=1)
                item = inbox.get(timeout=5.0)
                value = cfg.get("key")
                # dklint: ignore[unbounded-wait] every producer notifies
                cv.wait()
        """}, None)),
    "blocking-under-lock": (
        ({"block.py": """
            import threading
            import time

            from faults import fault_point

            _lock = threading.Lock()


            def helper():
                time.sleep(0.1)


            def direct():
                with _lock:
                    time.sleep(1.0)
                    helper()
                    fault_point("x.y")
        """}, None),
        ({"block.py": """
            import threading
            import time

            _lock = threading.Lock()


            def fine():
                with _lock:
                    pass
                time.sleep(0.5)
        """}, None)),
    "unused-waiver": (
        ({"x.py": """
            def stale():
                # dklint: ignore[broad-except] nothing broad left below
                return 1
        """}, None),
        ({"x.py": """
            def kept():
                # dklint: ignore[unused-waiver] kept deliberately for the
                # next refactor wave
                # dklint: ignore[broad-except] nothing broad left below
                return 1


            def active():
                try:
                    work()
                # dklint: ignore[broad-except] best-effort
                except Exception:
                    pass
        """}, None)),
    "rule-undocumented": (
        ({"x.py": "a = 1\n"}, "no marked tables here\n"),
        ({"x.py": "a = 1\n"},
         "<!-- dklint: rules-table -->\n" + rules_table() + "\n")),
    "rule-doc-drift": (
        ({"x.py": "a = 1\n"},
         "<!-- dklint: rules-table -->\n" + rules_table().replace(
             "| `syntax-error` |", "| `syntax-error` | STALE |", 1) + "\n"),
        ({"x.py": "a = 1\n"},
         "<!-- dklint: rules-table -->\n" + rules_table() + "\n")),
}


def test_every_rule_has_a_fixture_pair():
    assert set(CASES) == set(RULES)


@pytest.mark.parametrize("kind", ["violating", "clean"])
@pytest.mark.parametrize("rule", sorted(CASES))
def test_both_analyzers_agree_on_the_rule_fixtures(tmp_path, rule, kind):
    files, readme = CASES[rule][kind == "clean"]
    readme_path = write_tree(tmp_path, files, readme)
    jax_f, port_f = both(tmp_path, readme_path)
    assert port_f == jax_f
    fired = [f for f in port_f if f[0] == rule]
    if kind == "violating":
        assert fired, f"{rule}: the violating fixture raised nothing"
    else:
        assert not fired, fired


def test_f5_the_typed_error_scope_is_path_components(tmp_path):
    """The JAX pass tests ``"ps/" in rel``, so ``ops/x.py`` falls under
    ``ps/``'s typed-error contract; the port matches a top-level
    ``serving/`` or ``ps/`` directory, or a contract basename."""
    raising = """
        def go():
            raise RuntimeError("untyped")
    """
    write_tree(tmp_path, {"ops/x.py": raising, "ps/x.py": raising,
                          "serving/y.py": raising,
                          "resilience/coordination.py": raising})
    jax_f, port_f = both(tmp_path)
    assert sorted(f[1] for f in jax_f) == [
        "ops/x.py", "ps/x.py", "resilience/coordination.py",
        "serving/y.py"]
    assert sorted(f[1] for f in port_f) == [
        "ps/x.py", "resilience/coordination.py", "serving/y.py"]
    assert [f for f in jax_f if f[1] != "ops/x.py"] == port_f


def test_a_row_marked_jax_only_is_no_drift_in_the_port(tmp_path):
    """A README metrics row marked ``(JAX package only)`` documents a
    metric that only the JAX package registers: the port's analyzer
    lets it be, the JAX analyzer still holds it to its registry, and an
    unmarked ghost row is drift to both."""
    readme = write_tree(tmp_path, {"metrics.py": METRICS},
                        METRIC_TABLE.format(extra=(
                            f"| `ghost.metric` | counter | {JAX_ONLY} |\n"
                            "    | `q.depth` | gauge |")))

    def metric_rules(found):
        return [f[0] for f in found if f[0].startswith("metric")]

    jax_f, port_f = both(tmp_path, readme)
    assert metric_rules(jax_f) == ["metric-doc-drift"]
    assert metric_rules(port_f) == []
    write_tree(tmp_path, {}, METRIC_TABLE.format(extra=(
        "| `ghost.metric` | counter |\n    | `q.depth` | gauge |")))
    jax_f, port_f = both(tmp_path, readme)
    assert metric_rules(port_f) == ["metric-doc-drift"] == metric_rules(jax_f)


def test_jit_impure_reads_torch_compile(tmp_path):
    write_tree(tmp_path, {"x.py": """
        import random
        import re
        import time
        from functools import partial

        import torch


        @torch.compile
        def step(x):
            return x * time.time()


        @torch.compile(mode="reduce-overhead")
        def step2(x):
            return x + random.random()


        @partial(torch.compile, fullgraph=True)
        def step3(x):
            return x * time.perf_counter()


        def plain(x):
            return x + time.monotonic()


        fast = torch.compile(plain)
        lam = torch.compile(lambda x: x + random.random())


        def clean(x):
            return time.time(), re.compile("a"), compile("1", "f", "eval")
    """})
    port = run_analysis(str(tmp_path), rules=["jit-impure"])
    assert [f.line for f in port] == [12, 17, 22, 26, 30]
    assert all("inside a jit-compiled function" in f.message for f in port)
    # the JAX pass reads jax.jit only: none of these
    assert jax_run(str(tmp_path), rules=["jit-impure"]) == []


@pytest.fixture(scope="module")
def trees():
    """Each real tree through each analyzer once, and the port's CLI in
    a subprocess beside them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    cli = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "dist_keras_tpu_torch.analysis", "--json"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    timings = {}
    out = {
        "jax_on_jax": jax_run(JAX_PKG, readme=README),
        "port_on_jax": run_analysis(JAX_PKG, readme=README),
        "jax_on_port": jax_run(PORT, readme=README),
        "port_on_port": run_analysis(PORT, readme=README, timings=timings),
        "timings": timings,
    }
    stdout, stderr = cli.communicate(timeout=300)
    out["cli"] = (cli.returncode, stdout, stderr)
    return out


def test_both_analyzers_agree_on_the_jax_tree(trees):
    assert norm(trees["port_on_jax"]) == norm(trees["jax_on_jax"]) == []


def test_on_the_port_tree_the_jax_analyzer_differs_only_by_f5(trees):
    jax_f, port_f = norm(trees["jax_on_port"]), norm(trees["port_on_port"])
    extra = [f for f in jax_f if f not in port_f]
    assert [f for f in jax_f if f not in extra] == port_f
    assert [(r, p) for r, p, _, _ in extra if r != "metric-doc-drift"] == [
        ("untyped-raise", "ops/_build.py")]
    # the README rows of the JAX package's own metrics, which the port's
    # analyzer leaves to the JAX package's
    drift = [(p, m) for r, p, _, m in extra if r == "metric-doc-drift"]
    assert sorted(drift) == [(README, f"README metrics table names {name!r} which "
                      "is not in metrics.KNOWN_METRICS")
                     for name in sorted(JAX_ONLY_METRICS)]
    with open(README) as f:
        rows = [ln for ln in f if ln.startswith("| `perf.")]
    assert sorted(r.split("`")[1] for r in rows
                  if JAX_ONLY in r) == sorted(JAX_ONLY_METRICS)


def test_port_tree_is_clean_with_shipped_baseline(trees):
    path = os.path.join(PORT, "analysis", "baseline.json")
    with open(path) as f:
        assert json.load(f) == {"version": 1, "findings": []}
    fresh = apply_baseline(trees["port_on_port"], load_baseline(path))
    assert fresh == [], [f"{f.rule} {f.path}:{f.line}" for f in fresh]


def test_cli_subprocess_port_tree(trees):
    rc, stdout, stderr = trees["cli"]
    assert rc == 0, stdout + stderr
    doc = json.loads(stdout)
    assert doc["fresh"] == 0 and doc["total"] == 0
    assert os.path.samefile(doc["root"], PORT)
    assert os.path.samefile(doc["readme"], README)
    loaded = {line.rsplit("|", 1)[-1].strip() for line in
              stderr.splitlines() if line.startswith("import time:")}
    assert "dist_keras_tpu_torch.analysis.core" in loaded
    assert not {m for m in loaded if m.split(".")[0] in (
        "jax", "jaxlib", "dist_keras_tpu", "torch")}, sorted(loaded)


def test_analyzer_runtime_budget(trees):
    timings = trees["timings"]
    total = sum(timings.values())
    assert total < BUDGET_S, f"analyzer took {total:.1f}s: {timings}"
    assert timings.get("concurrency", 0.0) > 0.0


def test_rules_and_tables_are_the_jax_analyzers(capsys):
    assert RULES == JAX_RULES
    assert list(RULES) == list(JAX_RULES)
    assert rules_table() == jax_rules_table()
    assert dklint_main(["--rules-table"]) == 0
    assert capsys.readouterr().out.strip() == jax_rules_table().strip()
    from dist_keras_tpu_torch.utils import knobs

    assert dklint_main(["--knob-table"]) == 0
    assert capsys.readouterr().out.strip() == knobs.doc_table().strip()


def test_cli_exit_codes_json_and_baseline(tmp_path, capsys):
    (tmp_path / "x.py").write_text(textwrap.dedent("""
        try:
            work()
        except Exception:
            pass
    """))
    baseline = tmp_path / "bl.json"
    rc = dklint_main(["--root", str(tmp_path), "--no-readme", "--json",
                      "--baseline", str(baseline)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["fresh"] == 1
    assert doc["findings"][0]["rule"] == "broad-except"
    rc = dklint_main(["--root", str(tmp_path), "--no-readme",
                      "--baseline", str(baseline), "--write-baseline"])
    assert rc == 0
    capsys.readouterr()
    rc = dklint_main(["--root", str(tmp_path), "--no-readme",
                      "--baseline", str(baseline)])
    assert rc == 0 and "1 baselined" in capsys.readouterr().out
    rc = dklint_main(["--root", str(tmp_path), "--no-readme",
                      "--baseline", str(baseline), "--no-baseline"])
    capsys.readouterr()
    assert rc == 1
    with pytest.raises(SystemExit):
        dklint_main(["--help"])
    assert "python -m dist_keras_tpu_torch.analysis" in \
        capsys.readouterr().out
