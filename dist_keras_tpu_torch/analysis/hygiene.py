"""dklint pass 3 — seam hygiene (counterpart of
``dist_keras_tpu/analysis/hygiene.py``).

- ``broad-except``: every ``except Exception`` / bare ``except`` in the
  tree must carry a ``# dklint: ignore[broad-except] <reason>`` waiver
  naming WHY the swallow is intentional (best-effort telemetry, typed
  fallback, optional-dependency probe, ...).  The round-12 audit waived
  each existing site with its reason in place; a new broad except
  without one is a finding.
- ``untyped-raise``: modules with a typed-error contract (coordination:
  ``PeerLost``/``BarrierTimeout``/``CoordinatorPoisoned``; checkpoint:
  ``CheckpointCorrupt``; serving: ``Overloaded``; supervisor:
  ``CrashLoop``; ps: ``StaleCommit``/``PSUnavailable``) must not grow
  new ``raise RuntimeError``/``raise
  Exception`` sites — an untyped error is exactly what the supervisor
  cannot classify.  Deliberate fatal RuntimeErrors are waived in place
  with their rationale.  The scope is matched on path components: a
  contract basename, or a file under a top-level ``serving/`` or
  ``ps/`` directory.  (The JAX pass tests ``"ps/" in rel``, a
  substring, which also takes in ``ops/``; the port does not.)
- ``jit-impure``: ``time.time()``/``perf_counter`` and ``random``/
  ``np.random`` calls inside a jit-compiled function trace ONCE and
  freeze — the call silently stops doing what it looks like it does.
  Covers ``@jax.jit``/``@jit``/``@partial(jax.jit, ...)`` decorations
  and ``jax.jit(fn)``/``jax.jit(lambda ...)`` call forms whose target
  is statically resolvable, and the port's compiled form, which freezes
  the same way: ``@torch.compile`` / ``@torch.compile(...)`` /
  ``@partial(torch.compile, ...)`` and ``torch.compile(fn)`` /
  ``torch.compile(lambda ...)``.  (``jax.random`` is fine — it is
  deterministic and traceable.)
"""

from __future__ import annotations

import ast

from dist_keras_tpu_torch.analysis.core import Finding, is_broad_handler

# files where the typed-error contract applies (basenames + top-level
# directories)
_TYPED_ERROR_BASENAMES = {"coordination.py", "supervisor.py",
                          "preemption.py", "backend.py",
                          "checkpoint.py"}
_TYPED_ERROR_DIRS = {"serving", "ps"}
_UNTYPED = {"Exception", "RuntimeError"}

_TIME_IMPURE = {"time", "time_ns", "perf_counter", "perf_counter_ns",
                "monotonic", "monotonic_ns"}


def _enclosing_functions(tree):
    """-> {node: qualname} for every function, for stable keys."""
    quals = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = f"{prefix}{child.name}"
                quals[child] = q
                visit(child, q + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return quals


def _qual_at(quals_spans, lineno):
    best = ""
    for (start, end), q in quals_spans:
        if start <= lineno <= end:
            best = q  # innermost wins: spans are visited outer-first
    return best


def _typed_error_scope(rel):
    parts = rel.split("/")
    if parts[-1] in _TYPED_ERROR_BASENAMES:
        return True
    return len(parts) > 1 and parts[0] in _TYPED_ERROR_DIRS


# -- jit detection -----------------------------------------------------

def _is_jit_expr(node):
    """``jit`` / ``jax.jit`` / ``torch.compile`` as an expression."""
    if isinstance(node, ast.Name) and node.id == "jit":
        return True
    if isinstance(node, ast.Attribute) and node.attr == "compile":
        return isinstance(node.value, ast.Name) and node.value.id == "torch"
    return isinstance(node, ast.Attribute) and node.attr == "jit"


def _jit_targets(sf):
    """FunctionDef/Lambda nodes that are jit-compiled in this module."""
    functions = {n.name: n for n in ast.walk(sf.tree)
                 if isinstance(n, ast.FunctionDef)}
    targets = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                expr = dec.func if isinstance(dec, ast.Call) else dec
                if _is_jit_expr(expr):
                    targets.append(node)
                elif isinstance(dec, ast.Call) and isinstance(
                        dec.func, (ast.Name, ast.Attribute)) \
                        and (getattr(dec.func, "id", None) == "partial"
                             or getattr(dec.func, "attr", None)
                             == "partial") \
                        and dec.args and _is_jit_expr(dec.args[0]):
                    targets.append(node)
        elif isinstance(node, ast.Call) and _is_jit_expr(node.func) \
                and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Lambda):
                targets.append(arg)
            elif isinstance(arg, ast.Name) \
                    and arg.id in functions:
                targets.append(functions[arg.id])
    return targets


def _impure_calls(fn):
    """(lineno, description) for impure calls inside a jit function."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id == "time" \
                    and func.attr in _TIME_IMPURE:
                out.append((node.lineno, f"time.{func.attr}()"))
            elif isinstance(base, ast.Name) and base.id == "random":
                out.append((node.lineno, f"random.{func.attr}()"))
            elif isinstance(base, ast.Attribute) \
                    and base.attr == "random" \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id in ("np", "numpy"):
                out.append((node.lineno,
                            f"{base.value.id}.random.{func.attr}()"))
    return out


def run(project):
    findings = []
    for sf in project.files:
        quals = _enclosing_functions(sf.tree)
        quals_spans = [((n.lineno, getattr(n, "end_lineno", n.lineno)),
                        q) for n, q in quals.items()]

        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ExceptHandler) \
                    and is_broad_handler(node):
                if not sf.waived("broad-except", node.lineno):
                    qual = _qual_at(quals_spans, node.lineno) \
                        or "<module>"
                    findings.append(Finding(
                        "broad-except", sf.rel, node.lineno,
                        "broad except without a waiver naming why the "
                        "swallow is intentional "
                        "(`# dklint: ignore[broad-except] <reason>`)",
                        key=f"broad-except:{qual}:"
                            f"{sf.line_text(node.lineno)}"))
            elif isinstance(node, ast.Raise) \
                    and _typed_error_scope(sf.rel):
                exc = node.exc
                name = None
                if isinstance(exc, ast.Call) \
                        and isinstance(exc.func, ast.Name):
                    name = exc.func.id
                elif isinstance(exc, ast.Name):
                    name = exc.id
                if name in _UNTYPED \
                        and not sf.waived("untyped-raise", node.lineno):
                    qual = _qual_at(quals_spans, node.lineno) \
                        or "<module>"
                    findings.append(Finding(
                        "untyped-raise", sf.rel, node.lineno,
                        f"raise {name} in a typed-error-contract "
                        "module — use the module's typed class, or "
                        "waive with the rationale",
                        key=f"untyped-raise:{qual}:{name}"))

        for fn in _jit_targets(sf):
            for lineno, what in _impure_calls(fn):
                if not sf.waived("jit-impure", lineno):
                    findings.append(Finding(
                        "jit-impure", sf.rel, lineno,
                        f"{what} inside a jit-compiled function is "
                        "traced once and frozen into the executable",
                        key=f"jit-impure:{what}:"
                            f"{sf.line_text(lineno)}"))
    return findings
