"""dklint pass 2 — signal-safety and never-raise discipline.

Two invariants that previously lived only in comments and CHANGES.md
prose:

1. **Signal handlers stay lock-free, emit-free and I/O-free.**  CPython
   dispatches handlers re-entrantly on the main thread at bytecode
   boundaries; a handler that blocks on a lock the interrupted code
   holds (the observability writer's, the metrics registry's) deadlocks
   the process — the round-8 rule ``preemption._handler`` documents.
   This pass finds every function registered via ``signal.signal(sig,
   handler)``, walks the statically-resolvable call graph reachable
   from it (same-module calls by name; cross-module calls through
   ``from pkg.mod import fn`` / ``from pkg import mod`` /
   ``import pkg.mod as m`` bindings whose target file is part of the
   analyzed tree), and flags lock
   acquisitions (``with <lock>``, ``.acquire()``), event emission
   (any ``emit`` call) and blocking I/O (``open``/``print``/
   ``os.write``/``time.sleep``/...).  ``os.kill``/``os.getpid``/
   ``signal.signal`` are allowlisted — the escalation path needs them.

2. **Never-throws observability entry points keep their broad
   handler.**  ``events.emit``, ``supervisor.alert``,
   ``MetricsSampler.tick`` and ``Watchdog.check`` promise to degrade
   rather than raise into training code; deleting their
   ``except Exception`` guard is a contract break this pass catches
   (``obs-must-not-raise``).
"""

from __future__ import annotations

import ast

from dist_keras_tpu_torch.analysis.core import (
    Finding,
    import_bindings,
    is_broad_handler,
)

# (file basename, enclosing class or None, function name) — the
# documented never-throws entry points
NEVER_RAISE = (
    ("events.py", None, "emit"),
    ("supervisor.py", None, "alert"),
    ("timeseries.py", "MetricsSampler", "tick"),
    ("watchdog.py", "Watchdog", "check"),
)

_ALLOWED_CALLS = {("os", "kill"), ("os", "getpid"),
                  ("signal", "signal"), ("signal", "getsignal")}
_IO_CALLS = {
    ("os", "write"), ("os", "read"), ("os", "fsync"), ("os", "open"),
    ("os", "close"), ("os", "makedirs"), ("os", "replace"),
    ("os", "remove"), ("os", "rename"), ("os", "unlink"),
    ("time", "sleep"),
    ("subprocess", "run"), ("subprocess", "call"),
    ("subprocess", "Popen"), ("subprocess", "check_call"),
    ("subprocess", "check_output"),
}
_IO_NAMES = {"open", "print", "input"}


def _lockish(expr):
    """A name whose terminal component smells like a lock
    (``_lock``, ``self._lock``, ``cond``...)."""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    else:
        return False
    name = name.lower()
    return "lock" in name or "cond" in name


class _ModuleIndex:
    """Per-module function defs + import bindings for call resolution."""

    def __init__(self, sf):
        self.sf = sf
        self.functions = {}   # name -> FunctionDef (module-level only)
        # local name -> dotted module or (module, attr) for
        # from-imports — the shared core.import_bindings extraction
        self.imports = import_bindings(sf.tree)
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self.functions[node.name] = node


def _handler_roots(index):
    """Functions this module registers via ``signal.signal(sig, F)``."""
    roots = []
    for node in ast.walk(index.sf.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        is_signal = (isinstance(func, ast.Attribute)
                     and func.attr == "signal"
                     and isinstance(func.value, ast.Name)
                     and func.value.id == "signal")
        if not is_signal or len(node.args) < 2:
            continue
        target = node.args[1]
        if isinstance(target, ast.Name) \
                and target.id in index.functions:
            roots.append(index.functions[target.id])
    return roots


def _check_handler_body(index, fn, findings, root_name, visited,
                        indexes_by_module):
    key = (index.sf.rel, fn.name)
    if key in visited:
        return
    visited.add(key)
    sf = index.sf

    def flag(lineno, what):
        if not sf.waived("signal-unsafe", lineno):
            findings.append(Finding(
                "signal-unsafe", sf.rel, lineno,
                f"{what} is reachable from signal handler "
                f"{root_name!r} (handlers must stay lock-free, "
                "emit-free and I/O-free)",
                key=f"signal-unsafe:{fn.name}:{sf.line_text(lineno)}"))

    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                if _lockish(item.context_expr):
                    flag(node.lineno, "a `with <lock>` acquisition")
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in _IO_NAMES:
                flag(node.lineno, f"blocking I/O ({name})")
            elif name == "emit":
                flag(node.lineno, "event emission (emit)")
            elif name in index.functions:
                _check_handler_body(index, index.functions[name],
                                    findings, root_name, visited,
                                    indexes_by_module)
            else:
                # `from pkg.mod import fn` then `fn()`: resolve fn in
                # mod's file when mod is part of the analyzed tree
                bound = index.imports.get(name)
                if isinstance(bound, tuple):
                    other = indexes_by_module.get(
                        bound[0].split(".")[-1] + ".py")
                    if other and bound[1] in other.functions:
                        _check_handler_body(
                            other, other.functions[bound[1]],
                            findings, root_name, visited,
                            indexes_by_module)
        elif isinstance(func, ast.Attribute):
            attr = func.attr
            base = (func.value.id if isinstance(func.value, ast.Name)
                    else None)
            if (base, attr) in _ALLOWED_CALLS:
                continue
            if (base, attr) in _IO_CALLS:
                flag(node.lineno, f"blocking I/O ({base}.{attr})")
            elif attr == "acquire":
                flag(node.lineno, "a lock .acquire()")
            elif attr == "emit":
                flag(node.lineno, f"event emission ({base}.{attr})")
            elif base is not None:
                bound = index.imports.get(base)
                # `import pkg.mod as m` -> str; `from pkg import mod`
                # -> (pkg, mod): either way, follow the call into the
                # bound module's file IF it is part of the analyzed
                # tree (by_basename lookup — stdlib imports miss it)
                target = None
                if isinstance(bound, str):
                    target = bound.split(".")[-1] + ".py"
                elif isinstance(bound, tuple):
                    target = bound[1] + ".py"
                other = (indexes_by_module.get(target)
                         if target else None)
                if other and attr in other.functions:
                    _check_handler_body(
                        other, other.functions[attr], findings,
                        root_name, visited, indexes_by_module)


def run(project):
    findings = []
    indexes = [(sf, _ModuleIndex(sf)) for sf in project.files]
    by_basename = {}
    for sf, index in indexes:
        by_basename.setdefault(sf.rel.rsplit("/", 1)[-1], index)

    for sf, index in indexes:
        for root in _handler_roots(index):
            _check_handler_body(index, root, findings, root.name,
                                set(), by_basename)

    # never-throws entry points keep their broad handler
    for sf, index in indexes:
        basename = sf.rel.rsplit("/", 1)[-1]
        for want_base, want_class, want_fn in NEVER_RAISE:
            if basename != want_base:
                continue
            fn = _find_function(sf, want_class, want_fn)
            if fn is None:
                continue
            if not _has_broad_handler(fn) \
                    and not sf.waived("obs-must-not-raise", fn.lineno):
                scope = (f"{want_class}.{want_fn}" if want_class
                         else want_fn)
                findings.append(Finding(
                    "obs-must-not-raise", sf.rel, fn.lineno,
                    f"{scope} is a never-throws entry point but has "
                    "no `except Exception` guard — it can raise into "
                    "training code", key=f"obs-must-not-raise:{scope}"))
    return findings


def _find_function(sf, class_name, fn_name):
    if class_name is None:
        for node in sf.tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name == fn_name:
                return node
        return None
    for node in sf.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) \
                        and sub.name == fn_name:
                    return sub
    return None


def _has_broad_handler(fn):
    return any(isinstance(node, ast.ExceptHandler)
               and is_broad_handler(node) for node in ast.walk(fn))
