"""dklint pass 4 — concurrency invariants.

Rounds 12-14 grew a real multi-threaded runtime — the async checkpoint
writer, the serving batcher + replica workers, the heartbeat/deadline
threads, the sampler/exporter plane — and its safety arguments lived
only as CHANGES.md prose and regression tests.  This pass turns them
into source invariants, with the same never-imports-the-tree design as
the other passes (registries are extracted from the AST, so fixture
trees lint exactly like the real package):

1. **Thread-root inventory** (``thread-root-unknown`` /
   ``thread-root-unused``).  Every ``threading.Thread(target=...)`` /
   ``threading.Timer`` / ``signal.signal`` registration site must
   resolve to a named root in ``analysis/threads.py``
   ``KNOWN_THREAD_ROOTS`` — the checker's ground truth for *which
   functions execute off the main thread*.  Dynamic sites (a variable
   handler, an inherited ``serve_forever``) annotate
   ``# dklint: thread-root=<name>``.  Registry values: ``"rel:Qual"``
   (must match a resolved site), ``"~rel:Qual"`` / ``"~rel:Class.*"``
   (a framework-dispatched root with no visible registration site —
   e.g. per-request HTTP handler threads; validated to exist, seeds
   reachability), or ``"external"`` (a restored foreign handler; used
   only via annotations).

2. **Lock-order graph** (``lock-order-cycle``).  Registered locks are
   the ``threading.Lock/RLock/Condition`` constructor assignments the
   AST shows (``self._x = threading.Lock()`` / module-level
   ``_lock = ...``).  The pass builds the acquires-while-holding graph:
   lexical ``with lock:`` nesting plus ``.acquire()`` reachability
   through the cross-module call-graph walker (same resolution rules as
   the round-12 signal-safety pass: ``self.m()``, same-module calls by
   name, ``from pkg import mod`` / ``import pkg.mod as m`` bindings
   into analyzed files).  ``LOCK_ORDER`` in ``analysis/threads.py``
   declares the intended orderings once as asserted edges; any cycle
   through observed + declared edges is a potential deadlock.
   Re-entrant locks (RLock, Condition — whose default inner lock is an
   RLock) may self-nest; a plain ``Lock`` self-edge is a length-1
   cycle.

3. **Shared-state audit** (``unguarded-shared-write``).  An instance
   attribute written from >= 2 distinct thread roots (the main thread
   counts as one) must have every write guarded by a common registered
   lock, be a sync primitive (Event/Condition/queue...), or carry a
   waiver naming the safety argument — this mechanically re-derives the
   "reference assignment is atomic" claims scattered through
   CHANGES.md.  ``__init__`` writes are pre-thread by construction and
   exempt; a helper that is *always called* with a lock held inherits
   that lock (intersection over its call sites, to a fixpoint).

4. **Bounded-wait enforcement** (``unbounded-wait``).  ``.join()``,
   ``Condition.wait()`` / ``wait_for()``, ``Event.wait()``,
   ``lock.acquire()`` and ``future.result()`` without a
   timeout/deadline argument are findings — the "a wedged writer costs
   one deadline, never a hang" contract as lint.  (Static check: a
   *passed* timeout variable that is None at runtime still satisfies
   it; the rule catches the overwhelmingly common omission.)

5. **Blocking-under-lock** (``blocking-under-lock``).  No
   ``time.sleep``, subprocess, socket/HTTP or ``fault_point`` call
   (an armed chaos ``delay`` IS a sleep) while holding a registered
   lock — lexically or through the call graph — because every other
   acquirer stalls behind it.

Resolution is deliberately best-effort static: calls through object
attributes other than ``self`` (``self._reg.inc()``) do not resolve,
so the graphs under-approximate — a finding is real, absence of one is
not a proof.  The registry + waivers carry the rest of the argument.
"""

from __future__ import annotations

import ast

from dist_keras_tpu_torch.analysis.core import Finding, import_bindings

_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_REENTRANT_CTORS = {"RLock", "Condition"}
_SYNC_CTORS = _LOCK_CTORS | {
    "Event", "Semaphore", "BoundedSemaphore", "Barrier",
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
_SYNC_MODULES = {"threading", "queue"}
_BLOCKING_BASES = {"subprocess", "socket", "requests"}


def _str_const(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_name(func):
    if isinstance(func, ast.Name):
        return None, func.id
    if isinstance(func, ast.Attribute):
        base = func.value.id if isinstance(func.value, ast.Name) else None
        return base, func.attr
    return None, None


def _kw(node, name):
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


# -- registry extraction ------------------------------------------------

def _extract_thread_registry(project):
    """-> (roots, order): ``KNOWN_THREAD_ROOTS`` as
    ``({name: value}, sf, lineno)`` and ``LOCK_ORDER`` as
    ``([(before, after), ...], sf, lineno)`` — either None when the
    tree does not declare it (fixture trees without a registry skip the
    inventory rules, like the other passes)."""
    roots = order = None
    for sf in project.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if "KNOWN_THREAD_ROOTS" in names and roots is None \
                    and isinstance(node.value, ast.Dict):
                out = {}
                for k, v in zip(node.value.keys, node.value.values):
                    ks, vs = _str_const(k), _str_const(v)
                    if ks is None or vs is None:
                        out = None
                        break
                    out[ks] = vs
                if out is not None:
                    roots = (out, sf, node.lineno)
            if "LOCK_ORDER" in names and order is None \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                pairs = []
                for e in node.value.elts:
                    if isinstance(e, (ast.Tuple, ast.List)) \
                            and len(e.elts) == 2:
                        a, b = _str_const(e.elts[0]), \
                            _str_const(e.elts[1])
                        if a is None or b is None:
                            pairs = None
                            break
                        pairs.append((a, b))
                    else:
                        pairs = None
                        break
                if pairs is not None:
                    order = (pairs, sf, node.lineno)
    return roots, order


# -- per-file index -----------------------------------------------------

class _FileIndex:
    """Functions (by dotted qualname), import bindings, registered
    locks/sync attrs, and thread/signal registration sites of one
    module."""

    def __init__(self, sf):
        self.sf = sf
        self.functions = {}    # qual -> def node ("Class.m", "f.inner")
        self.func_class = {}   # qual -> innermost enclosing class name
        self.locks = {}        # (cls_or_None, attr) -> reentrant bool
        self.sync_attrs = set()  # (cls, attr) assigned a sync primitive
        self.thread_sites = []   # (call node, cls, enclosing qual, kind)
        # local name -> binding, via the shared core.import_bindings
        # (one extraction for both cross-module walkers)
        self.imports = import_bindings(sf.tree)
        self._build(sf.tree, None, "")

    def _sync_ctor(self, value):
        """The constructor name if ``value`` builds a lock/sync
        primitive (``threading.Lock()``, ``queue.Queue()``, or a bare
        imported name), else None."""
        if not isinstance(value, ast.Call):
            return None
        base, attr = _call_name(value.func)
        if attr not in _SYNC_CTORS:
            return None
        if base in _SYNC_MODULES:
            return attr
        if base is None and isinstance(value.func, ast.Name):
            bound = self.imports.get(attr)
            if isinstance(bound, tuple) and bound[0] in _SYNC_MODULES:
                return attr
        return None

    def _build(self, node, cls, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + child.name
                self.functions[qual] = child
                self.func_class[qual] = cls
                self._build(child, cls, qual + ".")
            elif isinstance(child, ast.ClassDef):
                self._build(child, child.name, prefix + child.name + ".")
            else:
                if isinstance(child, ast.Assign):
                    ctor = self._sync_ctor(child.value)
                    if ctor is not None:
                        for t in child.targets:
                            if isinstance(t, ast.Attribute) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self" \
                                    and cls is not None:
                                self.sync_attrs.add((cls, t.attr))
                                if ctor in _LOCK_CTORS:
                                    self.locks[(cls, t.attr)] = \
                                        ctor in _REENTRANT_CTORS
                            elif isinstance(t, ast.Name) and cls is None \
                                    and not prefix:
                                if ctor in _LOCK_CTORS:
                                    self.locks[(None, t.id)] = \
                                        ctor in _REENTRANT_CTORS
                if isinstance(child, ast.Call):
                    self._note_site(child, cls, prefix)
                self._build(child, cls, prefix)

    def _note_site(self, node, cls, prefix):
        base, attr = _call_name(node.func)
        kind = None
        if attr in ("Thread", "Timer"):
            bound = self.imports.get(attr)
            if base == "threading" or (
                    base is None and isinstance(bound, tuple)
                    and bound[0] == "threading"):
                kind = attr
        elif attr == "signal" and base == "signal" \
                and len(node.args) >= 2:
            kind = "signal"
        if kind is not None:
            qual = prefix[:-1] if prefix.endswith(".") else prefix
            self.thread_sites.append((node, cls, qual, kind))

    def lock_of(self, expr, cls):
        """-> the registered lock key ``(cls_or_None, attr)`` this
        expression names, or None."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None:
            key = (cls, expr.attr)
            return key if key in self.locks else None
        if isinstance(expr, ast.Name):
            key = (None, expr.id)
            return key if key in self.locks else None
        return None


def _lock_name(lock_id):
    """Display name of a global lock id ``(rel, cls, attr)``."""
    rel, cls, attr = lock_id
    return f"{rel}:{cls}.{attr}" if cls else f"{rel}:{attr}"


def _resolve_call(index, caller_qual, cls, func, by_basename):
    """Resolve a call expression to ``(other_index, qual)`` or None —
    the round-12 walker's rules, extended with nested-scope and
    ``self.method`` resolution."""
    if isinstance(func, ast.Name):
        name = func.id
        parts = caller_qual.split(".") if caller_qual else []
        for i in range(len(parts), -1, -1):
            q = ".".join(parts[:i] + [name])
            if q in index.functions:
                return index, q
        bound = index.imports.get(name)
        if isinstance(bound, tuple):
            other = by_basename.get(bound[0].split(".")[-1] + ".py")
            if other is not None and bound[1] in other.functions:
                return other, bound[1]
        return None
    if isinstance(func, ast.Attribute):
        attr = func.attr
        base = func.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                q = f"{cls}.{attr}"
                if q in index.functions:
                    return index, q
                return None
            bound = index.imports.get(base.id)
            target = None
            if isinstance(bound, str):
                target = bound.split(".")[-1] + ".py"
            elif isinstance(bound, tuple):
                target = bound[1] + ".py"
            other = by_basename.get(target) if target else None
            if other is not None and attr in other.functions:
                return other, attr
    return None


# -- per-function summaries ---------------------------------------------

class _FnSummary:
    __slots__ = ("acquires", "calls", "blocking", "writes", "waits")

    def __init__(self):
        self.acquires = []   # (lock_id, lineno, held_tuple)
        self.calls = []      # ((rel, qual), lineno, held_frozenset)
        self.blocking = []   # (lineno, description, held_frozenset)
        self.writes = []     # (attr, lineno, held_frozenset)
        self.waits = []      # (lineno, description) — unbounded sites


def _queueish_name(expr):
    """Receiver-name heuristic for ``.get()``: a queue-shaped name
    (``inbox``, ``_queue``...) — dict/env ``.get`` always passes a
    key, so only the zero-arg form even reaches this check."""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    else:
        return False
    name = name.lower()
    return "queue" in name or "inbox" in name


def _wait_finding(node, base, attr, lockish, queueish):
    """-> description when this call is an unbounded cross-thread wait."""
    has_timeout_kw = any(
        kw.arg in ("timeout", "timeout_s", "deadline_s")
        for kw in node.keywords)
    if attr == "join" and not node.args and not node.keywords:
        return ".join() without a timeout"
    if attr == "wait" and not node.args and not has_timeout_kw:
        return ".wait() without a timeout"
    if attr == "wait_for" and len(node.args) < 2 and not has_timeout_kw:
        return ".wait_for(predicate) without a timeout"
    if attr == "result" and not node.args and not has_timeout_kw:
        return ".result() without a timeout"
    if attr == "acquire" and lockish and not node.args \
            and not has_timeout_kw:
        return ".acquire() without a timeout"
    if attr == "get" and queueish and not node.args \
            and not has_timeout_kw:
        return "queue .get() without a timeout"
    return None


def _lockish_name(expr):
    """Name-based lock heuristic for ``.acquire()`` receivers that are
    not registered locks (a parameter, a foreign object)."""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    else:
        return False
    name = name.lower()
    return "lock" in name or "cond" in name or "sem" in name


def _blocking_desc(node, index):
    """-> description when this call blocks (sleep/subprocess/socket/
    HTTP/fault_point), else None."""
    base, attr = _call_name(node.func)
    if attr == "fault_point":
        return "fault_point(...) (a chaos delay is a sleep)"
    if base == "time" and attr == "sleep":
        return "time.sleep(...)"
    if base in _BLOCKING_BASES:
        return f"{base}.{attr}(...)"
    if attr in ("urlopen", "getaddrinfo", "create_connection"):
        return f".{attr}(...)"
    if base is None and isinstance(node.func, ast.Name):
        bound = index.imports.get(node.func.id)
        if isinstance(bound, tuple) and bound[1] == "fault_point":
            return "fault_point(...) (a chaos delay is a sleep)"
        if isinstance(bound, tuple) and bound[0] in _BLOCKING_BASES:
            return f"{bound[0]}.{bound[1]}(...)"
    return None


def _scan(index, qual, by_basename):
    """Walk one function body tracking the lexically held registered
    locks -> :class:`_FnSummary`."""
    cls = index.func_class.get(qual)
    rel = index.sf.rel
    s = _FnSummary()

    def visit(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # separate summary; a closure runs later, locks free
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = held
            for item in node.items:
                visit(item.context_expr, new)
                lk = index.lock_of(item.context_expr, cls)
                if lk is not None:
                    gid = (rel,) + lk
                    s.acquires.append((gid, node.lineno, new))
                    new = new + (gid,)
            for b in node.body:
                visit(b, new)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" and cls is not None:
                    s.writes.append((t.attr, node.lineno,
                                     frozenset(held)))
        if isinstance(node, ast.Call):
            base, attr = _call_name(node.func)
            receiver = (node.func.value
                        if isinstance(node.func, ast.Attribute)
                        else None)
            lk = (index.lock_of(receiver, cls)
                  if receiver is not None else None)
            if attr == "acquire" and lk is not None:
                s.acquires.append(((rel,) + lk, node.lineno, held))
            if attr in ("join", "wait", "wait_for", "result",
                        "acquire", "get"):
                lockish = lk is not None or (
                    receiver is not None and _lockish_name(receiver))
                queueish = (receiver is not None
                            and _queueish_name(receiver))
                desc = _wait_finding(node, base, attr, lockish,
                                     queueish)
                if desc is not None:
                    s.waits.append((node.lineno, desc))
            desc = _blocking_desc(node, index)
            if desc is not None:
                s.blocking.append((node.lineno, desc, frozenset(held)))
            resolved = _resolve_call(index, qual, cls, node.func,
                                     by_basename)
            if resolved is not None:
                other, oq = resolved
                s.calls.append(((other.sf.rel, oq), node.lineno,
                                frozenset(held)))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    fn = index.functions[qual]
    for stmt in fn.body:
        visit(stmt, ())
    return s


# -- thread-root site resolution ----------------------------------------

def _resolve_target(index, target, cls, qual):
    """Resolve a Thread ``target=`` / signal handler expression to a
    ``(rel, qual)`` function in this file, or None."""
    if isinstance(target, ast.Name):
        parts = qual.split(".") if qual else []
        for i in range(len(parts), -1, -1):
            q = ".".join(parts[:i] + [target.id])
            if q in index.functions:
                return index.sf.rel, q
        return None
    if isinstance(target, ast.Attribute) \
            and isinstance(target.value, ast.Name) \
            and target.value.id == "self" and cls is not None:
        q = f"{cls}.{target.attr}"
        if q in index.functions:
            return index.sf.rel, q
    return None


def _site_target(node, kind):
    """The target/handler expression of a registration site, or the
    string ``"skip"`` when the site registers nothing to track
    (``signal.signal(sig, SIG_DFL/SIG_IGN)``)."""
    if kind == "signal":
        h = node.args[1]
        if isinstance(h, ast.Attribute) \
                and h.attr in ("SIG_DFL", "SIG_IGN"):
            return "skip"
        return h
    target = _kw(node, "target" if kind == "Thread" else "function")
    if target is not None:
        return target
    if kind == "Timer" and len(node.args) >= 2:
        return node.args[1]
    if kind == "Thread" and len(node.args) >= 2:
        return node.args[1]
    return None


def _closure(seeds, summaries):
    seen = set(seeds)
    stack = list(seen)
    while stack:
        f = stack.pop()
        summ = summaries.get(f)
        if summ is None:
            continue
        for callee, _, _ in summ.calls:
            if callee not in seen:
                seen.add(callee)
                stack.append(callee)
    return seen


# -- the pass -----------------------------------------------------------

def run(project):
    findings = []
    reg, order_reg = _extract_thread_registry(project)

    indexes = {}
    by_basename = {}
    for sf in project.files:
        idx = _FileIndex(sf)
        indexes[sf.rel] = idx
        base = sf.rel.rsplit("/", 1)[-1]
        if base != "__init__.py":
            by_basename.setdefault(base, idx)

    summaries = {}
    for rel, idx in indexes.items():
        for qual in idx.functions:
            summaries[(rel, qual)] = _scan(idx, qual, by_basename)

    def flag(rule, sf, lineno, message, key):
        if not sf.waived(rule, lineno):
            findings.append(Finding(rule, sf.rel, lineno, message,
                                    key=key))

    # ---- 1. thread-root inventory + root seeds -------------------------
    reg_map = reg[0] if reg else {}
    reg_by_value = {v: k for k, v in reg_map.items()}
    used_keys = set()
    root_seeds = {}  # root display name -> set of (rel, qual) seeds

    for rel, idx in indexes.items():
        sf = idx.sf
        for node, cls, qual, kind in idx.thread_sites:
            target = _site_target(node, kind)
            if target == "skip":
                continue
            resolved = (None if target is None
                        else _resolve_target(idx, target, cls, qual))
            if resolved is not None:
                value = f"{resolved[0]}:{resolved[1]}"
                name = reg_by_value.get(value)
                if name is not None:
                    used_keys.add(name)
                elif reg is not None:
                    declared = sf.annotation("thread-root", node.lineno)
                    if declared and all(d in reg_map for d in declared):
                        used_keys.update(declared)
                        name = declared[0]
                    else:
                        flag("thread-root-unknown", sf, node.lineno,
                             f"{kind} registration targets {value!r} "
                             "which is not a named root in "
                             "KNOWN_THREAD_ROOTS",
                             key=f"thread-root:{value}")
                root_seeds.setdefault(name or value,
                                      set()).add(resolved)
            else:
                declared = sf.annotation("thread-root", node.lineno)
                if declared is None:
                    if reg is not None:
                        flag("thread-root-unknown", sf, node.lineno,
                             f"{kind} registration with a computed "
                             "target needs `# dklint: "
                             "thread-root=<name>` naming a "
                             "KNOWN_THREAD_ROOTS entry",
                             key="thread-root-dynamic:"
                                 f"{sf.line_text(node.lineno)}")
                    continue
                for name in declared:
                    if reg is not None and name not in reg_map:
                        flag("thread-root-unknown", sf, node.lineno,
                             f"annotated thread root {name!r} is not "
                             "in KNOWN_THREAD_ROOTS",
                             key=f"thread-root:{name}")
                    else:
                        used_keys.add(name)

    # ~declared roots (framework-dispatched, no registration site)
    if reg is not None:
        reg_sf, reg_line = reg[1], reg[2]
        for name, value in reg_map.items():
            if value == "external":
                continue
            if not value.startswith("~"):
                continue
            loc = value[1:]
            rel, _, q = loc.partition(":")
            idx = indexes.get(rel)
            seeds = set()
            if idx is not None:
                if q.endswith(".*"):
                    prefix = q[:-1]  # "Class."
                    seeds = {(rel, fq) for fq in idx.functions
                             if fq.startswith(prefix)}
                elif q in idx.functions:
                    seeds = {(rel, q)}
            if not seeds:
                if not reg_sf.waived("thread-root-unused", reg_line):
                    findings.append(Finding(
                        "thread-root-unused", reg_sf.rel, reg_line,
                        f"declared root {name!r} -> {value!r} resolves "
                        "to no function in the analyzed tree",
                        key=f"thread-root-unused:{name}"))
            else:
                used_keys.add(name)
                root_seeds.setdefault(name, set()).update(seeds)
        for name, value in reg_map.items():
            if name in used_keys or value.startswith("~"):
                continue
            if not reg_sf.waived("thread-root-unused", reg_line):
                findings.append(Finding(
                    "thread-root-unused", reg_sf.rel, reg_line,
                    f"KNOWN_THREAD_ROOTS entry {name!r} -> {value!r} "
                    "matches no registration site or annotation (dead "
                    "registry row)", key=f"thread-root-unused:{name}"))

    # ---- reachability: which functions run under which roots -----------
    root_reach = {name: _closure(seeds, summaries)
                  for name, seeds in root_seeds.items()}
    off_main = set()
    for reach in root_reach.values():
        off_main |= reach
    main_seeds = [f for f in summaries if f not in off_main]
    main_reach = _closure(main_seeds, summaries)

    def roots_of(f):
        roots = {name for name, reach in root_reach.items()
                 if f in reach}
        if f in main_reach or not roots:
            roots.add("main")
        return roots

    # ---- held-at-every-call-site fixpoint ------------------------------
    callers = {}
    for f, summ in summaries.items():
        for callee, _, held in summ.calls:
            callers.setdefault(callee, []).append((f, held))
    held_env = {f: None for f in summaries}  # None = TOP (unknown)
    for _ in range(30):
        changed = False
        for f in summaries:
            cl = callers.get(f)
            if not cl:
                new = frozenset()
            else:
                acc = None
                for caller, held in cl:
                    ce = held_env.get(caller)
                    if ce is None and not held:
                        continue  # TOP caller adds no constraint
                    site = set(held) | set(ce or ())
                    acc = site if acc is None else (acc & site)
                new = None if acc is None else frozenset(acc)
            if new != held_env[f]:
                held_env[f] = new
                changed = True
        if not changed:
            break

    def env_of(f):
        e = held_env.get(f)
        return e if e is not None else frozenset()

    # ---- 3. shared-state audit -----------------------------------------
    writes = {}
    for (rel, qual), summ in summaries.items():
        cls = indexes[rel].func_class.get(qual)
        if cls is None:
            continue
        fname = qual.split(".")[-1] if "." in qual else qual
        # writes inside __init__ (or nested defs of it) happen before
        # any thread this object starts exists
        in_init = "__init__" in qual.split(".")
        for attr, lineno, held in summ.writes:
            writes.setdefault((rel, cls, attr), []).append(
                ((rel, qual), fname, lineno, held, in_init))
    for (rel, cls, attr), sites in sorted(writes.items()):
        idx = indexes[rel]
        if (cls, attr) in idx.sync_attrs:
            continue
        live = [s for s in sites if not s[4]]
        if not live:
            continue
        all_roots = set()
        for f, _, _, _, _ in live:
            all_roots |= roots_of(f)
        if len(all_roots) < 2:
            continue
        effective = [frozenset(h) | env_of(f)
                     for f, _, _, h, _ in live]
        if frozenset.intersection(*effective):
            continue  # every write guarded by a common lock
        # flag the bare writes when some exist (the actionable sites);
        # when every write IS locked but by different locks, flag all
        unguarded = [s for s, eff in zip(live, effective) if not eff]
        flag_sites = unguarded or live
        for f, _, lineno, held, _ in flag_sites:
            eff = frozenset(held) | env_of(f)
            locks = (", ".join(sorted(_lock_name(g) for g in eff))
                     or "no lock")
            flag("unguarded-shared-write", idx.sf, lineno,
                 f"self.{attr} is written from threads "
                 f"{sorted(all_roots)} but this write holds {locks} "
                 "(no common lock across all write sites) — guard it, "
                 "make it a sync primitive, or waive with the safety "
                 "argument",
                 key=f"unguarded-shared-write:{cls}.{attr}:"
                     f"{idx.sf.line_text(lineno)}")

    # ---- 4. bounded-wait ------------------------------------------------
    for (rel, qual), summ in summaries.items():
        sf = indexes[rel].sf
        for lineno, desc in summ.waits:
            flag("unbounded-wait", sf, lineno,
                 f"{desc} can hang forever on a wedged peer thread — "
                 "pass a timeout/deadline or waive with the reason the "
                 "wait is bounded elsewhere",
                 key=f"unbounded-wait:{qual}:{sf.line_text(lineno)}")

    # ---- 2. lock-order graph -------------------------------------------
    all_acquires = {f: {g for g, _, _ in summ.acquires}
                    for f, summ in summaries.items()}
    for _ in range(30):
        changed = False
        for f, summ in summaries.items():
            acc = all_acquires[f]
            before = len(acc)
            for callee, _, _ in summ.calls:
                acc |= all_acquires.get(callee, set())
            if len(acc) != before:
                changed = True
        if not changed:
            break

    edges = {}  # (A_name, B_name) -> (sf, lineno) first observed

    def add_edge(a, b, sf, lineno, reentrant_ok):
        if a == b and reentrant_ok:
            return
        an, bn = _lock_name(a), _lock_name(b)
        edges.setdefault((an, bn), (sf, lineno))

    for (rel, qual), summ in summaries.items():
        idx = indexes[rel]
        for gid, lineno, held in summ.acquires:
            re_ok = idx.locks.get(gid[1:], False)
            for h in held:
                add_edge(h, gid, idx.sf, lineno, re_ok and h == gid)
        for callee, lineno, held in summ.calls:
            if not held:
                continue
            for gid in all_acquires.get(callee, ()):
                c_rel = gid[0]
                re_ok = indexes[c_rel].locks.get(gid[1:], False)
                for h in held:
                    add_edge(h, gid, idx.sf, lineno,
                             re_ok and h == gid)

    def _known_lock(name):
        rel, _, rest = name.partition(":")
        idx = indexes.get(rel)
        if idx is None:
            return False
        cls, _, attr = rest.rpartition(".")
        return (cls or None, attr or rest) in idx.locks

    graph = {}
    for (a, b), site in edges.items():
        graph.setdefault(a, set()).add(b)
    if order_reg is not None:
        for a, b in order_reg[0]:
            # a declaration that names no registered lock declares
            # nothing — it would rot silently, like a stale waiver
            for name in (a, b):
                if not _known_lock(name):
                    flag("lock-order-cycle", order_reg[1],
                         order_reg[2],
                         f"LOCK_ORDER declares {name!r} which matches "
                         "no registered lock in the analyzed tree",
                         key=f"lock-order-unknown:{name}")
            graph.setdefault(a, set()).add(b)

    for cycle in _find_cycles(graph):
        members = set(cycle)
        observed = sorted(
            ((sf, lineno, a, b) for (a, b), (sf, lineno)
             in edges.items() if a in members and b in members),
            key=lambda t: (t[0].rel, t[1]))
        if any(sf.waived("lock-order-cycle", lineno)
               for sf, lineno, _, _ in observed):
            continue
        if observed:
            sf, lineno = observed[0][0], observed[0][1]
        elif order_reg is not None:
            sf, lineno = order_reg[1], order_reg[2]
        else:  # pragma: no cover - cycle needs at least one edge
            continue
        findings.append(Finding(
            "lock-order-cycle", sf.rel, lineno,
            "potential deadlock: locks acquired in a cycle "
            f"({' -> '.join(cycle + [cycle[0]])}) — fix the order or "
            "declare the intended one in LOCK_ORDER",
            key="lock-order-cycle:" + ",".join(sorted(members))))

    # ---- 5. blocking-under-lock ----------------------------------------
    blocks = {f: (summ.blocking[0][1] if summ.blocking else None)
              for f, summ in summaries.items()}
    for _ in range(30):
        changed = False
        for f, summ in summaries.items():
            if blocks[f] is not None:
                continue
            for callee, _, _ in summ.calls:
                via = blocks.get(callee)
                if via is not None:
                    blocks[f] = f"{via} via {callee[1]}()"
                    changed = True
                    break
        if not changed:
            break

    for (rel, qual), summ in summaries.items():
        sf = indexes[rel].sf
        for lineno, desc, held in summ.blocking:
            if held:
                locks = ", ".join(sorted(_lock_name(g) for g in held))
                flag("blocking-under-lock", sf, lineno,
                     f"{desc} while holding {locks} — every other "
                     "acquirer stalls behind it",
                     key=f"blocking-under-lock:{qual}:"
                         f"{sf.line_text(lineno)}")
        for callee, lineno, held in summ.calls:
            if not held:
                continue
            via = blocks.get(callee)
            if via is None:
                continue
            locks = ", ".join(sorted(_lock_name(g) for g in held))
            flag("blocking-under-lock", sf, lineno,
                 f"{via} via {callee[1]}() while holding {locks} — "
                 "every other acquirer stalls behind it",
                 key=f"blocking-under-lock:{qual}:"
                     f"{sf.line_text(lineno)}")

    return findings


def _find_cycles(graph):
    """-> list of cycles (each a list of node names) — one per strongly
    connected component with >= 2 nodes, plus self-loops.  Iterative
    Tarjan (the tree is small, but recursion depth must not depend on
    it)."""
    index = {}
    low = {}
    on_stack = set()
    stack = []
    sccs = []
    counter = [0]

    for start in sorted(graph):
        if start in index:
            continue
        work = [(start, iter(sorted(graph.get(start, ()))))]
        index[start] = low[start] = counter[0]
        counter[0] += 1
        stack.append(start)
        on_stack.add(start)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt,
                                                            ())))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or node in graph.get(node, ()):
                    sccs.append(sorted(comp))
    return sccs
