"""Remote checkpoint tier — pluggable object stores + the mirror protocol;
a copy of the JAX package's ``resilience/store.py`` (it is all stdlib)
on the port's ``knobs``, ``events``, ``faults`` and ``checkpoint``.

Every recovery path before this module assumed the checkpoint directory
SURVIVES the host: a spot fleet whose replacement machines share no
disk with the dead ones could not restore at all (the round-13 elastic
resize reshards a checkpoint that must already be *somewhere*).  This
module gives checkpoints a pluggable remote home:

- :class:`CheckpointStore` is the seam — ``put_bytes`` / ``get_bytes``
  / ``exists`` / ``list`` / ``delete`` over opaque keys.  Two backends
  ship: :class:`LocalDirStore` (a directory — NFS mount, ``file://``
  URL, or plain path) and :class:`HTTPStore` (stdlib ``http.client``
  against any object-store-shaped endpoint; :class:`ObjectStoreServer`
  is the matching stdlib server in the ``serving/server.py`` style, so
  tests and gates exercise the real wire path without a cloud bucket).
  :class:`MemoryStore` (``mem://<name>`` URLs) is the in-process
  third backend — the cluster simulator's disk/network tier, with a
  partition hook for unreachable-window scenarios.
- The MIRROR PROTOCOL (:func:`push_step` / :func:`fetch_step`) maps a
  promoted local step onto store keys: content-addressed chunks under
  ``chunks/<sha256>`` (pushed at most once — the differential CAS
  identity IS the remote dedup key), per-step files under
  ``steps/step_NNNNNNNN/<rel>``, and a ``COMPLETE`` marker written
  LAST naming every file and chunk the step needs.  ``COMPLETE`` is
  the remote commit instant: :func:`remote_steps` only ever reports
  marked steps, so a push killed mid-stream is invisible — exactly the
  local promote discipline, one tier out.  Un-chunked and
  non-differential payloads mirror too (their chunk files are just
  per-step files); the CAS fast path is an optimization, not a
  requirement.
- :class:`CheckpointUploader` is the background mirror thread
  (registered as the ``ckpt.uploader`` root in ``analysis/threads.py``):
  it polls the local ``Checkpointer`` read-only — it only ever sees
  PROMOTED steps — and pushes anything newer than the newest remote
  ``COMPLETE``.  ``Checkpointer.save`` arms it automatically when
  ``DK_CKPT_REMOTE`` is set (leader-only on shared-dir pods).  Push
  failures are absorbed typed in the loop (events + retry surface
  counters) and re-tried next poll: a dead store degrades the run to
  local-only durability, never kills it.  Since round 20 the uploader
  also owns remote RETENTION: after each poll that pushed something,
  :func:`prune_remote` retires mirrored steps past the
  ``DK_CKPT_REMOTE_KEEP`` horizon (default: follow the local
  ``max_to_keep``) — marker-first deletes plus a conservative CAS
  sweep, counted by ``ckpt.remote_pruned`` / ``ckpt_remote_prune``.

Failure semantics: every object transfer runs under a named
``RetryPolicy`` surface (``"ckpt.push"`` / ``"ckpt.pull"``, transient
``OSError`` absorbed with backoff) with the matching fault points fired
INSIDE the retried body, so chaos mode exercises both the absorbed and
the typed-kill path (``gates.py --diff-ckpt-only``).  A missing remote
step is ``FileNotFoundError``; any non-OK store response is a typed
:class:`StoreError` (an ``OSError`` — outer supervisors classify it
transient).  Remote bytes are never trusted blind: a fetched step lands
in local staging, is promoted with the normal journaled swap, and then
passes through the SAME manifest verification every local restore runs.
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dist_keras_tpu_torch.utils import knobs

STEP_PREFIX = "steps/"
CHUNK_PREFIX = "chunks/"
COMPLETE_NAME = "COMPLETE"

_STEP_KEY_RE = re.compile(r"^steps/step_(\d+)/COMPLETE$")


class StoreError(OSError):
    """A checkpoint store operation failed (non-OK HTTP status,
    malformed response, refused key).  An ``OSError`` so the default
    retry policies absorb transient occurrences and supervisors
    classify it restartable."""


def step_key(step):
    """The remote key prefix of one step: ``steps/step_NNNNNNNN``."""
    return f"{STEP_PREFIX}step_{int(step):08d}"


# ---------------------------------------------------------------------
# the store seam + backends
# ---------------------------------------------------------------------

class CheckpointStore:
    """The pluggable remote tier: opaque-key object storage.

    Keys are relative POSIX-ish paths (``chunks/<sha>``,
    ``steps/step_N/manifest.json``); values are bytes.  Backends must
    make ``put_bytes`` atomic-per-key (a reader never sees a torn
    object) and ``exists``/``list`` consistent with completed puts.
    """

    def put_bytes(self, key, data):  # pragma: no cover - interface
        raise NotImplementedError

    def get_bytes(self, key):  # pragma: no cover - interface
        raise NotImplementedError

    def exists(self, key):  # pragma: no cover - interface
        raise NotImplementedError

    def list(self, prefix=""):  # pragma: no cover - interface
        raise NotImplementedError

    def delete(self, key):  # pragma: no cover - interface
        raise NotImplementedError

    def put_file(self, key, path):
        with open(path, "rb") as f:
            data = f.read()
        self.put_bytes(key, data)
        return len(data)


def _check_key(key):
    key = str(key)
    if (not key or key.startswith(("/", "\\")) or ".." in key.split("/")
            or "\\" in key):
        raise StoreError(f"refusing unsafe store key {key!r}")
    return key


class LocalDirStore(CheckpointStore):
    """Filesystem backend: keys are paths under ``root``.  Puts are
    atomic (tmp + fsync + rename) so a reader — possibly another host
    on the same NFS mount — never sees a torn object."""

    def __init__(self, root, fsync=True):
        self.root = os.path.abspath(os.path.expanduser(str(root)))
        self.fsync = bool(fsync)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key):
        return os.path.join(self.root, *_check_key(key).split("/"))

    def put_bytes(self, key, data):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_bytes(self, key):
        with open(self._path(key), "rb") as f:
            return f.read()

    def exists(self, key):
        return os.path.isfile(self._path(key))

    def list(self, prefix=""):
        out = []
        for dirpath, _dn, filenames in os.walk(self.root):
            for name in filenames:
                rel = os.path.relpath(os.path.join(dirpath, name),
                                      self.root).replace(os.sep, "/")
                if rel.startswith(prefix) and ".tmp-" not in rel:
                    out.append(rel)
        return sorted(out)

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass  # idempotent: absent is the goal state


class MemoryStore(CheckpointStore):
    """In-process dict backend — the cluster simulator's disk/network
    tier (and a zero-setup store for tests).  Hundreds of simulated
    writers share one instance with no sockets and no tmpdirs, while
    the mirror protocol above it stays byte-identical to production.

    Per-key puts are atomic by construction (one dict assignment under
    the lock).  ``fail`` is the partition hook: a callable
    ``fail(op, key) -> bool`` consulted before every operation —
    returning True raises a transient :class:`StoreError`, which is how
    a scenario script makes the remote tier unreachable for a window
    and then heals it."""

    def __init__(self, fail=None):
        self._objects = {}
        self._lock = threading.Lock()
        self.fail = fail

    def _gate(self, op, key):
        if self.fail is not None and self.fail(op, key):
            raise StoreError(
                f"store unreachable (simulated partition): {op} {key!r}")

    def put_bytes(self, key, data):
        key = _check_key(key)
        self._gate("put", key)
        with self._lock:
            self._objects[key] = bytes(data)

    def get_bytes(self, key):
        key = _check_key(key)
        self._gate("get", key)
        with self._lock:
            try:
                return self._objects[key]
            except KeyError:
                raise FileNotFoundError(
                    f"store has no object {key!r}") from None

    def exists(self, key):
        key = _check_key(key)
        self._gate("head", key)
        with self._lock:
            return key in self._objects

    def list(self, prefix=""):
        self._gate("list", prefix)
        with self._lock:
            return sorted(k for k in self._objects
                          if k.startswith(prefix))

    def delete(self, key):
        key = _check_key(key)
        self._gate("delete", key)
        with self._lock:
            self._objects.pop(key, None)


# named in-process stores, so `mem://<name>` URLs resolve to a SHARED
# MemoryStore within the process — the sim scenario and the components
# it drives (uploader, fetch paths) meet at the same object the way
# real processes meet at the same bucket
_memory_stores = {}
_memory_stores_lock = threading.Lock()


def memory_store(name="default"):
    """The process-wide named :class:`MemoryStore` (created on first
    use) — what ``mem://<name>`` resolves to."""
    with _memory_stores_lock:
        store = _memory_stores.get(str(name))
        if store is None:
            store = _memory_stores[str(name)] = MemoryStore()
        return store


class HTTPStore(CheckpointStore):
    """Stdlib ``http.client`` backend against an object-store-shaped
    endpoint (``PUT/GET/HEAD/DELETE /o/<key>`` + ``GET /list?prefix=``
    — what :class:`ObjectStoreServer` serves).  One connection per
    operation: thread-safe with zero locks, and a half-dead keep-alive
    socket can never wedge a later call."""

    def __init__(self, base_url, timeout_s=10.0):
        from urllib.parse import urlsplit

        parts = urlsplit(str(base_url))
        if parts.scheme not in ("http",):
            raise ValueError(
                f"HTTPStore needs an http:// URL, got {base_url!r}")
        self.host = parts.hostname
        self.port = parts.port or 80
        self.prefix = parts.path.rstrip("/")
        self.timeout_s = float(timeout_s)

    def _request(self, method, path, body=None):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            conn.request(method, self.prefix + path, body=body)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data
        finally:
            conn.close()

    def _okey(self, key):
        from urllib.parse import quote

        return "/o/" + quote(_check_key(key), safe="/")

    def put_bytes(self, key, data):
        status, body = self._request("PUT", self._okey(key), body=data)
        if status != 200:
            raise StoreError(f"PUT {key}: HTTP {status} "
                             f"{body[:120]!r}")

    def get_bytes(self, key):
        status, data = self._request("GET", self._okey(key))
        if status == 404:
            raise FileNotFoundError(f"store has no object {key!r}")
        if status != 200:
            raise StoreError(f"GET {key}: HTTP {status}")
        return data

    def exists(self, key):
        status, _ = self._request("HEAD", self._okey(key))
        if status == 200:
            return True
        if status == 404:
            return False
        raise StoreError(f"HEAD {key}: HTTP {status}")

    def list(self, prefix=""):
        from urllib.parse import quote

        status, data = self._request(
            "GET", "/list?prefix=" + quote(str(prefix), safe=""))
        if status != 200:
            raise StoreError(f"LIST {prefix!r}: HTTP {status}")
        try:
            doc = json.loads(data.decode("utf-8"))
            return [str(k) for k in doc["keys"]]
        except (ValueError, KeyError, TypeError) as e:
            raise StoreError(
                f"LIST {prefix!r}: malformed response "
                f"({type(e).__name__}: {e})")

    def delete(self, key):
        status, _ = self._request("DELETE", self._okey(key))
        if status not in (200, 404):
            raise StoreError(f"DELETE {key}: HTTP {status}")


def store_from_url(url):
    """Build a backend from a ``DK_CKPT_REMOTE``-style URL:
    ``http://host:port[/prefix]`` -> :class:`HTTPStore`,
    ``file:///path`` or a plain path -> :class:`LocalDirStore`."""
    url = str(url).strip()
    if url.startswith("http://"):
        return HTTPStore(url)
    if url.startswith("mem://"):
        # in-process named store (cluster simulator / tests): every
        # resolver of the same name shares ONE MemoryStore
        return memory_store(url[len("mem://"):] or "default")
    if url.startswith("https://"):
        raise ValueError(
            "https:// checkpoint stores are not supported by the "
            "bundled stdlib backend (front it with an http:// gateway "
            "inside the pod trust domain)")
    if url.startswith("file://"):
        url = url[len("file://"):]
    return LocalDirStore(url)


def store_from_env():
    """The ``DK_CKPT_REMOTE`` store, or None when the knob is unset —
    re-read per call, so launcher-exported values win."""
    url = (knobs.raw("DK_CKPT_REMOTE") or "").strip()
    return store_from_url(url) if url else None


# ---------------------------------------------------------------------
# the object-store HTTP server (tests / gates / single-pod deployments)
# ---------------------------------------------------------------------

class _StoreHandler(BaseHTTPRequestHandler):
    server_version = "dk-ckpt-store/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: the event log is the log
        pass

    def _reply(self, code, data=b"", content_type="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(data)

    def _key(self):
        from urllib.parse import unquote

        path = self.path.split("?")[0]
        if not path.startswith("/o/"):
            return None
        return unquote(path[len("/o/"):])

    def do_PUT(self):
        # consume the body BEFORE any early reply: an HTTP/1.1
        # keep-alive server answering with the payload unread would
        # desynchronize the connection framing (the ps/server.py
        # lesson)
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        key = self._key()
        if key is None:
            self._reply(404, b'{"error": "not_found"}')
            return
        try:
            self.server.store.put_bytes(key, data)
        except OSError as e:
            self._reply(500, json.dumps(
                {"error": type(e).__name__,
                 "detail": str(e)[:200]}).encode())
            return
        self._reply(200, b'{"ok": true}')

    def do_GET(self):
        path = self.path.split("?")[0]
        if path == "/healthz":
            self._reply(200, b'{"status": "ok"}')
            return
        if path == "/list":
            from urllib.parse import parse_qs, urlsplit

            q = parse_qs(urlsplit(self.path).query)
            prefix = (q.get("prefix") or [""])[0]
            try:
                keys = self.server.store.list(prefix)
            except OSError as e:
                self._reply(500, json.dumps(
                    {"error": type(e).__name__}).encode())
                return
            self._reply(200, json.dumps({"keys": keys}).encode())
            return
        key = self._key()
        if key is None:
            self._reply(404, b'{"error": "not_found"}')
            return
        try:
            data = self.server.store.get_bytes(key)
        except FileNotFoundError:
            self._reply(404, b'{"error": "no_such_key"}')
            return
        except OSError as e:
            self._reply(500, json.dumps(
                {"error": type(e).__name__}).encode())
            return
        self._reply(200, data, content_type="application/octet-stream")

    def do_HEAD(self):
        key = self._key()
        if key is not None and self.server.store.exists(key):
            self._reply(200)
        else:
            self._reply(404)

    def do_DELETE(self):
        key = self._key()
        if key is None:
            self._reply(404, b'{"error": "not_found"}')
            return
        self.server.store.delete(key)
        self._reply(200, b'{"ok": true}')


class ObjectStoreServer(ThreadingHTTPServer):
    """Stdlib object-store endpoint over a :class:`LocalDirStore` root
    — the remote tier a gate/test (or a small single-head deployment)
    stands up in-process.  ``start()`` serves on a background thread;
    ``close()`` is safe from any thread, any lifecycle state (the
    ``ServingServer`` lifecycle-guard contract: ``shutdown()`` blocks
    forever unless ``serve_forever`` is actually running)."""

    daemon_threads = True

    def __init__(self, root, host="127.0.0.1", port=0):
        self.store = LocalDirStore(root)
        self._thread = None
        self._lifecycle = threading.Lock()
        self._serving = False
        super().__init__((host, int(port)), _StoreHandler)

    @property
    def address(self):
        return self.server_address[:2]

    @property
    def url(self):
        host, port = self.address
        return f"http://{host}:{port}"

    def serve_forever(self, poll_interval=0.5):
        with self._lifecycle:
            self._serving = True
        try:
            super().serve_forever(poll_interval)
        finally:
            with self._lifecycle:
                self._serving = False

    def start(self):
        """Serve on a daemon thread; -> (host, port)."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self.serve_forever, daemon=True,
                name="dk-ckpt-store")
            self._thread.start()
        return self.address

    def close(self):
        with self._lifecycle:
            serving = self._serving
        if serving:
            self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------
# the mirror protocol
# ---------------------------------------------------------------------

def _default_retry(name):
    from dist_keras_tpu_torch.resilience.retry import RetryPolicy

    return RetryPolicy(attempts=3, backoff=0.05, jitter=0.0,
                       retryable=(OSError,), name=name)


def collect_cas_refs(step_path):
    """Every CAS chunk sha a step's payload(s) reference — parsed from
    each ``chunks.json`` under ``step_path`` (the payload root for a
    single-host step, ``host_*/`` subdirs for a promoted two-phase
    one).  Unreadable/torn tables contribute nothing (the manifest
    verification owns convicting them)."""
    from dist_keras_tpu_torch.checkpoint import CHUNKS_NAME

    refs = set()
    for dirpath, _dn, filenames in os.walk(step_path):
        if CHUNKS_NAME not in filenames:
            continue
        try:
            with open(os.path.join(dirpath, CHUNKS_NAME)) as f:
                meta = json.load(f)
            for leaf in meta.get("leaves", []):
                for rel in leaf.get("files", []):
                    head, name = os.path.split(str(rel))
                    if os.path.basename(head) == "chunks":
                        refs.add(name)
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            continue  # torn table: nothing to mirror from it
    return refs


def remote_steps(store):
    """Sorted steps the store holds a ``COMPLETE`` marker for — the
    remote analogue of ``Checkpointer.all_steps`` (a push killed
    mid-stream never appears here)."""
    steps = set()
    for key in store.list(STEP_PREFIX):
        m = _STEP_KEY_RE.match(key)
        if m:
            steps.add(int(m.group(1)))
    return sorted(steps)


def remote_has_step(store, step):
    return store.exists(step_key(step) + "/" + COMPLETE_NAME)


def _marker_chunk_refs(store, retry):
    """sha -> referenced, unioned over every ``COMPLETE`` marker the
    store holds RIGHT NOW.  Markers are the commit instants, so this is
    the authoritative liveness set for the chunk sweep; a marker that
    vanishes mid-read (a concurrent prune) contributes nothing."""
    refs = set()
    for key in store.list(STEP_PREFIX):
        if not _STEP_KEY_RE.match(key):
            continue
        try:
            marker = json.loads(retry.call(
                store.get_bytes, key).decode("utf-8"))
            refs.update(str(s) for s in marker.get("chunks", []))
        except (FileNotFoundError, ValueError, KeyError, TypeError,
                AttributeError):
            continue
    return refs


def prune_remote(store, keep, retry=None):
    """Retire mirrored steps past the newest ``keep`` — the remote
    analogue of local ``max_to_keep`` retention; -> stats dict.

    Deletion order mirrors the push protocol REVERSED, so the store
    can never hold a marked-but-gutted step: a doomed step's
    ``COMPLETE`` marker is deleted FIRST (the step vanishes from
    :func:`remote_steps` at that instant — the commit point of its
    retirement), then its per-step files, and finally a conservative
    CAS sweep removes chunks no SURVIVING marker references — with the
    reference set recomputed from every marker present at sweep time,
    so a step pushed concurrently with the prune keeps the chunks its
    just-written marker names.  (The matching race on the pusher's
    side — exists-skip, then the chunk vanishes before its marker
    lands — is closed in :func:`push_step` by re-verifying chunks
    right before the marker write.)

    ``keep <= 0`` is a no-op by contract (retention off).  Each delete
    runs under the ``"ckpt.push"`` retry surface.
    """
    import time as _time

    from dist_keras_tpu_torch.observability import events, metrics

    t0 = _time.perf_counter()
    keep = int(keep)
    if keep <= 0:
        return {"pruned_steps": [], "deleted_objects": 0,
                "swept_chunks": 0}
    retry = retry or _default_retry("ckpt.push")
    steps = remote_steps(store)
    doomed = steps[:-keep] if len(steps) > keep else []
    if not doomed:
        return {"pruned_steps": [], "deleted_objects": 0,
                "swept_chunks": 0}
    deleted = 0
    for step in doomed:
        root_key = step_key(step)
        # marker first: the retirement's commit instant — a crash
        # between here and the file deletes leaves garbage objects
        # (swept by the next prune), never a half-fetchable step
        retry.call(store.delete, root_key + "/" + COMPLETE_NAME)
        deleted += 1
        for key in store.list(root_key + "/"):
            retry.call(store.delete, key)
            deleted += 1
    # conservative CAS sweep: liveness recomputed from EVERY marker
    # present now (not just the survivors of this prune), so
    # concurrent pushes keep their chunks
    referenced = _marker_chunk_refs(store, retry)
    swept = 0
    for key in store.list(CHUNK_PREFIX):
        if key[len(CHUNK_PREFIX):] not in referenced:
            retry.call(store.delete, key)
            swept += 1
    metrics.counter("ckpt.remote_pruned").inc(len(doomed))
    events.emit("ckpt_remote_prune", steps=list(doomed), kept=keep,
                objects=deleted + swept, chunks_swept=swept,
                duration_s=_time.perf_counter() - t0)
    return {"pruned_steps": list(doomed), "deleted_objects": deleted,
            "swept_chunks": swept}


def _same_remote_content(store, step_path, files, root_key, retry):
    """True when the remote copy of this step holds the SAME content
    as the local one — judged by byte-comparing every integrity
    manifest (the manifest signs every payload byte, so manifest
    equality IS content equality).  A step without manifests
    (``DK_CKPT_VERIFY=0``) degrades to trusting the marker — the
    pre-content-aware idempotence."""
    manifests = [rel for rel in files
                 if rel.rsplit("/", 1)[-1] == "manifest.json"]
    if not manifests:
        return True
    for rel in manifests:
        with open(os.path.join(step_path, *rel.split("/")), "rb") as f:
            local = f.read()
        try:
            remote = retry.call(store.get_bytes, root_key + "/" + rel)
        except FileNotFoundError:
            return False
        if remote != local:
            return False
    return True


def push_step(store, directory, step, step_path, retry=None):
    """Mirror one promoted local step out; -> stats dict.

    CAS chunks push first (skipped when the store already holds the
    sha — the content address IS the cross-step dedup key), then every
    per-step file, then the ``COMPLETE`` marker LAST: a push killed at
    any instant leaves either nothing visible or a fully fetchable
    step.  Idempotence is CONTENT-AWARE: a step already marked
    ``COMPLETE`` is a no-op only when its remote manifests byte-match
    the local ones — a step number re-saved with different bytes
    (training fell back and overtook itself while the old remote copy
    survived) is RE-PUSHED and its marker overwritten, so the heal
    path can never resurrect parameters the run walked away from.  (A
    fetch racing a re-push can read mixed old/new objects; the
    post-fetch manifest verification convicts that typed, and the
    next poll retries.)  Every transfer runs under the ``"ckpt.push"``
    retry surface with the fault point inside the retried body."""
    import time as _time

    from dist_keras_tpu_torch.observability import events, metrics
    from dist_keras_tpu_torch.resilience.faults import fault_point

    t0 = _time.perf_counter()
    step = int(step)
    retry = retry or _default_retry("ckpt.push")
    root_key = step_key(step)
    marker_key = root_key + "/" + COMPLETE_NAME
    files = {}
    for dirpath, _dn, filenames in os.walk(step_path):
        for name in filenames:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, step_path).replace(os.sep, "/")
            files[rel] = int(os.path.getsize(full))
    if retry.call(store.exists, marker_key) and _same_remote_content(
            store, step_path, files, root_key, retry):
        return {"step": step, "skipped": True, "bytes": 0}
    chunks = sorted(collect_cas_refs(step_path))
    cas_dir = os.path.join(directory, "chunks")
    pushed = 0

    def _put_chunk(sha):
        fault_point("ckpt.push")
        key = CHUNK_PREFIX + sha
        if store.exists(key):
            return 0  # content-addressed: already mirrored by an
            #           earlier step's push
        return store.put_file(key, os.path.join(cas_dir, sha))

    def _put_file(rel):
        fault_point("ckpt.push")
        return store.put_file(root_key + "/" + rel,
                              os.path.join(step_path, *rel.split("/")))

    def _put_marker():
        fault_point("ckpt.push")
        store.put_bytes(marker_key, json.dumps(
            {"format": 1, "step": step, "files": files,
             "chunks": chunks}, sort_keys=True).encode())

    for sha in chunks:
        pushed += retry.call(_put_chunk, sha)
    for rel in sorted(files):
        pushed += retry.call(_put_file, rel)
    # close the dedup-skip race against a concurrent prune_remote: a
    # chunk skipped above because "already mirrored" may have been
    # swept between that exists() and this instant (prune saw no marker
    # referencing it yet — ours lands only below).  Re-running the
    # chunk loop is cheap (exists-check per sha) and re-uploads exactly
    # the swept ones, so the marker we are about to write never names a
    # chunk the store no longer holds.
    for sha in chunks:
        pushed += retry.call(_put_chunk, sha)
    retry.call(_put_marker)
    metrics.counter("ckpt.bytes_pushed").inc(pushed)
    events.emit("ckpt_push", step=step, files=len(files),
                chunks=len(chunks), bytes=pushed,
                duration_s=_time.perf_counter() - t0)
    return {"step": step, "skipped": False, "bytes": pushed,
            "files": len(files), "chunks": len(chunks)}


def fetch_step(store, directory, step, retry=None, fsync=True):
    """Download remote ``step`` into local staging; -> the staging dir
    (the caller promotes it with the normal journaled swap — fetching
    and committing stay two instants, like every writer here).
    Referenced CAS chunks land in the local ``chunks/`` dir first
    (already-present shas are not re-downloaded); a step without a
    ``COMPLETE`` marker is ``FileNotFoundError``.  Every transfer runs
    under the ``"ckpt.pull"`` retry surface with the fault point
    inside the retried body."""
    import shutil
    import time as _time

    from dist_keras_tpu_torch.observability import events
    from dist_keras_tpu_torch.resilience.faults import fault_point

    t0 = _time.perf_counter()
    step = int(step)
    retry = retry or _default_retry("ckpt.pull")
    root_key = step_key(step)

    def _get(key):
        fault_point("ckpt.pull")
        return store.get_bytes(key)

    raw = retry.call(_get, root_key + "/" + COMPLETE_NAME)
    try:
        marker = json.loads(raw.decode("utf-8"))
        file_list = sorted(str(r) for r in marker["files"])
        chunk_list = [str(s) for s in marker.get("chunks", [])]
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise StoreError(
            f"remote step {step}: malformed COMPLETE marker "
            f"({type(e).__name__}: {e})")
    from dist_keras_tpu_torch.checkpoint import _hash_file

    cas_dir = os.path.join(directory, "chunks")
    pulled = 0
    for sha in chunk_list:
        full = os.path.join(cas_dir, sha)
        if os.path.exists(full):
            # a fetch is the HEAL path, so an already-present local
            # CAS entry is re-hashed before it is trusted: a rotted
            # or truncated chunk (the very thing that may have
            # convicted the step being healed) is re-downloaded and
            # atomically replaced — for every step that references it
            try:
                if _hash_file(full) == sha:
                    os.utime(full, None)  # reused: GC grace reset
                    continue
            except OSError:  # pragma: no cover - raced delete
                pass
        data = retry.call(_get, CHUNK_PREFIX + sha)
        os.makedirs(cas_dir, exist_ok=True)
        tmp = os.path.join(cas_dir, f".tmp-{os.getpid()}-{sha[:16]}")
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, full)
        pulled += len(data)
    stage = os.path.join(directory, f"step_{step:08d}.fetch")
    shutil.rmtree(stage, ignore_errors=True)
    for rel in file_list:
        data = retry.call(_get, root_key + "/" + rel)
        local = os.path.join(stage, *rel.split("/"))
        os.makedirs(os.path.dirname(local), exist_ok=True)
        with open(local, "wb") as f:
            f.write(data)
        pulled += len(data)
    if fsync:
        from dist_keras_tpu_torch.checkpoint import _fsync_tree

        _fsync_tree(stage)
    events.emit("ckpt_pull", step=step, files=len(file_list),
                chunks=len(chunk_list), bytes=pulled,
                duration_s=_time.perf_counter() - t0)
    return stage


# ---------------------------------------------------------------------
# the background uploader
# ---------------------------------------------------------------------

class CheckpointUploader:
    """Mirror newly promoted local steps to the remote tier on a
    background thread.

    Read-only against the local directory (it polls ``all_steps`` —
    only promoted steps are ever visible), so it can watch a live
    writer's directory forever.  ``poll_once`` pushes every promoted
    step this process has not already mirrored; cross-process
    resume-awareness comes from ``push_step``'s CONTENT-AWARE skip
    (remote manifests byte-matching the local ones), so a restarted
    uploader neither re-transfers identical steps nor leaves a stale
    remote copy of a step number that was re-saved with different
    bytes after a fallback.  Loop errors are absorbed typed —
    recorded on the ``ckpt_push`` event with an ``error`` field and
    retried at the next poll; a direct ``poll_once`` caller gets the
    raise."""

    def __init__(self, checkpointer, store=None, poll_s=None,
                 retry=None, remote_keep=None):
        self.checkpointer = checkpointer
        self.store = store if store is not None else store_from_env()
        if self.store is None:
            raise ValueError(
                "CheckpointUploader needs a store (pass one, or set "
                "DK_CKPT_REMOTE)")
        self.poll_s = (float(knobs.get("DK_CKPT_REMOTE_POLL_S"))
                       if poll_s is None else float(poll_s))
        self._retry = retry or _default_retry("ckpt.push")
        # remote retention horizon: explicit arg > DK_CKPT_REMOTE_KEEP
        # > follow the local checkpointer's max_to_keep; 0 = never
        # prune (the pre-round-20 accumulate-forever behavior)
        if remote_keep is None:
            remote_keep = knobs.get("DK_CKPT_REMOTE_KEEP")
        if remote_keep is None:
            remote_keep = getattr(checkpointer, "max_to_keep", 0)
        self.remote_keep = int(remote_keep)
        self.last_pushed = None
        self.pushes = 0
        self.errors = 0
        self._pushed = set()  # steps this process mirrored (or found
        #                       content-identical remotely)
        self._stop = threading.Event()
        self._thread = None

    def poll_once(self):
        """Push every promoted step not yet mirrored by this process;
        -> how many were attempted (content-identical remote copies
        count — the transfer itself was skipped).  Raises the (typed)
        push error to a direct caller — the background loop is the
        absorbing path."""
        steps = self.checkpointer.all_steps()
        # single driver at a time by contract: either the background
        # loop owns polling, or a direct caller does (after stop(),
        # or with no loop started) — and a raced duplicate push is an
        # idempotent no-op anyway (push_step's content-aware skip), so
        # the worst a torn interleave costs is redundant transfers
        # dklint: ignore[unguarded-shared-write] single poll driver by contract (loop OR direct caller); duplicate pushes are idempotent no-ops
        self._pushed &= set(steps)  # retired steps leave the set
        n = 0
        for step in steps:
            if step in self._pushed:
                continue
            path = self.checkpointer._read_path(step)
            push_step(self.store, self.checkpointer.directory, step,
                      path, retry=self._retry)
            self._pushed.add(step)
            # dklint: ignore[unguarded-shared-write] same single-driver contract as above
            self.last_pushed = step
            # dklint: ignore[unguarded-shared-write] monotonic best-effort counter; same single-driver contract
            self.pushes += 1
            n += 1
        if n and self.remote_keep > 0:
            # retention rides the same poll: once fresh steps mirrored,
            # steps past the horizon retire (ckpt.remote_pruned /
            # ckpt_remote_prune record it).  Only after a push — an
            # idle poll must never delete anything.
            prune_remote(self.store, self.remote_keep,
                         retry=self._retry)
        return n

    def drain(self):
        """Synchronous catch-up: push everything outstanding NOW (the
        end-of-run barrier a worker that exits right after its final
        save calls — run it AFTER ``stop()`` when the loop was
        started, so exactly one driver polls at a time); -> pushed
        count."""
        return self.poll_once()

    def _loop(self):
        from dist_keras_tpu_torch.observability import events

        while not self._stop.is_set():
            try:
                self.poll_once()
            # dklint: ignore[broad-except] push failure is typed +
            # non-fatal: the run keeps its local durability, the next
            # poll retries the mirror
            except Exception as e:
                self.errors += 1
                events.emit("ckpt_push", error=type(e).__name__,
                            detail=str(e)[:200])
            self._stop.wait(self.poll_s)

    def start(self):
        """Start the background mirror loop (daemon thread); -> self."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dk-ckpt-upload")
        self._thread.start()
        return self

    def stop(self, timeout_s=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
