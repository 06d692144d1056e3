"""Paged KV-cache allocator — fixed-size pages, free list, exact accounting.

The decode engine (``serving/decode.py``) keeps each replica's attention
keys/values in a page pool: one device array per replica of shape
``(layers, heads, num_pages + 1, page_size, head_dim)`` whose page axis
is carved into fixed-size pages.  This module owns the HOST-side
accounting for that pool — which pages are free, which sequence holds
which pages — so the device arrays never need compaction and a
sequence's KV never moves once written (vLLM's PagedAttention layout).

Contract (the decode engine's admission story depends on every clause):

- **Worst-case reservation at the door.**  ``alloc`` hands out every
  page a sequence could EVER need (``ceil((prompt + max_new) / page
  size)``) in one call, so an admitted sequence can never stall or die
  mid-decode on KV exhaustion — rejection happens strictly at
  admission, as a typed :class:`PagesExhausted` the engine converts to
  ``Overloaded(reason="kv_exhausted")`` (rejected, not lost).
- **Page-exact accounting.**  ``free + held == num_pages`` after every
  operation; double-free and foreign-page frees raise instead of
  corrupting the free list.  ``assert_balanced`` is the leak check the
  engine's ``assert_no_leaks`` calls.
- **The scratch page.**  Page index ``num_pages`` (one PAST the
  accounted pool) is a write-only spill target: padding slots in a
  fixed-shape decode step and padded prefill positions beyond a
  prompt's real length must write THEIR k/v somewhere with the same
  scatter, and the scratch page absorbs them.  It is never
  allocated, never read (masked by per-sequence lengths), and never
  counted.

Thread safety: the allocator has its own lock, but the decode engine
additionally serializes alloc/free per replica under its scheduler
lock — the lock here makes ``stats()`` safe from any thread.

Copied from the JAX package's ``serving/kv_cache.py`` (it is framework
free), with its ``decode.kv_alloc`` fault point on the port's
``resilience/faults.py``.
"""

from __future__ import annotations

import threading

from dist_keras_tpu_torch.resilience.faults import fault_point


class PagesExhausted(RuntimeError):
    """Typed allocation failure: the pool cannot cover the request.

    Carries ``needed`` / ``free`` / ``capacity`` so the admission door
    can answer 503 with real numbers.  Nothing is allocated on this
    path — a failed alloc is side-effect free.
    """

    def __init__(self, needed, free, capacity):
        self.needed = int(needed)
        self.free = int(free)
        self.capacity = int(capacity)
        super().__init__(
            f"KV pool exhausted: need {self.needed} pages, "
            f"{self.free} free of {self.capacity}")


class PagedKVCache:
    """Free-list page allocator over a ``num_pages`` pool.

    Pure host-side accounting — the device pool arrays live with the
    replica that owns them (the engine threads page ids from here into
    the jitted prefill/decode scatters).
    """

    def __init__(self, num_pages, page_size):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        if self.num_pages < 1 or self.page_size < 1:
            raise ValueError(
                f"PagedKVCache(num_pages={num_pages}, "
                f"page_size={page_size}): both must be >= 1")
        # LIFO free list: a just-freed page is the next handed out, so
        # a steady workload touches a small working set of pages
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._held = {}      # seq_id -> [page ids]
        self._peak = 0
        self._allocs = 0
        self._frees = 0
        self._lock = threading.Lock()

    @property
    def scratch_page(self):
        """The write-only spill page index (one past the pool)."""
        return self.num_pages

    def pages_for(self, tokens):
        """Pages needed to hold ``tokens`` KV positions."""
        t = int(tokens)
        return max(1, -(-t // self.page_size))

    def alloc(self, seq_id, tokens):
        """Reserve every page ``tokens`` positions need; -> page-id
        list.  Raises :class:`PagesExhausted` (side-effect free) when
        the free list cannot cover it, ``ValueError`` on a duplicate
        ``seq_id`` (an accounting bug, not load)."""
        fault_point("decode.kv_alloc")
        n = self.pages_for(tokens)
        with self._lock:
            if seq_id in self._held:
                raise ValueError(
                    f"sequence {seq_id!r} already holds pages")
            if n > len(self._free):
                raise PagesExhausted(n, len(self._free), self.num_pages)
            pages = [self._free.pop() for _ in range(n)]
            self._held[seq_id] = pages
            self._allocs += 1
            used = self.num_pages - len(self._free)
            self._peak = max(self._peak, used)
            return list(pages)

    def free(self, seq_id):
        """Return every page ``seq_id`` holds to the free list — the
        single reclamation path for completion, cancel, error and
        engine shutdown.  Idempotent-hostile by design: freeing an
        unknown sequence raises ``KeyError`` (callers own exactly-once
        reclamation; a silent second free would hide a leak of the
        OPPOSITE sign)."""
        with self._lock:
            pages = self._held.pop(seq_id)
            self._free.extend(pages)
            self._frees += 1
            return len(pages)

    def holds(self, seq_id):
        with self._lock:
            return seq_id in self._held

    def sequence_ids(self):
        """Sequence ids currently holding pages — the engine's
        periodic self-check reconciles this against the sequences the
        scheduler actually owns (anything unowned is a leak)."""
        with self._lock:
            return tuple(self._held)

    def used_pages(self):
        with self._lock:
            return self.num_pages - len(self._free)

    def assert_balanced(self):
        """The leak invariant: every non-free page is attributable to
        exactly one live sequence.  Raises ``AssertionError`` naming
        the imbalance — the engine's zero-leak check."""
        with self._lock:
            held = sum(len(p) for p in self._held.values())
            free = len(self._free)
            if held + free != self.num_pages:
                raise AssertionError(
                    f"KV page leak: {held} held + {free} free != "
                    f"{self.num_pages} pool pages "
                    f"({sorted(self._held)} live)")
            if len(set(self._free)) != free:
                raise AssertionError("KV free list holds duplicates")

    def stats(self):
        """JSON-ready pool counters (occupancy is the bench's
        ``kv_occupancy`` series)."""
        with self._lock:
            used = self.num_pages - len(self._free)
            return {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "used_pages": used,
                "free_pages": len(self._free),
                "peak_pages": self._peak,
                "occupancy": used / self.num_pages,
                "sequences": len(self._held),
                "allocs": self._allocs,
                "frees": self._frees,
            }
