"""Double-buffered host -> device chunk feed — counterpart of
``data/feed.py``: an epoch larger than the card trains.

The reference streams training data partition by partition through each
worker's iterator (workers.py:~60), so an epoch never has to fit in an
executor's memory.  Resident training copies the whole epoch to the
card once; ``ChunkFeed`` instead keeps the epoch in host memory and
ships it one dispatch chunk at a time:

- the epoch arrays stay on the host, ``(workers, N, ...)``, and each
  chunk is the zero-copy view ``a[:, start:start + length]``;
- the training loop dispatches per chunk, and the feed starts chunk
  ``k + 1``'s copy while chunk ``k`` runs;
- at most TWO chunks are on the card at any moment (the running one and
  the prefetched one): the data's device memory is bounded by two
  chunks whatever the epoch's size.

The loop contract (``trainers/chunking.py``)::

    feed = ChunkFeed(spans, put, xs, ys)
    for i in range(len(spans)):
        data = feed.get(i)          # device tensors (prefetched or put now)
        losses = dispatch(i, data)  # enqueued, never waited
        retire(i - 1); feed.release(i - 1)   # chunk i-1 done: its memory goes
        feed.prefetch(i + 1)        # the copy runs under chunk i

``put`` is a :class:`DevicePut` on the trainers' path
(``Trainer._chunk_put``): a two-slot pinned host ring sized to the
largest chunk and a copy stream of its own.  A chunk is copied from the epoch's view into a free slot, laid out as the
resident path lays out its data (units first) in the same pass, then
copied to the card with ``non_blocking=True`` on the copy stream, into
a tensor allocated on that stream and ``record_stream``-ed on the
compute stream.  :meth:`ChunkFeed.get` makes the compute stream wait on
the chunk's copy event and never blocks the host.  A slot is refilled
only after the copy that last read it is done, which the depth-2 retire
has already guaranteed, so that wait is free in the steady state.  The
whole epoch is never pinned (streaming is for epochs larger than the
card), and a copy from pageable memory would block the host.  On the
CPU the put is a plain copy.

Instrumentation (``peak_resident_chunks``, ``put_count``,
``put_bytes``) lets the tests prove the residency bound, and each put
records ``perf.h2d`` (bytes and the enqueue wall).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dist_keras_tpu_torch.observability import perf


class DeviceChunk(tuple):
    """A chunk's device tensors; ``event`` is the copy's CUDA event on
    ``device`` (None on the CPU), waited on by the compute stream at
    first use."""

    event = None
    device = None
    waited = False


class DevicePut:
    """The trainers' ``put``: host chunk views -> :class:`DeviceChunk`.

    ``layout(view)`` maps a ``(workers, K, ...)`` host view to the
    resident layout (a transposed view, no copy) whose dim 0 is the
    chunk's K units.  ``max_units`` sizes the staging slots."""

    def __init__(self, device, layout, max_units):
        self.device = torch.device(device)
        self._layout = layout
        self._max_units = int(max_units)
        self._slots = None         # [2][n_arrays] pinned flat byte buffers
        self._slot_events = [None, None]
        self._next = 0
        self._stream = None

    def __call__(self, *views):
        laid = [self._layout(v) for v in views]
        if self.device.type != "cuda":
            return DeviceChunk(torch.from_numpy(np.ascontiguousarray(a))
                               for a in laid)
        if self._slots is None:
            self._slots = [
                [torch.empty(self._max_units * (a.nbytes // max(1, len(a))),
                             dtype=torch.uint8, pin_memory=True)
                 for a in laid] for _ in range(2)]
            self._stream = torch.cuda.Stream(self.device)
        s = self._next
        self._next ^= 1
        if self._slot_events[s] is not None:
            # the copy that last read this slot (chunk i-2's): done by
            # the time the depth-2 retire has run, so this is free
            self._slot_events[s].synchronize()
        compute = torch.cuda.current_stream(self.device)
        out = []
        for a, buf in zip(laid, self._slots[s]):
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            host = buf[:a.nbytes].view(dtype).view(a.shape)
            np.copyto(host.numpy(), a)   # the layout's transpose, once
            with torch.cuda.stream(self._stream):
                # allocated on the copy stream; record_stream keeps the
                # block from reuse until the compute stream is done too
                dev = torch.empty(a.shape, dtype=dtype, device=self.device)
                dev.copy_(host, non_blocking=True)
            dev.record_stream(compute)
            out.append(dev)
        chunk = DeviceChunk(out)
        chunk.device = self.device
        chunk.event = torch.cuda.Event()
        chunk.event.record(self._stream)
        self._slot_events[s] = chunk.event
        return chunk

    def close(self):
        """Free the pinned ring (after waiting out its last copies)."""
        for ev in self._slot_events:
            if ev is not None:
                ev.synchronize()
        self._slots, self._slot_events = None, [None, None]


def _ready(chunk):
    """Order the compute stream after ``chunk``'s copy (once); never
    blocks the host."""
    ev = getattr(chunk, "event", None)
    if ev is not None and not chunk.waited:
        torch.cuda.current_stream(chunk.device).wait_event(ev)
        chunk.waited = True
    return chunk


class ChunkFeed:
    """Serve device-resident chunks of host arrays, one chunk ahead.

    Parameters
    ----------
    spans : list of (start, length)
        Slices along axis 1 of every host array (axis 0 is the worker
        axis), one per dispatch, in dispatch order.
    put : callable
        ``put(*host_views) -> tuple of device tensors``, asynchronous
        (:class:`DevicePut` on the trainers' path).
    *arrays
        Host arrays of shape ``(workers, N, ...)``; each chunk is the
        zero-copy view ``a[:, start:start+length]``.
    """

    def __init__(self, spans, put, *arrays):
        self._spans = list(spans)
        self._put = put
        self._arrays = arrays
        self._bufs = {}
        self.put_count = 0
        self.put_bytes = 0
        self.peak_resident_chunks = 0

    def __len__(self):
        return len(self._spans)

    def prefetch(self, i):
        """Start chunk ``i``'s copy to the device (idempotent)."""
        if i >= len(self._spans) or i in self._bufs:
            return
        start, length = self._spans[i]
        views = tuple(a[:, start:start + length] for a in self._arrays)
        # perf attribution: bytes shipped + the enqueue wall (the host's
        # staging copy included; the DMA itself overlaps compute)
        t0 = time.perf_counter()
        self._bufs[i] = self._put(*views)
        nbytes = sum(v.nbytes for v in views)
        perf.h2d(nbytes, time.perf_counter() - t0)
        self.put_count += 1
        self.put_bytes += nbytes
        self.peak_resident_chunks = max(self.peak_resident_chunks,
                                        len(self._bufs))

    def get(self, i):
        """Device tensors for chunk ``i`` (copied now if not prefetched);
        the compute stream is ordered after the copy."""
        self.prefetch(i)
        return _ready(self._bufs[i])

    def release(self, i):
        """Drop the feed's reference to chunk ``i``: its device memory is
        reused once the work that read it is done (a chunk never got is
        ordered after its copy first, so no copy races the reuse)."""
        chunk = self._bufs.pop(i, None)
        if chunk is not None:
            _ready(chunk)

    def close(self):
        """Drop every buffer AND the host-array references: a feed kept
        for introspection (``trainer._last_feed``) pins only the span and
        counter stats, not the host epoch arrays or the pinned ring."""
        for i in list(self._bufs):
            self.release(i)
        self._arrays = ()
        if isinstance(self._put, DevicePut):
            self._put.close()
        self._put = None
