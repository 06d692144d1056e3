"""The card-only parts of the port's streaming feed (``data/feed.py``'s
``DevicePut``): the copy stream and the two-slot pinned ring, a slot
refilled only after the copy that read it, and ``ChunkFeed.get`` never
blocking the host.  These need an NVIDIA GPU and skip elsewhere; the
file imports no JAX, so the card's host (which has none) runs it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_feed_cuda.py
"""

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch.data.feed import ChunkFeed, DevicePut
from dist_keras_tpu_torch.trainers import chunking as tchunk

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the feed's copy stream and pinned "
                    "ring exist only on a card")
    return torch.device("cuda")


def test_card_put_uses_a_copy_stream_and_a_pinned_ring():
    dev = _card()
    xs = np.random.default_rng(0).normal(size=(4, 12, 8, 3)).astype(
        np.float32)
    layout = tchunk._layout(1)
    put = DevicePut(dev, layout, max_units=3)
    resident = np.ascontiguousarray(layout(xs))
    feed = ChunkFeed([(0, 3), (3, 3), (6, 3), (9, 3)], put, xs)
    got = []
    for i in range(4):
        (chunk,) = feed.get(i)
        assert chunk.device.type == "cuda"
        got.append((chunk * 1).cpu().numpy())   # read on the compute stream
        feed.prefetch(i + 1)
        feed.release(i)
    np.testing.assert_array_equal(np.concatenate(got), resident)
    assert put._stream is not None
    assert put._stream != torch.cuda.current_stream(dev)
    assert all(buf.is_pinned() for slot in put._slots for buf in slot)
    assert feed.peak_resident_chunks <= 2
    feed.close()
    assert put._slots is None


def test_card_slot_reuse_waits_for_the_copy_that_read_it():
    """Three puts through two slots: the third refills slot 0 only after
    the first copy is done, so every chunk holds its own rows even when
    the compute stream is busy while the copies run."""
    dev = _card()
    xs = np.arange(6 * 1 * 4096, dtype=np.float32).reshape(1, 6, 4096)
    put = DevicePut(dev, tchunk._layout(None), max_units=2)
    busy = torch.randn(4096, 4096, device=dev)
    chunks = []
    for start in (0, 2, 4):
        for _ in range(4):
            busy = busy @ busy / 64.0   # keeps the compute stream busy
        chunks.append(put(xs[:, start:start + 2]))
    for start, chunk in zip((0, 2, 4), chunks):
        torch.cuda.current_stream(dev).wait_event(chunk.event)
        np.testing.assert_array_equal(chunk[0].cpu().numpy(),
                                      xs[0, start:start + 2])


def test_card_get_never_blocks_the_host_and_record_stream_keeps_memory():
    """``get`` only orders the compute stream (sync debug mode "error"
    passes), and a chunk released while the compute stream still reads
    it is not handed to the next copy."""
    dev = _card()
    xs = np.random.default_rng(1).normal(size=(1, 8, 256, 256)).astype(
        np.float32)
    put = DevicePut(dev, tchunk._layout(None), max_units=2)
    feed = ChunkFeed([(0, 2), (2, 2), (4, 2), (6, 2)], put, xs)
    feed.prefetch(0)
    outs = []
    for i in range(4):
        torch.cuda.set_sync_debug_mode("error")
        try:
            (chunk,) = feed.get(i)
            outs.append((chunk @ chunk).sum(0))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        feed.release(i)        # freed while the product may still run
        feed.prefetch(i + 1)
    want = [(torch.from_numpy(xs[0, s:s + 2]) @ torch.from_numpy(
        xs[0, s:s + 2])).sum(0) for s in (0, 2, 4, 6)]
    for got, w in zip(outs, want):
        torch.testing.assert_close(got.cpu(), w, rtol=1e-4, atol=1e-3)
    feed.close()
