"""The port's paged decode attention (plain version) against the JAX
package's ``paged_attention_reference`` and its Pallas kernel in
interpret mode.  Lengths cover 0 (a padding slot: exact zeros), a
partial page, an exact page boundary and the full extent.

Tolerance: f32 max-abs 1e-5 (same math, summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_keras_tpu.ops.pallas import decode_attention as jdec
from dist_keras_tpu_torch.ops import decode_attention as tdec

TOL = 1e-5


def _inputs(slots, heads=2, head_dim=8, page_size=4, n_pages=4, seed=0):
    rng = np.random.default_rng(seed)
    pool = n_pages * slots + 1
    q = rng.normal(size=(slots, heads, head_dim)).astype(np.float32)
    kp = rng.normal(size=(heads, pool, page_size, head_dim)).astype(
        np.float32)
    vp = rng.normal(size=(heads, pool, page_size, head_dim)).astype(
        np.float32)
    pt = rng.integers(0, pool, size=(slots, n_pages)).astype(np.int32)
    t = n_pages * page_size
    picks = [0, 1, page_size, t, page_size + 3, t - 1]
    lengths = np.asarray([picks[i % len(picks)] for i in range(slots)],
                         np.int32)
    return q, kp, vp, pt, lengths


@pytest.mark.parametrize("slots", [1, 4, 8])
def test_plain_version_matches_jax_reference_and_kernel(slots):
    args = _inputs(slots, seed=slots)
    got = tdec.paged_attention_reference(
        *(torch.from_numpy(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jdec.paged_attention_reference(*jargs))
    ker = np.asarray(jdec.paged_attention_kernel(*jargs, interpret=True))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, ker, atol=TOL, rtol=0)
    for i, n in enumerate(args[4]):
        if n == 0:
            assert np.abs(got[i]).max() == 0.0   # exact, not NaN


def test_auto_on_cpu_is_the_plain_version_and_launches_nothing():
    args = [torch.from_numpy(a) for a in _inputs(4)]
    before = tdec.paged_decode_launches
    got = tdec.paged_attention_auto(*args)
    assert torch.equal(got, tdec.paged_attention_reference(*args))
    assert tdec.paged_decode_launches == before


def test_custom_scale_and_head_dims():
    for d in (32, 64):
        args = _inputs(3, head_dim=d, seed=d)
        got = tdec.paged_attention_reference(
            *(torch.from_numpy(a) for a in args), scale=0.3).numpy()
        ref = np.asarray(jdec.paged_attention_reference(
            *(jnp.asarray(a) for a in args), scale=0.3))
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_kernel_entry_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(2)]
    with pytest.raises(ValueError, match="CUDA"):
        tdec.paged_attention_kernel(*args)


# -- the split-KV kernel's host plan and its plain split model -------------
N_SM = 132        # a stand-in SM count (an H100 SXM's); the plan reads
                  # the card's own on a GPU
SERVE_PAGES, SERVE_PAGE_SIZE, SERVE_HEADS = 128, 16, 6


@pytest.mark.parametrize("slots,want", [(1, 44), (4, 11), (8, 6)])
def test_split_plan_fills_the_card_at_the_decode_rungs(slots, want):
    n = tdec.split_plan(slots, SERVE_HEADS, SERVE_PAGES, SERVE_PAGE_SIZE,
                        N_SM)
    full = SERVE_PAGES * SERVE_PAGE_SIZE
    n_chunks = -(-full // tdec.CHUNK)
    assert n == want
    assert n <= n_chunks
    assert slots * SERVE_HEADS * n >= N_SM
    # every split of a full slot gets at least one chunk
    assert all(hi - lo >= tdec.CHUNK
               for lo, hi in tdec.split_ranges(full, n))


@pytest.mark.parametrize("slots,heads,max_pages,page_size", [
    (1, 6, 2, 16), (1, 1, 1, 4), (8, 6, 3, 16), (4, 2, 128, 8),
    (64, 6, 128, 16)])
def test_split_plan_caps_at_the_chunk_count(slots, heads, max_pages,
                                            page_size):
    n = tdec.split_plan(slots, heads, max_pages, page_size, N_SM)
    n_chunks = -(-max_pages * page_size // tdec.CHUNK)
    assert 1 <= n <= n_chunks
    # at least N_SM blocks wherever the extent allows
    assert slots * heads * n >= min(N_SM, slots * heads * n_chunks)
    assert all(hi > lo for lo, hi in
               tdec.split_ranges(max_pages * page_size, n))


@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 100, 128, 2048])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 200])
def test_split_ranges_tile_the_valid_positions_evenly(length, n_split):
    ranges = tdec.split_ranges(length, n_split)
    assert len(ranges) == n_split
    assert ranges[0][0] == 0 and ranges[-1][1] == length
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    chunks = [-(-(hi - lo) // tdec.CHUNK) for lo, hi in ranges]
    assert max(chunks) - min(chunks) <= 1


def _split_inputs(seed=0):
    # 32 pages of 4 positions: 128 positions, 8 chunks per full slot
    q, kp, vp, pt, _ = _inputs(6, heads=2, head_dim=8, page_size=4,
                               n_pages=32, seed=seed)
    lengths = np.asarray([0, 1, 16, 128, 37, 100], np.int32)
    return q, kp, vp, pt, lengths


@pytest.fixture(scope="module")
def jax_split_case():
    args = _split_inputs()
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jdec.paged_attention_reference(*jargs))
    ker = np.asarray(jdec.paged_attention_kernel(*jargs, interpret=True))
    return args, ref, ker


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 12])
def test_split_reference_matches_jax_reference_and_kernel(jax_split_case,
                                                          n_split):
    args, ref, ker = jax_split_case
    got = tdec.paged_attention_split_reference(
        *(torch.from_numpy(a) for a in args), n_split).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, ker, atol=TOL, rtol=0)
    assert np.abs(got[0]).max() == 0.0    # length 0: exact zeros, not NaN
    if n_split == 12:   # more splits than a full slot's 8 chunks
        assert any(hi == lo for lo, hi in tdec.split_ranges(128, n_split))


def test_split_reference_custom_scale_and_head_dim():
    args = _inputs(3, head_dim=32, page_size=4, n_pages=16, seed=7)
    got = tdec.paged_attention_split_reference(
        *(torch.from_numpy(a) for a in args), 3, scale=0.3).numpy()
    ref = np.asarray(jdec.paged_attention_reference(
        *(jnp.asarray(a) for a in args), scale=0.3))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_kernel_entry_takes_n_split_but_still_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(2)]
    with pytest.raises(ValueError, match="CUDA"):
        tdec.paged_attention_kernel(*args, n_split=2)
