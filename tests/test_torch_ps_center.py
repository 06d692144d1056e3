"""The port's PS center variable and delta codec against the JAX
package's (``dist_keras_tpu_torch/ps/center.py``, ``compress.py``).

The center replay is held BIT-EQUAL to the JAX ``CenterVariable`` on
the same commit log and to the port's own DynSGD commit expressions in
torch f32 (``trainers/dynsgd.py``: ``scale = 1/(staleness+1)``, then
``(c + scale*d).to(c.dtype)``); the codec is held bit-equal to the JAX
module's on seeded deltas.  Integer leaves never move.
"""

import numpy as np
import pytest
import torch

from dist_keras_tpu.ps import CenterVariable as JCenter
from dist_keras_tpu.ps import compress as jcompress
from dist_keras_tpu_torch.ps import (
    CenterVariable,
    PSError,
    PSUnavailable,
    StaleCommit,
    apply_commit,
    dynsgd_scale,
)
from dist_keras_tpu_torch.ps import compress
from dist_keras_tpu_torch.resilience import faults
from dist_keras_tpu_torch.resilience.faults import FaultInjected
from dist_keras_tpu_torch.trainers.dynsgd import commit_schedule


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.normal(size=(6, 4)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)},
            "seed_state": np.array([1, 2], dtype=np.uint32)}


def _delta(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.normal(size=(6, 4)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)},
            "seed_state": np.zeros((), np.int32)}


# (version, delta): w0 fresh, w0 fresh, w1 stale by 1; then a restarted
# w1 recommits the version it pulled before two center updates landed
# (staleness 3), then a fresh one
_LOG = [(0, 1), (1, 2), (1, 3), (0, 4), (4, 5)]


def _torch_dynsgd(center0, log):
    """The port's DynSGD commit expressions, eager torch f32 on the CPU:
    ``scale = 1/(staleness+1)`` in f32 (``trainers/dynsgd.py``), then
    ``(c + scale*d).to(c.dtype)`` per float leaf."""
    ref = {k: torch.from_numpy(center0["dense"][k].copy())
           for k in ("w", "b")}
    clock = 0
    for version, seed in log:
        staleness = np.asarray([max(0, clock - version)], np.int64)
        scale = torch.from_numpy(np.float32(1.0) / (
            staleness.astype(np.float32) + np.float32(1.0)))[0]
        d = _delta(seed)["dense"]
        for k in ref:
            ref[k] = (ref[k] + scale * torch.from_numpy(d[k])).to(
                ref[k].dtype)
        clock += 1
    return {k: v.numpy() for k, v in ref.items()}, clock


def test_replayed_commit_log_bit_equal_to_jax_and_dynsgd():
    center0 = _params(0)
    ours = CenterVariable(center0, staleness_cap=100)
    theirs = JCenter(center0, staleness_cap=100)
    stal = []
    for version, seed in _LOG:
        a = ours.commit("w", version, _delta(seed))
        b = theirs.commit("w", version, _delta(seed))
        assert (a["version"], a["staleness"], a["scale"]) == (
            b["version"], b["staleness"], b["scale"])
        stal.append(a["staleness"])
    assert stal == [0, 0, 1, 3, 0]
    ref, clock = _torch_dynsgd(center0, _LOG)
    assert ours.clock == theirs.clock == clock
    (_, got), (_, want) = ours.state(), theirs.state()
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["dense"][k], want["dense"][k])
        np.testing.assert_array_equal(got["dense"][k], ref[k])
    np.testing.assert_array_equal(got["seed_state"],
                                  center0["seed_state"])
    assert got["seed_state"].dtype == np.uint32


def test_scale_matches_the_port_dynsgd_schedule():
    """The server's f32 scale is the scale the single-card DynSGD
    schedule computes for the same staleness."""
    commits, staleness, scale = commit_schedule(48, 12, 4)
    assert staleness[commits].max() >= 3
    for s, want in zip(staleness[commits], scale[commits]):
        assert dynsgd_scale(s) == want and dynsgd_scale(s).dtype == np.float32
    c = np.linspace(-1, 1, 12).astype(np.float32).reshape(3, 4)
    d = (np.arange(12, dtype=np.float32) / 7.0).reshape(3, 4)
    want = (torch.from_numpy(c) + torch.tensor(dynsgd_scale(2))
            * torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(apply_commit(c, d, dynsgd_scale(2)), want)
    i = np.array([3, 4], dtype=np.int64)
    np.testing.assert_array_equal(apply_commit(i, np.zeros(2), 0.5), i)


def test_rollback_clamp_negative_staleness_is_zero():
    cv = CenterVariable(_params(0), clock=2)
    info = cv.commit("w", 10, _delta(1))
    assert info["staleness"] == 0 and info["scale"] == 1.0
    assert cv.clock == 3


def test_over_cap_commit_refused_typed_nothing_applied():
    cv = CenterVariable(_params(0), staleness_cap=2)
    for i in range(4):
        cv.commit("fresh", cv.clock, _delta(i))
    before = cv.state()
    with pytest.raises(StaleCommit) as ei:
        cv.commit("old", 0, _delta(9))
    assert ei.value.staleness == 4 and ei.value.cap == 2
    after = cv.state()
    assert after[0] == before[0]
    np.testing.assert_array_equal(after[1]["dense"]["w"],
                                  before[1]["dense"]["w"])


def test_commit_id_makes_retries_idempotent():
    cv = CenterVariable(_params(0))
    cv.join(wid="w0", now=0.0)
    first = cv.commit("w0", 0, _delta(1), commit_id="n:0")
    assert not first["duplicate"] and cv.clock == 1
    replay = cv.commit("w0", 0, _delta(1), commit_id="n:0")
    assert replay["duplicate"] and cv.clock == 1
    assert replay["staleness"] == first["staleness"]
    np.testing.assert_array_equal(replay["center"]["dense"]["w"],
                                  first["center"]["dense"]["w"])
    assert not cv.commit("w0", 1, _delta(2), commit_id="n:1")["duplicate"]
    assert not cv.commit("w0", 2, _delta(3), commit_id="m:0")["duplicate"]
    assert cv.clock == 3


def test_lease_lifecycle_reap_and_auto_rejoin():
    cv = CenterVariable(_params(0), lease_s=10.0)
    wid, version, _, rejoined = cv.join(rank=1, now=0.0)
    assert not rejoined and version == 0 and cv.stats()["workers"] == 1
    cv.pull(wid, now=8.0)
    assert cv.reap(now=15.0) == []
    assert cv.reap(now=30.0) == [(wid, 1)]
    assert cv.stats()["workers"] == 0
    info = cv.commit(wid, version, _delta(0), now=31.0)
    assert info["rejoined"] and cv.stats()["workers"] == 1
    assert cv.join(wid=wid, now=32.0)[3]


def test_auto_rejoin_commit_keeps_host_drop_coverage():
    cv = CenterVariable(_params(0), lease_s=5.0)
    wid, version, _, _ = cv.join(rank=2, now=0.0)
    assert cv.reap(now=10.0) == [(wid, 2)]
    cv.commit(wid, version, _delta(0), now=11.0, rank=2)
    assert cv.workers_by_rank([2]) == [(wid, 2)]


def test_workers_by_rank_maps_host_drop_evidence():
    cv = CenterVariable(_params(0))
    w1, *_ = cv.join(rank=1, now=0.0)
    w2, *_ = cv.join(rank=2, now=0.0)
    cv.join(now=0.0)
    assert cv.workers_by_rank([1]) == [(w1, 1)]
    assert set(cv.workers_by_rank([1, 2])) == {(w1, 1), (w2, 2)}
    assert cv.lapse(w1) and not cv.lapse(w1)


def test_ps_error_taxonomy():
    assert issubclass(StaleCommit, PSError)
    assert issubclass(PSUnavailable, OSError)
    assert issubclass(PSUnavailable, PSError)


# ---------------------------------------------------------------------
# the delta codec
# ---------------------------------------------------------------------

def _big_delta(seed):
    rng = np.random.default_rng(seed)
    return [{"kernel": rng.normal(size=(40, 30)).astype(np.float32),
             "bias": rng.normal(size=(30,)).astype(np.float32)},
            {"kernel": (rng.normal(size=(30, 5)) * 1e-3).astype(np.float32),
             "rng": np.zeros((), np.int32)}]


def _assert_trees_bit_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_bit_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_bit_equal(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ["fp16", "int8", "int8@0.1", "fp16@0.25"])
def test_codec_bit_equal_to_jax(spec):
    delta = _big_delta(3)
    ours, theirs = compress.parse_spec(spec), jcompress.parse_spec(spec)
    assert ours == theirs
    wire, jwire = compress.encode_tree(delta, ours), jcompress.encode_tree(
        delta, theirs)
    _assert_trees_bit_equal(wire, jwire)
    _assert_trees_bit_equal(compress.decode_tree(wire),
                            jcompress.decode_tree(jwire))
    _assert_trees_bit_equal(compress.residual_update(delta, wire),
                            jcompress.residual_update(delta, jwire))
    assert compress.payload_nbytes(wire) == jcompress.payload_nbytes(jwire)
    assert compress.payload_nbytes(wire) < compress.payload_nbytes(delta)
    # a JAX-encoded delta decodes in the port (the server is codec-blind)
    _assert_trees_bit_equal(compress.decode_tree(jwire),
                            jcompress.decode_tree(jwire))


@pytest.mark.parametrize("spec", ["zstd", "int8@0", "int8@1.5", "fp16@x",
                                  "int4@0.1"])
def test_malformed_specs_refused_like_jax(spec):
    with pytest.raises(ValueError, match="malformed DK_PS_COMPRESS"):
        compress.parse_spec(spec)
    with pytest.raises(ValueError, match="malformed DK_PS_COMPRESS"):
        jcompress.parse_spec(spec)


@pytest.mark.parametrize("spec", [None, "", "0", "off", "False"])
def test_off_spellings(spec):
    assert compress.parse_spec(spec) is None is jcompress.parse_spec(spec)
    delta = _big_delta(0)
    assert compress.encode_tree(delta, compress.parse_spec(spec)) is delta


def test_resolve_spec_reads_the_knob(monkeypatch):
    monkeypatch.setenv("DK_PS_COMPRESS", "int8@0.5")
    assert compress.resolve_spec()["spec"] == "int8@0.5"
    assert compress.resolve_spec("fp16")["spec"] == "fp16"


def test_encode_fault_point_fires():
    assert "ps.encode" in faults.KNOWN_POINTS
    spec = compress.parse_spec("int8")
    with faults.armed("ps.encode"):
        with pytest.raises(FaultInjected):
            compress.encode_tree(_big_delta(0), spec)
    # disarmed: the seam works again, and the JAX package's registry is
    # a different one (arming the port's never fires the reference's)
    assert compress.is_encoded(compress.encode_tree(_big_delta(0), spec))
    with faults.armed("ps.encode"):
        assert jcompress.is_encoded(jcompress.encode_tree(
            _big_delta(0), jcompress.parse_spec("int8")))
