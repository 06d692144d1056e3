"""The port's own half of ``checkpoint.py``: the tensor snapshot, bf16
without ml_dtypes, restore onto a template, the restricted unpickler's
placeholders.

Saving and restoring are bit-exact in every dtype, in the chunked, the
``state.pkl`` and the differential formats.  The CUDA cases (pinned
buffers on a side stream, upload from pinned memory) carry the ``cuda``
marker and skip without a card; ``chip_smoke.py`` phase 12 runs them at
full size."""

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch import checkpoint as tckpt
from dist_keras_tpu_torch.checkpoint import Checkpointer

DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
          torch.bool]
FORMATS = {"chunked": {"DK_CKPT_CHUNK_MB": "0.001"},
           "state.pkl": {"DK_CKPT_CHUNK_MB": "0"},
           "differential": {"DK_CKPT_CHUNK_MB": "0.001",
                            "DK_CKPT_DIFF": "1"}}


def _tensor(dtype, shape=(37, 29), seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=g, dtype=torch.float64) * 1e3
        return x.to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g,
                         dtype=torch.int64).to(dtype)


def _bits(x):
    x = torch.as_tensor(x)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if x.is_floating_point():
        return x.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])
    return x


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_every_dtype_round_trips_bit_exact(tmp_path, monkeypatch, fmt,
                                           dtype):
    for k, v in FORMATS[fmt].items():
        monkeypatch.setenv(k, v)
    state = {"big": _tensor(dtype), "small": _tensor(dtype, (3,), 1)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state).wait(timeout_s=60)
    assert ck.verify(1) == "ok"
    _, got = ck.restore()
    for k, want in state.items():
        host = got[k]
        if dtype == torch.bfloat16:
            assert isinstance(host, torch.Tensor)   # numpy has no bf16
        else:
            assert isinstance(host, np.ndarray)
        assert torch.equal(_bits(host), _bits(want)), k
    # onto a template of tensors: the template's dtype and device
    _, on = ck.restore(template={k: torch.empty_like(v)
                                 for k, v in state.items()})
    for k, want in state.items():
        assert on[k].dtype == dtype and on[k].device.type == "cpu"
        assert torch.equal(_bits(on[k]), _bits(want)), k


def test_save_calls_no_cpu_or_item_per_leaf(tmp_path, monkeypatch):
    """The caller's side of save() never reads a tensor back through
    ``.cpu()`` or ``.item()`` (each waits for the card)."""
    def refuse(*a, **k):
        raise AssertionError("save() read a tensor back per leaf")

    state = {"w": torch.randn(64, 64), "c": torch.zeros((), dtype=torch.int32),
             "g": torch.Generator().manual_seed(0).get_state()}
    ck = Checkpointer(str(tmp_path))
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    h = ck.save(1, state)
    monkeypatch.undo()
    h.wait(timeout_s=60)
    _, got = ck.restore()
    np.testing.assert_array_equal(got["w"], state["w"].numpy())


@pytest.mark.parametrize("kind", ["tensor", "parameter", "numpy"])
def test_snapshot_is_decoupled_from_in_place_updates(tmp_path, kind):
    """A leaf changed in place right after save() returns (a torch.optim
    step on a Parameter, a numpy buffer reused) does not reach the
    checkpoint."""
    w = torch.arange(4096, dtype=torch.float32)
    leaf = {"tensor": w.clone(), "parameter": torch.nn.Parameter(w.clone()),
            "numpy": w.numpy().copy()}[kind]
    ck = Checkpointer(str(tmp_path))
    h = ck.save(1, {"w": leaf})
    with torch.no_grad():
        if kind == "numpy":
            leaf += 1
        else:
            leaf.add_(1)
    h.wait(timeout_s=60)
    _, got = ck.restore()
    np.testing.assert_array_equal(got["w"], w.numpy())


def test_template_mismatches_are_named(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3), "b": [torch.ones(2)]}).wait()
    with pytest.raises(ValueError, match=r"\['a'\] has shape \(3,\)"):
        ck.restore(template={"a": torch.zeros(4), "b": [torch.ones(2)]})
    with pytest.raises(ValueError, match=r"missing \[\"\['c'\]\"\]"):
        ck.restore(template={"a": torch.zeros(3), "b": [torch.ones(2)],
                             "c": torch.zeros(1)})
    _, got = ck.restore(template={"a": torch.zeros(3, dtype=torch.float64),
                                  "b": [np.zeros(2, np.float32)]})
    assert got["a"].dtype == torch.float64
    assert isinstance(got["b"][0], np.ndarray)


def test_paths_follow_jax_keystr():
    """The leaf paths shard_meta.json is keyed by: jax.tree_util.keystr's
    format, and its leaf order (dict keys sorted, None an empty node)."""
    import jax
    from optax._src.transform import ScaleByAdamState

    s0 = tckpt.optax_state_class("ScaleByAdamState")(
        np.zeros(()), [{"k": np.ones(2)}], [{"k": np.ones(2)}])
    tree = {"p": [{"w": np.ones(2), "b": np.ones(1)}], "n": None,
            "t": (np.zeros(1), s0), "a": np.zeros(3)}
    ours = [p for p, _ in tckpt._flatten(tree)[0]]
    ref_tree = dict(tree, t=(tree["t"][0], ScaleByAdamState(*s0)))
    theirs = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert ours == theirs


def test_optax_placeholders_pickle_and_flatten_by_field():
    cls = tckpt.optax_state_class("ScaleByAdamState")
    s = cls(np.int32(3), {"a": np.ones(2)}, {"a": np.zeros(2)})
    assert dict(zip(s._fields, s))["count"] == 3
    assert s.type_name == "ScaleByAdamState"
    import io
    import pickle

    back = tckpt.restricted_load(io.BytesIO(pickle.dumps(s)))
    assert type(back) is cls and back._fields == ("count", "mu", "nu")
    with pytest.raises(tckpt.CheckpointFormatError, match="ScaleByLion"):
        tckpt.optax_state_class("ScaleByLionState")


@pytest.mark.cuda
@pytest.mark.parametrize("async_on", ["1", "0"])
def test_cuda_leaves_snapshot_through_pinned_buffers(tmp_path, monkeypatch,
                                                     async_on):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the snapshot's side-stream "
                    "copies have no CPU mode")
    monkeypatch.setenv("DK_CKPT_ASYNC", async_on)
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0.25")
    dev = torch.device("cuda")
    state = {d: _tensor(d, (512, 257)).to(dev) for d in (
        torch.float32, torch.bfloat16, torch.int32)}
    state = {str(k): v for k, v in state.items()}
    state["gen"] = torch.Generator(device=dev).manual_seed(3).get_state()
    ck = Checkpointer(str(tmp_path))
    h = ck.save(1, state)
    # the caller's stream moves on as a trainer's does: the old tensors
    # are dropped and new ones of the same sizes written — the caching
    # allocator must not hand the saved tensors' memory to them while
    # the side stream still copies it (record_stream)
    template = {k: torch.empty_like(v) for k, v in state.items()}
    state = {k: (torch.full_like(v, 7) if v.is_cuda else v)
             for k, v in state.items()}
    h.wait(timeout_s=60)
    _, got = ck.restore(template=template)
    for k, v in got.items():
        assert v.device == template[k].device
    ref = {str(d): _tensor(d, (512, 257)) for d in (
        torch.float32, torch.bfloat16, torch.int32)}
    for k, want in ref.items():
        assert torch.equal(_bits(got[k].cpu()), _bits(want)), k


def test_pinned_pool_reuses_arenas_and_keeps_two():
    """The snapshot's staging arenas come back to the pool after a write
    and are handed out again (largest kept, at most two)."""
    pool = tckpt._PinnedPool()
    a, b, c = (torch.empty(n, dtype=torch.uint8) for n in (100, 300, 200))
    for arena in (a, b, c):
        pool.give(arena)
    assert [t.numel() for t in pool._free] == [200, 300]
    assert pool.take(150) is c and pool.take(250) is b
    assert pool._free == []
    snap = tckpt._Snapshot({}, (), [a], pool)
    snap.release()
    snap.release()                      # idempotent
    assert pool._free == [a]
