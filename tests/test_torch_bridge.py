"""Parameter bridge: JAX params pytree <-> the PyTorch port, bit for bit."""

import jax
import numpy as np
import pytest
import torch

from dist_keras_tpu.models.transformer import Transformer as JaxTransformer
from dist_keras_tpu.models.transformer import transformer_config
from dist_keras_tpu_torch.models.transformer import Transformer
from dist_keras_tpu_torch.utils.bridge import (
    params_from_jax,
    params_to_numpy,
    tree_map,
)

CFG = dict(input_dim=16, seq_len=32, d_model=16, n_heads=2, n_layers=2,
           n_classes=16)


def _jax_params(seed=0):
    m = JaxTransformer(transformer_config(**CFG), seed=seed)
    return jax.tree.map(np.asarray, m.params)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _paths(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def test_round_trip_is_bit_equal():
    ref = _jax_params()
    back = params_to_numpy(params_from_jax(ref, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_jax_array_leaves_bridge_without_copying_the_caller():
    m = JaxTransformer(transformer_config(**CFG), seed=1)
    port = params_from_jax(m.params, "cpu")          # jax.Array leaves
    back = params_to_numpy(port)
    for a, b in zip(jax.tree.leaves(m.params), jax.tree.leaves(back)):
        assert np.asarray(a).tobytes() == b.tobytes()
    kinds = []
    tree_map(lambda t: kinds.append(type(t)), port)
    assert kinds and set(kinds) == {torch.Tensor}
    src = _jax_params()
    port = params_from_jax(src, "cpu")
    port["proj"].add_(1.0)                           # never aliases src
    assert src["proj"].tobytes() == _jax_params()["proj"].tobytes()


def test_module_parameters_map_one_to_one_onto_the_pytree():
    ref = _jax_params()
    model = Transformer(transformer_config(**CFG), params=ref, device="cpu")
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(_paths(ref))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert named[key].detach().numpy().tobytes() == leaf.tobytes()
    back = params_to_numpy(model.params)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.tobytes() == b.tobytes()


def test_layouts_are_the_references():
    ref = _jax_params()
    port = params_from_jax(ref, "cpu")
    blk = port["blocks"][0]
    assert tuple(blk["wq"].shape) == (16, 2, 8)      # (d, h, dh)
    assert tuple(blk["wo"].shape) == (2, 8, 16)      # (h, dh, d)
    assert port["proj"].dtype == torch.float32


def test_seeded_init_has_the_reference_layout():
    ref = _jax_params()
    model = Transformer(transformer_config(**CFG), seed=3, device="cpu")
    for a, (_, t) in zip(jax.tree.leaves(ref),
                         sorted(dict(model.named_parameters()).items(),
                                key=lambda kv: _paths(ref).index(kv[0]))):
        assert tuple(t.shape) == a.shape
    again = Transformer(transformer_config(**CFG), seed=3, device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [np.array(["x"]), object()])
def test_unbridgeable_leaves_raise(bad):
    with pytest.raises(TypeError):
        params_from_jax({"w": bad}, "cpu")


def test_pytree_helpers_match_jax():
    from dist_keras_tpu.utils import pytree as jpt
    from dist_keras_tpu_torch.utils import pytree as tpt

    rng = np.random.default_rng(3)

    def make():
        return {"a": rng.normal(size=(3, 2)).astype(np.float32),
                "b": [rng.normal(size=(4,)).astype(np.float32)]}

    a, b, c = make(), make(), make()
    a["n"] = b["n"] = c["n"] = np.arange(3, dtype=np.int32)
    ta, tb, tc = (params_from_jax(t, "cpu") for t in (a, b, c))

    def same(got, want):
        for g, w in zip(jax.tree.leaves(params_to_numpy(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)

    same(tpt.tree_add(ta, tb), jpt.tree_add(a, b))
    same(tpt.tree_sub(ta, tb), jpt.tree_sub(a, b))
    same(tpt.tree_scale(ta, 0.5), jpt.tree_scale(a, 0.5))
    same(tpt.tree_axpy(-2.0, ta, tb), jpt.tree_axpy(-2.0, a, b))
    same(tpt.tree_zeros_like(ta), jpt.tree_zeros_like(a))
    floats = [{k: v for k, v in t.items() if k != "n"} for t in (a, b, c)]
    tfloats = [params_from_jax(t, "cpu") for t in floats]
    same(tpt.tree_mean(tfloats), jpt.tree_mean(floats))
    np.testing.assert_allclose(float(tpt.tree_global_norm(tfloats[0])),
                               float(jpt.tree_global_norm(floats[0])),
                               rtol=1e-6)
    merged = tpt.tree_merge_floats(tpt.tree_scale(ta, 2.0), ta)
    same(merged, jpt.tree_merge_floats(jpt.tree_scale(a, 2.0), a))
    assert merged["n"].dtype == torch.int32
    assert tpt.tree_size(ta) == jpt.tree_size(a) == 6 + 4 + 3


def test_a_moe_tree_round_trips_and_maps_onto_the_module():
    """A MoE transformer's tree (``blocks[i].moe.{router, w1, b1, w2,
    b2}`` in place of the dense FFN) crosses bit for bit, and the
    module's parameters and ``get_weights`` follow its layout and JAX's
    leaf order."""
    m = JaxTransformer(transformer_config(**CFG, moe_experts=4), seed=2)
    ref = jax.tree.map(np.asarray, m.params)
    back = params_to_numpy(params_from_jax(ref, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    port = Transformer(m.cfg, params=ref, device="cpu")
    names = {n for n, _ in port.named_parameters()}
    assert set(_paths(ref)) == names
    assert "blocks.0.moe.router" in names and "blocks.0.w1" not in names
    for a, b in zip(port.get_weights(), m.get_weights()):
        assert a.tobytes() == np.asarray(b).tobytes()
