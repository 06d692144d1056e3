"""The frozen FLOP and byte arithmetic against hand counts, and the
configurations' parameter counts against their shapes."""

import json
import math

import pytest

from port_bench import harness
from port_bench.reference import flops, inputs


def _config(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json")
                      .read_text())


def test_vit_b16_flops_by_hand_at_224():
    dims = inputs.vit_dims(_config("vit-b16"))
    assert dims == {"input_dim": 768, "seq_len": 196, "d": 768,
                    "heads": 12, "layers": 12, "ff": 3072,
                    "classes": 1000}
    t, d = 196, 768
    proj = 2 * t * 768 * d                      # 231,211,008
    qkvo = 4 * 2 * t * d * d                    # 924,844,032 a layer
    mlp = 2 * 2 * t * d * 3072                  # 1,849,688,064
    attn = 2 * 2 * t * t * d                    # 118,013,952
    head = 2 * d * 1000
    forward = proj + 12 * (qkvo + mlp + attn) + head
    assert forward == 34_943_299_584
    assert flops.vit_forward_flops(dims) == forward
    assert flops.vit_train_flops(dims) == 3 * forward
    # 13.4 TFLOP a step of 128 images
    assert math.isclose(128 * 3 * forward / 1e12, 13.419, rel_tol=1e-3)


def test_vit_b16_flops_at_1024():
    dims = inputs.vit_dims({**_config("vit-b16"), "image_size": 1024})
    assert dims["seq_len"] == 4096
    t, d = 4096, 768
    layer = 8 * t * d * d + 4 * t * d * 3072 + 4 * t * t * d
    assert flops.vit_forward_flops(dims) == (2 * t * 768 * d + 12 * layer
                                             + 2 * d * 1000)
    # attention's T x T products against the layer's linear ones
    assert 0.85 < (4 * t * t * d) / (8 * t * d * d + 4 * t * d * 3072) \
        < 0.95


def test_mnist_cnn_flops_by_hand():
    cfg = _config("adag-mnist-cnn")
    macs = (28 * 28 * 32 * 9 * 1 + 28 * 28 * 32 * 9 * 32
            + 14 * 14 * 64 * 9 * 32 + 7 * 7 * 64 * 128 + 128 * 10)
    assert macs == 11_466_496
    assert flops.cnn_forward_macs(cfg) == macs
    assert flops.cnn_train_flops(cfg) == 6 * macs   # 68.8 MFLOP a sample


@pytest.mark.parametrize("kind,fl,nbytes", [
    ("fwd", 4, 4 * 2 * 1 + 4),
    ("bwd_dq", 6, 5 * 2 + 2 * 4),
    ("bwd_dkv", 8, 6 * 2 + 2 * 4),
    ("bwd_fused", 10, 7 * 2 + 2 * 4),
])
def test_attention_launch_by_hand(kind, fl, nbytes):
    # one batch, one head, t = 1, d = 1: FLOPs are fl * t^2 d, bytes the
    # bf16 tensors of shape (1, 1, 1, 1) plus the f32 row statistics
    assert flops.attention_launch(kind, 1, 1, 1, 1) == (fl, nbytes)
    b, t, h, d = 128, 196, 12, 64
    f, by = flops.attention_launch(kind, b, t, h, d)
    assert f == fl * b * h * t * t * d
    assert flops.bound_s(f, by) == max(f / 989e12, by / 3.35e12)


def test_attention_launch_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        flops.attention_launch("sideways", 1, 1, 1, 1)


@pytest.mark.parametrize("px", [224, 1024])
def test_vit_parameter_count_from_shapes(px):
    cfg = _config("vit-b16")
    dims = inputs.vit_dims({**cfg, "image_size": px})
    d, ff, t = dims["d"], dims["ff"], dims["seq_len"]
    layer = 4 * d * d + 2 * d * ff + ff + d + 2 * 2 * d   # + ln1, ln2
    n = (dims["input_dim"] * d + t * d + dims["layers"] * layer + 2 * d
         + d * dims["classes"] + dims["classes"])
    assert n == cfg["parameters"][f"image_size_{px}"]


def test_vit_params_tree_has_those_shapes():
    dims = inputs.vit_dims({**_config("vit-b16"), "hidden_size": 8,
                            "num_attention_heads": 2, "intermediate_size": 16,
                            "num_hidden_layers": 2, "patch_size": 4,
                            "image_size": 8, "num_labels": 3})
    p = inputs.vit_params(dims, 5, "cpu")
    assert p["proj"].shape == (48, 8) and p["pos"].shape == (4, 8)
    assert p["blocks"][1]["wq"].shape == (8, 2, 4)
    assert p["blocks"][0]["wo"].shape == (2, 4, 8)
    assert p["head"]["kernel"].shape == (8, 3)


def test_cnn_parameter_count_from_shapes():
    cfg = _config("adag-mnist-cnn")
    n = sum(math.prod(k) + b for k, b in inputs.cnn_shapes(cfg))
    assert n == cfg["parameters"] == 430_890
