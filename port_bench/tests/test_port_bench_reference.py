"""The plain reference against the port at a tiny size on the CPU, and
the reference's own pieces."""

import copy
import time

import pytest
import torch

from port_bench import harness
from port_bench.reference import cnn, inputs, numbers, precision, vit
from port_bench.tests.tiny import TINY


def _cell(name):
    c = harness.load_cell(name)
    return harness.load_cell(name, TINY[c.traffic["kind"]])


def _run(cell, seed=2**33 + 5):
    return harness.Run(cell, seed, 0.1, False, "cpu", time.time())


def test_reference_vit_forward_matches_the_ports():
    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.ops.attention import attention
    from dist_keras_tpu_torch.parallel.transformer_tp import (
        tp_transformer_forward,
    )

    c = _cell("vit-b16.train-224")
    dims = inputs.vit_dims({**c.config, **c.traffic})
    p = inputs.vit_params(dims, 11, "cpu")
    x, _ = inputs.vit_batch(dims, 3, 11, 0, "cpu")
    cfg = transformer_config(dims["input_dim"], dims["seq_len"], dims["d"],
                             dims["heads"], dims["layers"], dims["ff"],
                             dims["classes"])
    with torch.no_grad():
        want = tp_transformer_forward(p, x, cfg, attn_fn=attention)
        got = vit.forward(p, x, dims)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_reference_cnn_forward_matches_the_ports():
    from dist_keras_tpu_torch.models import mnist_cnn

    c = _cell("adag-mnist-cnn.stacked4")
    ws = inputs.cnn_weights(c.config, 3, "cpu")
    model = mnist_cnn()
    model.set_weights([w.numpy() for w in ws])
    x, _ = inputs.cnn_rows(c.config, 5, 3, "cpu")
    with torch.no_grad():
        want = model.apply(model.params, x, training=False)
        got = cnn.forward(ws, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["vit-b16.train-224",
                                  "adag-mnist-cnn.stacked4"])
def test_the_ports_f32_check_meets_the_reference(cell):
    """The program's check numbers (losses, first grads from adam's state,
    the change) in f32 lie at rounding from the reference's."""
    c = _cell(cell)
    s = harness.kind(c).prepare(_run(c))
    ref = (vit if c.traffic["kind"] == "vit_train" else cnn).check_numbers(
        c.config, c.traffic, 2**33 + 5, "cpu")
    assert set(s.program["grad"]) == set(ref["grad"])
    assert set(s.program["change"]) == set(ref["change"])
    g = numbers.gaps(s.program, ref)
    assert max(g.values()) < 1e-4, g


def test_the_reference_draws_the_ports_dropout_masks():
    """The stacked worker step's masks: one draw of every worker's from
    the trainer's generator, which the reference makes again."""
    from torch.func import vmap

    from dist_keras_tpu_torch.models.layers import Dropout

    seed, shape = 2**35 + 7, (3, 5, 16)
    g = torch.Generator().manual_seed(inputs.dropout_seed(seed))
    layer = Dropout(0.25)
    kept = [vmap(lambda x: layer.apply({}, x, training=True, generator=g),
                 randomness="different")(torch.ones(shape)) != 0
            for _ in range(2)]
    want = inputs.dropout_masks(0.25, shape, 2, seed, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(kept, want))
    assert 0.6 < float(want[0].float().mean()) < 0.9


def test_reference_adam_is_optaxs():
    from dist_keras_tpu_torch.ops.optimizers import adam, apply_updates

    p = {"a": torch.randn(5), "b": torch.randn(2, 3)}
    tx = adam(1e-2)
    state, ps, st = tx.init(p), numbers.flat(p), {}
    cur = p
    for _ in range(3):
        g = {k: torch.randn_like(v) for k, v in p.items()}
        upd, state = tx.update(g, state, cur)
        cur = apply_updates(cur, upd)
        ps = vit.adam_step(ps, numbers.flat(g), st, 1e-2)
    for (k, v) in ps:
        torch.testing.assert_close(v, cur[k], rtol=1e-6, atol=1e-7)


def test_the_control_moves_the_gradients():
    c = _cell("vit-b16.train-224")
    ref = vit.check_numbers(c.config, c.traffic, 9, "cpu")
    ctl = vit.check_numbers(c.config, c.traffic, 9, "cpu",
                            prec=precision.FP8)
    assert numbers.gaps(ctl, ref)["grad_gap"] > 1e-3


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.3])
    got = precision.fp8_round(x, torch.float8_e4m3fn, precision.E4M3_MAX)
    assert got[0] == 1.0 and got[2] == 1.125 and got[3] == 448.0
    assert got[1] in (1.0, 1.125)          # 1/16 is below e4m3's step
    assert abs(got[4] + 3.25) < 1e-6 or abs(got[4] + 3.5) < 1e-6


def test_gaps_leave_out_leaves_moved_by_round_off_alone():
    ref = {"loss": {"0": 2.0}, "grad": {"a": 1.0, "b": 1.0, "tiny": 1e-9},
           "change": {"a": 0.1, "b": 0.1, "tiny": 0.1}}
    prog = copy.deepcopy(ref)
    prog["change"]["tiny"] = 0.0
    assert numbers.excluded(ref) == ["tiny"]
    assert numbers.gaps(prog, ref)["change_gap"] == 0.0
    prog["grad"]["a"] = 1.5
    prog["loss"]["0"] = 2.2
    g = numbers.gaps(prog, ref)
    assert abs(g["grad_gap"] - 0.5) < 1e-12
    assert abs(g["loss_gap"] - 0.1) < 1e-12


def test_inputs_repeat_from_the_seed_and_differ_across_seeds():
    a = inputs.cnn_rows({"input_shape": [4, 4, 1], "num_classes": 3}, 6,
                        2**40 + 3, "cpu")
    b = inputs.cnn_rows({"input_shape": [4, 4, 1], "num_classes": 3}, 6,
                        2**40 + 3, "cpu")
    c = inputs.cnn_rows({"input_shape": [4, 4, 1], "num_classes": 3}, 6,
                        2**40 + 4, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert 0 <= inputs.sub_seed(2**63 + 1, "x") < 2**63
