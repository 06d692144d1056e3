"""The bits of the port's kernels on fixed inputs, to compare two trees.

Run on a card, once per checkout, then compare::

    python3 dist_keras_tpu_torch/utils/kernel_bits.py --root A > a.json
    python3 dist_keras_tpu_torch/utils/kernel_bits.py --root B --against a.json

(``--may-differ paged_decode`` lets a kernel whose summation order was
meant to change differ without failing the comparison;
``--may-differ flash_bwd_dq:float32`` does so for one dtype of it.)

``--root`` names the checkout whose ``dist_keras_tpu_torch`` is loaded
(this file may come from another one).  Each kernel runs on inputs made
with numpy from a fixed seed, the backward ones on the lse and output of
the plain forward, so that a change to the forward does not reach them.
Each output is printed as the SHA-256 of its bytes, with -0 made +0
first, so two digests agree exactly when ``torch.equal`` would.
``--against`` exits 1 when any kernel both files ran differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

# (B, Tq, Tk, H, D, causal, q_offset, kv_offset, g_lse) of the cases:
# the training shape, then the edges (dead rows, Tq != Tk, ragged T, D)
BWD_CASES = [
    (16, 2048, 2048, 6, 128, True, 0, 0, False),
    (1, 256, 256, 6, 128, True, 0, 96, False),
    (1, 256, 512, 6, 128, True, 256, 0, True),
    (1, 1000, 1000, 6, 128, True, 0, 0, False),
    (2, 300, 300, 8, 64, True, 0, 0, False),
    (2, 300, 300, 8, 32, True, 0, 0, False),
]
PAGE_SIZE, MAX_PAGES = 16, 128


def digest(x):
    import torch

    x = (x + 0).contiguous()   # -0 + 0 is +0
    return hashlib.sha256(x.view(torch.uint8).cpu().numpy()).hexdigest()


def kernel_bits():
    """{kernel and case: digest} for K1 bf16, K2 and K3 (bf16 and f32),
    K4 f32 and K5."""
    import torch

    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu

    rng, dev, bits = np.random.default_rng(0), torch.device("cuda"), {}
    for b, tq, tk, h, d, causal, qo, ko, g_lse in BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            mk = lambda *shape: torch.from_numpy(  # noqa: E731
                rng.standard_normal(shape, np.float32)).to(dev, dtype)
            q, k, v, do = mk(b, tq, h, d), mk(b, tk, h, d), mk(b, tk, h, d), \
                mk(b, tq, h, d)
            args = (causal, d ** -0.5, qo, ko)
            out, lse = fa.flash_attention_reference(q, k, v, causal, d ** -0.5,
                                                    qo, ko)
            dl = -(do.float() * out.float()).sum(-1).transpose(1, 2)
            if g_lse:
                dl = dl + torch.from_numpy(rng.standard_normal(
                    (b, h, tq), np.float32)).to(dev)
            bwd = (q, k, v, do, lse, dl.contiguous(), *args)
            case = (f"B={b} Tq={tq} Tk={tk} H={h} D={d} causal={causal} "
                    f"q_off={qo} kv_off={ko} g_lse={int(g_lse)} "
                    f"{str(dtype)[6:]}")
            outs = {"flash_bwd_dq": [fa.flash_bwd_dq(*bwd)],
                    "flash_bwd_dkv": list(fa.flash_bwd_dkv(*bwd))}
            if dtype == torch.bfloat16:
                outs["flash_fwd"] = list(fa.flash_fwd(q, k, v, *args))
            else:
                outs["flash_bwd_fused"] = list(fu.fused_bwd(*bwd))
            for name, xs in outs.items():
                bits[f"{name} {case}"] = [digest(x) for x in xs]
            del q, k, v, do, out, lse, dl, bwd, outs
            torch.cuda.empty_cache()
    full = MAX_PAGES * PAGE_SIZE
    for lengths in ([0, 5, PAGE_SIZE, full, 1000, 33, full - 1,
                     PAGE_SIZE + 1], [full], [1000], [17, 0, full, 999]):
        s, h, d, pool = len(lengths), 6, 128, len(lengths) * MAX_PAGES + 1
        mk = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape, np.float32)).to(dev)
        q, kp, vp = mk(s, h, d), mk(h, pool, PAGE_SIZE, d), \
            mk(h, pool, PAGE_SIZE, d)
        pt = torch.from_numpy(rng.integers(0, pool, size=(s, MAX_PAGES),
                                           dtype=np.int32)).to(dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        bits[f"paged_decode S={s} H={h} D={d} lengths={lengths} float32"] = [
            digest(da.paged_attention_kernel(q, kp, vp, pt, ln))]
    return bits


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, required=True,
                    help="the checkout whose dist_keras_tpu_torch to load")
    ap.add_argument("--against", type=Path,
                    help="a JSON file this script printed for another tree")
    ap.add_argument("--may-differ", action="append", default=[],
                    metavar="KERNEL[:DTYPE]",
                    help="a kernel (or one dtype of it, e.g. "
                         "flash_bwd_dq:float32) whose outputs may differ "
                         "from the other tree's (its summation order "
                         "changed); repeatable")
    a = ap.parse_args(argv)
    sys.path[0] = str(a.root.resolve())   # not this file's directory
    bits = kernel_bits()
    if a.against is None:
        print(json.dumps(bits, indent=1))
        return 0
    lines, differ = compare(bits, json.loads(a.against.read_text()),
                            a.may_differ)
    print("\n".join(lines))
    return 1 if differ else 0


def compare(bits, other, may_differ):
    """Each key both runs have, tagged equal / different / different
    where ``may_differ`` allows it (a kernel's name, or ``name:dtype``),
    and a summary line.  -> (lines, count of disallowed differences)."""
    differ = allowed = 0
    lines = []
    for key in sorted(bits.keys() & other.keys()):
        same = bits[key] == other[key]
        name, dtype = key.split(" ", 1)[0], key.rsplit(" ", 1)[1]
        may = name in may_differ or f"{name}:{dtype}" in may_differ
        differ += not same and not may
        allowed += not same and may
        tag = "equal" if same else "different, allowed" if may \
            else "DIFFERENT"
        lines.append(f"{tag}  {key}")
    n = len(bits.keys() & other.keys())
    lines.append(f"{n - differ - allowed} equal, {differ} different, "
                 f"{allowed} different where allowed "
                 f"({', '.join(may_differ) or 'none'}), "
                 f"{len(bits.keys() ^ other.keys())} in one file only")
    return lines, differ


if __name__ == "__main__":
    sys.exit(main())
