"""Faithfully-shaped synthetic datasets for the examples + accuracy gates —
a copy of the JAX package's ``data/synthetic.py``: the same seed gives the
same arrays in both packages (the port has no ``Dataset.from_csv`` yet, so
``to_csv``'s files are read by the JAX package only).

The reference ships small sample data under ``examples/data/`` (MNIST
csv/gz, ``atlas_higgs.csv`` — SURVEY.md §2.4) and its examples double as the
integration tests.  The examples/gates here need no download: they use
*procedural* datasets with the exact shapes, value ranges and difficulty
character of the originals:

- ``synthetic_mnist``    — 28x28x1 grayscale digits in [0,255], labels 0-9.
  Each digit is rendered from a stroke skeleton (polylines/arcs) under a
  random affine jitter + stroke-width/intensity/pixel noise, so the class
  signal is spatial structure (what a CNN must exploit), not a lookup table.
- ``synthetic_higgs``    — 28 continuous physics-flavoured features, binary
  signal/background labels with overlapping nonlinear class structure
  (invariant-mass peak vs falling background + angular correlations),
  mixed by a fixed rotation so no single column separates the classes.
- ``synthetic_cifar10``  — 32x32x3 color images in [0,255], 10 classes of
  textured patterns (oriented gratings / checkers / radial blobs x class
  palettes) with per-sample phase/angle/brightness jitter.

All generators are deterministic in ``seed`` and return ``Dataset`` objects
with the same column layout the reference examples build from their CSVs
(``features`` flat float row + integer ``label``).  ``to_csv`` round-trips
through the native fastcsv reader so the example scripts exercise the real
ingestion path (reference examples load MNIST from CSV, examples/mnist.py).
"""

from __future__ import annotations

import numpy as np

from dist_keras_tpu_torch.data.dataset import Dataset

__all__ = [
    "synthetic_mnist",
    "synthetic_higgs",
    "synthetic_cifar10",
    "to_csv",
]


# ---------------------------------------------------------------------------
# digit stroke skeletons, in a unit box (x right, y down)
# ---------------------------------------------------------------------------
def _arc(cx, cy, rx, ry, a0, a1, n=12):
    t = np.linspace(np.radians(a0), np.radians(a1), n)
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], axis=1)


def _digit_strokes():
    """-> list of 10 lists of polylines (each an (P,2) array)."""
    s = [None] * 10
    s[0] = [_arc(0.5, 0.5, 0.19, 0.32, 0, 360, 24)]
    s[1] = [np.array([[0.38, 0.30], [0.52, 0.16], [0.52, 0.84]]),
            np.array([[0.38, 0.84], [0.66, 0.84]])]
    s[2] = [np.concatenate([
        _arc(0.5, 0.33, 0.18, 0.17, 180, 360, 10),
        np.array([[0.66, 0.45], [0.33, 0.82]]),
        np.array([[0.33, 0.84], [0.70, 0.84]])])]
    s[3] = [np.concatenate([
        _arc(0.47, 0.31, 0.17, 0.15, 160, 400, 10),
        _arc(0.47, 0.66, 0.19, 0.18, -80, 160, 12)])]
    s[4] = [np.array([[0.62, 0.84], [0.62, 0.16], [0.30, 0.62], [0.74, 0.62]])]
    s[5] = [np.concatenate([
        np.array([[0.68, 0.17], [0.36, 0.17], [0.33, 0.47]]),
        _arc(0.49, 0.64, 0.19, 0.19, -60, 160, 12)])]
    s[6] = [np.concatenate([
        np.array([[0.62, 0.16], [0.40, 0.45]]),
        _arc(0.50, 0.64, 0.17, 0.19, -180, 180, 16)])]
    s[7] = [np.array([[0.30, 0.17], [0.70, 0.17], [0.44, 0.84]])]
    s[8] = [_arc(0.5, 0.32, 0.15, 0.15, 0, 360, 16),
            _arc(0.5, 0.66, 0.18, 0.17, 0, 360, 16)]
    s[9] = [np.concatenate([
        _arc(0.50, 0.34, 0.17, 0.18, -180, 180, 16),
        np.array([[0.67, 0.34], [0.60, 0.84]])])]
    return s


def _segments(polylines):
    """polylines -> (S, 2, 2) array of line segments."""
    segs = []
    for pl in polylines:
        segs.append(np.stack([pl[:-1], pl[1:]], axis=1))
    return np.concatenate(segs, axis=0)


_DIGIT_SEGS = None


def _digit_segments():
    global _DIGIT_SEGS
    if _DIGIT_SEGS is None:
        _DIGIT_SEGS = [_segments(p) for p in _digit_strokes()]
    return _DIGIT_SEGS


def _render_digits(labels, rng, size=28, chunk=256):
    """Rasterize stroke skeletons with per-sample affine + noise.

    -> (n, size, size) float32 in [0, 255].
    """
    n = len(labels)
    px = (np.arange(size) + 0.5) / size
    gx, gy = np.meshgrid(px, px, indexing="xy")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)  # (G, 2), G=size²

    out = np.empty((n, size * size), dtype=np.float32)
    segs_by_digit = _digit_segments()

    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        # per-sample affine: rotation, anisotropic scale, shear, translation
        th = rng.normal(0.0, np.radians(11.0), size=m)
        sx = rng.uniform(0.78, 1.15, size=m)
        sy = rng.uniform(0.78, 1.15, size=m)
        sh = rng.normal(0.0, 0.13, size=m)
        tx = rng.uniform(-0.09, 0.09, size=m)
        ty = rng.uniform(-0.09, 0.09, size=m)
        c, s_ = np.cos(th), np.sin(th)
        # A = R(th) @ [[sx, sh],[0, sy]]
        A = np.empty((m, 2, 2))
        A[:, 0, 0] = c * sx
        A[:, 0, 1] = c * sh - s_ * sy
        A[:, 1, 0] = s_ * sx
        A[:, 1, 1] = s_ * sh + c * sy
        width = rng.uniform(0.035, 0.09, size=m)
        gain = rng.uniform(0.6, 1.0, size=m)

        dmin = np.full((m, grid.shape[0]), np.inf, dtype=np.float32)
        # group samples in this chunk by digit so segments batch cleanly
        lab = np.asarray(labels[lo:hi])
        for d in range(10):
            idx = np.nonzero(lab == d)[0]
            if idx.size == 0:
                continue
            segs = segs_by_digit[d]  # (S, 2, 2)
            ctr = np.array([0.5, 0.5])
            pts = segs - ctr  # center, transform, un-center
            # (k, S, 2, 2): per-sample transformed endpoints
            tp = np.einsum("kij,spj->kspi", A[idx], pts)
            tp = tp + ctr + np.stack([tx[idx], ty[idx]], 1)[:, None, None, :]
            a, b = tp[:, :, 0], tp[:, :, 1]        # (k, S, 2)
            ab = b - a
            denom = np.maximum((ab * ab).sum(-1, keepdims=True), 1e-12)
            # t = clip(((g - a)·ab)/|ab|², 0, 1) per (k, S, G)
            pa = grid[None, None] - a[:, :, None]  # (k, S, G, 2)
            t = np.clip((pa * ab[:, :, None]).sum(-1)
                        / denom, 0.0, 1.0)
            proj = a[:, :, None] + t[..., None] * ab[:, :, None]
            dist = np.linalg.norm(grid[None, None] - proj, axis=-1)
            dmin[idx] = np.minimum(dmin[idx], dist.min(axis=1))

        aa = 0.022  # anti-alias falloff in unit coords (~0.6 px)
        ink = np.clip((width[:, None] - dmin) / aa + 1.0, 0.0, 1.0)
        img = ink * gain[:, None] * 255.0
        img += rng.normal(0.0, 16.0, size=img.shape)
        out[lo:hi] = np.clip(img, 0.0, 255.0)
    return out.reshape(n, size, size)


def synthetic_mnist(n=8192, seed=0, flat=True):
    """MNIST-faithful digits: 28x28 grayscale in [0,255], labels 0-9.

    ``flat=True`` gives a (n, 784) ``features`` column (the CSV layout the
    reference's examples/mnist.py loads); reshape with ReshapeTransformer
    for CNNs exactly as the reference does.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    imgs = _render_digits(labels, rng)
    feats = imgs.reshape(n, -1) if flat else imgs[..., None]
    return Dataset({"features": feats.astype(np.float32),
                    "label": labels.astype(np.int64)})


# ---------------------------------------------------------------------------
# ATLAS-Higgs-flavoured tabular binary classification
# ---------------------------------------------------------------------------
def synthetic_higgs(n=16384, seed=0, signal_fraction=0.5):
    """28 continuous features, binary label (1 = signal).

    Structure mirrors the character of the ATLAS Higgs challenge set the
    reference's workflow.ipynb trains on: a resonance-mass feature (peak for
    signal, falling exponential for background), transverse-momentum-like
    positive features with class-dependent scales, angular features with
    class-dependent correlation, derived nonlinear combinations, and pure
    noise columns — all mixed by a fixed rotation so no single column is
    separating on its own.
    """
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < signal_fraction).astype(np.int64)
    sig = y == 1

    cols = []
    # resonance mass: signal peaks at 125, background falls exponentially
    mass = np.where(sig, rng.normal(125.0, 18.0, n),
                    35.0 + rng.exponential(70.0, n))
    cols.append(mass)
    # transverse momenta: heavier tails for signal
    for scale_s, scale_b in ((48.0, 40.0), (36.0, 31.0), (29.0, 27.0)):
        cols.append(np.where(sig, rng.gamma(2.1, scale_s, n),
                             rng.gamma(2.0, scale_b, n)))
    # missing-energy magnitude
    cols.append(np.where(sig, rng.gamma(1.9, 33.0, n),
                         rng.gamma(1.7, 30.0, n)))
    # angular features: signal has correlated Δφ structure
    phi1 = rng.uniform(-np.pi, np.pi, n)
    dphi = np.where(sig, rng.normal(np.pi, 1.2, n),
                    rng.uniform(-np.pi, np.pi, n))
    phi2 = np.mod(phi1 + dphi + np.pi, 2 * np.pi) - np.pi
    eta1 = rng.normal(0.0, 1.2, n)
    eta2 = np.where(sig, eta1 + rng.normal(0.0, 1.3, n),
                    rng.normal(0.0, 1.4, n))
    cols += [np.cos(phi1), np.sin(phi1), np.cos(phi2), np.sin(phi2),
             eta1, eta2, np.abs(eta1 - eta2)]
    # derived nonlinear combinations (the "DER_*" columns of the real set)
    pt_ratio = cols[1] / (cols[2] + 1.0)
    cols += [np.sqrt(np.abs(mass - 125.0)), pt_ratio,
             np.log1p(cols[1] + cols[2]),
             np.cos(dphi) * np.sqrt(cols[4] / 30.0)]
    base = np.stack(cols, axis=1)  # 19 informative columns
    base = (base - base.mean(0)) / (base.std(0) + 1e-8)
    noise = rng.normal(0.0, 1.0, size=(n, 28 - base.shape[1]))
    x = np.concatenate([base, noise], axis=1)
    # fixed rotation mixes informative and noise directions
    q, _ = np.linalg.qr(np.random.default_rng(1234).normal(size=(28, 28)))
    x = x @ q
    # mild label noise keeps the problem realistically unsaturable
    flip = rng.random(n) < 0.05
    y = np.where(flip, 1 - y, y)
    return Dataset({"features": x.astype(np.float32), "label": y})


# ---------------------------------------------------------------------------
# CIFAR-10-flavoured textured color images
# ---------------------------------------------------------------------------
_CIFAR_PALETTES = np.array([
    [[0.85, 0.30, 0.25], [0.15, 0.10, 0.30]],
    [[0.20, 0.65, 0.85], [0.90, 0.85, 0.30]],
    [[0.30, 0.75, 0.35], [0.55, 0.20, 0.60]],
    [[0.95, 0.60, 0.20], [0.10, 0.35, 0.55]],
    [[0.80, 0.80, 0.80], [0.20, 0.20, 0.20]],
    [[0.70, 0.25, 0.55], [0.25, 0.65, 0.60]],
    [[0.95, 0.85, 0.70], [0.35, 0.15, 0.10]],
    [[0.25, 0.30, 0.80], [0.85, 0.45, 0.40]],
    [[0.45, 0.85, 0.75], [0.60, 0.35, 0.15]],
    [[0.90, 0.40, 0.65], [0.15, 0.45, 0.25]],
])


def synthetic_cifar10(n=8192, seed=0, flat=True):
    """CIFAR-shaped 32x32x3 images in [0,255], 10 texture classes.

    Class signal = (pattern family, orientation, palette); per-sample jitter
    in phase/angle/frequency/brightness plus pixel noise keeps a convnet
    honest (it must learn oriented filters, not a mean color).
    """
    rng = np.random.default_rng(seed)
    size = 32
    labels = rng.integers(0, 10, size=n)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    imgs = np.empty((n, size, size, 3), dtype=np.float32)
    for lo in range(0, n, 512):
        hi = min(lo + 512, n)
        m = hi - lo
        lab = labels[lo:hi]
        angle = np.radians(lab * 18.0 + rng.normal(0, 6.0, m))
        freq = rng.uniform(2.5, 4.0, m) + (lab % 3)
        phase = rng.uniform(0, 2 * np.pi, m)
        u = (xx[None] * np.cos(angle)[:, None, None]
             + yy[None] * np.sin(angle)[:, None, None])
        v = (-xx[None] * np.sin(angle)[:, None, None]
             + yy[None] * np.cos(angle)[:, None, None])
        wave = 2 * np.pi * freq[:, None, None]
        fam = lab % 3
        stripes = 0.5 + 0.5 * np.sin(wave * u + phase[:, None, None])
        checker = (0.5 + 0.5 * np.sin(wave * u + phase[:, None, None])
                   * np.sin(wave * v + phase[:, None, None]))
        cx = rng.uniform(0.3, 0.7, m)[:, None, None]
        cy = rng.uniform(0.3, 0.7, m)[:, None, None]
        r = np.sqrt((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2)
        radial = 0.5 + 0.5 * np.sin(wave * r * 2 + phase[:, None, None])
        pat = np.where(fam[:, None, None] == 0, stripes,
                       np.where(fam[:, None, None] == 1, checker, radial))
        pal = _CIFAR_PALETTES[lab].copy()  # (m, 2, 3)
        # blend toward a random other palette so mean color alone is weak
        alt = _CIFAR_PALETTES[rng.integers(0, 10, m)]
        mix = rng.uniform(0.0, 0.45, (m, 1, 1))
        pal = (1 - mix) * pal + mix * alt
        img = (pat[..., None] * pal[:, None, None, 0]
               + (1 - pat[..., None]) * pal[:, None, None, 1])
        img *= rng.uniform(0.6, 1.05, m)[:, None, None, None]
        img = img * 255.0 + rng.normal(0, 26.0, img.shape)
        imgs[lo:hi] = np.clip(img, 0, 255)
    feats = imgs.reshape(n, -1) if flat else imgs
    return Dataset({"features": feats.astype(np.float32),
                    "label": labels.astype(np.int64)})


# ---------------------------------------------------------------------------
# CSV round-trip (the reference's examples load their data from CSV)
# ---------------------------------------------------------------------------
def to_csv(dataset, path, features_col="features", label_col="label"):
    """Write features+label as a numeric CSV readable by Dataset.from_csv.

    Layout matches the reference's MNIST CSVs: one row per sample, feature
    columns first, label last.
    """
    x = np.asarray(dataset[features_col], dtype=np.float32).reshape(
        len(dataset), -1)
    y = np.asarray(dataset[label_col], dtype=np.float32).reshape(-1, 1)
    mat = np.concatenate([x, y], axis=1)
    header = ",".join([f"f{i}" for i in range(x.shape[1])] + [label_col])
    np.savetxt(path, mat, delimiter=",", header=header, comments="",
               fmt="%.6g")
    return path
