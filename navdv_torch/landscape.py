"""Landscape textures: host NumPy, seeded, or loaded from a file.

A copy of the JAX package's generator and loader, bit for bit: the same seed
(or file) gives the same f32[H, W] array in [0, 1].
"""

from __future__ import annotations

import numpy as np


def _normalize(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros_like(img, dtype=np.float32)
    return ((img - lo) / (hi - lo)).astype(np.float32)


def _blobs(rng: np.random.Generator, size: tuple[int, int], n_features: int,
           feature_scale: float | None = None) -> np.ndarray:
    """Random Gaussian bumps — feature-rich landscape (positive control).

    ``feature_scale`` sets the length scale feature sizes derive from
    (sigma in scale*[0.01, 0.05]); default = min(h, w). With it set each
    bump is accumulated only on its ±6 sigma bounding box.
    """
    h, w = size
    scale = feature_scale if feature_scale is not None else min(h, w)
    img = np.zeros((h, w))
    cx = rng.uniform(0, w, n_features)
    cy = rng.uniform(0, h, n_features)
    sigma = rng.uniform(scale * 0.01, scale * 0.05, n_features)
    amp = rng.uniform(0.3, 1.0, n_features) * rng.choice([-1.0, 1.0], n_features)
    if feature_scale is None:
        yy, xx = np.mgrid[0:h, 0:w]
        for i in range(n_features):
            img += amp[i] * np.exp(
                -((xx - cx[i]) ** 2 + (yy - cy[i]) ** 2) / (2 * sigma[i] ** 2)
            )
        return img
    for i in range(n_features):
        r = 6.0 * sigma[i]
        x0, x1 = max(0, int(cx[i] - r)), min(w, int(cx[i] + r) + 1)
        y0, y1 = max(0, int(cy[i] - r)), min(h, int(cy[i] + r) + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = np.arange(x0, x1) - cx[i]
        ys = np.arange(y0, y1) - cy[i]
        img[y0:y1, x0:x1] += amp[i] * np.exp(
            -(xs[None, :] ** 2 + ys[:, None] ** 2) / (2 * sigma[i] ** 2)
        )
    return img


def _noise(rng: np.random.Generator, size: tuple[int, int], smooth: float) -> np.ndarray:
    """Gaussian-smoothed uniform noise."""
    img = rng.uniform(size=size)
    if smooth > 0:
        radius = max(int(3 * smooth), 1)
        t = np.arange(-radius, radius + 1)
        k = np.exp(-0.5 * (t / smooth) ** 2)
        k /= k.sum()
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
        img = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, img)
    return img


def _fractal(rng: np.random.Generator, size: tuple[int, int], beta: float) -> np.ndarray:
    """1/f^beta spectral noise (natural-scene spatial statistics)."""
    h, w = size
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0  # DC handled below
    amp = f ** (-beta / 2.0)
    amp[0, 0] = 0.0
    phase = rng.uniform(0, 2 * np.pi, size=(h, w))
    spec = amp * np.exp(1j * phase)
    return np.real(np.fft.ifft2(spec))


def _checker(size: tuple[int, int], cell: int) -> np.ndarray:
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy // cell) + (xx // cell)) % 2).astype(np.float64)


def load_landscape(path: str) -> np.ndarray:
    """Load a landscape texture from an image file (PNG/JPEG/TIFF via PIL,
    imported only here) or a ``.npy`` array; grayscale-converted and
    normalized to f32 [0, 1]."""
    if path.endswith(".npy"):
        return _normalize(np.load(path).astype(np.float64))
    from PIL import Image

    img = Image.open(path).convert("L")
    return _normalize(np.asarray(img, dtype=np.float64))


def make_landscape(
    kind: str = "blobs",
    size: tuple[int, int] = (512, 512),
    seed: int = 0,
    n_features: int = 150,
    smooth: float = 4.0,
    cell: int = 32,
    beta: float = 2.0,
    feature_scale: float | None = None,
) -> np.ndarray:
    """Synthesize an f32[H, W] landscape in [0, 1].

    kinds: ``blobs`` | ``noise`` | ``fractal`` | ``checker`` | ``flat``
    (featureless negative control).
    """
    rng = np.random.default_rng(seed)
    if kind == "blobs":
        return _normalize(_blobs(rng, size, n_features, feature_scale))
    if kind == "noise":
        return _normalize(_noise(rng, size, smooth))
    if kind == "fractal":
        return _normalize(_fractal(rng, size, beta))
    if kind == "checker":
        return _normalize(_checker(size, cell))
    if kind == "flat":
        return np.full(size, 0.5, dtype=np.float32)
    raise ValueError(f"unknown landscape kind {kind!r}")
