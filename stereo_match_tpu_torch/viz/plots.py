"""Visualization / debug QA surface (numpy and matplotlib).

Capability parity with the reference's ``plot_functions.py`` (SURVEY.md §2
#13): camera-pose triads, rectified pairs with horizontal epipolar rule
lines (the human rectification check, ``plot_functions.py:79-80``), raw vs
filtered disparity views — plus a perceptual disparity colormap the
reference lacked. The figure functions render to matplotlib figures
(headless "Agg" safe, imported at the call) and return the figure. The
same code as ``stereo_match_tpu/viz/plots.py``, whose package imports JAX,
but for :func:`colorize_disparity`, which the CLI runs on machines without
matplotlib: it keeps turbo's table itself.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def axis_equal_3d(ax) -> None:
    """Equalize 3-D axis scales (``plot_functions.py:14-30`` parity)."""
    extents = np.array([getattr(ax, f"get_{dim}lim")() for dim in "xyz"])
    centers = np.mean(extents, axis=1)
    r = np.max(np.abs(extents[:, 1] - extents[:, 0])) / 2
    for center, dim in zip(centers, "xyz"):
        getattr(ax, f"set_{dim}lim")(center - r, center + r)


def plot_camera(ax, pose: np.ndarray, label: str = "", scale: float = 0.1) -> None:
    """RGB axis triad for a camera pose (``plot_functions.py:33-48``)."""
    origin = pose[:3, 3]
    ax.scatter(*origin)
    for axis, color in zip(range(3), ("red", "green", "blue")):
        ax.quiver(*origin, *pose[:3, axis], color=color, length=scale)
    if label:
        ax.text(*(origin + 0.05), label)


def plot_transforms(poses, labels=None, scale: float = 0.1):
    """Plot a trajectory of camera poses (``plot_functions.py:111-126``)."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    for i, pose in enumerate(poses):
        label = labels[i] if labels else str(i)
        plot_camera(ax, np.asarray(pose), label, scale)
    axis_equal_3d(ax)
    return fig


def show_image_pair(left: np.ndarray, right: np.ndarray,
                    line_spacing: int = 25, title: str = "rectified pair"):
    """Side-by-side pair with horizontal epipolar rule lines every
    ``line_spacing`` px (``plot_functions.py:51-83``): matched features
    must lie on the same line after rectification."""
    plt = _plt()
    left = np.asarray(left)
    right = np.asarray(right)
    pair = np.concatenate([left, right], axis=1)
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(pair, cmap="gray" if pair.ndim == 2 else None)
    for y in range(line_spacing, pair.shape[0], line_spacing):
        ax.axhline(y, color="lime", linewidth=0.5)
    ax.set_title(title)
    ax.axis("off")
    return fig


def show_disparity(raw: np.ndarray, filtered: np.ndarray | None = None,
                   title: str = "disparity"):
    """Raw (and optionally filtered) disparity, min-max normalized
    (``plot_functions.py:86-108``)."""
    plt = _plt()
    n = 2 if filtered is not None else 1
    fig, axes = plt.subplots(1, n, figsize=(7 * n, 4), squeeze=False)
    for ax, (img, name) in zip(
            axes[0], [(raw, "raw")] + ([(filtered, "filtered")] if n == 2 else [])):
        im = ax.imshow(np.asarray(img), cmap="turbo")
        ax.set_title(f"{title} ({name})")
        ax.axis("off")
        fig.colorbar(im, ax=ax, shrink=0.8)
    return fig


# matplotlib's "turbo" (a ListedColormap of N = 256 colours) as the bytes
# (rgb * 255).astype(uint8), row by row: the colours colorize_disparity
# writes, without matplotlib.
TURBO_N = 256
TURBO_RGB8 = np.frombuffer(bytes.fromhex(
    "30123b31154232184a341b51351e5836215f37236538266c3929723a2c793b2f7f3c3285"
    "3c358b3d37913e3a963f3d9c4040a14043a64145ab4148b0424bb5434eba4350be4353c2"
    "4456c74458cb455bce455ed24560d64563d94666dd4668e0466be3466de64670e84673eb"
    "4675ed4678f0467af2467df4467ff64682f84584f94587fb4589fc448cfd438efd4291fe"
    "4193fe4096fe3f98fe3e9bfe3c9dfd3ba0fc39a2fc38a5fb36a8f934aaf833acf631aff5"
    "2fb1f32db4f12bb6ef2ab9ed28bbeb26bde925c0e623c2e421c4e120c6df1ec9dc1dcbda"
    "1ccdd71bcfd41ad1d219d3cf18d5cc18d7ca17d9c717dac417dcc217debf18e0bd18e1ba"
    "19e3b81ae4b61be5b41de7b11ee8af20e9ac22eba924eca627eda329eea02cef9d2ff09a"
    "32f19735f39438f4913bf48d3ff58a42f68746f7834af8804df97c51f97955fa7659fb72"
    "5dfb6f61fc6c65fc6869fd656dfd6271fd5f74fe5c78fe597cfe5680fe5384fe5087fe4d"
    "8bfe4b8efe4892fe4695fe4498fe429bfd409efd3ea1fc3da4fc3ba6fb3aa9fb39acfa37"
    "aef937b1f836b3f835b6f735b9f534bbf434bef334c0f233c3f133c5ef33c8ee33caed33"
    "cdeb34cfea34d1e834d4e735d6e535d8e335dae236dde036dfde36e1dc37e3da37e5d838"
    "e7d738e8d538ead339ecd139edcf39efcd39f0cb3af2c83af3c63af4c43af6c23af7c039"
    "f8be39f9bc39f9ba38fab737fbb537fbb336fcb035fcae34fdab33fda932fda631fda330"
    "fea12ffe9e2efe9b2dfe982cfd952bfd9229fd8f28fd8c27fc8926fc8624fb8323fb8022"
    "fa7d20fa7a1ff9771ef8741cf7711bf76e1af66b18f56817f46516f36315f26014f15d13"
    "ef5a11ee5810ed550fec520eea500de94d0de84b0ce6490be5460ae3440ae24209e04008"
    "de3e08dd3c07db3a07d93806d73606d63405d43205d23005d02f04ce2d04cb2b03c92903"
    "c72803c52602c32402c02302be2102bb1f01b91e01b61c01b41b01b11901ae1801ac1601"
    "a91501a61401a31201a011019d10019a0e01970d01940c01910b018e0a018b0901870801"
    "8407018106027d05027a0402"), np.uint8).reshape(TURBO_N, 3)


def colorize_disparity(disparity: np.ndarray,
                       d_min: float | None = None,
                       d_max: float | None = None) -> np.ndarray:
    """Disparity -> RGB uint8 with the turbo colormap; NaN -> black.

    The lookup of matplotlib's ``Colormap.__call__`` on floats in [0, 1]:
    x * N, N -> N - 1, truncated to an index of ``TURBO_RGB8``.
    """
    d = np.asarray(disparity, np.float64)
    valid = np.isfinite(d)
    lo = d_min if d_min is not None else (np.nanmin(d) if valid.any() else 0)
    hi = d_max if d_max is not None else (np.nanmax(d) if valid.any() else 1)
    norm = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    x = np.where(valid, norm, 0) * TURBO_N
    x[x == TURBO_N] = TURBO_N - 1
    rgb = TURBO_RGB8[x.astype(int)]
    rgb[~valid] = 0
    return rgb
