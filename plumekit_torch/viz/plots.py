"""Scene and prediction plots (``plumekit/viz/plots.py``), drawn with the
same artists on matplotlib's Agg backend, so that both packages write the
same PNGs. The tables are the port's row tables
(:class:`plumekit_torch.io.tables.Table`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from plumekit_torch.io.tables import unique


def matplotlib_present() -> bool:
    """True when matplotlib imports (the card's machine has none)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plt(purpose: str = "drawing"):
    """``matplotlib.pyplot`` on the Agg backend, imported here and only
    here; an ImportError naming matplotlib where it is absent."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{purpose} needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_identify_bboxes(aod: np.ndarray, aod_table, out_path: str,
                         vmin: float = 0, vmax: float = 1) -> None:
    """AOD image with red plume bounding boxes: the rg main's plot
    (``plume_identifier_rg.py:584-596``)."""
    plt = _plt("--plot")
    import matplotlib.patches as mpatches

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(aod, cmap="gray", interpolation="None", vmin=vmin, vmax=vmax)
    for r0, c0, r1, c1 in zip(*(aod_table.column(f"plume_{e}") for e in (
            "min_row", "min_col", "max_row", "max_col"))):
        ax.add_patch(mpatches.Rectangle((c0, r0), c1 - c0, r1 - r0,
                                        fill=False, edgecolor="red",
                                        linewidth=1))
    plt.xticks([])
    plt.yticks([])
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def plot_identify_hulls(aod: np.ndarray, hull_table, out_path: str,
                        vmin: float = 0, vmax: float = 1) -> None:
    """AOD image with dashed hull outlines: the gaussian main's plot
    (``plume_identifier_gaussian_profile.py:628-636``)."""
    plt = _plt("--plot")
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(aod, cmap="gray", interpolation="None", vmin=vmin, vmax=vmax)
    ids = hull_table.column("id")
    xs, ys = hull_table.column("hull_x"), hull_table.column("hull_y")
    for pid in unique(ids):
        rows = [i for i, v in enumerate(ids) if v == pid]
        ax.plot([xs[i] for i in rows], [ys[i] for i in rows], "r--",
                lw=0.5)
    plt.xticks([])
    plt.yticks([])
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def plot_prediction(aod: np.ndarray, probs: np.ndarray, out_path: str,
                    threshold: float = 0.5) -> None:
    """AOD | probability | mask triptych of a predicted granule."""
    plt = _plt("--plot")
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(aod, cmap="gray", vmin=0, vmax=1)
    axes[0].set_title("AOD")
    axes[1].imshow(probs, cmap="magma", vmin=0, vmax=1)
    axes[1].set_title("P(plume)")
    axes[2].imshow(probs > threshold, cmap="gray")
    axes[2].set_title(f"mask @ {threshold}")
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def plot_training_history(history: Dict[str, list], out_path: str) -> None:
    """Train loss and IoU curves, with the last eval IoU as a line."""
    plt = _plt()
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(12, 4))
    ax0.plot(history.get("loss", []))
    ax0.set_title("train loss")
    ax1.plot(history.get("iou", []), label="train IoU")
    if history.get("eval_iou"):
        ax1.axhline(history["eval_iou"][-1], color="r", ls="--",
                    label="eval IoU")
    ax1.legend()
    ax1.set_title("IoU")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
