"""Plot helpers: corner posterior plots and colored scatter matrices.

Counterpart of ``emri_frequencydomainwaveforms_tpu.utils.plotting``: pure
matplotlib (no ``corner``), imported inside each function with the Agg
backend, so nothing on the computing path pulls in a display stack (the
card's machine need not have matplotlib at all).
"""

from __future__ import annotations

import numpy as np


def plot_corner(samples, labels=None, truths=None, bins: int = 40, fname=None, color="C0"):
    """Minimal corner plot: 1-D histograms + 2-D density panels.

    ``samples``: (nsamples, ndim). Returns the matplotlib Figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples = np.asarray(samples)
    ndim = samples.shape[1]
    labels = labels or [f"p{i}" for i in range(ndim)]
    fig, axes = plt.subplots(ndim, ndim, figsize=(2.2 * ndim, 2.2 * ndim))
    if ndim == 1:
        axes = np.array([[axes]])
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(samples[:, i], bins=bins, color=color, histtype="step")
                if truths is not None:
                    ax.axvline(truths[i], color="k", ls="--", lw=1)
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=bins, cmap="Blues")
                if truths is not None:
                    ax.axvline(truths[j], color="k", ls="--", lw=1)
                    ax.axhline(truths[i], color="k", ls="--", lw=1)
            if i == ndim - 1:
                ax.set_xlabel(labels[j])
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i])
            else:
                ax.set_yticklabels([])
    fig.tight_layout()
    if fname:
        fig.savefig(fname, dpi=120)
    return fig


def get_colorplot(data, color_value, labels=None, fname=None):
    """Scatter matrix colored by a per-sample value."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.asarray(data)
    ndim = data.shape[1]
    labels = labels or [f"var {i}" for i in range(ndim)]
    fig, axes = plt.subplots(ndim, ndim, figsize=(2.2 * ndim, 2.2 * ndim))
    if ndim == 1:
        axes = np.array([[axes]])
    sc = None
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j >= i:
                ax.set_visible(False)
                continue
            sc = ax.scatter(data[:, j], data[:, i], c=color_value, s=4, cmap="viridis")
            if i == ndim - 1:
                ax.set_xlabel(labels[j])
            if j == 0:
                ax.set_ylabel(labels[i])
    if sc is not None:
        fig.colorbar(sc, ax=axes.ravel().tolist(), shrink=0.7)
    if fname:
        fig.savefig(fname, dpi=120)
    return fig


__all__ = ["plot_corner", "get_colorplot"]
