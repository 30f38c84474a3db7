"""3D plots of rays and sampled points (nerf_sampling_tpu/viz/visualize.py).

The reference's visualize.py (plot_histogram, visualize_rays_pts,
plot_rays, plot_points, normalize_directions) on numpy arrays: anything
np.asarray takes, CPU torch tensors included. matplotlib is imported where
a plot is made (the GPU machine has none).
"""

from __future__ import annotations

import pickle
from typing import Any, Optional, Tuple, Union

import numpy as np


def _initialize_3d_plot():
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(
        subplot_kw={"projection": "3d"},
        gridspec_kw=dict(top=1.07, bottom=0.02, left=0, right=1),
    )
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.view_init(elev=30, azim=45)
    lim = 3
    ax.set_xlim([-lim, lim])
    ax.set_ylim([-lim, lim])
    ax.set_zlim([-lim, lim])
    return fig, ax


def normalize_directions(rays_d: Any) -> np.ndarray:
    """Normalize direction vectors [N, 3]."""
    rays_d = np.asarray(rays_d)
    return rays_d / np.linalg.norm(rays_d, axis=1, keepdims=True)


def plot_histogram(densities: Any, title: str = "Histogram"):
    """Histogram of densities/alphas/weights [N_rays, N_samples]."""
    flat = np.asarray(densities).reshape(-1)
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot()
    ax.hist(flat)
    ax.set_title(title)
    ax.set_xlabel("Density")
    ax.set_ylabel("N of samples")
    return fig, ax


def _plot_rays(ax, rays_o, rays_d, near: float = 2, far: float = 6):
    rays_o = np.asarray(rays_o)
    direction_norm = normalize_directions(rays_d)
    near_seg = rays_o + direction_norm * near
    far_seg = rays_o + direction_norm * far
    for origin, near_pt, far_pt in zip(rays_o, near_seg, far_seg):
        ax.plot(
            [origin[0], near_pt[0]],
            [origin[1], near_pt[1]],
            [origin[2], near_pt[2]],
            color="red",
        )
        ax.plot(
            [near_pt[0], far_pt[0]],
            [near_pt[1], far_pt[1]],
            [near_pt[2], far_pt[2]],
            color="gray",
        )
    return ax


def plot_rays(rays_o, rays_d, near: float = 2, far: float = 6):
    """Plot rays as red (origin->near) + gray (near->far) segments."""
    fig, ax = _initialize_3d_plot()
    _plot_rays(ax, rays_o, rays_d, near, far)
    return fig, ax


def _plot_points(ax, ray_pts, s: int = 20, c=None):
    pts = np.asarray(ray_pts).reshape(-1, 3)
    # cmap only applies to scalar mapping data; passing it with c=None or
    # with an explicit RGB(A) color spec makes matplotlib warn that it
    # will be ignored
    kw = {}
    if c is not None and not isinstance(c, (tuple, list)):
        c = np.asarray(c).reshape(-1)
        kw["cmap"] = "Reds"
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=s, c=c, depthshade=False,
               **kw)
    return ax


def plot_points(ray_pts, s: int = 20, c=None, title: str = "Points plot"):
    """Scatter sampled points [N_rays, N_samples, 3]."""
    import matplotlib.pyplot as plt

    fig, ax = _initialize_3d_plot()
    _plot_points(ax, ray_pts, s=s, c=c)
    plt.title(title)
    return fig, ax


def visualize_rays_pts(
    rays_o,
    rays_d,
    pts: Optional[Any] = None,
    n_rays: int = 3,
    near: float = 2.0,
    far: float = 6.0,
    title: str = "Points sampled on rays",
    s: int = 20,
    c: Optional[Union[Any, Tuple]] = None,
):
    """Plot rays and (optionally) their sampled points."""
    import matplotlib.pyplot as plt

    fig, ax = _initialize_3d_plot()
    _plot_rays(ax, rays_o, rays_d, near, far)
    if pts is not None:
        _plot_points(ax, pts, s=s, c=c)
    plt.title(title)
    return fig, ax


def save_figure_pickle(fig, path: str) -> None:
    """Persist an interactive figure (reference pickles figs for view_plot)."""
    with open(path, "wb") as f:
        pickle.dump(fig, f)


def view_plot(path: str) -> None:
    """Re-open a pickled figure (reference view_plot.py)."""
    import matplotlib.pyplot as plt

    with open(path, "rb") as f:
        fig = pickle.load(f)
    fig.show()
    plt.show()
