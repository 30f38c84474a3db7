"""3D ray and point plots (reference visualize.py and view_plot.py)."""

from nerf_sampling_tpu_torch.viz.visualize import (
    normalize_directions,
    plot_histogram,
    plot_points,
    plot_rays,
    visualize_rays_pts,
)

__all__ = [
    "normalize_directions",
    "plot_histogram",
    "plot_points",
    "plot_rays",
    "visualize_rays_pts",
]
