"""Plot a rendered scene's point cloud (nerf_sampling_tpu/experiments/plot.py).

    python3 -m nerf_sampling_tpu_torch.experiments.plot -f <renderonly dir>/scene_data.npz -o points.png

The reference's experiments/plot.py: the points of ``scene_data.npz``
(written by the render CLI's ``-ssd``) whose volume-rendering weight is at
least ``-t``, at most ``-n`` of them (a seeded subsample), in a 3D
scatter, saved to ``-o`` or shown. matplotlib is imported where the plot
is made.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Scatter-plot high-weight scene points.")
    ap.add_argument("-f", "--file", dest="path", required=True, help="Path to scene_data.npz (from render.py -ssd).")
    ap.add_argument("-t", "--threshold", type=float, default=0.5, help="Minimum weight to keep a point.")
    ap.add_argument("-n", "--n_points", type=int, default=50_000)
    ap.add_argument("-o", "--out", default=None, help="Save the figure instead of showing it.")
    return ap


def main(argv: list[str] | None = None) -> np.ndarray:
    """Plot; returns the points plotted."""
    args = build_parser().parse_args(argv)
    with np.load(args.path) as data:
        pts, weights = data["all_pts"], data["all_weights"]
    mask = weights >= args.threshold
    pts = pts[mask]
    print(f"{mask.sum()} / {mask.size} points above weight {args.threshold}")
    if len(pts) > args.n_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), args.n_points, replace=False)]

    import matplotlib

    if args.out is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5)
    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    if args.out is not None:
        fig.savefig(args.out, dpi=150)
        print(f"saved {args.out}")
        plt.close(fig)
    else:
        plt.show()
    return pts


if __name__ == "__main__":
    main()
