"""Video export (nerf_sampling_tpu/utils/video.py).

The reference writes mp4 through imageio and ffmpeg (Trainer.py:223,
365-376). The port does not depend on imageio (the GPU machine has none):
it writes an animated GIF with Pillow, and raw ``.npz`` frames where
Pillow is missing.
"""

from __future__ import annotations

import numpy as np


def write_video(path_base: str, frames: np.ndarray, fps: int = 30) -> str:
    """Write uint8 frames [T, H, W, 3] to ``path_base`` + ``.gif`` (Pillow)
    or, without Pillow, + ``.npz``; returns the path written."""
    try:
        from PIL import Image
    except ImportError:
        path = path_base + ".npz"
        np.savez(path, frames=frames)
        return path
    path = path_base + ".gif"
    images = [Image.fromarray(np.ascontiguousarray(f)) for f in frames]
    images[0].save(path, save_all=True, append_images=images[1:], duration=1000.0 / fps, loop=0)
    return path
