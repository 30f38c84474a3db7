"""The port's pose math, procedural scenes and LLFF, LINEMOD and DeepVoxels loaders against the JAX package on CPU.

- Each function of ``core/poses.py`` on seeded random LLFF-style poses,
  at 1e-6 absolute (both are the same numpy code; they agree to the bit).
- Each generator at a small size against its JAX twin: the decoded
  pixels of every image equal, ``poses_bounds.npy`` equal, the json,
  pose and intrinsics files equal.
- Each loader, port against JAX, on copies of one directory (the LLFF
  loader writes its downsampled images beside the originals): images,
  poses, render_poses, hwf, K, the splits and near/far (in the scene and
  written back into the config), at 1e-6 absolute; LLFF at factor 1 and 2
  (cv2), spherified without NDC, path_zflat and a target width; LINEMOD
  with and without half_res; DeepVoxels.
- ``maybe_generate_example_dataset``: every built-in name and an unknown one.
"""

import json
import os
import shutil

import numpy as np
import pytest

from nerf_sampling_tpu.core import poses as jposes
from nerf_sampling_tpu.data import example as jexample
from nerf_sampling_tpu.data.deepvoxels import load_deepvoxels_scene as jax_load_dv
from nerf_sampling_tpu.data.linemod import load_linemod_scene as jax_load_linemod
from nerf_sampling_tpu.data.llff import load_llff_scene as jax_load_llff
from nerf_sampling_tpu.utils.config import TrainerConfig as JTrainerConfig
from nerf_sampling_tpu_torch.core import poses as tposes
from nerf_sampling_tpu_torch.data import example as texample
from nerf_sampling_tpu_torch.data.blender import read_png
from nerf_sampling_tpu_torch.data.deepvoxels import load_deepvoxels_scene
from nerf_sampling_tpu_torch.data.linemod import load_linemod_scene
from nerf_sampling_tpu_torch.data.llff import load_llff_scene
from nerf_sampling_tpu_torch.utils.config import TrainerConfig

ATOL = 1e-6


def llff_poses(n=10, seed=0):
    """[N, 3, 5] poses: random rotations, translations in [-1, 1], an hwf column."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out.append(np.concatenate([q, rng.uniform(-1, 1, (3, 1)), [[40.0], [48.0], [55.0]]], 1))
    return np.stack(out).astype(np.float32)


POSE_CASES = {
    "normalize": lambda m, p: m.normalize(p[:, :3, 2].sum(0)),
    "viewmatrix": lambda m, p: m.viewmatrix(p[0, :3, 2], p[0, :3, 1], p[0, :3, 3]),
    "poses_avg": lambda m, p: m.poses_avg(p),
    "render_path_spiral": lambda m, p: np.stack(m.render_path_spiral(
        m.poses_avg(p), m.normalize(p[:, :3, 1].sum(0)), np.array([0.3, 0.2, 0.1]), 3.5, 0.5, 2, 60.0)),
    "recenter_poses": lambda m, p: m.recenter_poses(p),
    "spherify_poses": lambda m, p: np.concatenate(
        [x.reshape(-1) for x in m.spherify_poses(p, np.array([[1.5, 7.0]] * len(p), np.float32))]),
}


@pytest.mark.parametrize("name", POSE_CASES)
def test_pose_math_matches_jax(name):
    p = llff_poses()
    got, want = POSE_CASES[name](tposes, p.copy()), POSE_CASES[name](jposes, p.copy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def tree_files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(got: str, want: str) -> None:
    """The same files; PNGs decode to the same pixels, .npy to the same
    array, .json to the same object, text files to the same text."""
    files = tree_files(got)
    assert files == tree_files(want) and files
    for rel in files:
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(a), read_png(b), err_msg=rel)
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=rel)
        elif rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), rel


GENERATORS = {
    "blender_sphere": ("generate_example_dataset", dict(H=16, W=16, n_train=2, n_val=1, n_test=1)),
    "blender_multi": ("generate_example_dataset", dict(H=16, W=16, n_train=2, n_val=1, n_test=1, variant="multi")),
    "llff": ("generate_example_llff_dataset", dict(H=24, W=32, n_images=10, seed=3)),
    "linemod": ("generate_example_linemod_dataset", dict(H=16, W=20, n_train=2, n_val=1, n_test=2)),
    "deepvoxels": ("generate_example_deepvoxels_dataset", dict(n_train=1, n_val=1, n_test=1)),
}


@pytest.mark.parametrize("case", GENERATORS)
def test_generators_match_jax(tmp_path, case):
    fn, kw = GENERATORS[case]
    getattr(texample, fn)(str(tmp_path / "port"), **kw)
    getattr(jexample, fn)(str(tmp_path / "jax"), **kw)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def assert_same_scene(got, want, tcfg, jcfg) -> None:
    for name in ("images", "poses", "render_poses", "i_train", "i_val", "i_test"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
    assert got.hwf == want.hwf and type(got.hwf[2]) is type(want.hwf[2])
    assert (got.K is None) == (want.K is None)
    if got.K is not None:
        np.testing.assert_array_equal(got.K, want.K)
    assert (got.near, got.far) == (want.near, want.far) == (tcfg.near, tcfg.far) == (jcfg.near, jcfg.far)


def load_both(tmp_path, src: str, port_loader, jax_loader, **cfg_kw):
    """The port's and the JAX loader's scenes of copies of ``src`` under one config."""
    scenes, cfgs = [], []
    for tag, loader, cfg_cls in (("port", port_loader, TrainerConfig), ("jax", jax_loader, JTrainerConfig)):
        root = str(tmp_path / f"{tag}_copy")
        shutil.copytree(src, root)
        cfg = cfg_cls(datadir=root, **cfg_kw)
        scenes.append(loader(cfg))
        cfgs.append(cfg)
    assert_same_scene(*scenes, *cfgs)
    return scenes[0], cfgs[0]


LLFF_CASES = {
    "ndc": dict(factor=1, llffhold=4),
    "factor2": dict(factor=2, llffhold=3),
    "spherify_no_ndc": dict(factor=1, llffhold=0, no_ndc=True, spherify=True),
    "path_zflat": dict(factor=1, llffhold=4, path_zflat=True),
}


@pytest.fixture(scope="module")
def llff_scene(tmp_path_factory):
    return texample.generate_example_llff_dataset(str(tmp_path_factory.mktemp("llff")), H=24, W=32, n_images=10)


@pytest.mark.parametrize("case", LLFF_CASES)
def test_llff_loader_matches_jax(tmp_path, llff_scene, case):
    kw = LLFF_CASES[case]
    scene, cfg = load_both(tmp_path, llff_scene, load_llff_scene, jax_load_llff, dataset_type="llff", **kw)
    if kw.get("no_ndc"):
        assert 0.0 < cfg.near < cfg.far
    else:
        assert (cfg.near, cfg.far) == (0.0, 1.0)
    factor = kw["factor"]
    assert scene.images.shape[1:3] == (24 // factor, 32 // factor)
    if factor != 1:  # the cv2 downsample's cache directory
        assert os.path.isdir(os.path.join(cfg.datadir, f"images_{factor}"))
    n_test = len(range(0, 10, kw["llffhold"])) if kw["llffhold"] else 1
    assert len(scene.i_test) == n_test and len(scene.i_train) == 10 - n_test
    assert scene.render_poses.shape == ((60 if kw.get("path_zflat") else 120), 3, 4)


def test_llff_loader_width_matches_jax(llff_scene, tmp_path):
    """_load_data's target width: images_{W}x{H}, through cv2, in both packages."""
    from nerf_sampling_tpu.data.llff import load_llff_data as jax_load_llff_data
    from nerf_sampling_tpu_torch.data.llff import load_llff_data

    out = []
    for tag, fn in (("port", load_llff_data), ("jax", jax_load_llff_data)):
        root = str(tmp_path / tag)
        shutil.copytree(llff_scene, root)
        out.append(fn(root, factor=None, width=16))
        assert os.path.isdir(os.path.join(root, "images_16x12"))
    for g, w in zip(*out):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert out[0][0].shape[1:3] == (12, 16)


@pytest.fixture(scope="module")
def linemod_scene(tmp_path_factory):
    return texample.generate_example_linemod_dataset(str(tmp_path_factory.mktemp("linemod")), H=16, W=20,
                                                     n_train=3, n_val=1, n_test=2)


@pytest.mark.parametrize("half_res", [False, True])
def test_linemod_loader_matches_jax(tmp_path, linemod_scene, half_res):
    scene, cfg = load_both(tmp_path, linemod_scene, load_linemod_scene, jax_load_linemod, dataset_type="LINEMOD",
                           half_res=half_res, testskip=1, white_bkgd=True)
    assert (cfg.near, cfg.far) == (2.0, 6.0)  # the metadata's 2.2 and 5.8, floored and ceiled
    assert scene.images.shape == (6, 16 // (1 + half_res), 20 // (1 + half_res), 3)
    assert scene.K[0][2] == 10.0 / (1 + half_res)


def test_deepvoxels_loader_matches_jax(tmp_path):
    src = texample.generate_example_deepvoxels_dataset(str(tmp_path / "dv"), n_train=2, n_val=2, n_test=2)
    scene, cfg = load_both(tmp_path, src, load_deepvoxels_scene, jax_load_dv, dataset_type="deepvoxels",
                           shape="cube", testskip=1)
    assert scene.hwf[:2] == (512, 512) and len(scene.i_train) == 2
    np.testing.assert_allclose(cfg.far - cfg.near, 2.0)
    np.testing.assert_array_equal(scene.render_poses, scene.poses[scene.i_test])


def test_maybe_generate_example_dataset(tmp_path, monkeypatch):
    """Each built-in name calls its generator with the JAX package's
    arguments, once; an existing directory is left alone; an unknown name
    without a directory raises."""
    calls = []
    for name, (what, fn, kw) in list(texample.EXAMPLE_DATASETS.items()):
        monkeypatch.setitem(texample.EXAMPLE_DATASETS, name,
                            (what, lambda d, _fn=fn.__name__, **k: calls.append((_fn, k)), kw))
    for name in texample.EXAMPLE_DATASETS:
        texample.maybe_generate_example_dataset(name, str(tmp_path / name))
    assert calls == [
        ("generate_example_dataset", dict(H=800, W=800, variant="sphere")),
        ("generate_example_dataset", dict(H=800, W=800, variant="multi")),
        ("generate_example_llff_dataset", dict(H=400, W=400)),
        ("generate_example_linemod_dataset", {}),
        ("generate_example_deepvoxels_dataset", {}),
    ]
    texample.maybe_generate_example_dataset("fern", str(tmp_path))  # exists: nothing to do
    with pytest.raises(ValueError, match="example_llff"):
        texample.maybe_generate_example_dataset("fern", str(tmp_path / "fern"))
