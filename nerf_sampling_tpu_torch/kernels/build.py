"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into an
object, all of them at once in parallel, and the objects link into one
shared library with a plain C interface (no PyTorch headers: seconds, not
minutes). The library goes to ``kernels/_build/<hash of the sources and
flags>/``, so an edit to a source rebuilds it and an unchanged tree reuses
it. Every C entry point returns a cudaError_t; ``check`` raises on anything
but 0. Every kernel launch goes through ``launch``, which counts it in
``launches``.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_info: dict = {}
# launches by (kernel, precision): kernels named "K1" .. "K11" (K10 is the
# int8 MLP of K2/K3/K6-K9, counted as theirs), the core checks of
# wg_dense.cu by their C entry; precision "bf16", "fp32" or "int8"
launches: collections.Counter = collections.Counter()


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> tuple[list[str], str]:
    files = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fp:
            h.update(fp.read())
    return [f for f in files if f.endswith(".cu")], h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the ctypes handle."""
    global _lib
    if _lib is not None:
        return _lib
    cu_files, digest = _sources()
    out_dir = os.path.join(BUILD_DIR, digest)
    so_path = os.path.join(out_dir, "libnst_kernels.so")
    log_path = os.path.join(out_dir, "build.log")
    t0 = time.perf_counter()
    built = False
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        nvcc = _nvcc()
        logs = []
        jobs = []
        for src in cu_files:  # one nvcc per source, all started together
            obj = os.path.join(out_dir, os.path.basename(src) + f".{os.getpid()}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(cmd[-3])} ({proc.returncode}):\n{err[-4000:]}")
        tmp = f"{so_path}.{os.getpid()}.tmp"
        if not failed:
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
        with open(log_path, "w") as fp:
            fp.write("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, so_path)
        built = True
    lib = ctypes.CDLL(so_path)
    ptrs, i64, i32, u32, f32, vp = (
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_uint, ctypes.c_float, ctypes.c_void_p,
    )
    lib.nst_depth_net_forward.argtypes = [ptrs, i32, i64, i32, i32, f32, f32, i32, i32, vp]
    lib.nst_depth_net_forward.restype = i32
    lib.nst_depth_net_occupancy.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.nst_depth_net_occupancy.restype = i32
    # the vp before the stream of the render entries: the int8 plan, a host
    # int32 array (quant.quant_plan), or null for bf16 and fp32 (a bf16 or
    # fp32 call, and every nst_render_hier call, ends ptrs with the packs'
    # weight slices)
    lib.nst_render_around_depth.argtypes = [ptrs, i32, i64, i32, i32, u32, f32, f32, i32, vp, vp]
    lib.nst_render_around_depth.restype = i32
    lib.nst_render_gaussian.argtypes = [ptrs, i32, i64, i32, i32, u32, f32, u32, i64, i32, vp, vp]
    lib.nst_render_gaussian.restype = i32
    lib.nst_render_linspace.argtypes = [ptrs, i32, i64, i32, i32, u32, f32, f32, i32, i32, i32, vp, vp]
    lib.nst_render_linspace.restype = i32
    lib.nst_shade.argtypes = [ptrs, i32, i64, i32, i32, u32, i32, i32, i32, vp, vp]
    lib.nst_shade.restype = i32
    # the i64 after the seed of nst_render_gaussian and nst_render_hier:
    # ray_base, the global index of the launch's ray 0 that keys Philox;
    # the vp before nst_render_hier's seed: the seed as a device word, or null
    lib.nst_render_hier.argtypes = [ptrs, i32, i64, i32, i32, i32, u32, i32, u32, f32, f32,
                                    i32, i32, vp, u32, i64, i32, i32, vp, vp, vp]
    lib.nst_render_hier.restype = i32
    lib.nst_render_mip.argtypes = [ptrs, i32, i64, i32, i32, u32, f32, f32, i32, i32, f32, f32, f32, f32, vp]
    lib.nst_render_mip.restype = i32
    lib.nst_render_mip_occupancy.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.nst_render_mip_occupancy.restype = i32
    lib.nst_nerf_points.argtypes = [ptrs, i32, i64, i64, i32, u32, i32, vp]
    lib.nst_nerf_points.restype = i32
    lib.nst_nerf_points_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nst_nerf_points_occupancy.restype = i32
    lib.nst_nerf_points_bwd_sizes.argtypes = [i64, i32, u32, i64, i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.nst_nerf_points_bwd_sizes.restype = i32
    lib.nst_nerf_points_bwd.argtypes = [ptrs, i32, i64, i64, i32, u32, i64, i32, i32, vp]
    lib.nst_nerf_points_bwd.restype = i32
    lib.nst_render_hier_occupancy.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.nst_render_hier_occupancy.restype = i32
    lib.nst_render_around_depth_occupancy.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.nst_render_around_depth_occupancy.restype = i32
    lib.nst_wg_dense.argtypes = [ptrs, i32, i64, i32, i32, i32, vp]
    lib.nst_wg_dense.restype = i32
    lib.nst_wg_dense_q.argtypes = [ptrs, i32, i64, i32, i32, vp]
    lib.nst_wg_dense_q.restype = i32
    lib.nst_wg_dense32.argtypes = [ptrs, i32, i64, i32, i32, i32, vp]
    lib.nst_wg_dense32.restype = i32
    lib.nst_pe_fill_check.argtypes = [ptrs, i32, i64, i32, i32, i32, vp]
    lib.nst_pe_fill_check.restype = i32
    lib.nst_point_fill_check.argtypes = [ptrs, i32, i64, i64, i32, i32, vp]
    lib.nst_point_fill_check.restype = i32
    build_info.update(
        path=so_path, log=log_path, built=built, seconds=time.perf_counter() - t0
    )
    _lib = lib
    return lib


def pointer_array(tensors: list[torch.Tensor | None]):
    """(ctypes void* array of the tensors' device pointers, its length);
    None passes a null pointer."""
    arr = (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])
    return arr, len(tensors)


def host_pointer(array) -> int | None:
    """The address of a host numpy array for a ``const`` pointer argument
    (the caller keeps the array alive across the call), or None for null."""
    return None if array is None else array.ctypes.data


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(kernel: str, precision: str, entry: str, tensors: list[torch.Tensor | None], *args) -> None:
    """One launch of the C entry ``entry(ptrs, n_ptrs, *args, stream)``: the
    tensors' pointers (None a null one), the current stream of the first
    tensor's device; raises on a nonzero return, then adds one to
    ``launches[kernel, precision]``."""
    device = next(t.device for t in tensors if t is not None)
    arr, count = pointer_array(tensors)
    check(getattr(load_library(), entry)(arr, count, *args, current_stream(device)), entry)
    launches[kernel, precision] += 1


def occupancy(entry: str, *args: int,
              fields: tuple[str, ...] = ("blocks_per_sm", "rays_per_block", "threads", "smem_bytes")) -> dict[str, int]:
    """A kernel's launch shape from its C entry ``entry(*args, out)``, whose
    ``out`` holds ``fields`` in order (resident blocks per SM first), and
    the SM count of the card in use (for the wave count), as "sms"."""
    out = (ctypes.c_int * len(fields))()
    check(getattr(load_library(), entry)(*args, out), entry)
    return {**dict(zip(fields, out)), "sms": sm_count(torch.device("cuda", torch.cuda.current_device()))}


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
