"""Build, load and launch-check the hand-written CUDA kernels.

The sources under `csrc/` are compiled at first use, one nvcc process a
source, all started together, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c

(`subpath.cu` and `frame_textured.cu` also with `-fmad=false`, so K6 and
K1's textured instantiations repeat their plain versions' float
operations one for one) and linked (`nvcc -shared`) into one
library with a plain `extern "C"` interface, loaded with ctypes.  The
library lands in `build/torch_kernels/<hash>/` at the root of the
checkout, keyed by a hash of the sources, so a checkout builds its own
kernels from its own sources.  A failed build raises with nvcc's output.

Each kernel wrapper counts its launches in `LAUNCHES`; a run resets the
counts with `reset_launch_counts()` and reads them to show which kernels
its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("frame.cu", "frame_textured.cu", "compact.cu", "intersect.cu", "bvh.cu",
           "splat_rows.cu", "subpath.cu")
HEADERS = ("common.cuh", "intersect.cuh", "frame_program.cuh", "frame_launch.cuh", "bvh.cuh",
           "bvh_pairs.cuh", "subpath.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
SOURCE_FLAGS = {"subpath.cu": ("-fmad=false",), "frame_textured.cu": ("-fmad=false",)}
LIB_NAME = "libbdpt_kernels.so"

LAUNCHES = {"frame": 0, "frame_textured": 0, "compact": 0, "splat_tile": 0,
            "splat_rows": 0, "closest": 0, "shaded": 0, "occluded": 0,
            "bvh_closest": 0, "bvh_shaded": 0, "bvh_occluded": 0, "subpath": 0}

_lock = threading.Lock()
_lib = None


def resolve_device(device) -> torch.device:
    """The device of an entry point: CUDA unless the caller names another.
    Asked for CUDA on a machine without a card it raises; it never falls
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "the caller names another device (device='cpu' runs the plain "
            "versions of the kernels on the CPU)")
    return dev


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for every (cmd, Popen) and raise with nvcc's output on a failure."""
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source hash is built; returns the .so."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (s + ".o") for s in SOURCES]
        extra = ["-Xptxas=-v"] if verbose else []
        log = _run([_start([nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s, ()), *extra, "-I",
                            str(CSRC), "-c", str(CSRC / s), "-o", str(o)])
                    for s, o in zip(SOURCES, objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        log += _run([_start([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                             *map(str, objs)])])
        if verbose:
            print(log)
        os.replace(tmp_lib, lib_path)
    return lib_path


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bdpt_frame_launch.argtypes = [p, i, p, p, p, p, p, p, p, p]
    lib.bdpt_frame_textured_launch.argtypes = [p, i, p, p, p, i, p, p, p, p, p, p, p]
    lib.bdpt_compact_count.argtypes = [p, i, i, p, p]
    lib.bdpt_compact_scatter.argtypes = [p, p, i, i, i, p, p, p, p]
    lib.bdpt_splat_reduce.argtypes = [p, p, i, i, p, p]
    lib.bdpt_intersect_closest.argtypes = [p, i, p, i, i, p, p, p, p, p]
    lib.bdpt_intersect_shaded.argtypes = [p, i, p, i, i, p, p]
    lib.bdpt_occluded.argtypes = [p, i, p, i, p, p]
    lib.bdpt_bvh_closest.argtypes = [p, i, p, p, i, p, p, p, p, p, p]
    lib.bdpt_bvh_shaded.argtypes = [p, i, p, p, p, i, p, p, p]
    lib.bdpt_bvh_occluded.argtypes = [p, i, p, p, p, p, p]
    lib.bdpt_bvh_count.argtypes = [p, i, p, p, i, p, p]
    lib.bdpt_splat_rows.argtypes = [p, p, i, i, i, i, p, p]
    lib.bdpt_subpath.argtypes = [p, i, p, i, i, i, i, p, p, p]
    for fn in (lib.bdpt_frame_launch, lib.bdpt_frame_textured_launch, lib.bdpt_compact_count,
               lib.bdpt_compact_scatter, lib.bdpt_splat_reduce,
               lib.bdpt_intersect_closest, lib.bdpt_intersect_shaded,
               lib.bdpt_occluded, lib.bdpt_bvh_closest, lib.bdpt_bvh_shaded,
               lib.bdpt_bvh_occluded, lib.bdpt_bvh_count, lib.bdpt_splat_rows,
               lib.bdpt_subpath):
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


# A launch's host cost is some microseconds, which short kernels (K3, K5:
# ~10-15 us on the device) feel: pointers and the stream go to ctypes as
# plain ints (their argtypes are c_void_p), and the raw stream handle comes
# without building a torch Stream object.
def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check_tensor(name: str, t: torch.Tensor, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != (device if isinstance(device, torch.device) else torch.device(device)):
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_error(kernel: str, err: int) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{kernel}' launch failed: cudaError {err}")


def check_launch(kernel: str, err: int) -> None:
    """check_error, then count one launch of `kernel`."""
    check_error(kernel, err)
    LAUNCHES[kernel] += 1
