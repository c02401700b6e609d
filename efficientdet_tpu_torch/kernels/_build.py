"""Build and load the package's CUDA C++ kernels.

The sources in ``efficientdet_tpu_torch/csrc/`` are compiled with ``nvcc``
for ``sm_90a``, one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, at first use, into
``efficientdet_tpu_torch/_build/`` (listed in ``.gitignore``). The library's
name carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. The library is bound with ``ctypes``:
each pointer and the stream go as ``c_void_p``, and each entry point returns
``cudaGetLastError()`` after its launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libedt_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Runs the commands at once and waits for all; returns their output, or
    raises with the stderr of those that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outputs = [proc.communicate() for proc in procs]
    failed = [f"nvcc failed ({' '.join(cmd)}):\n{stderr}"
              for cmd, proc, (_, stderr) in zip(cmds, procs, outputs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(f"{' '.join(cmd)}\n{stdout}{stderr}"
                   for cmd, (stdout, stderr) in zip(cmds, outputs))


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path. Each source is compiled by its own ``nvcc``, all started together,
    and the objects are linked with ``nvcc -shared``. ``nvcc``'s output
    (``-Xptxas=-v``: registers, shared memory and spills per kernel) is kept
    beside the library as ``.log``. Raises with nvcc's stderr if a step
    fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, f"{src.stem}.o") for src in cu]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for obj, src in zip(objects, cu)])
        lib = os.path.join(tmp, out.name)
        log += _run_all([[nvcc, "-shared", "-o", lib, *objects]])
        out.with_suffix(".log").write_text(
            f"{time.perf_counter() - start:.1f} s\n{log}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process and declare the entry points."""
    lib = ctypes.CDLL(str(build()))
    lib.edt_nms_select.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    lib.edt_nms_select.restype = ctypes.c_int
    lib.edt_mbconv_fused_f32.argtypes = ([ctypes.c_void_p] * 10
                                         + [ctypes.c_int] * 13
                                         + [ctypes.c_void_p])
    lib.edt_mbconv_fused_f32.restype = ctypes.c_int
    lib.edt_mbconv_fused_bf16.argtypes = ([ctypes.c_void_p] * 10
                                          + [ctypes.c_int] * 20
                                          + [ctypes.c_void_p])
    lib.edt_mbconv_fused_bf16.restype = ctypes.c_int
    return lib
