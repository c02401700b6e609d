"""The C++ host data pipeline: ``ctypes`` binding, build at first use, and
its plain numpy version.

``edt_native.cpp`` decodes a JPEG, resizes its longest side to the target
(bilinear, half-pixel centres: cv2 ``INTER_LINEAR`` float semantics),
optionally flips it, normalizes it as ``p * a + b`` and zero-pads it to a
square, in one pass per image, on a pool of threads, behind a plain C ABI.
It needs a C++ compiler and libjpeg, nothing else: no cv2. ``ctypes``
releases the GIL during each call, so the loader's prefetch thread decodes
while the training or evaluation loop runs.

The library is compiled with ``$CXX`` (default ``g++``) at first use into
``efficientdet_tpu_torch/_build/`` (``$EDT_NATIVE_BUILD_DIR`` overrides it),
under a name that carries a hash of the source, the compiler and the flags,
so a stale library is never loaded. Each process compiles into a temporary
file of its own and renames it into place, so processes that build at once
all load a whole library. ``$EDT_DISABLE_NATIVE`` set to a non-empty value
disables the pipeline. Where the build fails, ``available()`` is False and
every other call raises ``NativeUnavailable`` with the compiler's stderr:
nothing here falls back to another path.

Public API:
    available() -> bool
    load() -> ctypes.CDLL (raises NativeUnavailable)
    libjpeg_version() -> int or None (no jpeglib.h or -ljpeg)
    decode_resize_batch(paths, target, flips, mean, std, threads)
        -> (images (B, S, S, 3) float32, scales (B,) float32, ok (B,) bool)
    image_dims(path) -> (w, h) or None
    decode_rgb(path) -> (H, W, 3) uint8 or None
    resize_normalize_pad_plain(rgb, target, flip, mean, std)
        -> (image (S, S, 3) float32, scale): the plain version of one image's
        resize, flip, normalize and pad, for the tests and ``chip_smoke.py``
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

SOURCE = Path(__file__).resolve().with_name("edt_native.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBS = ("-ljpeg",)


class NativeUnavailable(RuntimeError):
    """The C++ pipeline cannot be built or loaded on this host."""


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def build_dir() -> Path:
    d = os.environ.get("EDT_NATIVE_BUILD_DIR")
    return Path(d) if d else SOURCE.parent.parent / "_build"


def library_path() -> Path:
    """Where the library for the current source, compiler and flags lives."""
    digest = hashlib.sha256(" ".join(
        (compiler(),) + CXX_FLAGS + LIBS).encode())
    digest.update(SOURCE.read_bytes())
    return build_dir() / f"libedt_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    ``NativeUnavailable`` with the compiler's stderr where that fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp",
                               dir=out.parent)
    os.close(fd)
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeUnavailable(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise NativeUnavailable(
                f"{' '.join(cmd)} failed with exit code {proc.returncode}:\n"
                f"{proc.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_PROBE = """#include <cstdio>
#include <jpeglib.h>
int main(int argc, char**) {
  if (argc > 9) jpeg_std_error(nullptr);  // links -ljpeg, never runs
  std::printf("%d\\n", JPEG_LIB_VERSION);
  return 0;
}
"""


def libjpeg_version() -> Optional[int]:
    """``JPEG_LIB_VERSION`` of the libjpeg that ``$CXX`` compiles and links
    the library against, from a one-line probe; None where ``jpeglib.h`` or
    ``-ljpeg`` is missing (or there is no compiler)."""
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "probe.cpp"), os.path.join(tmp, "probe")
        with open(src, "w") as f:
            f.write(_PROBE)
        try:
            subprocess.run([compiler(), "-o", exe, src, *LIBS], check=True,
                           capture_output=True, timeout=120)
            out = subprocess.run([exe], check=True, capture_output=True,
                                 text=True, timeout=60).stdout
        except (OSError, subprocess.SubprocessError):
            return None
    return int(out.strip())


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    intp = ctypes.POINTER(ctypes.c_int)
    lib.edt_decode_resize_batch.restype = ctypes.c_int
    lib.edt_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, u8p,
        f32p, f32p, f32p, f32p, u8p, ctypes.c_int]
    lib.edt_image_dims.restype = ctypes.c_int
    lib.edt_image_dims.argtypes = [ctypes.c_char_p, intp, intp]
    lib.edt_decode_rgb.restype = ctypes.c_int
    lib.edt_decode_rgb.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int]
    return lib


_lock = threading.Lock()
# The loaded library, or the reason it is not, once per process.
_result: Optional[Union[ctypes.CDLL, NativeUnavailable]] = None


def _build_and_load() -> ctypes.CDLL:
    if os.environ.get("EDT_DISABLE_NATIVE"):
        raise NativeUnavailable("the native pipeline is disabled: "
                                "EDT_DISABLE_NATIVE is set")
    path = build()
    try:
        return _declare(ctypes.CDLL(str(path)))
    except OSError as e:
        raise NativeUnavailable(f"cannot load {path}: {e}") from e


def load() -> ctypes.CDLL:
    """The library, built at the first call of the process. Raises
    ``NativeUnavailable`` (the same message on every call) where the build
    or the load failed."""
    global _result
    with _lock:
        if _result is None:
            try:
                _result = _build_and_load()
            except NativeUnavailable as e:
                _result = e
    if isinstance(_result, NativeUnavailable):
        raise NativeUnavailable(str(_result))
    return _result


def available() -> bool:
    """True if the native pipeline built and loaded on this host."""
    try:
        load()
    except NativeUnavailable:
        return False
    return True


def default_threads(n: int) -> int:
    """The threads ``decode_resize_batch`` uses for ``n`` images when not
    told: one per image, at most one per core."""
    return max(1, min(n, os.cpu_count() or 1))


def decode_resize_batch(
    paths: Sequence[str], target: int,
    flips: Optional[Sequence[bool]] = None,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused decode, resize, flip, normalize and pad for a batch of JPEGs.

    Returns (images (B, target, target, 3) float32, scales (B,) float32,
    ok (B,) bool). ``ok[i]`` False means image i could not be made here (not
    a JPEG, corrupt, or rotated by an EXIF orientation other than 1): its
    slot is zero and its scale 1, and the caller makes it by the dataset's
    Python path."""
    lib = load()
    n = len(paths)
    if target <= 0:
        raise ValueError(f"target must be positive, got {target}")
    mean_arr = np.ascontiguousarray(mean, dtype=np.float32)
    std_arr = np.ascontiguousarray(std, dtype=np.float32)
    if mean_arr.shape != (3,) or std_arr.shape != (3,):
        raise ValueError("mean and std take 3 values each")
    flips_arr = np.zeros((n,), dtype=np.uint8)
    if flips is not None:
        if len(flips) != n:
            raise ValueError(f"{len(flips)} flips for {n} paths")
        flips_arr[:] = np.asarray(flips, dtype=np.uint8)
    images = np.empty((n, target, target, 3), dtype=np.float32)
    scales = np.empty((n,), dtype=np.float32)
    ok = np.empty((n,), dtype=np.uint8)
    if n == 0:
        return images, scales, ok.astype(bool)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.edt_decode_resize_batch(
        c_paths, n, target, flips_arr.ctypes.data_as(u8p),
        mean_arr.ctypes.data_as(f32p), std_arr.ctypes.data_as(f32p),
        images.ctypes.data_as(f32p), scales.ctypes.data_as(f32p),
        ok.ctypes.data_as(u8p),
        threads if threads > 0 else default_threads(n))
    return images, scales, ok.astype(bool)


def image_dims(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None for a file that is not
    a readable JPEG."""
    lib = load()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.edt_image_dims(os.fsencode(path), ctypes.byref(w),
                          ctypes.byref(h)):
        return w.value, h.value
    return None


def decode_rgb(path: str) -> Optional[np.ndarray]:
    """The full-resolution RGB uint8 decode the batch pipeline resizes, or
    None where it would give ``ok`` False."""
    lib = load()
    dims = image_dims(path)
    if dims is None:
        return None
    w, h = dims
    out = np.empty((h, w, 3), dtype=np.uint8)
    if not lib.edt_decode_rgb(
            os.fsencode(path),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size):
        return None
    return out


def resize_normalize_pad_plain(
    rgb: np.ndarray, target: int, flip: bool = False,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> Tuple[np.ndarray, float]:
    """The plain numpy version of what ``edt_native.cpp`` does to one
    decoded image (``process_one``), in the same float32 operations: the
    longest side scaled to ``target`` (the other truncated), half-pixel
    bilinear samples (mirrored against the source width when ``flip``),
    ``p * a + b`` with ``a = 1 / (255 std)`` and ``b = -mean / std``, zero
    padding. Returns ((target, target, 3) float32, scale)."""
    f32 = np.float32
    h, w = rgb.shape[:2]
    s = f32(target) / f32(max(h, w))
    if h > w:
        nh, nw = target, int(f32(w) * s)
    else:
        nh, nw = int(f32(h) * s), target
    nh, nw = max(nh, 1), max(nw, 1)

    def samples(n_out, n_in, mirror):
        ratio = f32(n_in) / f32(n_out)
        pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * ratio - f32(0.5)
        if mirror:
            pos = f32(n_in - 1) - pos
        pos = np.minimum(np.maximum(pos, f32(0)), f32(n_in - 1))
        lo = pos.astype(np.int64)
        return lo, np.minimum(lo + 1, n_in - 1), pos - lo.astype(f32)

    x0, x1, fx = samples(nw, w, flip)
    y0, y1, fy = samples(nh, h, False)
    fx, fy = fx[None, :, None], fy[:, None, None]
    one = f32(1)
    src = rgb.astype(f32)
    r0, r1 = src[y0], src[y1]
    v = ((one - fy) * (one - fx) * r0[:, x0] + (one - fy) * fx * r0[:, x1]
         + fy * (one - fx) * r1[:, x0] + fy * fx * r1[:, x1])
    std32 = np.asarray(std, f32)
    a = one / (f32(255) * std32)
    b = -np.asarray(mean, f32) / std32
    out = np.zeros((target, target, 3), f32)
    out[:nh, :nw] = v * a + b
    return out, float(s)
