"""The C++ host data pipeline: ``ctypes`` binding, build at first use, and
its plain numpy version.

``edt_native.cpp`` decodes a JPEG, resizes its longest side to the target
(bilinear, half-pixel centres: cv2 ``INTER_LINEAR`` float semantics),
optionally flips it, normalizes it as ``p * a + b`` and zero-pads it to a
square, in one pass per image, on a pool of threads, behind a plain C ABI.
It needs a C++ compiler and libjpeg, nothing else: no cv2. ``ctypes``
releases the GIL during each call, so the loader's prefetch thread decodes
while the training or evaluation loop runs.

The library is compiled with ``$CXX`` (default ``g++``) at first use, by one
of two routes, decided once per process (``libjpeg()``):

- ``system``: the host's ``jpeglib.h`` and ``-ljpeg``, the JAX package's
  own build; taken wherever a one-line probe compiles, links and runs;
- ``pillow``: taken only where that probe fails. The headers vendored in
  ``include/`` (libjpeg-turbo 2.1.5, ``JPEG_LIB_VERSION`` 62) and the
  libjpeg that pillow's wheel bundles (``pillow.libs/libjpeg-*.so.62*``,
  found without importing PIL), linked by its path with an rpath to its
  directory.

Where neither route has a libjpeg, ``NativeUnavailable`` names both
failures. The library goes into ``efficientdet_tpu_torch/_build/``
(``$EDT_NATIVE_BUILD_DIR`` overrides it), under a name that carries a hash
of the source, the compiler, the flags and the route (for ``pillow`` also
the vendored headers' bytes and the bundled library's path and bytes), so a
stale library is never loaded. Each process compiles into a temporary file
of its own and renames it into place, so processes that build at once all
load a whole library. Once loaded, the library decodes a small JPEG kept in
this module and must give the pixels recorded here (``SELF_CHECK_RGB``): a
header that does not match the library's ABI would otherwise fail every
image, and the loaders would make every image through the dataset's Python
path without a word. ``$EDT_DISABLE_NATIVE`` set to a non-empty value
disables the pipeline. Where the build, the load or the self-check fails,
``available()`` is False and every other call raises ``NativeUnavailable``
with the reason (the compiler's stderr for a failed build): nothing here
falls back to another path.

Public API:
    available() -> bool
    load() -> ctypes.CDLL (raises NativeUnavailable)
    libjpeg() -> LibJpeg: the route and libjpeg of this process (raises)
    libjpeg_version() -> LibJpeg or None: the route a fresh probe finds
    open_library(jpeg) -> ctypes.CDLL: one route's library, checked
    decode_resize_batch(paths, target, flips, mean, std, threads)
        -> (images (B, S, S, 3) float32, scales (B,) float32, ok (B,) bool)
    image_dims(path) -> (w, h) or None
    decode_rgb(path) -> (H, W, 3) uint8 or None
    resize_normalize_pad_plain(rgb, target, flip, mean, std)
        -> (image (S, S, 3) float32, scale): the plain version of one image's
        resize, flip, normalize and pad, for the tests and ``chip_smoke.py``
"""

from __future__ import annotations

import base64
import ctypes
import dataclasses
import hashlib
import importlib.util
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

SOURCE = Path(__file__).resolve().with_name("edt_native.cpp")
INCLUDE = SOURCE.with_name("include")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBS = ("-ljpeg",)


class NativeUnavailable(RuntimeError):
    """The C++ pipeline cannot be built or loaded on this host."""


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def build_dir() -> Path:
    d = os.environ.get("EDT_NATIVE_BUILD_DIR")
    return Path(d) if d else SOURCE.parent.parent / "_build"


@dataclasses.dataclass(frozen=True)
class LibJpeg:
    """The libjpeg the library is built against, and the route to it."""
    route: str                 # "system" or "pillow"
    path: Optional[Path]       # the library file (system: as -ljpeg finds it)
    version: int               # JPEG_LIB_VERSION of the headers compiled with
    turbo: Optional[str]       # "libjpeg-turbo version x.y.z", from its bytes
    include: Optional[Path] = None   # the headers' directory (pillow route)

    def flags(self) -> Tuple[str, ...]:
        """The compiler's arguments after the source file."""
        if self.route == "system":
            return LIBS
        return ("-I", str(self.include), str(self.path),
                f"-Wl,-rpath,{self.path.parent}")

    def __str__(self) -> str:
        owner = "the system's" if self.route == "system" else "pillow's"
        name = (self.turbo.replace(" version", "") if self.turbo
                else "libjpeg")
        headers = f", headers {self.include}" if self.include else ""
        return (f"{owner} {name} at {self.path or '-ljpeg'} "
                f"(JPEG_LIB_VERSION {self.version}{headers})")


_PROBE = """#include <cstdio>
#include <jpeglib.h>
int main(int argc, char**) {
  if (argc > 9) jpeg_std_error(nullptr);  // links libjpeg, never runs
  std::printf("%d\\n", JPEG_LIB_VERSION);
  return 0;
}
"""
_TURBO = re.compile(rb"libjpeg-turbo version [0-9][0-9.]*")


def probe(flags: Sequence[str]) -> int:
    """``JPEG_LIB_VERSION`` from a one-line program that ``$CXX`` compiles
    and links with ``flags`` and that runs; raises ``NativeUnavailable``
    with the command and its stderr where any of that fails."""
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "probe.cpp"), os.path.join(tmp, "probe")
        with open(src, "w") as f:
            f.write(_PROBE)
        cmd = [compiler(), "-o", exe, src, *flags]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=120)
            out = subprocess.run([exe], check=True, capture_output=True,
                                 text=True, timeout=60).stdout
        except subprocess.CalledProcessError as e:
            raise NativeUnavailable(
                f"{' '.join(e.cmd)} failed with exit code {e.returncode}:\n"
                f"{(e.stderr or '').strip()}") from e
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeUnavailable(f"{' '.join(cmd)}: {e}") from e
    return int(out.strip())


def _turbo_version(path: Optional[Path]) -> Optional[str]:
    if path is None:
        return None
    found = _TURBO.search(path.read_bytes())
    return found.group().decode() if found else None


def system_libjpeg() -> LibJpeg:
    """The ``system`` route: the host's ``jpeglib.h`` and ``-ljpeg``, probed
    (raises ``NativeUnavailable`` with the compiler's stderr)."""
    version = probe(LIBS)
    try:
        found = subprocess.run([compiler(), "-print-file-name=libjpeg.so"],
                               capture_output=True, text=True, timeout=60)
        path = Path(found.stdout.strip()).resolve()
    except (OSError, subprocess.SubprocessError):
        path = None
    path = path if path is not None and path.is_file() else None
    return LibJpeg("system", path, version, _turbo_version(path))


def pillow_libs() -> Optional[Path]:
    """The ``pillow.libs`` directory beside an installed PIL, found without
    importing it; None where PIL is not installed."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    package = Path(list(spec.submodule_search_locations)[0])
    return package.parent / "pillow.libs"


def pillow_libjpeg(include: Path = INCLUDE) -> LibJpeg:
    """The ``pillow`` route: the headers in ``include`` and pillow's bundled
    libjpeg, probed (raises ``NativeUnavailable`` naming where it looked,
    or with the compiler's stderr)."""
    libs = pillow_libs()
    found = sorted(libs.glob("libjpeg-*.so.62*")) if libs else []
    if not found:
        raise NativeUnavailable(
            f"no libjpeg-*.so.62* in {libs}" if libs
            else "PIL is not installed: importlib.util.find_spec('PIL') "
                 "found nothing")
    path = found[0].resolve()
    jpeg = LibJpeg("pillow", path, 0, _turbo_version(path), Path(include))
    return dataclasses.replace(jpeg, version=probe(jpeg.flags()))


def select_libjpeg() -> LibJpeg:
    """The ``system`` route where its probe passes, else ``pillow``; raises
    ``NativeUnavailable`` naming both failures where neither has one."""
    try:
        return system_libjpeg()
    except NativeUnavailable as system:
        try:
            return pillow_libjpeg()
        except NativeUnavailable as pillow:
            raise NativeUnavailable(
                f"no libjpeg to build the C++ pipeline against.\n"
                f"route system (jpeglib.h and -ljpeg): {system}\n"
                f"route pillow (pillow's bundled libjpeg, headers "
                f"{INCLUDE}): {pillow}") from None


def libjpeg_version() -> Optional[LibJpeg]:
    """The route a fresh probe takes (its name, libjpeg's path,
    ``JPEG_LIB_VERSION`` and libjpeg-turbo version string), or None where
    neither route has a libjpeg (or there is no compiler)."""
    try:
        return select_libjpeg()
    except NativeUnavailable:
        return None


def library_path(jpeg: Optional[LibJpeg] = None) -> Path:
    """Where the library for the current source, compiler, flags and
    route (``libjpeg()`` unless given) lives."""
    jpeg = jpeg or libjpeg()
    digest = hashlib.sha256(" ".join(
        (compiler(),) + CXX_FLAGS + jpeg.flags()).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(jpeg.route.encode())
    if jpeg.include is not None:
        for header in sorted(Path(jpeg.include).glob("*.h")):
            digest.update(header.name.encode() + header.read_bytes())
    if jpeg.route == "pillow":
        digest.update(hashlib.sha256(jpeg.path.read_bytes()).digest())
    return build_dir() / f"libedt_native_{digest.hexdigest()[:16]}.so"


def build(jpeg: Optional[LibJpeg] = None) -> Path:
    """Compile the library by ``jpeg``'s route (``libjpeg()`` unless given)
    unless it exists; returns its path. Raises ``NativeUnavailable`` with
    the compiler's stderr where that fails."""
    jpeg = jpeg or libjpeg()
    out = library_path(jpeg)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp",
                               dir=out.parent)
    os.close(fd)
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE), *jpeg.flags()]
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


# A 16 x 8 baseline JPEG, 4:2:0, quality 90 (gradients and a block of red),
# and its RGB pixels as the system route's library decodes them with
# libjpeg-turbo 2.1.5: the load-time self-check.
SELF_CHECK_JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
    "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsN"
    "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/wAAR"
    "CAAIABADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA"
    "AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK"
    "FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE"
    "hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDxHwb+ybN5Cvb6J/aEhwBFkJj3ySP8mvav"
    "hv8AspS3lu73nh/7PKkpAXcpTYAPm3Anvn8qKK/OvrtaOEwle6cqvPe6T+FJqyaa663TOLw7"
    "8SM5lgIZdyU9Gn7TlftNejlzWt5WP//Z")
SELF_CHECK_RGB_B64 = (
    "AAIABwQAGQcAJAQAPAcDRAAAVQQBZQcFcAcMfgYPkAQPogYRsQMNvwcPwwQL0xIXBhoBEyEI"
    "IR8KNhwNURoVbRgbgBEXkA4YnhEiqRYprxcsuh0yxiA20CI72iNC4iZHAjwKE0IWIDoXQTYi"
    "bi8qpjI70CQ65x4+6hlB6B9L0SJJzzNb0jxs1jx460KT8kGbAGARD2IaIFogRlEpe0EztDc/"
    "4yBA/xZD/w9C9RdI1iFK5VF13l2D212M7GCd9GOoAIAOB4AWKoAlUXQwiGI+rj492B8/8RFD"
    "9w8/6xc/0SlA9XJ45H931Htp13lg3n9jAKQTCaEaJ6EqR5I3cX1LhFRGpjtPvzBOzDZBvTIr"
    "rUAr04Beyoxly5dl1Z1g5axnALsRCr4dIcAyOr5RWLt7b7GViq2ppLKjsrZ5q6pQq6pNv7pm"
    "wrl+0cCS4siX6cmWCtQcGtwuJ9g/O9pkSdaRX9u3b9jJhOC7hNRxj9JPreJgud1vzN2Z3+Gy"
    "7eC24c6k")
SELF_CHECK_JPEG = base64.b64decode(SELF_CHECK_JPEG_B64)
SELF_CHECK_RGB = np.frombuffer(base64.b64decode(SELF_CHECK_RGB_B64),
                               np.uint8).reshape(8, 16, 3)


def self_check(lib: ctypes.CDLL, jpeg: LibJpeg) -> None:
    """Decode ``SELF_CHECK_JPEG`` with ``lib``; raises ``NativeUnavailable``
    unless it gives ``SELF_CHECK_RGB`` exactly."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "self_check.jpg")
        with open(path, "wb") as f:
            f.write(SELF_CHECK_JPEG)
        got = _decode_rgb(lib, path)
    if got is None:
        reason = "the decode failed (ok false)"
    elif got.shape != SELF_CHECK_RGB.shape:
        reason = f"it decoded {got.shape}, not {SELF_CHECK_RGB.shape}"
    elif not np.array_equal(got, SELF_CHECK_RGB):
        err = np.abs(got.astype(int) - SELF_CHECK_RGB).max()
        reason = f"its pixels differ from the recorded ones by up to {err}"
    else:
        return
    raise NativeUnavailable(
        f"libjpeg at {jpeg.path or '-ljpeg'} does not decode with the "
        f"headers at {jpeg.include or 'the host include path'} "
        f"({jpeg.route} route, JPEG_LIB_VERSION {jpeg.version}): the "
        f"self-check JPEG: {reason}")


_lock = threading.RLock()
# The route and the loaded library, or the reason there are none; each
# decided once per process.
_libjpeg: Optional[Union[LibJpeg, NativeUnavailable]] = None
_result: Optional[Union[ctypes.CDLL, NativeUnavailable]] = None


def libjpeg() -> LibJpeg:
    """The route and libjpeg of this process (``select_libjpeg``), decided
    at its first call; raises ``NativeUnavailable`` (the same message on
    every call) where there is none."""
    global _libjpeg
    with _lock:
        if _libjpeg is None:
            try:
                _libjpeg = select_libjpeg()
            except NativeUnavailable as e:
                _libjpeg = e
    if isinstance(_libjpeg, NativeUnavailable):
        raise NativeUnavailable(str(_libjpeg))
    return _libjpeg


def open_library(jpeg: LibJpeg) -> ctypes.CDLL:
    """The library of ``jpeg``'s route: built unless it is, loaded and
    self-checked (raises ``NativeUnavailable`` where any of that fails).
    ``load()`` opens this process's route once; the tests open both."""
    path = build(jpeg)
    try:
        lib = _declare(ctypes.CDLL(str(path)))
    except OSError as e:
        raise NativeUnavailable(f"cannot load {path}: {e}") from e
    self_check(lib, jpeg)
    return lib


def _build_and_load() -> ctypes.CDLL:
    if os.environ.get("EDT_DISABLE_NATIVE"):
        raise NativeUnavailable("the native pipeline is disabled: "
                                "EDT_DISABLE_NATIVE is set")
    return open_library(libjpeg())


def load() -> ctypes.CDLL:
    """The library, built and checked at the first call of the process.
    Raises ``NativeUnavailable`` (the same message on every call) where the
    build, the load or the self-check failed."""
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
    """True if the native pipeline built, loaded and passed its self-check
    on this host."""
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


def _image_dims(lib: ctypes.CDLL, path: str) -> Optional[Tuple[int, int]]:
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.edt_image_dims(os.fsencode(path), ctypes.byref(w),
                          ctypes.byref(h)):
        return w.value, h.value
    return None


def _decode_rgb(lib: ctypes.CDLL, path: str) -> Optional[np.ndarray]:
    dims = _image_dims(lib, path)
    if dims is None:
        return None
    w, h = dims
    out = np.empty((h, w, 3), dtype=np.uint8)
    if not lib.edt_decode_rgb(
            os.fsencode(path),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size):
        return None
    return out


def image_dims(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None for a file that is not
    a readable JPEG."""
    return _image_dims(load(), path)


def decode_rgb(path: str) -> Optional[np.ndarray]:
    """The full-resolution RGB uint8 decode the batch pipeline resizes, or
    None where it would give ``ok`` False."""
    return _decode_rgb(load(), path)


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
