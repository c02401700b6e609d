"""The build routes of the port's C++ batch pipeline
(``efficientdet_tpu_torch.native``) and its self-check at load, on the CPU.

- Route ``pillow`` (the headers vendored in ``native/include`` and the
  libjpeg bundled with pillow, linked by its path) builds here, and its
  ``decode_rgb``, ``image_dims``, ``decode_resize_batch`` and the native
  batches of ``DataLoader`` and ``eval_batches`` are bit-equal to route
  ``system`` (the host's ``jpeglib.h`` and ``-ljpeg``) and to the JAX
  package's library, on baseline 4:4:4 / 4:2:0 / 4:2:2, progressive and
  grayscale JPEGs;
- the route: ``system`` where its probe passes, ``pillow`` where it fails
  (another library name), and ``NativeUnavailable`` naming both failures
  where neither has a libjpeg;
- the self-check: a library built against headers that do not match the
  libjpeg it links (another ``JPEG_LIB_VERSION``; a colour-space enum out of
  order) is refused at load, so 'on' raises and 'auto' takes the Python
  path, instead of every image failing over to it one by one;
- the vendored headers are the host's, byte for byte.

Every library is built into a directory of this module's
(``EDT_NATIVE_BUILD_DIR``), apart from any other process's build. The
module skips where the host has no ``jpeglib.h`` and ``-ljpeg`` or no
pillow with its bundled libjpeg.
"""

import os
from pathlib import Path
from typing import NamedTuple

import cv2
import numpy as np
import pytest

from efficientdet_tpu import data as jax_data
from efficientdet_tpu import native as jax_native_mod
from efficientdet_tpu.data import loader as jax_loader
from efficientdet_tpu_torch import data as port_data
from efficientdet_tpu_torch import native
from efficientdet_tpu_torch.data import loader as port_loader
from test_torch_port_native import (LOADER_SIZE, SHAPES,
                                    _assert_batches_equal, _voc_pair,
                                    _write_jpeg, write_voc)

HEADERS = ("jpeglib.h", "jmorecfg.h", "jconfig.h")
HOST_HEADERS = {"jpeglib.h": "/usr/include/jpeglib.h",
                "jmorecfg.h": "/usr/include/jmorecfg.h",
                "jconfig.h": "/usr/include/x86_64-linux-gnu/jconfig.h"}


class Opened(NamedTuple):
    jpeg: native.LibJpeg
    lib: object


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    """Both packages build into this module's directory, and the JAX
    package's library state is reset for the module (put back after)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDT_NATIVE_BUILD_DIR",
                  str(tmp_path_factory.mktemp("native_build")))
        mp.setattr(jax_native_mod, "_LIB", None)
        mp.setattr(jax_native_mod, "_TRIED", False)
        yield


@pytest.fixture(scope="module")
def routes(build_dir):
    """Both routes' libraries, built, loaded and self-checked here."""
    try:
        system = native.system_libjpeg()
        pillow = native.pillow_libjpeg()
    except native.NativeUnavailable as e:
        pytest.skip(f"a route has no libjpeg on this host: {e}")
    opened = {jpeg.route: Opened(jpeg, native.open_library(jpeg))
              for jpeg in (system, pillow)}
    # linked by pillow's own name, found through the rpath
    assert pillow.path.name.encode() in native.library_path(
        pillow).read_bytes()
    return opened


@pytest.fixture(scope="module")
def jax_native(routes):
    assert jax_native_mod.available()
    return jax_native_mod


def on_route(monkeypatch, opened: Opened):
    """Make ``opened`` this process's route and library."""
    monkeypatch.setattr(native, "_libjpeg", opened.jpeg)
    monkeypatch.setattr(native, "_result", opened.lib)


# ------------------------------------------------------------- the files
def _encode(path, img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    Path(path).write_bytes(buf.tobytes())


def _sample(h, w, seed):
    """Smooth colour ramps with noise, so that every encoding keeps work
    for the IDCT and the upsampling."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x * 255 / w, y * 255 / h, (x + y) * 127 / (h + w)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 24, 0, 255).astype(np.uint8)


Q, S = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
ENCODINGS = {
    # name: (shape, cv2.imencode parameters); "grayscale" is one channel
    "baseline_444": ((375, 500), (Q, 95, S,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
    "baseline_420": ((333, 500), (Q, 75, S,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
    "baseline_422": ((241, 317), (Q, 50, S,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
    "progressive": ((500, 375), (Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
    "grayscale": ((200, 301), (Q, 85)),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> path: the JPEGs of ``test_torch_port_native`` (cv2 at
    quality 95), the repository's demo JPEG, and the encodings above."""
    d = tmp_path_factory.mktemp("encodings")
    out = {}
    for i, (h, w) in enumerate(SHAPES):
        out[f"fixture_{i}"] = str(d / f"fixture_{i}.jpg")
        _write_jpeg(out[f"fixture_{i}"], i, h, w)
    out["demo"] = os.path.join(os.path.dirname(__file__), os.pardir, "docs",
                               "demo_minivoc20.jpg")
    for k, (name, ((h, w), params)) in enumerate(ENCODINGS.items()):
        img = _sample(h, w, 100 + k)
        if name == "grayscale":
            img = img[:, :, 1]
        out[name] = str(d / f"{name}.jpg")
        _encode(out[name], img, *params)
    return out


FILES = [f"fixture_{i}" for i in range(len(SHAPES))] + ["demo",
                                                        *ENCODINGS]


# ----------------------------------------------------- (a) route pillow
@pytest.mark.parametrize("name", FILES)
def test_pillow_route_decodes_as_system_and_jax(routes, jax_native, files,
                                                monkeypatch, name):
    """``decode_rgb`` and ``image_dims`` of the pillow route bit-equal to
    the system route's and the JAX package's library."""
    path = files[name]
    got = {}
    for route in ("system", "pillow"):
        on_route(monkeypatch, routes[route])
        got[route] = (native.decode_rgb(path), native.image_dims(path))
    want = jax_native.decode_rgb(path)
    assert want is not None and want.shape[2] == 3
    h, w = want.shape[:2]
    for route, (rgb, dims) in got.items():
        assert dims == jax_native.image_dims(path) == (w, h), route
        assert rgb.dtype == np.uint8
        np.testing.assert_array_equal(rgb, want, err_msg=route)


@pytest.mark.parametrize("size", [512, 384, 640])
def test_pillow_route_batches_as_system_and_jax(routes, jax_native, files,
                                                monkeypatch, size):
    """``decode_resize_batch`` over every file, alternate ones flipped, on
    three threads: images, scales and ok bit-equal in all three."""
    paths = [files[n] for n in FILES]
    flips = [k % 2 == 1 for k in range(len(paths))]
    want = jax_native.decode_resize_batch(paths, size, flips, threads=3)
    assert want[2].all()
    for route in ("system", "pillow"):
        on_route(monkeypatch, routes[route])
        got = native.decode_resize_batch(paths, size, flips, threads=3)
        assert got[0].shape == (len(paths), size, size, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=route)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """VOC2007 trainval of 7 images, one EXIF-rotated and one PNG."""
    return write_voc(tmp_path_factory.mktemp("voc"),
                     {("2007", "trainval"): 7},
                     bad=[("2007", "trainval", 2, "exif6"),
                          ("2007", "trainval", 5, "png")], seed=3)


def test_pillow_route_data_loader_as_jax(routes, jax_native, voc,
                                         monkeypatch):
    """Two epochs of ``DataLoader(native='on', flip_prob=0.5)`` on the
    pillow route bit-equal to the JAX package's, the two unusable files
    made through ``dataset[i]``; its start line names the route."""
    on_route(monkeypatch, routes["pillow"])
    port_ds, jax_ds = _voc_pair(voc, True)
    kw = dict(batch_size=3, shuffle=True, max_boxes=6, seed=11,
              image_size=LOADER_SIZE, flip_prob=0.5, native="on",
              drop_last=False)
    got_loader = port_data.DataLoader(port_ds, **kw)
    want_loader = jax_data.DataLoader(jax_ds, **kw)
    assert got_loader.native_active and want_loader._native
    assert f"libjpeg: {routes['pillow'].jpeg}" in got_loader.data_path()
    assert "pillow's libjpeg-turbo" in got_loader.data_path()
    for _ in range(2):
        _assert_batches_equal(list(got_loader), list(want_loader))
    assert got_loader.native_fallbacks == 4


def test_pillow_route_eval_batches_as_jax(routes, jax_native, voc,
                                          monkeypatch):
    """``eval_batches(native='on')`` on the pillow route bit-equal to the
    JAX package's, the padded last batch included."""
    on_route(monkeypatch, routes["pillow"])
    port_ds, jax_ds = _voc_pair(voc, False)
    got_it = port_loader.eval_batches(port_ds, 3, LOADER_SIZE, "on")
    got = list(got_it)
    want = list(jax_loader.eval_batches(jax_ds, 3, LOADER_SIZE, "on"))
    assert got_it.native_active and got_it.native_fallbacks == 2
    assert len(got) == len(want) == 3
    for (gi, gx, gs), (wi, wx, ws) in zip(got, want):
        assert gi == wi
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gs, ws)


# ------------------------------------------------------ (b) route choice
@pytest.fixture
def fresh(monkeypatch, build_dir):
    """No route or library decided yet in this process (put back after)."""
    monkeypatch.setattr(native, "_libjpeg", None)
    monkeypatch.setattr(native, "_result", None)
    return native


MISSING = "-ljpeg_absent_for_this_test"


def _system_probe_fails():
    """The system route's probe as on a host without libjpeg: the linker
    cannot find the library."""
    native.probe((MISSING,))
    raise AssertionError("the probe linked a missing library")


def test_pillow_route_where_the_system_probe_fails(routes, fresh, voc,
                                                   monkeypatch):
    """The system probe failing, the process takes route pillow: another
    library name than route system's, built, self-checked, and serving
    'on'."""
    monkeypatch.setattr(native, "system_libjpeg", _system_probe_fails)
    jpeg = native.libjpeg()
    assert jpeg.route == "pillow" and jpeg.include == native.INCLUDE
    assert jpeg.path == routes["pillow"].jpeg.path and jpeg.version == 62
    assert jpeg.turbo.startswith("libjpeg-turbo version ")
    assert native.libjpeg_version() == jpeg
    assert (native.library_path(jpeg)
            != native.library_path(routes["system"].jpeg))
    assert native.library_path() == native.library_path(jpeg)
    assert native.available()
    ds, _ = _voc_pair(voc, False)
    batches = port_loader.eval_batches(ds, 4, LOADER_SIZE, "on")
    assert "pillow's libjpeg-turbo" in batches.data_path()
    assert sum(len(idx) for idx, _, _ in batches) == len(ds)


@pytest.mark.parametrize("pillow", ["empty_dir", "no_pil"])
def test_no_route_names_both_failures(fresh, voc, monkeypatch, tmp_path,
                                      pillow):
    """Neither route: ``NativeUnavailable`` names the system probe's
    linker error and where pillow's libjpeg was looked for; 'on' raises
    it, 'auto' takes the Python path."""
    monkeypatch.setattr(native, "system_libjpeg", _system_probe_fails)
    monkeypatch.setattr(native, "pillow_libs",
                        lambda: tmp_path if pillow == "empty_dir" else None)
    where = (f"no libjpeg-\\*\\.so\\.62\\* in {tmp_path}"
             if pillow == "empty_dir" else "PIL is not installed")
    for call in (native.libjpeg, native.load):
        with pytest.raises(native.NativeUnavailable) as err:
            call()
        assert MISSING.replace("-l", "") in str(err.value)
        assert "route system" in str(err.value)
        assert "route pillow" in str(err.value)
        assert pytest.raises(native.NativeUnavailable, call).match(where)
    assert native.libjpeg_version() is None and not native.available()
    ds, _ = _voc_pair(voc, False)
    with pytest.raises(native.NativeUnavailable, match="route pillow"):
        port_data.DataLoader(ds, batch_size=2, image_size=LOADER_SIZE,
                             native="on")
    auto = port_data.DataLoader(ds, batch_size=2, image_size=LOADER_SIZE,
                                native="auto")
    assert not auto.native_active and "Python" in auto.data_path()


# ----------------------------------------------------- (c) self-check
def _mismatched_headers(directory: Path, fault: str) -> Path:
    """The vendored headers in ``directory``, with ``JPEG_LIB_VERSION`` 80
    or with ``JCS_RGB`` and ``JCS_YCbCr`` swapped in the enum."""
    for name in HEADERS:
        (directory / name).write_bytes((native.INCLUDE / name).read_bytes())
    if fault == "lib_version_80":
        name, swaps = "jconfig.h", [("JPEG_LIB_VERSION  62",
                                     "JPEG_LIB_VERSION  80")]
    else:
        name, swaps = "jpeglib.h", [("JCS_RGB,", "@"), ("JCS_YCbCr,",
                                                        "JCS_RGB,"),
                                    ("@", "JCS_YCbCr,")]
    text = (directory / name).read_text()
    for old, new in swaps:
        assert old in text
        text = text.replace(old, new, 1)
    (directory / name).write_text(text)
    return directory


@pytest.mark.parametrize("fault", ["lib_version_80", "colour_enum_swapped"])
def test_self_check_refuses_mismatched_headers(routes, fresh, voc,
                                               monkeypatch, tmp_path, fault):
    """Headers that do not match pillow's libjpeg build a library that
    loads; the self-check refuses it, naming the library and the headers:
    ``available()`` False, 'on' raises, and 'auto' takes the Python path
    with no native batch."""
    include = _mismatched_headers(tmp_path, fault)
    bad = native.pillow_libjpeg(include)
    assert bad.version == (80 if fault == "lib_version_80" else 62)
    monkeypatch.setattr(native, "select_libjpeg", lambda: bad)
    reason = ("the decode failed" if fault == "lib_version_80"
              else "its pixels differ")
    with pytest.raises(native.NativeUnavailable) as err:
        native.load()
    message = str(err.value)
    assert f"libjpeg at {bad.path} does not decode" in message
    assert f"headers at {include}" in message and reason in message
    assert native.library_path(bad).exists()   # it built
    assert not native.available()
    ds, _ = _voc_pair(voc, True)
    kw = dict(batch_size=3, image_size=LOADER_SIZE, flip_prob=0.5)
    with pytest.raises(native.NativeUnavailable, match="does not decode"):
        port_data.DataLoader(ds, native="on", **kw)
    calls = []
    monkeypatch.setattr(port_loader, "native_images",
                        lambda *a: calls.append(a))
    auto = port_data.DataLoader(ds, native="auto", **kw)
    assert not auto.native_active and "Python" in auto.data_path()
    assert len(list(auto)) == len(ds) // 3 and not calls
    assert auto.native_fallbacks == 0


# ----------------------------------------------- (d) the vendored headers
@pytest.mark.parametrize("name", HEADERS)
def test_vendored_headers_are_the_hosts(name):
    """Each vendored header is the host's, byte for byte, where the host
    has it; the licence is beside them."""
    assert (native.INCLUDE / "LICENSE").read_text().count("libjpeg-turbo")
    host = Path(HOST_HEADERS[name])
    if not host.exists():
        pytest.skip(f"no {host} on this host")
    assert (native.INCLUDE / name).read_bytes() == host.read_bytes()
