"""The port's C++ batch pipeline (``efficientdet_tpu_torch.native``) and
the loaders that drive it, against the JAX package's, on the CPU.

Both libraries are built here from their own sources with the host's g++
and libjpeg (the JAX package's into a private directory through its own
``EDT_NATIVE_BUILD_DIR``); every case skips where ``jpeglib.h`` or
``-ljpeg`` is missing, and fails where they are present and a build fails.
The JPEGs are written by the tests with cv2.

- ``decode_rgb``, ``image_dims`` and ``decode_resize_batch`` are bit-equal
  to the JAX package's; EXIF-rotated and non-JPEG files give ``ok`` False,
  a zero slot and scale 1 in both;
- ``resize_normalize_pad_plain`` is within 1e-5 of the C++ on the same
  decoded pixels, and within the JAX package's 0.02 of the cv2
  Normalizer -> Augmenter -> Resizer path;
- ``DataLoader(native='on')`` and ``eval_batches(native='auto')`` are
  bit-equal to the JAX package's, fallbacks, flips, resumed epochs and the
  padded last batch included, and count their fallbacks;
- the rules that switch the pipeline on are the JAX package's, and 'on'
  raises where it cannot serve, with the compiler's error where the
  library did not build;
- processes that build the library at once all load a whole one.
"""

import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest

from efficientdet_tpu import data as jax_data
from efficientdet_tpu import native as jax_native_mod
from efficientdet_tpu.data import loader as jax_loader
from efficientdet_tpu_torch import data as port_data
from efficientdet_tpu_torch import native
from efficientdet_tpu_torch.data import loader as port_loader
from chip_smoke import splice_exif_orientation
from test_torch_port_slice import ROOT

SHAPES = [(375, 500), (500, 333), (64, 128), (512, 512)]
# The JAX package's bound between the native pipeline and the cv2 path:
# the two decoders differ by at most 1 LSB, 1 / (255 * 0.225) normalized.
CV2_TOL = 0.02
PLAIN_TOL = 1e-5


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def port_native():
    """The port's library, built here; skips without libjpeg."""
    if native.libjpeg_version() is None:
        pytest.skip("no jpeglib.h or -ljpeg on this host")
    native.load()   # a failed build with libjpeg present fails the tests
    return native


@pytest.fixture(scope="module")
def jax_native_private(tmp_path_factory):
    """The JAX package's library state reset, and its build pointed at a
    directory of this module's (its ``EDT_NATIVE_BUILD_DIR``), so that it
    builds from its source here, apart from any other process's build; put
    back after the module. Where libjpeg is missing it does not build, and
    the JAX package takes its Python path, as the port does."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDT_NATIVE_BUILD_DIR",
                  str(tmp_path_factory.mktemp("jax_native_build")))
        mp.setattr(jax_native_mod, "_LIB", None)
        mp.setattr(jax_native_mod, "_TRIED", False)
        yield jax_native_mod


@pytest.fixture(scope="module")
def jax_native(port_native, jax_native_private):
    """The JAX package's library, built here (after the port's)."""
    assert jax_native_private.available()
    return jax_native_private


@pytest.fixture
def fresh_port_native(monkeypatch):
    """The port's library state and route reset for this test (and put
    back after)."""
    monkeypatch.setattr(native, "_result", None)
    monkeypatch.setattr(native, "_libjpeg", None)
    return native


def _write_jpeg(path, seed, h, w):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(path), img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        paths.append(str(d / f"img{i}.jpg"))
        _write_jpeg(paths[-1], i, h, w)
    return paths


# ------------------------------------------------------- the library alone
def test_decode_rgb_and_dims_bit_equal_to_jax(port_native, jax_native, jpegs):
    for p in jpegs:
        got, want = port_native.decode_rgb(p), jax_native.decode_rgb(p)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        h, w = cv2.imread(p).shape[:2]
        assert port_native.image_dims(p) == jax_native.image_dims(p) == (w, h)
        # the same libjpeg family as cv2's: within 1 LSB
        assert np.abs(got.astype(int)
                      - cv2.imread(p)[:, :, ::-1].astype(int)).max() <= 1


@pytest.mark.parametrize("size", [512, 256])
def test_decode_resize_batch_bit_equal_to_jax(port_native, jax_native, jpegs,
                                              size):
    flips = [False, True, False, True]
    got = port_native.decode_resize_batch(jpegs, size, flips, threads=3)
    want = jax_native.decode_resize_batch(jpegs, size, flips, threads=3)
    assert got[0].shape == (4, size, size, 3) and got[2].all()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _unusable(kind, src, tmp_path):
    path = tmp_path / f"{kind}.jpg"
    if kind == "exif6":
        path.write_bytes(splice_exif_orientation(open(src, "rb").read(), 6))
    else:   # PNG bytes under a .jpg name
        ok, png = cv2.imencode(".png", np.full((32, 48, 3), 9, np.uint8))
        path.write_bytes(png.tobytes())
    return str(path)


@pytest.mark.parametrize("kind", ["exif6", "png"])
def test_unusable_files_give_ok_false(port_native, jax_native, jpegs, kind,
                                      tmp_path):
    """An EXIF orientation other than 1 (cv2 would rotate the image) and a
    file that is no JPEG: ``ok`` False, a zero slot and scale 1, as the
    JAX package gives; an EXIF orientation of 1 decodes as the plain file."""
    bad = _unusable(kind, jpegs[0], tmp_path)
    upright = tmp_path / "upright.jpg"
    upright.write_bytes(splice_exif_orientation(open(jpegs[0], "rb").read(),
                                                1))
    paths = [jpegs[0], bad, str(upright)]
    images, scales, ok = port_native.decode_resize_batch(paths, 128)
    assert ok.tolist() == [True, False, True]
    assert not images[1].any() and scales[1] == 1.0
    np.testing.assert_array_equal(images[0], images[2])
    for g, w in zip((images, scales, ok),
                    jax_native.decode_resize_batch(paths, 128)):
        np.testing.assert_array_equal(g, w)
    assert port_native.decode_rgb(bad) is None
    assert (port_native.image_dims(bad) is None) == (kind == "png")


@pytest.mark.parametrize("size", [512, 384, 256])
def test_plain_version_matches_cpp(port_native, jpegs, size):
    flips = [True, False, True, False]
    images, scales, _ = port_native.decode_resize_batch(jpegs, size, flips)
    for i, p in enumerate(jpegs):
        want, scale = native.resize_normalize_pad_plain(
            port_native.decode_rgb(p), size, flips[i])
        assert scale == scales[i]
        np.testing.assert_allclose(images[i], want, rtol=0, atol=PLAIN_TOL)


@pytest.mark.parametrize("flip", [False, True])
def test_plain_version_matches_cv2_transforms(port_native, jpegs, flip):
    """The plain version against the port's Normalizer -> Augmenter ->
    Resizer on cv2's decode, within the JAX package's bound."""
    for p in jpegs:
        img = cv2.imread(p)[:, :, ::-1].astype(np.float32) / 255.0
        sample = {"img": img, "annot": np.zeros((0, 5), np.float32),
                  "scale": 1.0}
        tf = port_data.Compose([port_data.Normalizer(),
                                port_data.Augmenter(float(flip)),
                                port_data.Resizer(256)])
        want = tf(sample)
        got, scale = native.resize_normalize_pad_plain(
            port_native.decode_rgb(p), 256, flip)
        assert scale == pytest.approx(want["scale"])
        assert np.abs(got - want["img"]).max() < CV2_TOL


# ---------------------------------------------------------------- loaders
VOC_OBJECT = """  <object>
    <name>{name}</name><difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>
"""


def write_voc(root, sets, shapes=((80, 100), (120, 90), (64, 64)),
              bad=(), seed=0):
    """A VOCdevkit under ``root``: ``sets`` maps (year, image set) to an
    image count; image ``k`` of a set has shape ``shapes[k % len]`` and 1-3
    objects. ``bad`` names (year, image set, k, 'exif6' | 'png') files the
    C++ pipeline cannot make."""
    rng = np.random.RandomState(seed)
    bad = {(y, s, k): kind for y, s, k, kind in bad}
    for (year, name), count in sets.items():
        base = root / f"VOC{year}"
        for sub in ("Annotations", os.path.join("ImageSets", "Main"),
                    "JPEGImages"):
            (base / sub).mkdir(parents=True, exist_ok=True)
        ids = [f"{year}_{name}_{k:03d}" for k in range(count)]
        for k, img_id in enumerate(ids):
            h, w = shapes[k % len(shapes)]
            objects = ""
            for _ in range(rng.randint(1, 4)):
                bw, bh = rng.randint(8, w // 2), rng.randint(8, h // 2)
                x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
                objects += VOC_OBJECT.format(
                    name=port_data.VOC_CLASSES[rng.randint(20)], x1=x1,
                    y1=y1, x2=x1 + bw, y2=y1 + bh)
            (base / "Annotations" / f"{img_id}.xml").write_text(
                f"<annotation>\n{objects}</annotation>")
            path = base / "JPEGImages" / f"{img_id}.jpg"
            _write_jpeg(path, rng.randint(1 << 30), h, w)
            kind = bad.get((year, name, k))
            if kind:
                path.write_bytes(open(_unusable(kind, str(path), root), "rb")
                                 .read())
        (base / "ImageSets" / "Main" / f"{name}.txt").write_text(
            "\n".join(ids) + "\n")
    return root


LOADER_SIZE = 96


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """VOC2007 trainval of 7 images, one EXIF-rotated and one PNG."""
    return write_voc(tmp_path_factory.mktemp("voc"),
                     {("2007", "trainval"): 7},
                     bad=[("2007", "trainval", 2, "exif6"),
                          ("2007", "trainval", 5, "png")])


def _voc_pair(root, train):
    sets = [("2007", "trainval")]
    tf = ((lambda pkg: pkg.train_transforms(LOADER_SIZE, seed=4)) if train
          else (lambda pkg: pkg.eval_transforms(LOADER_SIZE)))
    return (port_data.VOCDetection(str(root), sets, transform=tf(port_data)),
            jax_data.VOCDetection(str(root), sets, transform=tf(jax_data)))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_data_loader_bit_equal_to_jax(jax_native, voc):
    """Two epochs of ``DataLoader(native='on', flip_prob=0.5)`` batches
    (images, annotations, scales), the two unusable files made through
    ``dataset[i]``; a loader set to epoch 1 (a resumed run) gives the
    second epoch again."""
    port_ds, jax_ds = _voc_pair(voc, True)
    kw = dict(batch_size=3, shuffle=True, max_boxes=6, seed=7,
              image_size=LOADER_SIZE, flip_prob=0.5, native="on",
              drop_last=False)
    got_loader = port_data.DataLoader(port_ds, **kw)
    want_loader = jax_data.DataLoader(jax_ds, **kw)
    assert got_loader.native_active and want_loader._native
    epochs = []
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        _assert_batches_equal(got, want)
        epochs.append(got)
    assert got_loader.native_fallbacks == 4    # 2 files x 2 epochs
    resumed = port_data.DataLoader(_voc_pair(voc, True)[0], **kw)
    resumed.set_epoch(1)
    _assert_batches_equal(list(resumed), epochs[1])


def test_native_boxes_follow_the_python_transform(port_native, voc):
    """With every image flipped, a native batch's boxes are the cv2 path's
    (x mirrored against the original width, then scaled) and its images
    within ``CV2_TOL``."""
    port_ds, _ = _voc_pair(voc, True)
    port_ds.transform = port_data.train_transforms(LOADER_SIZE, flip_prob=1.0)
    kw = dict(batch_size=7, shuffle=False, max_boxes=6, image_size=LOADER_SIZE,
              flip_prob=1.0)
    nat = next(iter(port_data.DataLoader(port_ds, native="on", **kw)))
    ref = next(iter(port_data.DataLoader(port_ds, native="off", **kw)))
    np.testing.assert_allclose(nat["annotations"], ref["annotations"],
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(nat["scales"], ref["scales"])
    assert np.abs(nat["images"] - ref["images"]).max() < CV2_TOL


def test_eval_batches_bit_equal_to_jax(jax_native, voc):
    """``eval_batches(native='auto', image_size=S)`` in batches of 3 over
    7 images: the padded last batch, and the two unusable files from
    ``dataset[i]``, counted."""
    port_ds, jax_ds = _voc_pair(voc, False)
    got_it = port_loader.eval_batches(port_ds, 3, image_size=LOADER_SIZE,
                                      native="auto")
    got = list(got_it)
    want = list(jax_loader.eval_batches(jax_ds, 3, LOADER_SIZE, "auto"))
    assert got_it.native_active and got_it.native_fallbacks == 2
    assert len(got) == len(want) == 3 and got[-1][0] == [6]
    for (gi, gx, gs), (wi, wx, ws) in zip(got, want):
        assert gi == wi
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gs, ws)
    assert not got[-1][1][1:].any() and (got[-1][2][1:] == 1).all()
    python = list(port_loader.eval_batches(port_ds, 3, image_size=LOADER_SIZE,
                                           native="off"))
    for (_, nx, ns), (_, px, ps) in zip(got, python):
        np.testing.assert_allclose(ns, ps, rtol=1e-6)
        assert np.abs(nx - px).max() < CV2_TOL


class _NoFiles:
    """A dataset that reads no image files (no ``image_path``)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]

    def load_annotations(self, i):
        return self.ds.load_annotations(i)


ACTIVATION = {
    # name: (loader keyword arguments, dataset wrapper)
    "uint8_images": (dict(uint8_images=True), None),
    "cache_ram": (dict(cache="ram"), None),
    "image_size_0": (dict(image_size=0), None),
    "no_image_path": ({}, _NoFiles),
}


@pytest.mark.parametrize("name", list(ACTIVATION))
def test_activation_rules_match_jax(jax_native, voc, name):
    """The settings that keep the pipeline off under 'auto' keep it off in
    both packages; under 'on' the port raises exactly where the JAX package
    refuses, with the reason."""
    extra, wrap = ACTIVATION[name]
    kw = {"batch_size": 2, "image_size": LOADER_SIZE, "flip_prob": 0.5,
          **extra}
    pair = _voc_pair(voc, True)
    port_ds, jax_ds = (wrap(d) for d in pair) if wrap else pair
    assert not port_data.DataLoader(port_ds, native="auto", **kw).native_active
    assert not jax_data.DataLoader(jax_ds, native="auto", **kw)._native
    try:
        jax_data.DataLoader(jax_ds, native="on", **kw)
        jax_refuses = False
    except AssertionError:
        jax_refuses = True
    assert jax_refuses == (name in ("image_size_0", "no_image_path"))
    if jax_refuses:
        with pytest.raises(ValueError, match="cannot serve"):
            port_data.DataLoader(port_ds, native="on", **kw)
    else:
        loader = port_data.DataLoader(port_ds, native="on", **kw)
        assert not loader.native_active and "Python" in loader.data_path()
    if jax_refuses:
        assert not port_loader.eval_batches(
            port_ds, 2, kw["image_size"], "auto").native_active


def _fake_compiler(tmp_path):
    script = tmp_path / "fake-cxx"
    script.write_text("#!/bin/sh\necho 'fake-cxx: jpeglib.h: No such file "
                      "or directory' >&2\nexit 1\n")
    script.chmod(0o755)
    return str(script)


UNAVAILABLE = {
    "disabled": ("EDT_DISABLE_NATIVE", lambda tmp: "1", "EDT_DISABLE_NATIVE"),
    "missing_cxx": ("CXX", lambda tmp: str(tmp / "no-such-g++"),
                    "no-such-g\\+\\+"),
    "compile_error": ("CXX", _fake_compiler, "fake-cxx: jpeglib.h: No such"),
}


@pytest.mark.parametrize("name", list(UNAVAILABLE))
def test_on_raises_with_the_build_error(fresh_port_native, voc, monkeypatch,
                                        tmp_path, name):
    """Where the library cannot be built or is disabled, 'on' raises with
    the reason (the compiler's stderr for a failed build) from the loader,
    ``eval_batches`` and every entry point of the library, on every call;
    'auto' takes the Python path."""
    var, value, match = UNAVAILABLE[name]
    monkeypatch.setenv("EDT_NATIVE_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv(var, value(tmp_path))
    ds, _ = _voc_pair(voc, False)
    for _ in range(2):
        with pytest.raises(native.NativeUnavailable, match=match):
            port_data.DataLoader(ds, batch_size=2, image_size=LOADER_SIZE,
                                 native="on")
    with pytest.raises(native.NativeUnavailable, match=match):
        port_loader.eval_batches(ds, 2, LOADER_SIZE, "on")
    with pytest.raises(native.NativeUnavailable, match=match):
        native.decode_resize_batch([ds.image_path(0)], 64)
    assert not native.available()
    auto = port_data.DataLoader(ds, batch_size=2, image_size=LOADER_SIZE,
                                native="auto")
    assert not auto.native_active and "Python" in auto.data_path()
    assert not list((tmp_path / "build").glob("*.tmp"))


_BUILD_AND_DECODE = textwrap.dedent("""
    import sys
    sys.modules["cv2"] = None
    from efficientdet_tpu_torch import native
    path = native.build()
    images, scales, ok = native.decode_resize_batch([sys.argv[1]], 64)
    assert ok.all() and images.any(), "decode"
    print(path.name)
""")


def test_concurrent_builds_load_a_whole_library(port_native, jpegs, tmp_path):
    """Three processes build into one empty directory at once: each
    compiles into a file of its own and renames it into place, so all
    three load a library that decodes, and no temporary file is left."""
    env = dict(os.environ, EDT_NATIVE_BUILD_DIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_DECODE,
                               jpegs[0]], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert names == {native.library_path().name}
    assert sorted(os.listdir(tmp_path)) == sorted(names)


def test_library_name_follows_source_and_flags(port_native, monkeypatch):
    """A changed compiler or flag names another library, so a stale one is
    never loaded."""
    monkeypatch.delenv("EDT_NATIVE_BUILD_DIR", raising=False)
    path = native.library_path()
    assert path.parent == native.build_dir() and path.exists()
    monkeypatch.setenv("CXX", "clang++")
    assert native.library_path() != path
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path


def test_libjpeg_version_probe(port_native, monkeypatch):
    """The probe reads the header's version, and None without a compiler."""
    assert native.libjpeg_version().version >= 62
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert native.libjpeg_version() is None
