"""The port's native image loader (``csrc/image_loader.cpp`` built by
``ops/_build.py``, bound in ``vision/loader.py``) against its PIL route
and against the JAX package's loader: bit-identical canvases, the same
metas and sizes, PIL for what the native decoder rejects, the kill switch,
``return_ok``, and a warning, never silence, when the library cannot be
built or loaded."""

import ctypes
import warnings

import numpy as np
import pytest

from image_caption_tpu.vision import loader as JL
from image_caption_tpu_torch.ops import _build
from image_caption_tpu_torch.vision import loader


@pytest.fixture()
def fresh(monkeypatch):
    """The loader with its once-only library check undone (and undone
    again afterwards)."""
    monkeypatch.setattr(loader, "_lib_checked", False)
    monkeypatch.setattr(loader, "_lib", None)
    yield loader
    loader._lib_checked, loader._lib = False, None


@pytest.fixture
def jpeg_dir(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(7)
    paths = []
    for i, (h, w) in enumerate([(480, 640), (375, 500), (640, 480),
                                (333, 500), (52, 37), (1024, 683)]):
        p = str(tmp_path / f"im{i}.jpg")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            p, quality=95)
        paths.append(p)
    return paths


def test_native_route_is_built_here(fresh):
    """g++ and jpeglib.h are present: the native route must come up, with
    no warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fresh.native_available()
    assert fresh._lib is not None


@pytest.mark.parametrize("shape", [(480, 640, 376, 501),
                                   (100, 100, 640, 640),
                                   (7, 9, 3, 5),
                                   (1024, 768, 223, 167),
                                   (33, 47, 201, 99)])
def test_resize_bilinear_bit_exact_vs_pillow(shape):
    """The C++ resample reproduces Pillow's 8-bit bilinear bit for bit on
    up, down and asymmetric scales."""
    from PIL import Image
    h, w, nh, nw = shape
    lib = _build.load("image_loader")
    im = np.random.RandomState(h + nw).randint(0, 256, (h, w, 3), np.uint8)
    out = np.zeros((nh, nw, 3), np.uint8)
    lib.icx_resize_bilinear.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int]
    lib.icx_resize_bilinear.restype = None
    lib.icx_resize_bilinear(im.ctypes.data_as(ctypes.c_void_p), h, w,
                            out.ctypes.data_as(ctypes.c_void_p), nh, nw)
    ref = np.asarray(Image.fromarray(im).resize((nw, nh), Image.BILINEAR))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("rect", [False, True])
def test_batch_matches_pil_and_the_jax_loader(jpeg_dir, rect, fresh):
    """Native decode and letterbox equal the PIL route and the JAX
    package's loader on real JPEGs: canvases bit for bit, metas, sizes."""
    assert fresh.native_available()
    canv, metas, sizes = fresh.load_letterboxed_batch(jpeg_dir, 640,
                                                      rect=rect, nthreads=4)
    assert metas.shape[1] == (5 if rect else 3)
    for i, p in enumerate(jpeg_dir):
        c, m, z = fresh.load_letterboxed(p, 640, rect=rect)
        np.testing.assert_array_equal(canv[i], c)
        np.testing.assert_array_equal(metas[i], m)
        np.testing.assert_array_equal(sizes[i], z)
    jc, jm, jz = JL.load_letterboxed_batch(jpeg_dir, 640, rect=rect,
                                           nthreads=4)
    np.testing.assert_array_equal(canv, jc)
    np.testing.assert_array_equal(metas, jm)
    np.testing.assert_array_equal(sizes, jz)


def test_batch_falls_back_to_pil_for_non_jpeg(tmp_path, fresh):
    from PIL import Image
    assert fresh.native_available()
    rng = np.random.RandomState(3)
    png = str(tmp_path / "a.png")
    Image.fromarray(rng.randint(0, 256, (96, 128, 3), np.uint8)).save(png)
    jpg = str(tmp_path / "b.jpg")
    Image.fromarray(rng.randint(0, 256, (64, 80, 3), np.uint8)).save(jpg)
    canv, metas, sizes = fresh.load_letterboxed_batch([png, jpg], 128)
    for i, p in enumerate([png, jpg]):
        c, m, z = fresh.load_letterboxed(p, 128)
        np.testing.assert_array_equal(canv[i], c)
        np.testing.assert_array_equal(metas[i], m)
        np.testing.assert_array_equal(sizes[i], z)


def test_grayscale_jpeg(tmp_path, fresh):
    """libjpeg's conversion to RGB agrees with PIL's convert('RGB')."""
    from PIL import Image
    assert fresh.native_available()
    p = str(tmp_path / "gray.jpg")
    Image.fromarray(
        np.random.RandomState(5).randint(0, 256, (120, 160), np.uint8),
        mode="L").save(p, quality=95)
    canv, metas, _ = fresh.load_letterboxed_batch([p], 160)
    c, m, _ = fresh.load_letterboxed(p, 160)
    np.testing.assert_array_equal(canv[0], c)
    np.testing.assert_array_equal(metas[0], m)


def test_env_kill_switch(jpeg_dir, monkeypatch, fresh):
    """ICX_NATIVE_LOADER=0 routes every batch through PIL."""
    monkeypatch.setenv("ICX_NATIVE_LOADER", "0")
    assert not fresh.native_available()
    canv, _, _ = fresh.load_letterboxed_batch(jpeg_dir[:2], 320)
    c, _, _ = fresh.load_letterboxed(jpeg_dir[0], 320)
    np.testing.assert_array_equal(canv[0], c)


@pytest.mark.parametrize("native", [True, False])
def test_return_ok_isolates_unreadable_images(jpeg_dir, tmp_path,
                                              monkeypatch, fresh, native):
    """return_ok=True: a corrupt file yields ok=False and a gray canvas on
    both routes, the good rows are untouched; by default it raises."""
    if not native:
        monkeypatch.setenv("ICX_NATIVE_LOADER", "0")
    assert fresh.native_available() == native
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"definitely not an image")
    paths = [jpeg_dir[0], bad, jpeg_dir[1]]
    canv, metas, sizes, ok = fresh.load_letterboxed_batch(
        paths, 320, return_ok=True)
    np.testing.assert_array_equal(ok, [True, False, True])
    assert (canv[1] == 114).all() and metas[1, 0] == 1.0
    ref, _, _ = fresh.load_letterboxed(jpeg_dir[0], 320)
    np.testing.assert_array_equal(canv[0], ref)
    with pytest.raises(Exception):
        fresh.load_letterboxed_batch(paths, 320)


def test_missing_symbol_warns_and_falls_back(jpeg_dir, monkeypatch, fresh):
    """A library without the batch symbol warns, naming the error, and
    PIL loads the batch."""
    class _EmptyLib:                      # loads fine, has no symbols
        def __getattr__(self, name):
            raise AttributeError(name)

    monkeypatch.setattr(_build, "load", lambda name: _EmptyLib())
    with pytest.warns(RuntimeWarning, match="icx_load_letterboxed_batch"):
        assert not fresh.native_available()
    canv, _, _ = fresh.load_letterboxed_batch(jpeg_dir[:1], 320)
    ref, _, _ = fresh.load_letterboxed(jpeg_dir[0], 320)
    np.testing.assert_array_equal(canv[0], ref)


def test_failed_build_warns_and_falls_back(jpeg_dir, tmp_path, monkeypatch,
                                           fresh):
    """A source that does not compile: the warning carries the compiler's
    error, and PIL loads the batch."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "image_loader.cpp").write_text("#error no loader here\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.warns(RuntimeWarning, match="no loader here"):
        assert not fresh.native_available()
    canv, _, _ = fresh.load_letterboxed_batch(jpeg_dir[:2], 320)
    ref, _, _ = fresh.load_letterboxed(jpeg_dir[1], 320)
    np.testing.assert_array_equal(canv[1], ref)


def test_build_links_the_loader_with_its_own_flags(tmp_path, monkeypatch):
    """The loader links -pthread and -ljpeg (after its source), the reward
    scorer does not, and each library's flags enter its hash."""
    cmd = _build._command("image_loader", tmp_path / "x.so")
    src = str(_build.source_path("image_loader"))
    assert "-pthread" in cmd and cmd.index("-ljpeg") > cmd.index(src)
    assert "-ljpeg" not in _build._command("ngram_rewards",
                                           tmp_path / "y.so")
    before = _build.library_path("image_loader")
    monkeypatch.setitem(_build.HOST_LIBS, "image_loader",
                        (("-pthread",), ("-ljpeg", "-lm")))
    assert _build.library_path("image_loader") != before


def test_native_abi_n_zero_returns(fresh):
    """The exported symbol itself tolerates n=0."""
    lib = fresh._native_lib()
    assert lib is not None
    arr = (ctypes.c_char_p * 1)(b"unused")
    lib.icx_load_letterboxed_batch(arr, 0, 64, 0, 32, 4, None, None,
                                   None, None)   # must simply return


@pytest.mark.parametrize("native", [True, False])
def test_empty_batch_returns_empty_arrays(monkeypatch, fresh, native):
    if not native:
        monkeypatch.setenv("ICX_NATIVE_LOADER", "0")
    canv, metas, sizes = fresh.load_letterboxed_batch([], 320)
    assert canv.shape == (0, 320, 320, 3) and metas.shape == (0, 3)
    *_, ok = fresh.load_letterboxed_batch([], 320, rect=True, return_ok=True)
    assert ok.shape == (0,)


def test_etl_uses_batch_loader(tmp_path, monkeypatch):
    """extract_split_features hands the pipeline the loader's letterboxed
    canvases, whichever route is active."""
    import torch
    from PIL import Image
    import image_caption_tpu_torch.vision.etl as etl_mod
    from image_caption_tpu_torch.vision.etl import extract_split_features

    rng = np.random.RandomState(11)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"e{i}.jpg")
        Image.fromarray(rng.randint(0, 256, (60 + 10 * i, 90, 3),
                                    np.uint8)).save(p, quality=95)
        paths.append(p)
    seen = {}

    def fake_extract(params, canvases, metas, sizes, **kw):
        b = canvases.shape[0]
        seen.setdefault("canvases", []).append(canvases.numpy())
        seen.setdefault("metas", []).append(metas.numpy())
        return (torch.zeros((b, 4, 2048)), torch.zeros((b, 4, 84)),
                torch.zeros((b, 4, 4)))

    monkeypatch.setattr(etl_mod, "extract_features_batch", fake_extract)
    feats, _ = extract_split_features(
        paths, extractor_params={}, num_objects=3, batch_size=3,
        num_workers=2, verbose=False, device="cpu")
    assert feats.shape[0] == 3
    c0, m0, _ = loader.load_letterboxed(paths[0], 640)
    np.testing.assert_array_equal(seen["canvases"][0][0], c0)
    np.testing.assert_array_equal(seen["metas"][0][0], m0)
