"""Resize tests.

The matmul formulation is validated against an independent
windowed-loop implementation of the reference algorithm
(src/resize.cc:66-134), plus option-semantics unit checks. The golden
fixture parity test (test2.jpg -> 32x24 vs test2.png, reference
test/resize.js) lives in test_golden.py once the JPEG codec is up.
"""
import numpy as np
import pytest

import picha_tpu as picha
from picha_tpu import Image
from picha_tpu.errors import InvalidOptionsError
from picha_tpu.ops.resize import (DEFAULT_FILTER_SCALE, FILTERS,
                                  parse_resize_options, resize_array,
                                  resize_weights)


def loop_resize(arr, dst_w, dst_h, name, fscale):
    """Direct per-pixel windowed resize — independent oracle."""
    wh = resize_weights(dst_w, arr.shape[1], name, fscale)
    wv = resize_weights(dst_h, arr.shape[0], name, fscale)
    maxv = np.float32(np.iinfo(arr.dtype).max)
    f = arr.astype(np.float32) / maxv
    tmp = np.einsum("ow,hwc->hoc", wh, f)
    out = np.einsum("oh,hwc->owc", wv, tmp)
    return np.floor(np.clip(out * maxv + 0.5, 0, maxv)).astype(arr.dtype)


def test_weights_rows_sum_to_one():
    for name in FILTERS:
        w = resize_weights(17, 53, name, 1.0)
        np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)
        assert w.shape == (17, 53)


def test_weights_band_structure():
    w = resize_weights(10, 100, "cubic", 1.0)
    # downscale 10x with support 2 -> window ~ 2*2*10 = 40 taps
    nz = (w != 0).sum(axis=1)
    assert nz.max() <= 41
    assert nz.min() >= 20


def test_option_semantics():
    # default: cubic at 0.70
    assert parse_resize_options({}) == ("cubic", DEFAULT_FILTER_SCALE)
    # naming a filter resets the scale to 1.0 (resize.cc:180-183)
    assert parse_resize_options({"filter": "lanczos"}) == ("lanczos", 1.0)
    # explicit filterScale wins
    assert parse_resize_options({"filter": "box", "filterScale": 0.5}) == ("box", 0.5)
    assert parse_resize_options({"filterScale": 2.0}) == ("cubic", 2.0)
    with pytest.raises(InvalidOptionsError):
        parse_resize_options({"filter": "gaussian"})
    with pytest.raises(InvalidOptionsError):
        parse_resize_options({"filterScale": 0})


@pytest.mark.parametrize("name", list(FILTERS))
def test_matmul_matches_loop_all_filters(name):
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    got = resize_array(arr, 13, 11, filter=name, filter_scale=1.0)
    want = loop_resize(arr, 13, 11, name, 1.0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_upscale_and_deep():
    rng = np.random.default_rng(8)
    arr = rng.integers(0, 65536, (9, 7, 4), dtype=np.uint16)
    got = resize_array(arr, 21, 17)
    assert got.shape == (17, 21, 4)
    assert got.dtype == np.uint16


def test_image_level_api():
    rng = np.random.default_rng(9)
    img = Image.from_array(
        rng.integers(0, 256, (40, 30, 4), dtype=np.uint8), "rgba")
    out = picha.resizeSync(img, {"width": 15, "height": 20})
    assert (out.width, out.height, out.pixel) == (15, 20, "rgba")
    with pytest.raises(InvalidOptionsError):
        picha.resizeSync(img, {"width": 0, "height": 5})


def test_async_matches_sync():
    rng = np.random.default_rng(10)
    img = Image.from_array(
        rng.integers(0, 256, (20, 20, 3), dtype=np.uint8), "rgb")
    res = {}
    picha.resize(img, {"width": 10, "height": 10},
                 lambda e, r: res.update(e=e, r=r)).result(timeout=60)
    assert res["e"] is None
    assert res["r"].equal_pixels(picha.resizeSync(img, {"width": 10, "height": 10}))


def test_batched_resize():
    rng = np.random.default_rng(11)
    batch = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    got = resize_array(batch, 8, 8)
    single = np.stack([resize_array(b, 8, 8) for b in batch])
    np.testing.assert_array_equal(got, single)


def test_banded_plan_matches_dense():
    # large sizes use the block-banded plan; must match the dense matmul
    from picha_tpu.ops.resize import BANDED_THRESHOLD, resize_weights
    rng = np.random.default_rng(12)
    src_w = BANDED_THRESHOLD + 137  # odd size, forces banded on W only
    arr = rng.integers(0, 256, (40, src_w, 3), dtype=np.uint8)
    got = resize_array(arr, 100, 20)
    # dense reference computed directly
    wh = resize_weights(100, src_w, "cubic", 0.70)
    wv = resize_weights(20, 40, "cubic", 0.70)
    f = arr.astype(np.float32) / 255.0
    want = np.einsum("oh,hwc->owc", wv, np.einsum("ow,hwc->hoc", wh, f))
    want = np.floor(np.clip(want * 255 + 0.5, 0, 255)).astype(np.uint8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_banded_upscale():
    from picha_tpu.ops.resize import BANDED_THRESHOLD
    rng = np.random.default_rng(13)
    src = BANDED_THRESHOLD + 1
    arr = rng.integers(0, 256, (src, 8, 1), dtype=np.uint8)
    out = resize_array(arr, 8, 2 * src)
    assert out.shape == (2 * src, 8, 1)


def test_native_resize_matches_reference_paths():
    """The C++ separable resize (hostresize.cc) must stay within 1 LSB
    of the numpy reference path for every filter, and hit the public
    golden tolerance."""
    from picha_tpu.ops.resize import _resize_native, _resize_numpy
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    for name in ["cubic", "lanczos", "box", "triangle", "catmulrom",
                 "mitchel"]:
        got = _resize_native(img, 37, 23, name, 1.0)
        assert got is not None and got.shape == (23, 37, 3)
        want = _resize_numpy(img, 37, 23, name, 1.0)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1, f"{name}: max diff {d.max()}"


def test_native_resize_golden():
    """decode test2.jpg -> native resize 32x24 -> matches the
    pre-rendered golden (reference test/resize.js:22-30 tolerance)."""
    import picha_tpu as picha
    from conftest import fixture_bytes
    from picha_tpu.ops.resize import _resize_native
    img = picha.decodeJpegSync(fixture_bytes("test2.jpg"))
    out = _resize_native(img.to_array(), 32, 24, "cubic", 0.70)
    golden = picha.decodePngSync(fixture_bytes("test2.png"))
    g = golden.to_array()[:, :, :3].astype(int)
    assert np.abs(out.astype(int) - g).mean() < 2


def test_native_resize_upscale_and_edges():
    from picha_tpu.ops.resize import _resize_native, _resize_numpy
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    got = _resize_native(img, 31, 17, "cubic", 0.70)
    want = _resize_numpy(img, 31, 17, "cubic", 0.70)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_native_resize_deep_u16():
    """16-bit (r16*) images take the native path too (the deep leg of
    reference resize.cc:136-149), within 1 LSB of the numpy path."""
    from picha_tpu.ops.resize import _resize_native, _resize_numpy
    rng = np.random.default_rng(7)
    for ch in (1, 2, 3, 4):
        img = rng.integers(0, 65536, (48, 60, ch), dtype=np.uint16)
        got = _resize_native(img, 29, 21, "cubic", 0.70)
        assert got is not None and got.dtype == np.uint16
        want = _resize_numpy(img, 29, 21, "cubic", 0.70)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # up-scale + single-image API round trip stays uint16
    import picha_tpu as picha
    im = picha.Image.from_array(
        rng.integers(0, 65536, (20, 30, 3), dtype=np.uint16), "r16g16b16")
    out = picha.resizeSync(im, {"width": 45, "height": 31})
    assert out.pixel == "r16g16b16" and (out.width, out.height) == (45, 31)


def test_i16_kernel_matches_f32_within_1():
    """The int16 fixed-point kernel (precision="i16") must stay within
    +-1 of the f32 kernel everywhere and average well under 0.05 LSB;
    windows its q15 guard rejects (upscale taps >= 1.0) must silently
    take the f32 kernel and match exactly."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops.resize import resize_windows

    rng = np.random.default_rng(5)
    # downscale: i16 eligible
    a = rng.integers(0, 256, (120, 160, 3), np.uint8)
    xs, xw = resize_windows(80, 160, "cubic", 0.7)
    ys, yw = resize_windows(60, 120, "cubic", 0.7)
    f = native.resize_u8(a, 80, 60, xs, xw, ys, yw)
    i = native.resize_u8(a, 80, 60, xs, xw, ys, yw, precision="i16")
    d = np.abs(f.astype(int) - i.astype(int))
    assert d.max() <= 1
    assert d.mean() < 0.05
    # identity windows carry a 1.0 tap — unrepresentable in q15, so the
    # guard must trip and the i16 call must equal the f32 kernel exactly
    xs = np.arange(160, dtype=np.int32)
    xw = np.ones((160, 1), np.float32)
    ys = np.arange(120, dtype=np.int32)
    yw = np.ones((120, 1), np.float32)
    f = native.resize_u8(a, 160, 120, xs, xw, ys, yw)
    i = native.resize_u8(a, 160, 120, xs, xw, ys, yw, precision="i16")
    np.testing.assert_array_equal(f, i)
    np.testing.assert_array_equal(f, a)


def test_non_numeric_filter_scale_typed():
    img = picha.Image.from_array(
        np.zeros((8, 8, 3), np.uint8), "rgb")
    with pytest.raises(picha.InvalidOptionsError):
        picha.resizeSync(img, {"width": 4, "height": 4,
                               "filterScale": "abc"})


def test_resize_u8_i16same_dispatch_bit_identical():
    """precision="i16same" (the transpose-free same-size correction
    kernel, used in-C by the draft transcode) must be bit-identical to
    the generic i16 kernel through the Python dispatch — covers the
    ctypes arg wiring of picha_resize_u8_i16_same."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops.fastfix import windows_from_taps
    from picha_tpu.ops.raw420 import DRAFT_YX, DRAFT_YY

    r = np.random.default_rng(3)
    for h, w in ((48, 64), (544, 960), (17, 33)):
        img = r.integers(0, 256, (h, w, 1)).astype(np.uint8)
        xs, xw = windows_from_taps(w, tuple(float(v) for v in DRAFT_YX))
        ys, yw = windows_from_taps(h, tuple(float(v) for v in DRAFT_YY))
        a = native.resize_u8(img, w, h, xs, xw, ys, yw,
                             precision="i16same")
        b = native.resize_u8(img, w, h, xs, xw, ys, yw, precision="i16")
        assert np.array_equal(a, b), (h, w)
