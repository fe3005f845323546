"""JPEG codec tests — mirrors reference test/jpeg_codec.js (parameterised
fixtures incl. progressive/grey/CMYK, q100 round-trip < 8, alpha-input
encodes) plus device-path parity vs the host path."""
import numpy as np
import pytest

import picha_tpu as picha
from picha_tpu import Image
from conftest import fixture_bytes

FILES = [
    ("test2.jpg", 76, 50, "rgb"),
    ("test2g.jpg", 76, 50, "grey"),
    ("test2cmyk.jpg", 76, 50, "rgb"),   # CMYK folds to rgb
    ("test.jpeg", 50, 50, "rgb"),       # progressive
]


@pytest.mark.parametrize("name,w,h,pixel", FILES)
def test_stat_and_decode(name, w, h, pixel):
    buf = fixture_bytes(name)
    st = picha.statJpeg(buf)
    assert st == {"width": w, "height": h, "pixel": pixel}
    img = picha.decodeJpegSync(buf)
    assert (img.width, img.height, img.pixel) == (w, h, pixel)


@pytest.mark.parametrize("name,w,h,pixel", FILES)
def test_tpu_path_matches_host(name, w, h, pixel):
    buf = fixture_bytes(name)
    host = picha.decodeJpegSync(buf)
    dev = picha.decodeJpegSync(buf, {"backend": "tpu"})
    assert dev.pixel == host.pixel
    # ≤1 LSB average divergence (IDCT rounding only)
    assert host.avg_channel_diff(dev) <= 1.0


def test_q100_roundtrip():
    img = picha.decodeJpegSync(fixture_bytes("test2.jpg"))
    back = picha.decodeJpegSync(picha.encodeJpegSync(img, {"quality": 100}))
    assert img.avg_channel_diff(back) < 8  # test/jpeg_codec.js:57-69


def test_tpu_encode_roundtrip():
    img = picha.decodeJpegSync(fixture_bytes("test2.jpg"))
    data = picha.encodeJpegSync(img, {"quality": 100, "backend": "tpu"})
    back = picha.decodeJpegSync(data)
    assert img.avg_channel_diff(back) < 8


def test_alpha_input_encodes():
    # encode negotiation converts rgba -> rgb (test/jpeg_codec.js:82-89;
    # intended behaviour of the buggy index.js:48-50)
    rng = np.random.default_rng(0)
    img = Image.from_array(rng.integers(0, 256, (8, 8, 4), np.uint8), "rgba")
    data = picha.encodeJpegSync(img)
    assert picha.decodeJpegSync(data).pixel == "rgb"
    # greya converts to grey (preference map)
    img = Image.from_array(rng.integers(0, 256, (8, 8, 2), np.uint8), "greya")
    assert picha.decodeJpegSync(picha.encodeJpegSync(img)).pixel == "grey"


def test_grey_roundtrip():
    img = picha.decodeJpegSync(fixture_bytes("test2g.jpg"))
    assert img.pixel == "grey"
    back = picha.decodeJpegSync(picha.encodeJpegSync(img, {"quality": 100}))
    assert img.avg_channel_diff(back) < 8


def test_sync_async_identical():
    buf = fixture_bytes("test2.jpg")
    res = {}
    picha.decodeJpeg(buf, lambda e, r: res.update(e=e, r=r)).result(60)
    assert res["e"] is None
    assert res["r"].equal_pixels(picha.decodeJpegSync(buf))
    img = res["r"]
    enc = {}
    picha.encodeJpeg(img, lambda e, r: enc.update(e=e, r=r)).result(60)
    assert enc["r"] == picha.encodeJpegSync(img)


def test_quality_clamps_and_defaults():
    img = picha.decodeJpegSync(fixture_bytes("test2.jpg"))
    # out-of-range quality is clamped (jpegcodec.cc:434-441)
    a = picha.encodeJpegSync(img, {"quality": 150})
    b = picha.encodeJpegSync(img, {"quality": 100})
    assert a == b
    lo = picha.encodeJpegSync(img, {"quality": 5})
    assert len(lo) < len(b)


def test_corrupt_raises():
    with pytest.raises(picha.PichaError):
        picha.decodeJpegSync(b"\xff\xd8\xff\xe0garbage")
    assert picha.statJpeg(b"not a jpeg") is None


def test_pixel_request_extension():
    buf = fixture_bytes("test2.jpg")
    grey = picha.decodeJpegSync(buf, {"pixel": "grey"})
    assert grey.pixel == "grey"
    rgb = picha.decodeJpegSync(fixture_bytes("test2g.jpg"), {"pixel": "rgb"})
    assert rgb.pixel == "rgb"
    with pytest.raises(picha.InvalidOptionsError):
        picha.decodeJpegSync(buf, {"pixel": "rgba"})


def _make_jpeg_with_sampling(h_samp, v_samp):
    """Craft a JPEG with the given luma sampling via the coefficient
    writer (4:2:2 / 4:4:0 have no fixtures)."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops import jpeg_tpu

    rng = np.random.default_rng(3)
    w = h = 64
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.clip(
        np.stack([120 + 90 * np.sin(xx / 5.0),
                  128 + 60 * np.cos(yy / 7.0),
                  128 + 40 * np.sin((xx + yy) / 9.0)], axis=-1)
        + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
    # encode 4:4:4 coefficients then rewrite with subsampled chroma grids
    import jax.numpy as jnp
    y, cb, cr = (np.asarray(v) for v in jpeg_tpu.rgb_to_ycbcr(jnp.asarray(arr)))
    qluma, qchroma = jpeg_tpu.quality_tables(92)

    def plane_coefs(plane, q):
        import jax
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        blocks = jpeg_tpu.plane_to_blocks(jnp.asarray(plane), bh, bw)
        return np.asarray(jpeg_tpu.fdct_quant(blocks, jnp.asarray(q)))

    def sub(plane, fx, fy):
        p = plane.reshape(h // fy, fy, w // fx, fx)
        return ((p.sum(axis=(1, 3)) + fx * fy // 2) // (fx * fy)).astype(np.int32)

    comps = [{"coefs": plane_coefs(y, qluma), "qtable": qluma,
              "h_samp": h_samp, "v_samp": v_samp}]
    for c in (cb, cr):
        comps.append({"coefs": plane_coefs(sub(c, h_samp, v_samp), qchroma),
                      "qtable": qchroma, "h_samp": 1, "v_samp": 1})
    return native.jpeg_coef_write(w, h, comps)


@pytest.mark.parametrize("h_samp,v_samp", [
    # triangle ("fancy") upsample routes in libjpeg-turbo
    (2, 1), (1, 2), (2, 2), (1, 1),
    # int_upsample replication routes (any other integer expansion,
    # jdsample.c) — pins the fused path's per-axis `fancy` routing.
    # 4x4 is omitted: its MCU is 18 blocks > the JPEG limit of 10, and
    # libjpeg rejects it ("Sampling factors too large for interleaved
    # scan")
    (4, 1), (1, 4), (2, 4), (4, 2),
])
def test_tpu_path_sampling_modes(h_samp, v_samp):
    buf = _make_jpeg_with_sampling(h_samp, v_samp)
    host = picha.decodeJpegSync(buf)
    dev = picha.decodeJpegSync(buf, {"backend": "tpu"})
    assert host.avg_channel_diff(dev) <= 1.0

    # fused (decode-only identity resampling) must match the same
    # libjpeg oracle through the linear fold
    from picha_tpu.pipeline import JpegBatchPipeline

    p = JpegBatchPipeline(fused=True)
    cos = p.entropy_decode([buf])
    sig, args = p.stack_bucket(cos)
    out = np.asarray(p.run_bucket(sig, args))[0]
    want = np.asarray(host.to_array())
    fdiff = np.abs(out.astype(int) - want.astype(int)).mean()
    assert fdiff <= 1.0, f"fused {h_samp}x{v_samp} diff {fdiff:.3f} LSB"


def test_progressive_encode_roundtrip():
    """progressive=True writes SOF2 scans (beyond the reference's
    baseline-only encoder) that decode identically to the baseline
    encode of the same pixels at the same quality."""
    rng = np.random.default_rng(11)
    arr = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    img = picha.Image.from_array(arr, "rgb")
    prog = picha.encodeJpegSync(img, {"progressive": True, "quality": 92})
    assert b"\xff\xc2" in prog[:600]          # SOF2: progressive DCT
    base = picha.encodeJpegSync(img, {"quality": 92})
    assert b"\xff\xc2" not in base[:600]
    assert picha.decodeJpegSync(prog).equal_pixels(picha.decodeJpegSync(base))
    with pytest.raises(picha.InvalidOptionsError):
        picha.encodeJpegSync(img, {"progressive": True, "backend": "tpu"})


def test_encode_options_identical_across_backends():
    """subsample/optimize must not silently depend on the backend: the
    host path (libjpeg) honors them like the device branch does."""
    from picha_tpu.ops.jpeg_scan import parse_baseline

    rng = np.random.default_rng(41)
    img = picha.Image.from_array(
        rng.integers(0, 256, (64, 96, 3), np.uint8), "rgb")
    b444 = picha.encodeJpegSync(img, {"quality": 90, "subsample": False})
    b420 = picha.encodeJpegSync(img, {"quality": 90})
    assert [(h, v) for h, v, _ in parse_baseline(bytes(b444)).comps] \
        == [(1, 1)] * 3
    assert parse_baseline(bytes(b420)).comps[0][:2] == (2, 2)
    bopt = picha.encodeJpegSync(img, {"quality": 90, "optimize": True})
    assert len(bopt) < len(b420)  # optimized tables shrink the scan


def test_grey_request_is_y_passthrough_on_tpu_backend():
    """libjpeg's grayscale output from a YCbCr source is the raw Y
    plane; the device path must not round-trip through clipped RGB (which
    diverges by several LSBs on out-of-gamut chroma)."""
    sat = np.zeros((64, 64, 3), np.uint8)
    sat[..., 0] = 255  # pure red: chroma far outside the RGB gamut
    buf = picha.encodeJpegSync(picha.Image.from_array(sat, "rgb"),
                               {"quality": 85})
    host = picha.decodeJpegSync(buf, {"pixel": "grey"})
    dev = picha.decodeJpegSync(buf, {"pixel": "grey", "backend": "tpu"})
    assert host.avg_channel_diff(dev) <= 1.0


def test_option_errors_are_typed_and_surface_through_sniffing():
    rng = np.random.default_rng(43)
    img = picha.Image.from_array(
        rng.integers(0, 256, (16, 16, 3), np.uint8), "rgb")
    buf = picha.encodeJpegSync(img, {"quality": 85})
    with pytest.raises(picha.InvalidOptionsError):
        picha.encodeJpegSync(img, {"quality": "high"})
    with pytest.raises(picha.InvalidOptionsError):
        picha.decodeJpegSync(buf, {"scaleDenom": None})
    # a recognized buffer with bad options must NOT be masked as
    # 'unsupported image file' by the sniffing fall-through
    with pytest.raises(picha.InvalidOptionsError):
        picha.decodeSync(buf, {"scaleDenom": 3})
    with pytest.raises(picha.InvalidOptionsError):
        picha.encodeWebPSync(img, {"quality": "best"})
