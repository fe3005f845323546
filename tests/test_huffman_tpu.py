"""device Huffman encoder vs libjpeg — the scan bytes must be IDENTICAL.

Both sides encode the same quantised coefficients with the standard
Annex K tables (no optimisation, no restart markers), so everything
after SOS up to EOI is deterministic and comparable byte-for-byte.
"""
import numpy as np
import pytest

from conftest import fixture_bytes

from picha_tpu.native import lib as native
from picha_tpu.ops import jpeg_huffman_tpu as H
from picha_tpu.ops import jpeg_tpu


def scan_of(jpeg_bytes: bytes) -> bytes:
    """Bytes between the SOS header and EOI."""
    b = jpeg_bytes
    i = 2
    while i < len(b):
        assert b[i] == 0xFF, "marker desync"
        m = b[i + 1]
        ln = (b[i + 2] << 8) | b[i + 3]
        if m == 0xDA:
            start = i + 2 + ln
            assert b[-2:] == b"\xff\xd9"
            return b[start:-2]
        i += 2 + ln
    raise AssertionError("no SOS")


def tpu_encode_from_coefs(co, quality=85):
    comp_sig = tuple((c["blocks_h"], c["blocks_w"], c["h_samp"], c["v_samp"])
                     for c in co.comps)
    coefs = tuple(np.asarray(c["coefs"], np.int32)[None] for c in co.comps)
    enc = H.build_scan_encoder(comp_sig, byte_cap=1 << 18)
    scan, nbytes = enc(coefs)
    scan, nbytes = np.asarray(scan[0]), int(nbytes[0])
    assert nbytes <= scan.size
    return scan[:nbytes].tobytes()


def libjpeg_encode_from_coefs(co):
    comps = [{"coefs": np.asarray(c["coefs"], np.int16),
              "qtable": np.asarray(c["qtable"], np.uint16),
              "h_samp": c["h_samp"], "v_samp": c["v_samp"]}
             for c in co.comps]
    return native.jpeg_coef_write(co.width, co.height, comps)


@pytest.mark.parametrize("name", ["test2.jpg", "test.jpeg", "test2g.jpg"])
def test_scan_bytes_match_libjpeg_fixture(name):
    co = native.JpegCoefficients(fixture_bytes(name))
    want = scan_of(libjpeg_encode_from_coefs(co))
    got = tpu_encode_from_coefs(co)
    assert got == want


def test_worst_case_content_exact_and_byte_overflow_signals():
    """Incompressible noise at high quality (~50+ packets/block — the
    content class that used to need compaction headroom) is
    byte-identical to libjpeg on the dense per-block path; an
    undersized BYTE budget signals overflow out-of-band instead of
    emitting a corrupt scan."""
    rng = np.random.default_rng(4)
    noisy = rng.integers(0, 256, (192, 192, 3), dtype=np.uint8)
    co = native.JpegCoefficients(native.jpeg_encode(noisy, 97))
    want = scan_of(libjpeg_encode_from_coefs(co))
    got = tpu_encode_from_coefs(co)
    assert got == want
    # a byte_cap below the true scan size must SIGNAL, not corrupt
    comp_sig = tuple((c["blocks_h"], c["blocks_w"], c["h_samp"],
                      c["v_samp"]) for c in co.comps)
    coefs = tuple(np.asarray(c["coefs"], np.int32)[None] for c in co.comps)
    small_cap = max(1024, (len(want) // 2) & ~3)
    tiny = H.build_scan_encoder(comp_sig, byte_cap=small_cap)
    _, n2 = tiny(coefs)
    assert int(n2[0]) > small_cap  # overflow signal, caller falls back


@pytest.mark.parametrize("seed,w,h,c", [(0, 64, 48, 3), (1, 17, 13, 3),
                                        (2, 33, 31, 1), (3, 128, 96, 3)])
def test_scan_bytes_match_libjpeg_synthetic(seed, w, h, c):
    """Random images (odd dims exercise dummy blocks in partial MCUs)."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    buf = native.jpeg_encode(np.repeat(arr, 3, -1) if c == 1 else arr, 90)
    co = native.JpegCoefficients(
        buf if c == 3 else native.jpeg_encode(arr.repeat(3, -1), 90))
    if c == 1:
        # grey: re-encode through the grey path
        import io
        from PIL import Image as PILImage
        b = io.BytesIO()
        PILImage.fromarray(arr[..., 0], "L").save(b, "JPEG", quality=90)
        co = native.JpegCoefficients(b.getvalue())
    want = scan_of(libjpeg_encode_from_coefs(co))
    got = tpu_encode_from_coefs(co)
    assert got == want


def test_full_file_decodes_and_matches_pixels():
    """Header + scan assembles into a JPEG whose decode equals the
    libjpeg coef_write decode exactly."""
    co = native.JpegCoefficients(fixture_bytes("test2.jpg"))
    comp_sig = tuple((c["blocks_h"], c["blocks_w"], c["h_samp"], c["v_samp"])
                     for c in co.comps)
    # reconstruct quality from the qtable is overkill: write DQT from
    # the coefficients' own tables via a custom header
    header = H.jpeg_header(co.width, co.height, comp_sig, 85)
    # NOTE: the fixture's qtable IS quality 85? Not necessarily — build
    # the oracle from coefficients re-encoded with OUR quality tables.
    arr = native.jpeg_decode(fixture_bytes("test2.jpg"), 3,
                             co.width, co.height)
    comps = jpeg_tpu.encode_to_coefficients(arr, 85)
    comp_sig = tuple((c["coefs"].shape[0], c["coefs"].shape[1],
                      c["h_samp"], c["v_samp"]) for c in comps)
    coefs = tuple(np.asarray(c["coefs"], np.int32)[None] for c in comps)
    enc = H.build_scan_encoder(comp_sig, byte_cap=1 << 18)
    scan, nbytes = enc(coefs)
    out = H.assemble(H.jpeg_header(co.width, co.height, comp_sig, 85),
                     np.asarray(scan[0]), int(nbytes[0]))
    mine = native.jpeg_decode(out, 3, co.width, co.height)
    ref = native.jpeg_decode(native.jpeg_coef_write(
        co.width, co.height,
        [{"coefs": np.asarray(c["coefs"], np.int16),
          "qtable": np.asarray(c["qtable"], np.uint16),
          "h_samp": c["h_samp"], "v_samp": c["v_samp"]} for c in comps]),
        3, co.width, co.height)
    np.testing.assert_array_equal(mine, ref)


def test_pipeline_device_encode_matches_tpu_backend():
    """encode_backend='device' (full on-chip encode) must produce the
    same scan bytes as encode_backend='tpu' (device coefficients + host
    libjpeg Huffman) — identical coefficients, identical std tables."""
    from picha_tpu.pipeline import JpegBatchPipeline

    bufs = [fixture_bytes("test2.jpg")] * 3
    dev = JpegBatchPipeline(width=32, height=24, encode_quality=85,
                            encode_backend="device", fused=True,
                            upload="gap8")(bufs)
    host = JpegBatchPipeline(width=32, height=24, encode_quality=85,
                             encode_backend="tpu", fused=True,
                             upload="gap8")(bufs)
    assert len(dev) == len(host) == 3
    for d, h in zip(dev, host):
        assert scan_of(bytes(d)) == scan_of(bytes(h))
        # and the full file decodes identically
        img_d = native.jpeg_decode(bytes(d), 3, 32, 24)
        img_h = native.jpeg_decode(bytes(h), 3, 32, 24)
        np.testing.assert_array_equal(img_d, img_h)


def test_pipeline_device_encode_stream():
    from picha_tpu.pipeline import JpegBatchPipeline

    bufs = [fixture_bytes("test2.jpg")] * 2
    p = JpegBatchPipeline(width=32, height=24, encode_quality=85,
                          encode_backend="device", fused=True,
                          upload="gap8")
    want = p(bufs)
    got = list(p.stream(iter([bufs, bufs]), depth=2))
    assert [bytes(x) for x in got[0]] == [bytes(x) for x in want]
    assert [bytes(x) for x in got[1]] == [bytes(x) for x in want]


def test_440_subsampling_parity_with_libjpeg():
    """4:4:0 (1h2v) upsampling parity: libjpeg-TURBO (the library this
    image links as .so.62) ships h1v2_fancy_upsample — a vertical
    triangle IJG libjpeg does not have — and our decode paths must
    match it (measured: triangle 0.07 LSB, replication 20 LSB). The
    file is authored by our generic scan encoder from IN-GAMUT planes
    (forward DCT of real-range samples): the fused path is a linear
    fold without libjpeg's intermediate sample clipping, so wildly
    out-of-range synthetic coefficients would diverge by design."""
    from picha_tpu.ops.jpeg_fused import _IDCT_A
    from picha_tpu.ops.jpeg_tpu import quality_tables

    rng = np.random.default_rng(11)
    # 32x32: luma (1,2) full-res 4x4 blocks; chroma (1,1) at half
    # vertical resolution, 2x4 blocks
    comp_sig = ((4, 4, 1, 2), (2, 4, 1, 1), (2, 4, 1, 1))
    qluma, qchroma = quality_tables(85)
    qts = [qluma, qchroma, qchroma]

    def fdct_quant(plane, qt):
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        out = np.zeros((1, bh, bw, 64), np.int32)
        A = np.asarray(_IDCT_A, np.float64)  # samples = A.T @ C @ A
        for by in range(bh):
            for bx in range(bw):
                s = plane[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] - 128.0
                C = A @ s @ A.T
                out[0, by, bx] = np.round(
                    C / qt.reshape(8, 8)).astype(np.int32).reshape(64)
        return out

    def smooth(h, w, seed):
        r = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        return (128 + 70 * np.sin(2 * np.pi * (xx * r.uniform(1, 3) / w))
                * np.cos(2 * np.pi * (yy * r.uniform(1, 3) / h))
                + r.normal(0, 4, (h, w)))

    coefs = tuple(
        fdct_quant(np.clip(smooth(bh * 8, bw * 8, 20 + i), 20, 235), qts[i])
        for i, (bh, bw, _, _) in enumerate(comp_sig))
    enc = H.build_scan_encoder(comp_sig, byte_cap=1 << 16)
    scan, nbytes = enc(tuple(__import__("jax").numpy.asarray(c)
                             for c in coefs))
    buf = H.assemble(H.jpeg_header(32, 32, comp_sig, 85),
                     np.asarray(scan)[0], int(np.asarray(nbytes)[0]))
    want = native.jpeg_decode(buf, 3, 32, 32)

    import picha_tpu as picha
    got = picha.decodeJpegSync(buf, {"backend": "tpu"})
    diff = np.abs(np.asarray(got.to_array()).astype(int)
                  - want.astype(int)).mean()
    assert diff <= 1.0, f"staged device 4:4:0 decode diff {diff:.3f} LSB"

    # fused path (decode-only identity resampling) must agree too
    from picha_tpu.pipeline import JpegBatchPipeline
    p = JpegBatchPipeline(fused=True)
    cos = p.entropy_decode([buf])
    sig, args = p.stack_bucket(cos)
    out = np.asarray(p.run_bucket(sig, args))[0]
    fdiff = np.abs(out.astype(int) - want.astype(int)).mean()
    assert fdiff <= 1.0, f"fused 4:4:0 decode diff {fdiff:.3f} LSB"
