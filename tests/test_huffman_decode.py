"""device JPEG Huffman decoder (ops/jpeg_huffman_decode_tpu.py) and its
host-side scan model (ops/jpeg_scan.py).

Oracle: libjpeg itself — native.JpegCoefficients must match the
decoded planes EXACTLY (the entropy decode is lossless; there is no
tolerance). Covers the parser, the sequential numpy reference, the
chunked speculative prototype, and the XLA kernel (CPU backend here;
bench.py exercises the real chip)."""
import io
import pathlib

import numpy as np
import pytest

from picha_tpu.native import lib as native
from picha_tpu.ops import jpeg_scan
from picha_tpu.ops.jpeg_huffman_decode_tpu import (ScanBatch,
                                                   decode_planes,
                                                   min_bits_per_symbol)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def _exact(bufs, **kw):
    infos = [jpeg_scan.parse_baseline(bytes(b)) for b in bufs]
    assert all(i is not None for i in infos)
    planes = decode_planes(ScanBatch(infos, **kw))
    assert planes is not None, "decoder did not converge"
    for j, b in enumerate(bufs):
        co = native.JpegCoefficients(bytes(b))
        assert len(planes) == len(co.comps)
        for ci in range(len(planes)):
            want = co.comps[ci]["coefs"].astype(np.int32)
            assert np.array_equal(planes[ci][j], want), (j, ci)
    return infos


def test_parse_reports_geometry():
    rng = np.random.default_rng(0)
    buf = native.jpeg_encode(rng.integers(0, 256, (77, 115, 3), np.uint8),
                             85)
    info = jpeg_scan.parse_baseline(bytes(buf))
    assert (info.width, info.height, info.ncomp) == (115, 77, 3)
    co = native.JpegCoefficients(bytes(buf))
    for ci, (bh, bw, hs, vs) in enumerate(info.comp_sig):
        c = co.comps[ci]
        assert (bh, bw, hs, vs) == (c["blocks_h"], c["blocks_w"],
                                    c["h_samp"], c["v_samp"])


def test_parse_rejects_progressive_and_garbage():
    from PIL import Image as PILImage

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (32, 32, 3), np.uint8)
    b = io.BytesIO()
    PILImage.fromarray(img).save(b, "JPEG", progressive=True)
    assert jpeg_scan.parse_baseline(b.getvalue()) is None
    assert jpeg_scan.parse_baseline(b"\x00" * 64) is None
    assert jpeg_scan.parse_baseline(b"\xff\xd8\xff") is None


def test_reference_decoder_exact():
    rng = np.random.default_rng(1)
    buf = native.jpeg_encode(rng.integers(0, 256, (48, 64, 3), np.uint8),
                             85)
    info = jpeg_scan.parse_baseline(bytes(buf))
    got = jpeg_scan.decode_reference(info)
    co = native.JpegCoefficients(bytes(buf))
    for ci in range(3):
        assert np.array_equal(got[ci], co.comps[ci]["coefs"])


def test_single_component_scan_ignores_sampling_factors():
    """JPEG B.2.3 / libjpeg jdinput.c per_scan_setup: a one-component
    scan has MCU = 1 data unit and the declared sampling factors do not
    shape the scan. Some encoders emit grey files with 2x2 sampling in
    the SOF; the scan model must use libjpeg's geometry (row-major
    blocks, no dummy blocks, restarts counted in blocks), not a
    2x2-block MCU walk."""
    from picha_tpu.ops.jpeg_tpu import quality_tables

    rng = np.random.default_rng(7)
    coefs = rng.integers(-6, 7, (8, 8, 64)).astype(np.int16)
    coefs[..., 0] = rng.integers(-60, 61, (8, 8))
    qluma, _ = quality_tables(85)
    buf = native.jpeg_coef_write(
        64, 64, [{"coefs": coefs, "qtable": qluma,
                  "h_samp": 2, "v_samp": 2}], restart=3)
    info = jpeg_scan.parse_baseline(bytes(buf))
    assert info is not None
    assert info.comps[0][:2] == (1, 1)  # normalized
    assert len(info.segments) == -(-64 // 3)  # restart in 1-block MCUs
    got = jpeg_scan.decode_reference(info)
    want = native.JpegCoefficients(bytes(buf)).comps[0]["coefs"]
    assert np.array_equal(got[0], want)
    _exact([buf])  # device kernel too


def _tpu_encoded_444(w=32, h=32, quality=85, seed=9):
    """A 4:4:4 baseline JPEG authored by the device scan encoder (JFIF
    APP0 header, component ids 1/2/3) from in-gamut planes."""
    import jax.numpy as jnp

    from picha_tpu.ops import jpeg_huffman_tpu as H
    from picha_tpu.ops.jpeg_tpu import _IDCT_A, quality_tables

    rng = np.random.default_rng(seed)
    qluma, qchroma = quality_tables(quality)
    comp_sig = tuple((h // 8, w // 8, 1, 1) for _ in range(3))
    A = np.asarray(_IDCT_A, np.float64)

    def fdct_quant(plane, qt):
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        out = np.zeros((1, bh, bw, 64), np.int32)
        for by in range(bh):
            for bx in range(bw):
                s = plane[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] - 128.0
                out[0, by, bx] = np.round(
                    (A @ s @ A.T) / qt.reshape(8, 8)).astype(np.int32).reshape(64)
        return out

    planes = [np.clip(rng.normal(128, 30, (h, w)), 30, 225) for _ in range(3)]
    coefs = tuple(fdct_quant(p, qluma if i == 0 else qchroma)
                  for i, p in enumerate(planes))
    enc = H.build_scan_encoder(comp_sig, byte_cap=1 << 16)
    scan, nbytes = enc(tuple(jnp.asarray(c) for c in coefs))
    return H.assemble(H.jpeg_header(w, h, comp_sig, quality),
                      np.asarray(scan)[0], int(np.asarray(nbytes)[0]))


def _strip_jfif(buf: bytes) -> bytes:
    """Drop the fixed 18-byte JFIF APP0 our header writer emits."""
    assert buf[2:4] == b"\xff\xe0" and buf[6:11] == b"JFIF\x00"
    return buf[:2] + buf[20:]


def test_colorspace_detection_matches_libjpeg():
    """parse_baseline must reproduce libjpeg default_decompress_parms
    (jdapimin.c): JFIF => YCbCr (even with Adobe present), Adobe
    transform 0 => RGB / 1 => YCbCr, bare component ids 'R','G','B' =>
    RGB — and the device decode must then match libjpeg's pixels (which
    skips the YCbCr transform for RGB-tagged files)."""
    import picha_tpu as picha

    buf = bytes(_tpu_encoded_444())
    assert jpeg_scan.parse_baseline(buf).color_space == 3  # JFIF

    def adobe(transform):
        return (b"\xff\xee" + (14).to_bytes(2, "big") + b"Adobe"
                + bytes([0, 101, 0, 0, 0, 0, transform]))

    # JFIF wins over Adobe (libjpeg checks saw_JFIF_marker first)
    both = buf[:2] + adobe(0) + buf[2:]
    assert jpeg_scan.parse_baseline(both).color_space == 3

    bare = _strip_jfif(buf)
    for transform, cs in ((0, 2), (1, 3)):
        patched = bare[:2] + adobe(transform) + bare[2:]
        assert jpeg_scan.parse_baseline(patched).color_space == cs, transform
        host = picha.decodeJpegSync(patched)
        dev = picha.decodeJpegSync(patched, {"backend": "tpu"})
        d = host.avg_channel_diff(dev)
        assert d <= 1.0, (transform, d)

    # component ids 'R','G','B', no JFIF/Adobe
    ids = bytearray(bare)
    sof = ids.index(b"\xff\xc0")
    sos = ids.index(b"\xff\xda")
    for k, cid in enumerate((82, 71, 66)):
        ids[sof + 10 + 3 * k] = cid
        ids[sos + 5 + 2 * k] = cid
    ids = bytes(ids)
    assert jpeg_scan.parse_baseline(ids).color_space == 2
    host = picha.decodeJpegSync(ids)
    dev = picha.decodeJpegSync(ids, {"backend": "tpu"})
    assert host.avg_channel_diff(dev) <= 1.0


def test_fractional_sampling_routes_to_host():
    """Legal-but-fractional sampling ratios (hmax=3 with hs=2) are not
    implemented by the pixel stages — or by libjpeg, which raises
    'Fractional sampling not implemented'. parse_baseline must reject
    them so every path shares libjpeg's clean error."""
    import picha_tpu as picha
    from picha_tpu.ops.jpeg_tpu import quality_tables

    rng = np.random.default_rng(8)
    qluma, qchroma = quality_tables(85)
    comps = [{"coefs": rng.integers(-4, 5, (1, 3, 64)).astype(np.int16),
              "qtable": qluma, "h_samp": 3, "v_samp": 1},
             {"coefs": rng.integers(-4, 5, (1, 2, 64)).astype(np.int16),
              "qtable": qchroma, "h_samp": 2, "v_samp": 1},
             {"coefs": rng.integers(-4, 5, (1, 1, 64)).astype(np.int16),
              "qtable": qchroma, "h_samp": 1, "v_samp": 1}]
    buf = native.jpeg_coef_write(24, 8, comps)
    assert jpeg_scan.parse_baseline(bytes(buf)) is None
    # libjpeg's COEFFICIENT reader accepts such files (only its pixel
    # path errors), so the device path's own guard must fire
    with pytest.raises(picha.CodecError, match="ampling"):
        picha.decodeJpegSync(buf, {"backend": "tpu"})
    with pytest.raises(picha.CodecError):
        picha.decodeJpegSync(buf)  # host pixel path: libjpeg's error


def test_native_segment_parallel_decoder_exact():
    """jpegentropy.cc (restart-segment-parallel host entropy decode)
    must match libjpeg bit-for-bit across corpora and thread counts:
    restart / no-restart, grey, subsampled colour, odd dims, per-image
    optimized tables, and 1/2/5 threads (thread count must never change
    bytes — segments are independent)."""
    import io

    from PIL import Image as PILImage

    rng = np.random.default_rng(5)
    cases = []
    for (h, w, ri, q) in [(48, 64, 0, 85), (123, 201, 8, 75),
                          (240, 336, 5, 92), (77, 99, 3, 95)]:
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        cases.append(native.jpeg_encode(arr, q, restart=ri))
    grey = rng.integers(0, 256, (64, 80), np.uint8)
    cases.append(native.jpeg_encode(
        np.repeat(grey[..., None], 3, -1), 85, restart=2))
    b = io.BytesIO()
    PILImage.fromarray(rng.integers(0, 256, (90, 130, 3), np.uint8)).save(
        b, "JPEG", optimize=True, quality=80)
    cases.append(b.getvalue())
    for k, buf in enumerate(cases):
        info = jpeg_scan.parse_baseline(bytes(buf))
        assert info is not None, k
        want = native.JpegCoefficients(bytes(buf))
        for nth in (1, 2, 5):
            co = native.jpeg_entropy_decode(info, nthreads=nth)
            assert (co.width, co.height, co.ncomp, co.color_space) == (
                want.width, want.height, want.ncomp, want.color_space)
            for ci in range(co.ncomp):
                for f in ("h_samp", "v_samp", "blocks_w", "blocks_h",
                          "width", "height"):
                    assert co.comps[ci][f] == want.comps[ci][f], (k, ci, f)
                assert np.array_equal(co.comps[ci]["qtable"],
                                      want.comps[ci]["qtable"])
                assert np.array_equal(co.comps[ci]["coefs"],
                                      want.comps[ci]["coefs"]), (k, ci, nth)


def test_native_segment_decoder_corrupt_scans_never_crash():
    """jpegentropy.cc consumes untrusted bitstreams in native code:
    scan-body mutations that survive parse_baseline must decode to
    SOMETHING (garbage-in-garbage-out, like the device kernel) without
    crashing, raising, or writing out of bounds — any thread count.
    (An 8000-mutant soak ran clean; this pins a 400-mutant sample.)"""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (48, 64, 3), np.uint8)
    base = bytearray(native.jpeg_encode(img, 85, restart=4))
    parsed = 0
    for i in range(400):
        buf = bytearray(base)
        for _ in range(rng.integers(1, 8)):
            p = rng.integers(len(buf) // 3, len(buf))
            buf[p] = rng.integers(0, 256)
        info = jpeg_scan.parse_baseline(bytes(buf))
        if info is None:
            continue
        parsed += 1
        co = native.jpeg_entropy_decode(info, nthreads=3)
        for c in co.comps:
            assert c["coefs"].shape == (c["blocks_h"], c["blocks_w"], 64)
    assert parsed > 200  # the mutation scheme must actually reach the decoder


def test_jpeg_coefficients_dispatch():
    """native.jpeg_coefficients picks the segment decoder only when it
    can win (restarts present, >1 thread) and falls back to libjpeg for
    single-segment and non-baseline files — same results either way."""
    import io

    from PIL import Image as PILImage

    rng = np.random.default_rng(6)
    arr = rng.integers(0, 256, (64, 96, 3), np.uint8)
    for buf in (native.jpeg_encode(arr, 85, restart=4),   # segments
                native.jpeg_encode(arr, 85)):             # one segment
        want = native.JpegCoefficients(bytes(buf))
        got = native.jpeg_coefficients(bytes(buf), nthreads=3)
        for ci in range(3):
            assert np.array_equal(got.comps[ci]["coefs"],
                                  want.comps[ci]["coefs"])
    b = io.BytesIO()
    PILImage.fromarray(arr).save(b, "JPEG", progressive=True)
    got = native.jpeg_coefficients(b.getvalue(), nthreads=3)  # libjpeg path
    assert got.ncomp == 3


def test_chunked_prototype_exact_and_converges():
    from picha_tpu.ops.jpeg_scan_chunked import decode_chunked

    rng = np.random.default_rng(2)
    buf = native.jpeg_encode(rng.integers(0, 256, (48, 64, 3), np.uint8),
                             85)
    info = jpeg_scan.parse_baseline(bytes(buf))
    got, passes = decode_chunked(info, C=256)
    co = native.JpegCoefficients(bytes(buf))
    for ci in range(3):
        assert np.array_equal(got[ci], co.comps[ci]["coefs"])
    assert passes < 64


def test_device_kernel_exact_batch():
    rng = np.random.default_rng(3)
    noisy = rng.integers(0, 256, (120, 200, 3), np.uint8)
    smooth = np.clip(
        np.linspace(0, 255, 200)[None, :, None] + np.zeros((120, 1, 3)),
        0, 255).astype(np.uint8)
    _exact([native.jpeg_encode(noisy, 85),
            native.jpeg_encode(smooth, 90),
            native.jpeg_encode(noisy, 40)], chunk_bits=512)


def test_device_kernel_emission_merge_full_branch():
    """The emission-merged chunked path's FULL re-emission branch
    (taken when the changed-entry set outgrows CAP) is unreachable at
    CPU test sizes — force it with the 'fullemit' ablation and pin
    exactness against both libjpeg and the default (compact) branch."""
    import jax.numpy as jnp

    from picha_tpu.ops.jpeg_huffman_decode_tpu import (build_decoder,
                                                       split_planes)

    rng = np.random.default_rng(11)
    bufs = [native.jpeg_encode(
        rng.integers(0, 256, (120, 200, 3), np.uint8), 85)]
    infos = [jpeg_scan.parse_baseline(bytes(b)) for b in bufs]
    sb = ScanBatch(infos, chunk_bits=512)
    assert not sb.single_pass
    args = [jnp.asarray(a) for a in sb.args()]
    out_f, ok_f = build_decoder(*sb.static_key(), ablate="fullemit")(*args)
    assert bool(np.asarray(ok_f))
    out_c, ok_c = build_decoder(*sb.static_key())(*args)
    assert bool(np.asarray(ok_c))
    assert np.array_equal(np.asarray(out_f), np.asarray(out_c))
    co = native.JpegCoefficients(bytes(bufs[0]))
    planes = [np.asarray(p) for p in split_planes(out_f, sb.comp_sig)]
    for ci in range(3):
        assert np.array_equal(planes[ci][0],
                              co.comps[ci]["coefs"].astype(np.int32))


def test_device_kernel_grey_and_odd_dims():
    rng = np.random.default_rng(4)
    _exact([native.jpeg_encode(
        rng.integers(0, 256, (64, 100, 1), np.uint8), 85)])
    _exact([native.jpeg_encode(
        rng.integers(0, 256, (77, 115, 3), np.uint8), 85)])


def test_device_kernel_custom_tables():
    from PIL import Image as PILImage

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (120, 200, 3), np.uint8)
    b = io.BytesIO()
    PILImage.fromarray(img).save(b, "JPEG", quality=80, optimize=True)
    _exact([b.getvalue()], chunk_bits=512)


def test_device_kernel_restart_markers():
    from PIL import Image as PILImage

    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (160, 240, 3), np.uint8)
    for kw in ({"restart_marker_blocks": 7}, {"restart_marker_rows": 2}):
        b = io.BytesIO()
        PILImage.fromarray(img).save(b, "JPEG", quality=85, **kw)
        _exact([b.getvalue()], chunk_bits=512)


def test_device_kernel_fixture():
    _exact([(FIXTURES / "test2.jpg").read_bytes()])


def test_restart_single_pass_mode():
    """Restart-interval corpora take the single-pass (Jacobi-free)
    decoder: one lane per segment, entries exact by construction."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (120, 160, 3), np.uint8)
    bufs = [bytes(native.jpeg_encode(
        np.ascontiguousarray((img.astype(np.int32) + i) % 256,
                             ).astype(np.uint8), 85, restart=8))
            for i in range(3)]
    infos = [jpeg_scan.parse_baseline(b) for b in bufs]
    sb = ScanBatch(infos)
    assert sb.single_pass
    assert bool(sb.lane_pinned.all())
    _exact(bufs)  # exact vs libjpeg through the single-pass kernel
    # without restarts the same content stays on the chunked path
    plain = jpeg_scan.parse_baseline(
        bytes(native.jpeg_encode(img, 85)))
    assert not ScanBatch([plain]).single_pass


def test_single_pass_truncated_flags_fallback():
    """A restart stream with a chopped segment must flag, not crash."""
    rng = np.random.default_rng(12)
    buf = bytearray(native.jpeg_encode(
        rng.integers(0, 256, (64, 64, 3), np.uint8), 85, restart=2))
    cut = bytes(buf[: len(buf) * 2 // 3])
    info = jpeg_scan.parse_baseline(cut)
    if info is None:
        return
    sb = ScanBatch([info])
    planes = decode_planes(sb)
    assert planes is None or planes[0].shape[1:] == (
        info.comp_sig[0][0], info.comp_sig[0][1], 64)


def test_step_budget_bound():
    rng = np.random.default_rng(7)
    buf = native.jpeg_encode(rng.integers(0, 256, (32, 32, 3), np.uint8),
                             85)
    info = jpeg_scan.parse_baseline(bytes(buf))
    mb = min_bits_per_symbol(info)
    assert 2.0 <= mb <= 6.0  # std tables: (2 + 63*3)/64 ~ 2.98


def test_truncated_scan_does_not_crash():
    """Corrupt input must not crash the kernel: either it converges to
    garbage (flagged exact-mismatch at a higher level) or reports
    non-convergence — never raises."""
    rng = np.random.default_rng(8)
    buf = bytearray(native.jpeg_encode(
        rng.integers(0, 256, (64, 64, 3), np.uint8), 85))
    cut = buf[: len(buf) * 2 // 3]  # drop the scan tail (and EOI)
    info = jpeg_scan.parse_baseline(bytes(cut))
    if info is None:
        return
    planes = decode_planes(ScanBatch([info], chunk_bits=512))
    assert planes is None or planes[0].shape[1:] == (
        info.comp_sig[0][0], info.comp_sig[0][1], 64)


def test_pipeline_scan_upload_matches_gap4():
    """upload='scan' (on-chip entropy decode) must match the gap4 path
    bit-for-bit — same coefficients, same pixel stages."""
    from picha_tpu.pipeline import JpegBatchPipeline

    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (96, 144, 3), np.uint8)
    bufs = [native.jpeg_encode(np.roll(img, i, 0), 85) for i in range(3)]
    a = np.asarray(JpegBatchPipeline(width=72, height=48, fused=True,
                                     upload="scan")(bufs))
    b = np.asarray(JpegBatchPipeline(width=72, height=48, fused=True,
                                     upload="gap4")(bufs))
    assert np.array_equal(a, b)


def test_pipeline_scan_upload_encode_identical():
    from picha_tpu.pipeline import JpegBatchPipeline

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (96, 144, 3), np.uint8)
    bufs = [native.jpeg_encode(np.roll(img, i, 0), 85) for i in range(2)]
    kw = dict(width=72, height=48, encode_quality=85,
              encode_backend="raw420", fused=True)
    a = JpegBatchPipeline(upload="scan", **kw)(bufs)
    b = JpegBatchPipeline(upload="gap4", **kw)(bufs)
    assert all(bytes(x) == bytes(y) for x, y in zip(a, b))


def test_pipeline_scan_upload_progressive_fallback():
    """A batch containing a file the device decoder rejects falls back
    to the host entropy path transparently."""
    from PIL import Image as PILImage

    from picha_tpu.pipeline import JpegBatchPipeline

    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (96, 144, 3), np.uint8)
    b = io.BytesIO()
    PILImage.fromarray(img).save(b, "JPEG", quality=85, progressive=True)
    bufs = [native.jpeg_encode(img, 85), b.getvalue()]
    out = np.asarray(JpegBatchPipeline(width=72, height=48, fused=True,
                                       upload="scan")(bufs))
    assert out.shape == (2, 48, 72, 3)
    want = np.asarray(JpegBatchPipeline(width=72, height=48,
                                        fused=True)(bufs))
    assert np.array_equal(out, want)


def test_parse_fuzz_never_crashes():
    """parse_baseline over mutated real JPEGs and random garbage must
    either return a well-formed ScanInfo or None — never raise."""
    rng = np.random.default_rng(13)
    base = bytearray(native.jpeg_encode(
        rng.integers(0, 256, (64, 96, 3), np.uint8), 85, restart=4))
    for trial in range(200):
        buf = bytearray(base)
        kind = trial % 4
        if kind == 0:      # random byte flips
            for _ in range(rng.integers(1, 8)):
                buf[rng.integers(0, len(buf))] = rng.integers(0, 256)
        elif kind == 1:    # truncation
            buf = buf[: rng.integers(2, len(buf))]
        elif kind == 2:    # random garbage with JPEG magic
            buf = bytearray(b"\xff\xd8") + bytearray(
                rng.integers(0, 256, rng.integers(0, 300)).astype(
                    np.uint8).tobytes())
        else:              # marker-soup
            buf = bytearray(b"\xff\xd8") + bytearray(
                b"".join(bytes([0xFF, rng.integers(0, 256), 0, 4])
                         for _ in range(20)))
        info = jpeg_scan.parse_baseline(bytes(buf))
        if info is not None:
            assert info.width > 0 and info.height > 0
            assert len(info.segments) >= 1


def test_decode_fuzz_flagged_or_conforms():
    """Device decode of bit-flipped scans must never crash; results
    either carry the ok flag or are well-formed garbage planes."""
    rng = np.random.default_rng(14)
    base = bytearray(native.jpeg_encode(
        rng.integers(0, 256, (48, 64, 3), np.uint8), 85))
    for _ in range(5):
        buf = bytearray(base)
        for _ in range(3):
            buf[rng.integers(len(buf) // 2, len(buf))] ^= 1 << rng.integers(8)
        info = jpeg_scan.parse_baseline(bytes(buf))
        if info is None:
            continue
        planes = decode_planes(ScanBatch([info], chunk_bits=512))
        if planes is not None:
            for ci, (bh, bw, _, _) in enumerate(info.comp_sig):
                assert planes[ci].shape == (1, bh, bw, 64)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_device_kernel_chroma_samplings(subsampling):
    """4:4:4 (B=3), 4:2:2 (B=4) and 4:2:0 (B=6) MCU structures all
    decode exactly (slot/table cycling differs per sampling)."""
    from PIL import Image as PILImage

    rng = np.random.default_rng(20 + subsampling)
    img = rng.integers(0, 256, (120, 200, 3), np.uint8)
    b = io.BytesIO()
    PILImage.fromarray(img).save(b, "JPEG", quality=85,
                                 subsampling=subsampling)
    _exact([b.getvalue()], chunk_bits=512)


def test_device_kernel_2k_image():
    """Larger geometry (2560x1440, ~14k blocks): exercises multi-MCU-row
    block indexing and int32 bit-position arithmetic at scale."""
    rng = np.random.default_rng(30)
    base = np.clip(
        np.linspace(0, 255, 2560)[None, :, None]
        + rng.normal(0, 12, (1440, 2560, 3)), 0, 255).astype(np.uint8)
    _exact([native.jpeg_encode(base, 85)])


def test_device_kernel_dri_exceeds_mcus():
    """A restart interval larger than the MCU count = one segment."""
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (48, 64, 3), np.uint8)
    buf = native.jpeg_encode(img, 85, restart=10_000)
    info = jpeg_scan.parse_baseline(bytes(buf))
    assert info is not None
    _exact([bytes(buf)], chunk_bits=512)


def test_narrow_batch_dispatch_multicore(monkeypatch):
    """The narrow-batch branch of pipeline.entropy_decode (threads >
    images) must produce libjpeg-identical coefficients through the
    real dispatch path — gated off on this 1-core box, taken on every
    production host."""
    import os

    from picha_tpu.pipeline.jpeg_batch import entropy_decode

    rng = np.random.default_rng(12)
    bufs = [native.jpeg_encode(
        rng.integers(0, 256, (64, 96, 3), np.uint8), 85, restart=4)
        for _ in range(2)]
    want = [native.JpegCoefficients(bytes(b)) for b in bufs]
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    got = entropy_decode(bufs, None)  # 2 bufs < 8 cores -> segment path
    for g, w in zip(got, want):
        for ci in range(3):
            assert np.array_equal(g.comps[ci]["coefs"],
                                  w.comps[ci]["coefs"])
    # budget cap forces the wide-batch libjpeg path instead
    got2 = entropy_decode(bufs, None, max_threads=1)
    for g, w in zip(got2, want):
        assert np.array_equal(g.comps[0]["coefs"], w.comps[0]["coefs"])
    # force_libjpeg pins the reference decoder regardless of width
    got3 = entropy_decode(bufs, None, force_libjpeg=True)
    for g, w in zip(got3, want):
        assert np.array_equal(g.comps[0]["coefs"], w.comps[0]["coefs"])


def test_native_segment_parallel_decoder_thread_scaling():
    """Grounds the multi-core projection (docs/PERFORMANCE.md): the
    segment-parallel decode must actually SCALE with threads — no lock
    convoy, no false sharing serializing the segment loop beyond the
    GIL (which jpegentropy.cc runs outside of via ctypes).

    On a multi-core host: 2 threads must be >=1.2x faster than 1.
    On this 1-core box that is physically impossible (two native
    threads timeshare one core), so the test degrades to the property
    it CAN prove: adding a thread must not cost wall time beyond
    scheduler noise (a contended mutex or shared cache line would).
    Either way thread count never changes bytes (pinned above)."""
    import os
    import time

    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, (512, 768, 3), np.uint8)
    buf = native.jpeg_encode(arr, 90, restart=4)
    info = jpeg_scan.parse_baseline(bytes(buf))
    assert info is not None and len(info.segments) > 32

    def best(nth, reps=5):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            native.jpeg_entropy_decode(info, nthreads=nth)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    best(1)  # warm (page faults, lib load)
    # wall-clock asserts are noisy on a loaded shared machine (advisor
    # r4): retry the whole measurement once before failing, and keep
    # margins generous — this is a lock-convoy tripwire, not a perf
    # benchmark (bench.py owns the published scaling datum).
    for attempt in (0, 1):
        t1, t2 = best(1), best(2)
        if (os.cpu_count() or 1) >= 2:
            ok, msg = (t2 < t1 / 1.15,
                       f"2-thread speedup only {t1 / t2:.2f}x")
        else:
            ok, msg = (t2 < t1 * 2.0,
                       f"2 threads on 1 core cost {t2 / t1:.2f}x serial "
                       "time - lock contention or false sharing in the "
                       "segment loop")
        if ok:
            break
    assert ok, msg
