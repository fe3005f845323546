"""Batched pipeline tests: bucket graphs, parity with single-image
paths, training input determinism/resume, prefetch."""
import numpy as np
import pytest

import picha_tpu as picha
from picha_tpu.image import Image
from picha_tpu.pipeline import (JpegBatchPipeline, TrainingInput,
                                map_prefetch, prefetch)
from conftest import fixture_bytes


@pytest.fixture(scope="module")
def jpeg_bufs():
    return [fixture_bytes("test2.jpg")] * 4


def test_batch_decode_matches_single(jpeg_bufs):
    out = np.asarray(JpegBatchPipeline()(jpeg_bufs))
    single = picha.decodeJpegSync(jpeg_bufs[0], {"backend": "tpu"}).to_array()
    assert out.shape[0] == 4
    np.testing.assert_array_equal(out[0], single)
    np.testing.assert_array_equal(out[1], single)


def test_batch_resize_golden(jpeg_bufs):
    out = np.asarray(JpegBatchPipeline(width=32, height=24)(jpeg_bufs))
    golden = picha.decodeSync(fixture_bytes("test2.png"))
    got = Image.from_array(out[0], "rgb")
    assert got.avg_channel_diff(golden) < 2


def test_batch_normalize(jpeg_bufs):
    out = np.asarray(JpegBatchPipeline(width=16, height=16,
                                       normalize=True)(jpeg_bufs))
    assert out.shape == (4, 16, 16, 3)
    assert out.dtype == np.float32
    assert 0.0 <= out.min() and out.max() <= 1.0


def test_batch_reencode(jpeg_bufs):
    encs = JpegBatchPipeline(width=32, height=24, encode_quality=90)(jpeg_bufs)
    assert len(encs) == 4
    img = picha.decodeJpegSync(encs[0])
    assert (img.width, img.height) == (32, 24)
    # deterministic across calls
    encs2 = JpegBatchPipeline(width=32, height=24, encode_quality=90)(jpeg_bufs)
    assert encs[0] == encs2[0]


def test_mixed_signature_decode_only_rejected(jpeg_bufs):
    # without a resize target there is no common output shape
    with pytest.raises(ValueError):
        JpegBatchPipeline()([fixture_bytes("test2.jpg"),
                             fixture_bytes("test.jpeg")])


def test_mixed_signature_bucketed_resize(jpeg_bufs):
    """Heterogeneous batches bucket by signature and reassemble in
    input order (index.js:210-221 any-input contract lifted to
    batches)."""
    mixed = [fixture_bytes("test2.jpg"), fixture_bytes("test.jpeg"),
             fixture_bytes("test2.jpg"), fixture_bytes("test2g.jpg")]
    p = JpegBatchPipeline(width=16, height=12)
    out = np.asarray(p(mixed))
    assert out.shape == (4, 12, 16, 3)
    # each row matches the homogeneous path for the same input
    for i, buf in enumerate(mixed):
        want = np.asarray(JpegBatchPipeline(width=16, height=12)([buf] * 2))[0]
        if want.shape[-1] == 1:
            want = np.repeat(want, 3, axis=-1)
        np.testing.assert_array_equal(out[i], want)


def test_mixed_signature_encode(jpeg_bufs):
    mixed = [fixture_bytes("test2.jpg"), fixture_bytes("test.jpeg")]
    encs = JpegBatchPipeline(width=16, height=12, encode_quality=85)(mixed)
    assert len(encs) == 2
    for e in encs:
        img = picha.decodeJpegSync(e)
        assert (img.width, img.height) == (16, 12)


def test_training_input_mixed_corpus_resumable():
    """Mixed-size corpus: deterministic and resume-identical
    (SURVEY.md §7 hard part (c) done-criterion)."""
    files = ([fixture_bytes("test2.jpg")] * 5
             + [fixture_bytes("test.jpeg")] * 5
             + [fixture_bytes("test2g.jpg")] * 2)
    a = TrainingInput(files, batch=6, crop=40, size=32, seed=3)
    b = TrainingInput(files, batch=6, crop=40, size=32, seed=3)
    first_a = np.asarray(next(a))
    assert first_a.shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(first_a, np.asarray(next(b)))
    saved = a.state()
    c = TrainingInput(files, batch=6, crop=40, size=32, state=saved)
    np.testing.assert_array_equal(np.asarray(next(a)), np.asarray(next(c)))


def test_grey_batch():
    bufs = [fixture_bytes("test2g.jpg")] * 3
    out = np.asarray(JpegBatchPipeline()(bufs))
    assert out.shape == (3, 50, 76, 1)


def test_training_input_deterministic_and_resumable(jpeg_bufs):
    files = jpeg_bufs * 4  # 16 items
    a = TrainingInput(files, batch=4, crop=40, size=32, seed=7)
    b = TrainingInput(files, batch=4, crop=40, size=32, seed=7)
    np.testing.assert_array_equal(np.asarray(next(a)), np.asarray(next(b)))
    # advance a, save state, resume c from it
    second_a = np.asarray(next(a))
    saved = a.state()
    c = TrainingInput(files, batch=4, crop=40, size=32, state=saved)
    third_a = np.asarray(next(a))
    third_c = np.asarray(next(c))
    np.testing.assert_array_equal(third_a, third_c)
    # different seed differs
    d = TrainingInput(files, batch=4, crop=40, size=32, seed=8)
    assert not np.array_equal(np.asarray(next(d)), second_a)


def test_training_input_ks_high_water(jpeg_bufs):
    """The per-signature gap4 ks must be MONOTONE across steps (random
    ROI draws vary in packed size; a ks that shrinks or oscillates
    mints a fresh jit graph per bucket), and inflating it must not change values (padding
    rows are no-op encoded)."""
    files = jpeg_bufs * 4
    a = TrainingInput(files, batch=4, crop=40, size=32, seed=7)
    hist = []
    for _ in range(4):
        out_a = np.asarray(next(a))
        hist.append({k: v for k, v in a._ks_high.items()})
    # monotone per-component k growth across steps
    for prev, cur in zip(hist, hist[1:]):
        for key, (_nb, ks) in prev.items():
            assert key in cur
            for old, new in zip(ks, cur[key][1]):
                assert all(n >= o for n, o in zip(new, old)), (old, new)
    # the converged floors survive a checkpoint resume (state() round-
    # trips through JSON in models/checkpoint.py: tuples become lists)
    import json

    saved = json.loads(json.dumps(a.state()))
    r = TrainingInput(files, batch=4, crop=40, size=32, state=saved)
    assert r._ks_high == a._ks_high
    # seeding inflated floors changes only padding, never values
    b = TrainingInput(files, batch=4, crop=40, size=32, seed=7)
    b._ks_high = {key: (nb, tuple((k1 * 2, k2 * 2, kc * 2)
                                  for (k1, k2, kc) in ks))
                  for key, (nb, ks) in hist[0].items()}
    first_b = np.asarray(next(b))
    c = TrainingInput(files, batch=4, crop=40, size=32, seed=7)
    np.testing.assert_array_equal(first_b, np.asarray(next(c)))


def test_pre_crop_exact_vs_full_decode():
    """DCT-domain ROI pre-crop must reproduce the full-decode pipeline
    EXACTLY on 4:4:4 sources (no chroma resampling: per-block IDCT is
    local, so region decode == full decode on the region): re-derive
    the host window draw, crop the full libjpeg decode, apply the same
    device flip and resize, and compare bit-for-bit."""
    import io

    import jax
    import jax.numpy as jnp
    from PIL import Image as PILImage

    from picha_tpu.ops.resize import resize_f32

    rng = np.random.default_rng(21)
    bufs = []
    for i in range(3):
        arr = rng.integers(0, 256, (96, 112, 3), np.uint8)
        b = io.BytesIO()
        PILImage.fromarray(arr).save(b, "JPEG", quality=92, subsampling=0)
        bufs.append(b.getvalue())
    crop, size, seed = 48, 24, 5
    ti = TrainingInput(bufs, batch=3, crop=crop, size=size, seed=seed)
    got = np.asarray(next(ti))

    # expected: same draws in the same order as _pre_crop_host /
    # _jit_crop_resize_normalize
    perm = np.random.default_rng((seed, 0)).permutation(3)
    host = np.random.default_rng((seed, 0, 0))
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), 0), 0)
    kf = jax.random.split(key, 3)[2]
    flips = np.asarray(jax.random.bernoulli(kf, 0.5, (3,)))
    want = []
    for j, i in enumerate(perm):
        # backend="tpu" IS the training graph's decode stage
        # (jpeg_tpu.build_decode_stage) — bit-identical by construction
        full = np.asarray(
            picha.decodeJpegSync(bufs[i], {"backend": "tpu"}).to_array())
        x = int(host.integers(0, full.shape[1] - crop + 1))
        y = int(host.integers(0, full.shape[0] - crop + 1))
        c = full[y:y + crop, x:x + crop]
        if flips[j]:
            c = c[:, ::-1]
        f = jnp.asarray(c[None]).astype(jnp.float32) / 255.0
        want.append(np.asarray(jnp.clip(
            resize_f32(f, size, size, "cubic", 1.0), 0.0, 1.0))[0])
    # atol = a couple float32 ulps: the batched graph's contraction
    # order differs from this per-image oracle; any crop/flip/decode
    # mistake would be off by >=1/255
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-6)


def test_pre_crop_matches_legacy_when_identity(jpeg_bufs):
    """When the source equals the crop size, the pre-crop region is the
    whole image and the residual offsets are zero — the pre_crop and
    legacy paths must then produce identical batches (same decode, same
    flip key discipline)."""
    from picha_tpu.native import lib as native

    rng = np.random.default_rng(22)
    bufs = [native.jpeg_encode(rng.integers(0, 256, (48, 48, 3), np.uint8),
                               90) for _ in range(4)]
    a = TrainingInput(bufs, batch=4, crop=48, size=32, seed=1,
                      pre_crop=True)
    b = TrainingInput(bufs, batch=4, crop=48, size=32, seed=1,
                      pre_crop=False)
    np.testing.assert_array_equal(np.asarray(next(a)), np.asarray(next(b)))


def test_pre_crop_420_region_pixels():
    """4:2:0 pre-crop: the fine crop window inside the region must
    decode BIT-IDENTICALLY to the same window of the full-frame decode
    (the _crop_region invariant — the region carries >= 1 chroma
    sample of true context around the window, so the fancy upsampler's
    region-border edge-pinning never reaches it). A chroma
    block-indexing slip (off by one 16-px iMCU) would shift content
    and blow the assertion."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops import jpeg_tpu
    from picha_tpu.pipeline.training import _pre_crop_host

    rng = np.random.default_rng(33)
    yy, xx = np.mgrid[0:160, 0:192].astype(np.float64)
    arr = np.clip(np.stack([128 + 70 * np.sin(xx / 13) * np.cos(yy / 9),
                            128 + 60 * np.cos((xx - yy) / 17),
                            128 + 50 * np.sin(yy / 11)], axis=-1)
                  + rng.normal(0, 4, (160, 192, 3)), 0, 255).astype(np.uint8)
    buf = native.jpeg_encode(arr, 90)  # 4:2:0
    co = native.JpegCoefficients(bytes(buf))
    full = np.asarray(jpeg_tpu.decode_coefficients(co))

    crop = 64
    regions, offs = _pre_crop_host([co], crop, np.random.default_rng(7))
    rco = regions[0]
    got = np.asarray(jpeg_tpu.decode_coefficients(rco))
    # re-derive the host window draw (x then y, same rng construction)
    r2 = np.random.default_rng(7)
    x = int(r2.integers(0, co.width - crop + 1))
    y = int(r2.integers(0, co.height - crop + 1))
    yres, xres = (int(v) for v in offs[0])
    assert xres + crop <= rco.width and yres + crop <= rco.height
    np.testing.assert_array_equal(
        got[yres:yres + crop, xres:xres + crop],
        full[y:y + crop, x:x + crop])


def test_pre_crop_window_exact_all_positions():
    """Sweep crop window positions — interior, image corners, the
    aligned/unaligned right edge, the region-snap band — across
    sampling modes (4:2:0 fancy, 4:2:2, 4:4:4, grey). Every position's
    crop window must decode bit-identically to the full-frame decode;
    this is what makes DCT-ROI pre-crop a pure wire-size optimization
    rather than an approximation."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops import jpeg_tpu
    from picha_tpu.pipeline.training import _crop_region

    rng = np.random.default_rng(44)
    yy, xx = np.mgrid[0:120, 0:152].astype(np.float64)
    base = np.clip(np.stack(
        [128 + 90 * np.sin(xx / 5) * np.cos(yy / 7),
         128 + 80 * np.cos((xx + 2 * yy) / 9),
         128 + 70 * np.sin((2 * xx - yy) / 6)], axis=-1)
        + rng.normal(0, 6, (120, 152, 3)), 0, 255).astype(np.uint8)
    crop = 48
    import io

    from PIL import Image as PILImage

    b422 = io.BytesIO()
    PILImage.fromarray(base).save(b422, "JPEG", quality=90, subsampling=1)
    cases = [
        ("420", native.jpeg_encode(base, 90)),
        ("444", native.jpeg_encode(base, 90, subsample=False)),
        ("422", b422.getvalue()),
        ("grey", native.jpeg_encode(
            np.ascontiguousarray(base[..., :1]), 90)),
    ]
    for name, buf in cases:
        co = native.JpegCoefficients(bytes(buf))
        full = np.asarray(jpeg_tpu.decode_coefficients(co))
        w_max, h_max = co.width - crop, co.height - crop
        # positions: corners, 1-px-in (margin clamp), mid, and the
        # snap band near the high edge (both axes), odd offsets
        xs = sorted({0, 1, 2, 17, w_max // 2, w_max - 9, w_max - 1,
                     w_max})
        ys = sorted({0, 1, h_max // 2, h_max - 1, h_max})
        for x in xs:
            for y in ys:
                rco, yr, xr = _crop_region(co, crop, x, y)
                assert xr + crop <= rco.width, (name, x, y)
                assert yr + crop <= rco.height, (name, x, y)
                got = np.asarray(jpeg_tpu.decode_coefficients(rco))
                np.testing.assert_array_equal(
                    got[yr:yr + crop, xr:xr + crop],
                    full[y:y + crop, x:x + crop],
                    err_msg=f"{name} window ({x},{y})")


def test_pre_crop_region_shrinks_wire(jpeg_bufs):
    """The pre-crop region really is iMCU-sized, not the full frame."""
    from picha_tpu.native import lib as native
    from picha_tpu.pipeline.training import _pre_crop_host

    rng = np.random.default_rng(23)
    bufs = [native.jpeg_encode(
        rng.integers(0, 256, (256, 320, 3), np.uint8), 88)]
    cos = [native.JpegCoefficients(b) for b in bufs]
    region, offs = _pre_crop_host(cos, 64, np.random.default_rng(0))
    # fixed span crop + 2 iMCU (context margin for exact chroma)
    assert (region[0].width, region[0].height) == (96, 96)
    assert offs.shape == (1, 2) and (offs >= 0).all() and (offs < 33).all()
    full = sum(c["coefs"].size for c in cos[0].comps)
    small = sum(c["coefs"].size for c in region[0].comps)
    assert small * 8 < full  # >8x fewer coefficients packed/uploaded


def test_training_input_shapes(jpeg_bufs):
    ti = TrainingInput(jpeg_bufs * 2, batch=4, crop=48, size=24, seed=0)
    batch = np.asarray(next(ti))
    assert batch.shape == (4, 24, 24, 3)
    assert batch.dtype == np.float32


def test_prefetch_order_and_completeness():
    items = list(range(20))
    got = list(map_prefetch(lambda x: x * x, items, depth=3))
    assert got == [x * x for x in items]
    assert list(prefetch(iter([]), depth=2)) == []


def test_image_batch_pipeline_crop_resize_encode():
    from picha_tpu.pipeline import ImageBatchPipeline
    bufs = [fixture_bytes("test.png")] * 3
    p = ImageBatchPipeline(crop=(5, 5, 40, 40), resize=(16, 16),
                           encode=("image/webp", {"preset": "lossless"}))
    encs = p(bufs)
    assert len(encs) == 3
    img = picha.decodeWebPSync(encs[0])
    assert (img.width, img.height) == (16, 16)
    # parity with the single-image path: subView -> resize -> webp
    src = picha.decodePngSync(bufs[0])
    want = picha.resizeSync(src.sub_view(5, 5, 40, 40),
                            {"width": 16, "height": 16})
    got = picha.decodeWebPSync(encs[0])
    assert got.avg_channel_diff(want) <= 1.0


def test_image_batch_pipeline_convert_and_tiff():
    from picha_tpu.pipeline import ImageBatchPipeline
    bufs = [fixture_bytes("smallliz.tif")] * 2
    p = ImageBatchPipeline(resize=(32, 32), convert="rgb",
                           encode=("image/tiff", {"compression": "lzw"}))
    encs = p(bufs)
    img = picha.decodeTiffSync(encs[0])
    assert (img.width, img.height, img.pixel) == (32, 32, "rgba")


def test_metrics_counters():
    from picha_tpu.runtime import metrics
    metrics.reset()
    metrics.enable(True)
    try:
        picha.decodePngSync(fixture_bytes("test.png"))
        snap = metrics.snapshot()
        assert snap["decode.png"] == 1
        assert snap["bytes_in"] > 0
        assert snap["decode.png_ms"] > 0
    finally:
        metrics.enable(False)
        metrics.reset()


def test_sparse_upload_matches_dense(jpeg_bufs):
    dense = np.asarray(JpegBatchPipeline(width=32, height=24)(jpeg_bufs))
    sparse = np.asarray(JpegBatchPipeline(width=32, height=24,
                                          upload="sparse")(jpeg_bufs))
    np.testing.assert_array_equal(dense, sparse)


def test_raw420_encode_backend(jpeg_bufs):
    p = JpegBatchPipeline(width=32, height=32, encode_quality=92,
                          encode_backend="raw420")
    encs = p(jpeg_bufs)
    assert len(encs) == 4
    img = picha.decodeJpegSync(encs[0])
    assert (img.width, img.height, img.pixel) == (32, 32, "rgb")
    # quality sanity vs the plain host-encode backend
    ref = JpegBatchPipeline(width=32, height=32, encode_quality=92,
                            encode_backend="host")(jpeg_bufs)
    a = picha.decodeJpegSync(encs[0])
    b = picha.decodeJpegSync(ref[0])
    assert a.avg_channel_diff(b) < 3


def test_raw420_grey(jpeg_bufs):
    bufs = [fixture_bytes("test2g.jpg")] * 2
    p = JpegBatchPipeline(width=32, height=32, encode_quality=92,
                          encode_backend="raw420")
    encs = p(bufs)
    img = picha.decodeJpegSync(encs[0])
    assert (img.width, img.height) == (32, 32)


def test_fused_decode_resize_close_to_staged(jpeg_bufs):
    staged = np.asarray(JpegBatchPipeline(width=38, height=25)(jpeg_bufs))
    fused = np.asarray(JpegBatchPipeline(width=38, height=25,
                                         fused=True)(jpeg_bufs))
    d = np.abs(staged.astype(int) - fused.astype(int))
    assert d.mean() <= 1.0
    assert d.max() <= 16  # isolated ringing pixels may differ more


def test_fused_matches_on_all_fixture_types():
    for name in ["test2.jpg", "test2g.jpg", "test2cmyk.jpg", "test.jpeg"]:
        bufs = [fixture_bytes(name)] * 2
        staged = np.asarray(JpegBatchPipeline(width=30, height=20)(bufs))
        fused = np.asarray(JpegBatchPipeline(width=30, height=20,
                                             fused=True)(bufs))
        d = np.abs(staged.astype(int) - fused.astype(int))
        assert d.mean() <= 1.5, name


def test_fused_golden(jpeg_bufs):
    out = np.asarray(JpegBatchPipeline(width=32, height=24,
                                       fused=True)(jpeg_bufs))
    golden = picha.decodeSync(fixture_bytes("test2.png"))
    got = Image.from_array(out[0], "rgb")
    assert got.avg_channel_diff(golden) < 2


def test_dynamic_batcher(jpeg_bufs):
    from picha_tpu.pipeline import DynamicBatcher
    b = DynamicBatcher(width=24, height=16, max_batch=4, max_delay_ms=20)
    try:
        futs = [b.submit(buf) for buf in jpeg_bufs * 2]
        results = [f.result(timeout=120) for f in futs]
        assert all(r.shape == (16, 24, 3) for r in results)
        # same input -> same output; matches the direct pipeline
        direct = np.asarray(JpegBatchPipeline(width=24, height=16,
                                              fused=True)(jpeg_bufs))
        np.testing.assert_array_equal(results[0], direct[0])
        # mixed signatures batch separately but both resolve
        f1 = b.submit(fixture_bytes("test2g.jpg"))
        assert f1.result(timeout=120).shape == (16, 24, 1)
        # invalid input -> exception on the future, server stays up
        bad = b.submit(b"not a jpeg")
        with pytest.raises(Exception):
            bad.result(timeout=30)
        assert b.submit(jpeg_bufs[0]).result(timeout=120).shape == (16, 24, 3)
    finally:
        b.close()


def test_int8_upload_matches_dense(jpeg_bufs):
    dense = np.asarray(JpegBatchPipeline(width=32, height=24)(jpeg_bufs))
    i8 = np.asarray(JpegBatchPipeline(width=32, height=24,
                                      upload="int8")(jpeg_bufs))
    np.testing.assert_array_equal(dense, i8)
    # also through the fused graph
    df = np.asarray(JpegBatchPipeline(width=32, height=24,
                                      fused=True)(jpeg_bufs))
    i8f = np.asarray(JpegBatchPipeline(width=32, height=24, fused=True,
                                       upload="int8")(jpeg_bufs))
    np.testing.assert_array_equal(df, i8f)


def test_fused_decode_only(jpeg_bufs):
    # fused without a resize target uses identity resampling matrices
    staged = np.asarray(JpegBatchPipeline()(jpeg_bufs))
    fused = np.asarray(JpegBatchPipeline(fused=True)(jpeg_bufs))
    d = np.abs(staged.astype(int) - fused.astype(int))
    assert d.mean() <= 1.0


def test_batcher_survives_cancelled_future(jpeg_bufs):
    from picha_tpu.pipeline import DynamicBatcher
    b = DynamicBatcher(width=16, height=16, max_batch=4, max_delay_ms=50)
    try:
        futs = [b.submit(buf) for buf in jpeg_bufs]
        futs[0].cancel()
        rest = [f.result(timeout=120) for f in futs[1:]]
        assert all(r.shape == (16, 16, 3) for r in rest)
    finally:
        b.close()


def test_fused_large_image_matches_staged():
    # large-geometry fused fold must match the staged path in both
    # scale directions
    from picha_tpu.native import lib as native
    rng = np.random.default_rng(0)
    w = h = 384
    yy, xx = np.mgrid[0:h, 0:w]
    base = (127 + 80 * np.sin(xx / 17.0) + 40 * np.cos(yy / 11.0))
    arr = np.clip(base[..., None] + rng.normal(0, 5, (h, w, 3)), 0,
                  255).astype(np.uint8)
    buf = native.jpeg_encode(arr, 85)
    bufs = [buf] * 2
    staged = np.asarray(JpegBatchPipeline(width=160, height=96)(bufs))
    fused = np.asarray(JpegBatchPipeline(width=160, height=96,
                                         fused=True)(bufs))
    d = np.abs(staged.astype(int) - fused.astype(int))
    assert d.mean() <= 1.0
    # upscale direction too
    staged_up = np.asarray(JpegBatchPipeline(width=500, height=420)(bufs))
    fused_up = np.asarray(JpegBatchPipeline(width=500, height=420,
                                            fused=True)(bufs))
    du = np.abs(staged_up.astype(int) - fused_up.astype(int))
    assert du.mean() <= 1.0


def test_fused_with_tpu_encode_backend(jpeg_bufs):
    p = JpegBatchPipeline(width=32, height=24, encode_quality=90,
                          fused=True, encode_backend="tpu")
    encs = p(jpeg_bufs)
    img = picha.decodeJpegSync(encs[0])
    assert (img.width, img.height) == (32, 24)
    ref = picha.decodeJpegSync(
        JpegBatchPipeline(width=32, height=24, encode_quality=90,
                          encode_backend="host")(jpeg_bufs)[0])
    assert img.avg_channel_diff(ref) < 4


def test_png_batch_pipeline_matches_single():
    from picha_tpu.pipeline.png_batch import PngBatchPipeline
    for name, kwargs in [("test.png", {}), ("test16.png", {"deep": True}),
                         ("greytest.png", {}), ("test16.png", {}),
                         ("test.png", {"pixel": "grey"})]:
        bufs = [fixture_bytes(name)] * 3
        got = np.asarray(PngBatchPipeline(**kwargs)(bufs))
        want = picha.decodePngSync(bufs[0], kwargs).to_array()
        np.testing.assert_array_equal(got[0], want), (name, kwargs)
        np.testing.assert_array_equal(got[1], want)


def test_png_batch_palette():
    import io
    from PIL import Image as PILImage
    from picha_tpu.pipeline.png_batch import PngBatchPipeline
    rng = np.random.default_rng(5)
    bufs = []
    for i in range(3):
        arr = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
        b = io.BytesIO()
        PILImage.fromarray(arr, "RGB").convert(
            "P", palette=PILImage.ADAPTIVE).save(b, format="PNG")
        bufs.append(b.getvalue())
    got = np.asarray(PngBatchPipeline()(bufs))
    for i in range(3):
        want = picha.decodePngSync(bufs[i]).to_array()
        np.testing.assert_array_equal(got[i], want)


def test_image_batch_mimetype_dispatch():
    from picha_tpu.pipeline import ImageBatchPipeline
    bufs = [fixture_bytes("test.png")] * 2
    p = ImageBatchPipeline(resize=(8, 8))
    out = np.asarray(p(bufs, mimetype="image/png"))
    assert out.shape == (2, 8, 8, 4)
    # a corrupt buffer surfaces the codec's real error, not generic sniffing
    bad = bytearray(bufs[0]); bad[bufs[0].find(b"IDAT") + 10] ^= 0xFF
    with pytest.raises(picha.CodecError):
        p([bytes(bad)], mimetype="image/png")


def test_gap8_upload_matches_dense(jpeg_bufs):
    dense = np.asarray(JpegBatchPipeline(width=32, height=24)(jpeg_bufs))
    g8 = np.asarray(JpegBatchPipeline(width=32, height=24,
                                      upload="gap8")(jpeg_bufs))
    np.testing.assert_array_equal(dense, g8)
    df = np.asarray(JpegBatchPipeline(width=32, height=24,
                                      fused=True)(jpeg_bufs))
    g8f = np.asarray(JpegBatchPipeline(width=32, height=24, fused=True,
                                       upload="gap8")(jpeg_bufs))
    np.testing.assert_array_equal(df, g8f)


def test_stream_matches_serial_calls(jpeg_bufs):
    """stream() (stage-overlapped) must produce byte-identical encodes
    to per-batch __call__ — the sync==async contract on the batch API."""
    p = JpegBatchPipeline(width=32, height=24, encode_quality=85,
                          encode_backend="raw420", fused=True,
                          upload="gap8")
    batches = [jpeg_bufs, list(reversed(jpeg_bufs))]
    want = [p(b) for b in batches]
    got = list(p.stream(iter(batches), depth=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [bytes(x) for x in g] == [bytes(x) for x in w]


def test_stream_propagates_errors(jpeg_bufs):
    p = JpegBatchPipeline(width=32, height=24)
    with pytest.raises(Exception):
        list(p.stream(iter([jpeg_bufs, [b"not a jpeg"]]), depth=2))


def _tiff_of(arr, pixel, **opts):
    img = picha.Image.from_array(arr, pixel)
    return picha.encodeTiffSync(img, opts)


@pytest.mark.parametrize("comp", ["none", "lzw", "deflate"])
@pytest.mark.parametrize("pixel", ["rgb", "rgba", "grey", "greya",
                                   "r16g16b16"])
def test_tiff_batch_matches_single(comp, pixel):
    """TiffBatchPipeline (device transforms) must match decodeTiffSync
    per image (SURVEY §7 step 6 done-criterion)."""
    from picha_tpu.pipeline import TiffBatchPipeline
    from picha_tpu.pixels import pixel_format
    rng = np.random.default_rng(hash((comp, pixel)) % 2**32)
    fmt = pixel_format(pixel)
    bufs = []
    for i in range(3):
        arr = rng.integers(0, np.iinfo(fmt.dtype).max + 1,
                           (12, 17, fmt.channels), dtype=fmt.dtype)
        bufs.append(_tiff_of(arr, pixel, compression=comp))
    got = np.asarray(TiffBatchPipeline()(bufs))
    assert got.shape == (3, 12, 17, 4)
    for i, b in enumerate(bufs):
        want = picha.decodeTiffSync(b).to_array()
        np.testing.assert_array_equal(got[i], want)


def test_tiff_batch_palette_and_orientation():
    """Crafted palette + oriented greyscale files through the device
    graph agree with the host decoder."""
    from picha_tpu.pipeline import TiffBatchPipeline
    from tests.test_tiff import _craft_tiff, _grey_tiff
    import struct
    rng = np.random.default_rng(17)
    base = rng.integers(0, 256, (5, 9), dtype=np.uint8)
    for orientation in range(1, 9):
        bufs = [_grey_tiff(base, orientation)] * 2
        got = np.asarray(TiffBatchPipeline()(bufs))
        want = picha.decodeTiffSync(bufs[0]).to_array()
        np.testing.assert_array_equal(got[0], want)
        np.testing.assert_array_equal(got[1], want)


def test_tiff_batch_fallback_layouts():
    """Layouts outside the device graph (fax) fall back to the host
    decoder inside the batch API."""
    from picha_tpu.pipeline import TiffBatchPipeline
    from tests.test_tiff import _pil_bilevel_tiff
    arr = (np.add.outer(np.arange(10), np.arange(30)) // 3) % 2 == 0
    bufs = [_pil_bilevel_tiff(arr, "group4")] * 2
    got = np.asarray(TiffBatchPipeline()(bufs))
    want = picha.decodeTiffSync(bufs[0]).to_array()
    np.testing.assert_array_equal(got[0], want)


def test_tiff_batch_predictor_and_cmyk():
    from picha_tpu.pipeline import TiffBatchPipeline
    from tests.test_tiff import _craft_tiff
    rng = np.random.default_rng(23)
    # horizontal-predictor rgb
    h, w = 6, 11
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    diff = arr.astype(np.int16)
    diff[:, 1:] = diff[:, 1:] - diff[:, :-1]
    data = (diff % 256).astype(np.uint8).tobytes()
    data_off = 8 + 2 + 9 * 12 + 4
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8), (259, 3, 1, 1),
            (262, 3, 1, 2), (273, 4, 1, data_off), (277, 3, 1, 3),
            (279, 4, 1, len(data)), (317, 3, 1, 2)]
    buf = _craft_tiff(tags, data)
    got = np.asarray(TiffBatchPipeline()([buf, buf]))
    want = picha.decodeTiffSync(buf).to_array()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(want[:, :, :3], arr)
    # CMYK (photometric 5)
    cmyk = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8), (259, 3, 1, 1),
            (262, 3, 1, 5), (273, 4, 1, 8 + 2 + 8 * 12 + 4), (277, 3, 1, 4),
            (279, 4, 1, cmyk.size)]
    buf = _craft_tiff(tags, cmyk.tobytes())
    got = np.asarray(TiffBatchPipeline()([buf]))
    want = picha.decodeTiffSync(buf).to_array()
    np.testing.assert_array_equal(got[0], want)


def test_gap4_upload_matches_dense(jpeg_bufs):
    dense = np.asarray(JpegBatchPipeline(width=32, height=24)(jpeg_bufs))
    g4 = np.asarray(JpegBatchPipeline(width=32, height=24,
                                      upload="gap4")(jpeg_bufs))
    np.testing.assert_array_equal(dense, g4)
    df = np.asarray(JpegBatchPipeline(width=32, height=24,
                                      fused=True)(jpeg_bufs))
    g4f = np.asarray(JpegBatchPipeline(width=32, height=24, fused=True,
                                       upload="gap4")(jpeg_bufs))
    np.testing.assert_array_equal(df, g4f)


def test_stream_hybrid_order_and_validity(jpeg_bufs):
    """Hybrid scheduler: results arrive in input order; every output is
    a valid JPEG of the target size from either path (device chain or
    the pure-host path), pixels within lossy tolerance of each other."""
    p = JpegBatchPipeline(width=32, height=24, encode_quality=85,
                          encode_backend="raw420", fused=True,
                          upload="gap4")
    batches = [jpeg_bufs, list(reversed(jpeg_bufs)), jpeg_bufs,
               list(reversed(jpeg_bufs))]
    ref = p(jpeg_bufs)
    got = list(p.stream_hybrid(iter(batches), depth=2))
    assert len(got) == 4
    ref_img = picha.decodeJpegSync(ref[0]).to_array().astype(int)
    for bi, res in enumerate(got):
        assert len(res) == len(jpeg_bufs)
        order = jpeg_bufs if bi % 2 == 0 else list(reversed(jpeg_bufs))
        for j, enc in enumerate(res):
            img = picha.decodeJpegSync(enc)
            assert (img.width, img.height) == (32, 24)
        # batch 0/2 first image == ref first image's source
        img0 = picha.decodeJpegSync(res[0]).to_array().astype(int)
        if bi % 2 == 0:
            assert np.abs(img0 - ref_img).mean() < 8


def test_stream_hybrid_propagates_errors(jpeg_bufs):
    p = JpegBatchPipeline(width=16, height=12, encode_quality=85,
                          encode_backend="raw420", upload="gap4")
    with pytest.raises(Exception):
        list(p.stream_hybrid(iter([jpeg_bufs, [b"bogus"] * 2]), depth=2))


def test_stream_best_probes_and_finishes(jpeg_bufs):
    """stream_best yields every batch exactly once, in order, across
    the probe phase and the winning-config phase."""
    from picha_tpu.pipeline import stream_best
    from picha_tpu.native import lib as native

    batches = [jpeg_bufs for _ in range(9)]
    outs = list(stream_best(iter(batches), width=32, height=24,
                            quality=85, configs=("host", "gap4+raw420"),
                            probe_batches=1))
    assert len(outs) == 9
    for o in outs:
        assert len(o) == len(jpeg_bufs)
        for b in o:
            st = native.jpeg_stat(bytes(b))
            assert st == (32, 24, 3)


def test_stream_best_single_config(jpeg_bufs):
    from picha_tpu.pipeline import stream_best

    outs = list(stream_best(iter([jpeg_bufs] * 2), width=16, height=16,
                            configs=("host",), probe_batches=1))
    assert len(outs) == 2


def test_stream_best_empty_and_short_streams(jpeg_bufs):
    from picha_tpu.pipeline import stream_best

    assert list(stream_best(iter([]), width=16, height=16)) == []
    outs = list(stream_best(iter([jpeg_bufs]), width=16, height=16,
                            configs=("host",)))
    assert len(outs) == 1 and len(outs[0]) == len(jpeg_bufs)


def test_image_batch_pipeline_mixed_formats():
    """PNG (rgb) and TIFF (always rgba) in one batch: bucketed per
    (shape, pixel), processed per bucket, reassembled in input order —
    the any-input contract lifted to batches."""
    import picha_tpu as picha
    from picha_tpu.pipeline import ImageBatchPipeline

    rng = np.random.default_rng(40)
    imgs = [picha.Image.from_array(
        rng.integers(0, 256, (24, 32, 3), np.uint8), "rgb")
        for _ in range(4)]
    pngs = [picha.encodePngSync(im) for im in imgs]
    tiffs = [picha.encodeTiffSync(im, {"compression": "lzw"})
             for im in imgs]
    mixed = [pngs[0], tiffs[1], pngs[2], tiffs[3]]

    ib = ImageBatchPipeline(resize=(16, 12),
                            encode=("image/webp", {"quality": 80}))
    out = ib(mixed)
    assert len(out) == 4
    for o in out:
        st = picha.stat(bytes(o))
        assert (st["width"], st["height"]) == (16, 12)

    # decode-only with a common channel-normalizing convert
    ib2 = ImageBatchPipeline(resize=(16, 12), convert="rgba")
    arr = ib2(mixed)
    assert np.asarray(arr).shape == (4, 12, 16, 4)


def test_stream_best_config_failure_replays_on_host(jpeg_bufs, monkeypatch):
    """A device config whose probe raises (a device error) scores as
    losing; its consumed batches replay
    through the host path — every batch is yielded exactly once."""
    from picha_tpu.pipeline import jpeg_batch, stream_best

    def boom(self, batches, depth=2):
        raise RuntimeError("ABORTED: injected")
        yield  # pragma: no cover

    monkeypatch.setattr(jpeg_batch.JpegBatchPipeline, "stream_hybrid",
                        boom)
    outs = list(stream_best(iter([jpeg_bufs] * 6), width=16, height=16,
                            configs=("host", "gap4+raw420"),
                            probe_batches=1))
    assert len(outs) == 6
    assert all(len(o) == len(jpeg_bufs) for o in outs)


def test_host_fast_scale_path():
    """Draft-mode host path: exact 1/2 target decodes via the reduced
    IDCT (skipping the resize). On natural-statistics content it stays
    within the reference's golden tolerance of the cubic path; on pure
    noise the draft diverges — the divergence guard (round 4) detects
    that from the draft output itself and routes the image to the
    staged strict path (byte-identical result, trip counted).
    Non-matching targets silently use the normal path."""
    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline

    rng = np.random.default_rng(50)
    yy, xx = np.mgrid[0:256, 0:384].astype(np.float32)
    base = 127 + 80 * np.sin(xx / 40) + 40 * np.cos(yy / 25)
    smooth = np.clip(base[..., None] + rng.normal(0, 4, (256, 384, 3)),
                     0, 255).astype(np.uint8)
    noisy = rng.integers(0, 256, (256, 384, 3), np.uint8)
    sm_buf = native.jpeg_encode(smooth, 90)
    nz_buf = native.jpeg_encode(noisy, 90)
    w2, h2 = 192, 128

    def diff(buf, fast_guard=None):
        pf = JpegBatchPipeline(width=w2, height=h2, encode_quality=90,
                               encode_backend="host", host_fast_scale=True,
                               fast_guard=fast_guard)
        pn = JpegBatchPipeline(width=w2, height=h2, encode_quality=90,
                               encode_backend="host")
        a = native.jpeg_decode(bytes(pf.host_encode_batch([buf])[0]),
                               3, w2, h2)
        b = native.jpeg_decode(bytes(pn.host_encode_batch([buf])[0]),
                               3, w2, h2)
        return np.abs(a.astype(int) - b.astype(int)).mean(), \
            pf.fast_guard_trips

    d, trips = diff(sm_buf)
    assert d < 2.0 and trips == 0   # natural content: fast path, no trip
    d, trips = diff(nz_buf)
    assert d == 0.0 and trips == 1  # noise trips -> staged, identical
    d, trips = diff(nz_buf, fast_guard=0.0)
    assert d > 2.0 and trips == 0   # guard off: the raw draft divergence

    # a mixed batch preserves order (tripped and fast outputs reassemble)
    pf = JpegBatchPipeline(width=w2, height=h2, encode_quality=90,
                           encode_backend="host", host_fast_scale=True)
    outs = pf.host_encode_batch([sm_buf, nz_buf, sm_buf])
    assert pf.fast_guard_trips == 1
    pn = JpegBatchPipeline(width=w2, height=h2, encode_quality=90,
                           encode_backend="host")
    want_nz = pn.host_encode_batch([nz_buf])[0]
    assert bytes(outs[1]) == bytes(want_nz)
    assert bytes(outs[0]) != bytes(want_nz)

    # odd target -> normal path (byte-identical to fast_scale=False)
    po = JpegBatchPipeline(width=w2 - 1, height=h2, encode_quality=90,
                           encode_backend="host", host_fast_scale=True)
    pr = JpegBatchPipeline(width=w2 - 1, height=h2, encode_quality=90,
                           encode_backend="host")
    assert [bytes(x) for x in po.host_encode_batch([sm_buf])] == \
        [bytes(x) for x in pr.host_encode_batch([sm_buf])]


def test_pool_paths_not_dead_code(monkeypatch):
    """The multi-core pool branches (gated off on this 1-core box) must
    still execute correctly when cpu_count reports more cores —
    production hosts take them on every batch."""
    import os

    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline
    from picha_tpu.pipeline.training import TrainingInput

    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    rng = np.random.default_rng(2)
    bufs = [native.jpeg_encode(
        rng.integers(0, 256, (64, 80, 3), np.uint8).astype(np.uint8), 88)
        for _ in range(4)]
    p = JpegBatchPipeline(width=40, height=32, encode_quality=85,
                          encode_backend="host")
    pooled = p.host_encode_batch(bufs)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    serial = p.host_encode_batch(bufs)
    assert [bytes(a) for a in pooled] == [bytes(b) for b in serial]

    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    ti = TrainingInput(bufs, batch=2, crop=48, size=32, seed=3)
    a = np.asarray(next(ti))
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    ti2 = TrainingInput(bufs, batch=2, crop=48, size=32, seed=3)
    np.testing.assert_array_equal(a, np.asarray(next(ti2)))


def test_device_encode_overflow_falls_back():
    """Dense content can exceed the on-chip encoder's quality-derived
    packet budget; the pipeline must transparently redo the batch with
    the raw420 backend instead of raising OverflowError (VERDICT-style
    invariant: a budget is an optimisation, not a failure mode)."""
    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline

    rng = np.random.default_rng(0)
    bufs = [native.jpeg_encode(
        rng.integers(0, 256, (256, 256, 3), np.uint8).astype(np.uint8), 85)
        for _ in range(2)]
    p = JpegBatchPipeline(width=128, height=128, encode_quality=85,
                          encode_backend="device", fused=True,
                          upload="gap4")
    outs = p(bufs)
    assert len(outs) == 2
    for o, b in zip(outs, bufs):
        got = native.jpeg_decode(bytes(o), 3, 128, 128)
        assert got.shape == (128, 128, 3)
        # quality sanity vs the host path on the same source
        ref = native.jpeg_encode(
            np.ascontiguousarray(_resize_ref(b, 128, 128)), 85)
        refd = native.jpeg_decode(ref, 3, 128, 128)
        assert np.abs(got.astype(int) - refd.astype(int)).mean() < 4.0


def test_device_encode_overflow_retries_with_doubled_cap():
    """The quality-derived scan cap retries ONCE at 2x before the host
    fallback (advisor r4: keep dense-but-compressible batches on the
    device path); an explicit scan_byte_cap is the caller's contract
    and must never be boosted."""
    from picha_tpu.pipeline import JpegBatchPipeline

    p = JpegBatchPipeline(width=1024, height=1024, encode_quality=85,
                          encode_backend="device", fused=True,
                          upload="gap4")
    base_cap = p._scan_cap_for((2048, 2048, 3, ((1, 1), (1, 1), (1, 1))))
    calls = []

    def fake_process(cos):
        calls.append(p._cap_boost)
        if len(calls) == 1:
            raise OverflowError("forced")
        return "sig", "out"

    p._process = fake_process
    p._finish = lambda sig, out: ["ok"]
    assert p._run_with_retry([object()]) == ["ok"]
    assert calls == [1, 2]  # retried exactly once, at doubled budget
    big_cap = p._scan_cap_for((2048, 2048, 3, ((1, 1), (1, 1), (1, 1))))
    assert big_cap == 2 * base_cap

    # explicit cap: no boost, straight to the fallback
    p2 = JpegBatchPipeline(width=128, height=128, encode_quality=85,
                           encode_backend="device", fused=True,
                           upload="gap4", scan_byte_cap=1 << 16)

    def fail(cos):
        raise OverflowError("forced")

    p2._process = fail
    p2._overflow_fallback = lambda cos: ["fell back"]
    assert p2._run_with_retry([object()]) == ["fell back"]
    assert p2._cap_boost == 1


def _resize_ref(buf, w, h):
    from picha_tpu.native import lib as native
    from picha_tpu.ops.resize import _resize_native

    st = native.jpeg_stat(buf)
    return _resize_native(native.jpeg_decode(buf, 3, st[0], st[1]), w, h,
                          "cubic", 0.7)


def test_stream_best_cached_winner_failure_replays(tmp_path, monkeypatch):
    """A cached-winner failure must not drop batches: in-flight batches
    replay through the host path and the stream finishes there (the
    same nothing-is-ever-dropped guarantee the race path gives)."""
    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import serving
    import picha_tpu.pipeline.jpeg_batch as jb

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    bufs = [native.jpeg_encode(
        rng.integers(0, 256, (64, 80, 3), np.uint8).astype(np.uint8), 88)
        for _ in range(4)]
    batches = [bufs[:2], bufs[2:], bufs[:2], bufs[2:]]
    # race once to persist a winner
    outs = list(serving.stream_best(iter(batches), width=40, height=32,
                                    configs=("host", "host-raw")))
    assert len(outs) == 4
    # cached run: inject one mid-stream failure into the winner
    orig = jb.JpegBatchPipeline.host_encode_batch
    calls = [0]

    def failing(self, b):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected mid-stream failure")
        return orig(self, b)

    monkeypatch.setattr(jb.JpegBatchPipeline, "host_encode_batch", failing)
    outs2 = list(serving.stream_best(iter(batches), width=40, height=32,
                                     configs=("host", "host-raw")))
    assert len(outs2) == 4  # nothing dropped
    assert calls[0] >= 4


def test_image_batch_crop_bounds_rejected():
    """Out-of-bounds crops raise like Image.sub_view — Python slicing
    would silently clamp and resize would stretch the wrong region."""
    from picha_tpu.errors import InvalidImageError
    from picha_tpu.pipeline import ImageBatchPipeline

    rng = np.random.default_rng(3)
    img = picha.Image.from_array(
        rng.integers(0, 256, (32, 48, 3), np.uint8), "rgb")
    buf = picha.encodePngSync(img)
    ok = ImageBatchPipeline(crop=(8, 8, 16, 16))
    assert np.asarray(ok([buf])).shape == (1, 16, 16, 3)
    for rect in [(40, 0, 16, 16), (0, 24, 16, 16), (-1, 0, 8, 8),
                 (0, 0, 0, 8)]:
        with pytest.raises(InvalidImageError):
            ImageBatchPipeline(crop=rect)([buf])


def test_tiff_batch_crafted_tags_route_or_raise():
    """The batched TIFF path must not reintroduce the single-image
    codec's hardening gaps: predictor 3 routes to the codec's typed
    error, giant-dimension claims fail before allocation, and negative
    RowsPerStrip never returns uninitialized memory."""
    import struct as _s

    from picha_tpu.pipeline import TiffBatchPipeline
    from test_tiff import _craft_tiff

    base = np.arange(16, dtype=np.uint8).reshape(4, 4)

    def craft(extra):
        data_off = 8 + 2 + (7 + len(extra)) * 12 + 4
        tags = [(256, 4, 1, 4), (257, 4, 1, 4), (258, 3, 1, 8),
                (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, 1, data_off),
                (279, 4, 1, base.size)] + extra
        return _craft_tiff(tags, base.tobytes())

    p = TiffBatchPipeline()
    for extra in ([(317, 3, 1, 3)],                 # float predictor
                  [(278, 9, 1, 0xFFFFFFFB)],        # rps = -5 (SLONG)
                  [(277, 3, 1, 60000)]):            # spp bomb
        with pytest.raises(picha.CodecError):
            p([craft(extra)])
