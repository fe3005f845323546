"""Multi-device tests on the 8-way virtual CPU mesh (conftest forces
xla_force_host_platform_device_count=8) — SURVEY.md §4's fake-device
mesh strategy."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from picha_tpu.ops.resize import resize_array
from picha_tpu.parallel import make_mesh, resize_sharded, shard_batch


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_make_mesh_factorisations():
    m = make_mesh()
    assert m.shape == {"dp": 8}
    m2 = make_mesh((("dp", 2), ("tp", 4)))
    assert m2.shape == {"dp": 2, "tp": 4}
    m3 = make_mesh((("dp", -1), ("tp", 2)))
    assert m3.shape == {"dp": 4, "tp": 2}


def test_dp_sharded_batch_pipeline_matches():
    """The batched resize graph under a dp-sharded input equals the
    unsharded result — DP is transparent to the op."""
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (8, 24, 20, 3), dtype=np.uint8)
    want = resize_array(batch, 10, 12)
    mesh = make_mesh()
    sharded = shard_batch(batch, mesh)
    got = np.asarray(resize_array(sharded, 10, 12))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filter_name", ["cubic", "triangle", "lanczos"])
def test_spatial_halo_resize_matches_single_device(filter_name):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)
    # jnp input pins the device graph (same float ops as the sharded
    # path; the numpy fast-path may differ in accumulation order)
    want = resize_array(jnp.asarray(img), 20, 32, filter=filter_name,
                        filter_scale=1.0)
    mesh = make_mesh((("sp", 8),))
    got = np.asarray(resize_sharded(jnp.asarray(img), 20, 32, mesh,
                                    filter=filter_name, filter_scale=1.0))
    # halo math must make the sharded result identical (same float ops)
    np.testing.assert_array_equal(got, want)


def test_spatial_banded_vertical_bit_equal():
    """Per-shard slabs above BANDED_THRESHOLD take the banded vertical
    weight blocks (the dense per-shard form is ~dst*src/n floats —
    gigapixel-hostile); the banded plan must stay bit-equal to the
    single-device resize."""
    from picha_tpu.ops.resize import BANDED_THRESHOLD

    rng = np.random.default_rng(3)
    h = 8 * (BANDED_THRESHOLD + 88)  # local_in 600 > threshold
    img = rng.integers(0, 256, (h, 24, 3), dtype=np.uint8)
    want = resize_array(jnp.asarray(img), 16, h // 4)
    mesh = make_mesh((("sp", 8),))
    got = np.asarray(resize_sharded(jnp.asarray(img), 16, h // 4, mesh))
    np.testing.assert_array_equal(got, want)


def test_spatial_upscale():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (32, 16, 4), dtype=np.uint8)
    want = resize_array(jnp.asarray(img), 32, 64)
    mesh = make_mesh((("sp", 8),))
    got = np.asarray(resize_sharded(jnp.asarray(img), 32, 64, mesh))
    np.testing.assert_array_equal(got, want)


def test_dryrun_multichip_entrypoints():
    import importlib.util, pathlib
    spec = importlib.util.spec_from_file_location(
        "graft_entry", pathlib.Path(__file__).parent.parent / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # single-chip compile check
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (8, 16)
    # full multichip dryrun on the virtual mesh
    mod.dryrun_multichip(8)


def test_multihost_helpers_single_process():
    from picha_tpu.parallel import multihost
    items = list(range(10))
    assert multihost.local_shard(items, 0, 1) == items
    assert multihost.local_shard(items, 0, 4) == [0, 1, 2]
    # short tails wrap so every host's shard has equal length
    assert multihost.local_shard(items, 3, 4) == [9, 0, 1]
    assert multihost.local_shard([], 0, 4) == []
    mesh = make_mesh()
    arr = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    g = multihost.global_batch(arr, mesh)
    assert g.shape == (16, 3)
    np.testing.assert_array_equal(np.asarray(g), arr)
    multihost.initialize()  # no-op single process


def test_multihost_two_process_distributed():
    """REAL jax.distributed bootstrap: two CPU processes form a
    2-device global mesh; each contributes its local_shard and the
    cross-process global_batch reduces to the same total on both
    (SURVEY.md §5.8 — DCN only for input dispatch)."""
    import os
    import socket
    import subprocess
    import sys
    import textwrap

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    child = textwrap.dedent("""
        import sys
        import numpy as np
        pid, coord, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        sys.path.insert(0, repo)
        import jax
        import jax.numpy as jnp
        from picha_tpu.parallel import multihost
        from picha_tpu.parallel.mesh import make_mesh
        multihost.initialize(coordinator=coord, num_processes=2,
                             process_id=pid)
        assert jax.process_count() == 2
        assert len(jax.devices()) == 2
        mesh = make_mesh((("dp", 2),))
        items = [np.full((3, 4), i, np.float32) for i in range(8)]
        local = multihost.local_shard(items)
        g = multihost.global_batch(np.stack(local), mesh)
        assert g.shape == (8, 3, 4)
        print("RESULT", pid, float(jax.jit(jnp.sum)(g)), flush=True)
    """)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", child, str(i), f"127.0.0.1:{port}", repo],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    results = {}
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"proc {i} failed: {err[-800:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, total = line.split()
                results[int(pid)] = float(total)
    # sum(i for i in 0..7) * 3 * 4 = 28 * 12, identical on both hosts
    assert results == {0: 336.0, 1: 336.0}, results


def test_multihost_two_process_train_ingest():
    """End-to-end config-5 story across REAL processes: each of two
    jax.distributed CPU processes entropy-decodes its local_shard of a
    JPEG corpus through JpegBatchPipeline (fused decode+resize),
    contributes it to the dp global batch, and takes one gradient step
    whose collectives cross the process boundary. Both processes must
    produce the gradient the single-process run produces (SURVEY.md
    §5.8: batch axis = pure DP, DCN only for input dispatch)."""
    import os
    import socket
    import subprocess
    import sys
    import textwrap

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    child = textwrap.dedent("""
        import sys
        import numpy as np
        pid, coord, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        sys.path.insert(0, repo)
        import jax
        import jax.numpy as jnp
        from picha_tpu.parallel import multihost
        from picha_tpu.parallel.mesh import make_mesh
        multihost.initialize(coordinator=coord, num_processes=2,
                             process_id=pid)
        from picha_tpu.native import lib as native
        from picha_tpu.pipeline import JpegBatchPipeline
        rng = np.random.default_rng(0)
        bufs = [native.jpeg_encode(
            rng.integers(0, 256, (32, 32, 3), np.uint8), 85)
            for _ in range(8)]
        local = multihost.local_shard(bufs)
        assert len(local) == 4
        p = JpegBatchPipeline(width=16, height=16, fused=True)
        cos = p.entropy_decode([bytes(b) for b in local])
        sig, args = p.stack_bucket(cos)
        imgs = np.asarray(p.run_bucket(sig, args), np.float32) / 255.0
        mesh = make_mesh((("dp", 2),))
        g = multihost.global_batch(imgs, mesh)
        def loss(w, x):
            pred = x.reshape(x.shape[0], -1) @ w
            return jnp.mean((pred - 1.0) ** 2)
        gw = jax.jit(jax.grad(loss))(jnp.zeros((16 * 16 * 3,),
                                               jnp.float32), g)
        print("RESULT", pid, float(jnp.sum(jnp.abs(gw))), flush=True)
    """)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", child, str(i), f"127.0.0.1:{port}", repo],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    results = {}
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"proc {i} failed: {err[-800:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, total = line.split()
                results[int(pid)] = float(total)

    # single-process oracle: same corpus, same pipeline, same grad
    import jax
    import jax.numpy as jnp

    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline

    rng = np.random.default_rng(0)
    bufs = [native.jpeg_encode(
        rng.integers(0, 256, (32, 32, 3), np.uint8), 85) for _ in range(8)]
    p = JpegBatchPipeline(width=16, height=16, fused=True)
    cos = p.entropy_decode([bytes(b) for b in bufs])
    sig, args = p.stack_bucket(cos)
    imgs = np.asarray(p.run_bucket(sig, args), np.float32) / 255.0

    def loss(w, x):
        pred = x.reshape(x.shape[0], -1) @ w
        return jnp.mean((pred - 1.0) ** 2)

    want = float(jnp.sum(jnp.abs(
        jax.jit(jax.grad(loss))(jnp.zeros((16 * 16 * 3,), jnp.float32),
                                jnp.asarray(imgs)))))
    assert set(results) == {0, 1}, results
    for pid, got in results.items():
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (pid, got, want)


def test_stream_best_persists_winner(tmp_path, monkeypatch):
    """The config race's winner is cached next to the XLA cache and a
    restart (same deployment key) skips re-probing."""
    import json

    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import serving

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    bufs = [bytes(native.jpeg_encode(img, 85)) for _ in range(4)]
    batches = [bufs, bufs, bufs, bufs]
    outs = list(serving.stream_best(
        iter(batches), width=40, height=32, quality=85,
        configs=("host", "host-raw"), probe_batches=1))
    assert len(outs) == len(batches)
    cache = json.loads((tmp_path / "stream_best.json").read_text())
    (key, entry), = cache.items()
    assert entry["best"] in ("host", "host-raw")
    assert entry["rates"]
    # second run: cached winner, probe skipped -> all batches through
    # one runner (rates untouched)
    outs2 = list(serving.stream_best(
        iter(batches), width=40, height=32, quality=85,
        configs=("host", "host-raw"), probe_batches=1))
    assert len(outs2) == len(batches)
    cache2 = json.loads((tmp_path / "stream_best.json").read_text())
    assert cache2[key]["saved_at"] == entry["saved_at"]  # not re-raced


def _hostile_stream_bufs(n, w=192, h=160):
    """Small version of bench._hostile_images: 32px block mosaics +
    4px band-limited noise — content where the raw-domain transcode's
    YCbCr resize measurably diverges (>1 LSB) from the staged path."""
    from picha_tpu.native import lib as native

    r = np.random.default_rng(1234)
    out = []
    for i in range(n):
        if i % 2 == 0:
            t = r.integers(0, 256, (h // 32, w // 32, 3)).astype(np.float32)
            img = np.kron(t, np.ones((32, 32, 1), np.float32))
        else:
            g = r.normal(0, 1, (h // 4, w // 4, 3)).astype(np.float32)
            img = 127 + 45 * np.kron(g, np.ones((4, 4, 1), np.float32))
        out.append(bytes(native.jpeg_encode(
            np.clip(img, 0, 255).astype(np.uint8), 85)))
    return out


def _natural_stream_bufs(n, w=192, h=160):
    from picha_tpu.native import lib as native

    r = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for i in range(n):
        img = np.clip(np.stack([128 + 70 * np.sin(xx / 11 + i),
                                128 + 60 * np.cos(yy / 13),
                                128 + 50 * np.sin((xx + yy) / 17)], -1)
                      + r.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
        out.append(bytes(native.jpeg_encode(img, 85)))
    return out


def test_stream_best_strict_gate_disqualifies(tmp_path, monkeypatch):
    """With strict_lsb set, a config whose live-traffic parity exceeds
    the bound cannot win the race no matter how fast it probes: on the
    hostile corpus host-raw measures ~1.35 LSB vs the staged path
    (re-encode quantisation amplification — see test_raw420's dust-
    floor attribution; the gamut guard is pinned off so this stays
    true if its default ever changes), so the winner must be host and
    the measured parity must be recorded."""
    import json

    from picha_tpu.ops import raw420
    from picha_tpu.pipeline import serving

    monkeypatch.setattr(raw420, "GAMUT_GUARD_LSB", 0.0)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    bufs = _hostile_stream_bufs(6)
    batches = [bufs[i:i + 3] for i in range(0, 6, 3)] * 3
    outs = list(serving.stream_best(
        iter(batches), width=96, height=80, quality=85,
        configs=("host", "host-raw"), probe_batches=1, strict_lsb=1.0))
    assert len(outs) == len(batches)
    assert sum(len(o) for o in outs) == sum(len(b) for b in batches)
    cache = json.loads((tmp_path / "stream_best.json").read_text())
    (_, entry), = cache.items()
    assert entry["best"] == "host"
    assert entry["parity_lsb"]["host-raw"] > 1.0
    assert "host-raw" not in entry["rates"]  # disqualified, not slow


def test_stream_best_strict_gate_admits_on_natural(tmp_path, monkeypatch):
    """Same bound on photographic content: host-raw measures well
    under 1 LSB and stays in the race (rates + parity recorded)."""
    import json

    from picha_tpu.pipeline import serving

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    bufs = _natural_stream_bufs(6)
    batches = [bufs[i:i + 3] for i in range(0, 6, 3)] * 3
    outs = list(serving.stream_best(
        iter(batches), width=96, height=80, quality=85,
        configs=("host", "host-raw"), probe_batches=1, strict_lsb=1.0))
    assert len(outs) == len(batches)
    cache = json.loads((tmp_path / "stream_best.json").read_text())
    (_, entry), = cache.items()
    assert entry["parity_lsb"]["host-raw"] < 1.0
    assert "host-raw" in entry["rates"]


def test_stream_best_cached_winner_spot_check(tmp_path, monkeypatch):
    """A cached winner is parity-spot-checked on current traffic: seed
    the cache with best=host-raw, stream the hostile corpus with
    strict_lsb=1.0 — the spot check must demote it, the stream must
    still deliver every batch, and the re-race must record host."""
    import json

    from picha_tpu.pipeline import serving

    from picha_tpu.ops import raw420

    monkeypatch.setattr(raw420, "GAMUT_GUARD_LSB", 0.0)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    key = serving._race_cache_key(96, 80, 85, ("host", "host-raw"), 2, 1.0)
    serving._race_cache_store(key, {"best": "host-raw",
                                    "rates": {"host-raw": 999.0},
                                    "saved_at": 0.0})
    bufs = _hostile_stream_bufs(6)
    batches = [bufs[i:i + 3] for i in range(0, 6, 3)] * 4
    outs = list(serving.stream_best(
        iter(batches), width=96, height=80, quality=85,
        configs=("host", "host-raw"), probe_batches=1, strict_lsb=1.0))
    assert len(outs) == len(batches)
    assert sum(len(o) for o in outs) == sum(len(b) for b in batches)
    cache = json.loads((tmp_path / "stream_best.json").read_text())
    entry = cache[key]
    assert entry["best"] == "host"          # re-raced after demotion
    assert entry["saved_at"] != 0.0


def test_dp_sharded_jpeg_batch_graph():
    """The fused decode+resize bucket graph under a dp-sharded
    coefficient batch equals the unsharded result."""
    from conftest import fixture_bytes
    from picha_tpu.pipeline import JpegBatchPipeline

    bufs = [fixture_bytes("test2.jpg")] * 8
    p = JpegBatchPipeline(width=24, height=16, fused=True)
    cos = p.entropy_decode(bufs)
    sig, args = p.stack_bucket(cos)
    want = np.asarray(p.run_bucket(sig, args))
    mesh = make_mesh()
    sharded = [shard_batch(a, mesh) for a in args]
    got = np.asarray(p.run_bucket(sig, sharded))
    np.testing.assert_array_equal(got, want)


def test_gigapixel_scale_spatial_resize():
    """A tall image sharded over 8 devices resizes without ever being
    resident on one device (the CP/SP story at scale)."""
    rng = np.random.default_rng(3)
    h, w = 4096, 256  # 1 Mpix + per-shard slabs of 512 rows
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mesh = make_mesh((("sp", 8),))
    out = np.asarray(resize_sharded(jnp.asarray(img), 64, 1024, mesh))
    assert out.shape == (1024, 64, 3)
    want = resize_array(jnp.asarray(img), 64, 1024)
    np.testing.assert_array_equal(out, np.asarray(want))


def test_spatial_halo_guard():
    rng = np.random.default_rng(4)
    mesh = make_mesh((("sp", 8),))
    # 8 rows per shard but a 16x downscale needs a ~22-row halo: more
    # than one ppermute hop can deliver -> explicit error
    img = rng.integers(0, 256, (64, 8, 1), dtype=np.uint8)
    with pytest.raises(ValueError):
        resize_sharded(jnp.asarray(img), 8, 4, mesh)
    # the 2-rows-per-shard case is exactly reachable with the tight
    # per-shard halo (reach 2) and must now match the single resize
    from picha_tpu.ops.resize import resize_array
    img = rng.integers(0, 256, (16, 8, 1), dtype=np.uint8)
    got = np.asarray(resize_sharded(jnp.asarray(img), 8, 8, mesh))
    np.testing.assert_array_equal(got, resize_array(img, 8, 8))


@pytest.mark.parametrize("src_h,dst_h", [(100, 36), (97, 40), (64, 31),
                                         (1003, 257)])
def test_resize_sharded_non_divisible(src_h, dst_h):
    """Pad-and-crop: shard-indivisible heights match the single-device
    resize bit-exactly (VERDICT weak #6)."""
    import jax.numpy as jnp
    from picha_tpu.ops.resize import resize_array
    from picha_tpu.parallel.mesh import make_mesh
    from picha_tpu.parallel.spatial import resize_sharded
    import jax
    mesh = make_mesh((("sp", 8),), devices=jax.devices()[:8])
    rng = np.random.default_rng(src_h)
    img = rng.integers(0, 256, (src_h, 50, 3), dtype=np.uint8)
    got = np.asarray(resize_sharded(jnp.asarray(img), 30, dst_h, mesh))
    want = resize_array(img, 30, dst_h)
    np.testing.assert_array_equal(got, want)


def test_pipeline_parallel_matches_sequential():
    """GPipe pipeline over a 'pp' mesh: identical to running the stage
    stack sequentially (bit-exact), activations hop via ppermute."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from picha_tpu.parallel.mesh import make_mesh
    from picha_tpu.parallel.pipeline_stages import pipeline_apply

    S = 4
    mesh = make_mesh((("pp", S),), devices=jax.devices()[:S])
    rng = np.random.default_rng(0)
    d = 16
    w = rng.normal(0, 0.3, (S, d, d)).astype(np.float32)
    b = rng.normal(0, 0.1, (S, d)).astype(np.float32)

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    x = rng.normal(0, 1, (8, d)).astype(np.float32)
    got = np.asarray(pipeline_apply(
        stage, {"w": w, "b": b}, jnp.asarray(x), mesh, n_micro=4))
    want = x
    for s in range(S):
        want = np.tanh(want @ w[s] + b[s])
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pipeline_parallel_micro_batch_1():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from picha_tpu.parallel.mesh import make_mesh
    from picha_tpu.parallel.pipeline_stages import pipeline_apply

    mesh = make_mesh((("pp", 2),), devices=jax.devices()[:2])
    w = np.eye(4, dtype=np.float32)[None].repeat(2, 0) * 2.0

    def stage(p, x):
        return x @ p["w"]

    x = np.ones((3, 4), np.float32)
    got = np.asarray(pipeline_apply(stage, {"w": w}, jnp.asarray(x),
                                    mesh, n_micro=1))
    assert np.allclose(got, x * 4.0)


def test_make_mesh_rejects_double_wildcard():
    with pytest.raises(ValueError):
        make_mesh((("dp", -1), ("tp", -1)))


def test_resize_sharded_zero_halo():
    """Box filter at shard-aligned scales computes halo=0; img[-0:]
    used to slice the WHOLE slab instead of an empty one (review r3d),
    crashing the einsum at trace time."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (128, 64, 3), np.uint8)
    mesh = make_mesh((("sp", 4),))
    got = np.asarray(resize_sharded(jnp.asarray(img), 32, 32, mesh,
                                    filter="box", filter_scale=0.5))
    want = resize_array(jnp.asarray(img), 32, 32, filter="box",
                        filter_scale=0.5)
    np.testing.assert_array_equal(got, np.asarray(want))
