"""chip_smoke.py's phases at tiny sizes on the CPU backend, its refusal
to run without a GPU, and the same for bench.py.

The phases run here with their real gates (bit-exact decode,
byte-identical encode, <= 1 LSB pixels, bit-equal resume, served ==
batched); only the sizes shrink. The full-size run needs the card."""
import os
import pathlib
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _ok(r):
    assert not r.get("failed"), r
    return r


@pytest.mark.parametrize("restart", [0, 2], ids=["no-restart", "restart"])
def test_transcode_phase_tiny(restart):
    r = _ok(chip_smoke.phase_transcode(
        n_img=4, batch=2, src=(64, 48), out=(32, 24), restart=restart,
        dc_src=(32, 32), name="tiny"))
    assert r["decode_exact"] and r["encode_identical"]
    assert r["fallbacks"] == {"scan_parse": 0, "decode_not_ok": 0,
                              "encode_overflow": 0}
    assert r["dc_diff_max"] >= 2000  # the extreme-DC batch was decoded


def test_transcode_phase_without_stage_parity_still_gates_decode():
    r = _ok(chip_smoke.phase_transcode(
        n_img=4, batch=2, src=(64, 48), out=(32, 24), restart=2,
        name="tiny", stage_parity=False))
    assert r["decode_exact"] and r["fallbacks"]["scan_parse"] == 0
    assert "encode_identical" not in r and "fused_lsb_mean" not in r


def test_training_phase_tiny():
    r = _ok(chip_smoke.phase_training(n_src=16, batch=8, crop=32, size=24,
                                      sizes=((64, 48), (48, 64))))
    assert r["resume_bit_equal"]


def test_serving_phase_tiny():
    r = _ok(chip_smoke.phase_serving(n_req=8, src=(64, 48), size=24,
                                     max_batch=4))
    assert r["answered"] == 8


def test_four_card_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4
    r = _ok(chip_smoke.phase_four_cards(
        n_dev=4, side=256, out_side=128, n_img=8, src=(64, 48),
        out=(32, 24)))
    assert r["devices"] == 4


def test_scan_of_extracts_entropy_segment():
    from picha_tpu.native import lib as native
    import numpy as np

    jpg = native.jpeg_encode(np.zeros((8, 8, 3), np.uint8), 85)
    scan = chip_smoke.scan_of(jpg)
    assert 0 < len(scan) < len(jpg) and jpg.endswith(scan + b"\xff\xd9")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / script)], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_alone_without_the_repo_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.gpu
def test_transcode_phase_on_gpu(gpu_device):
    r = _ok(chip_smoke.phase_transcode(
        n_img=16, batch=8, src=(640, 480), out=(320, 240), name="gpu"))
    assert r["decode_exact"] and r["encode_identical"]


@pytest.mark.gpu
def test_serving_phase_on_gpu(gpu_device):
    _ok(chip_smoke.phase_serving(n_req=16, src=(640, 480), size=224,
                                 max_batch=8))
