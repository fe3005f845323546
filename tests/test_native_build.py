"""Native build script: staleness keyed by a hash of the sources and
the host, and the libjpeg fallback to the Pillow-bundled copy with the
vendored headers when the system has no libjpeg."""
import pathlib

import pytest

from picha_tpu.native import build


def test_source_key_changes_with_the_host(monkeypatch):
    key = build.source_key()
    assert key == build.source_key() and len(key) == 64
    monkeypatch.setattr(build.platform, "uname", lambda: ("other-host",))
    assert build.source_key() != key


def test_stamp_mismatch_is_stale(monkeypatch, tmp_path):
    lib, stamp = tmp_path / "lib.so", tmp_path / "lib.stamp"
    monkeypatch.setattr(build, "LIB_PATH", lib)
    monkeypatch.setattr(build, "STAMP", stamp)
    assert build.is_stale()  # nothing built
    lib.write_bytes(b"")
    stamp.write_text("another machine's build")
    assert build.is_stale()
    stamp.write_text(build.source_key())
    assert not build.is_stale()


def test_system_libjpeg_is_preferred():
    if not build._links(build._JPEG_PROBE, [], ["-ljpeg"]):
        pytest.skip("this host has no system libjpeg")
    flags, link = build.jpeg_flags()
    assert link == ["-ljpeg"] and flags == []


def test_bundled_libjpeg_used_without_system_library(monkeypatch):
    if build._bundled_libjpeg() is None:
        pytest.skip("this Pillow wheel bundles no libjpeg")
    real = build._links
    monkeypatch.setattr(
        build, "_links",
        lambda code, flags, link: (False if link == ["-ljpeg"]
                                   else real(code, flags, link)))
    flags, link = build.jpeg_flags()
    assert flags == ["-I", str(build.VENDORED_JPEG)]
    assert pathlib.Path(link[0]).name.startswith("libjpeg")
    assert link[1].startswith("-Wl,-rpath,")


def test_missing_libjpeg_names_it(monkeypatch):
    monkeypatch.setattr(build, "_links", lambda *a: False)
    with pytest.raises(RuntimeError, match="libjpeg"):
        build.jpeg_flags()


def test_vendored_headers_are_complete():
    names = {p.name for p in build.VENDORED_JPEG.iterdir()}
    assert {"jpeglib.h", "jconfig.h", "jmorecfg.h", "LICENSE"} <= names


def test_unloadable_library_is_rebuilt(monkeypatch, tmp_path):
    """A library that cannot load on this host (built elsewhere against
    libraries this one lacks) is rebuilt with force, then loaded."""
    from picha_tpu.native import lib

    bogus = tmp_path / "libbogus.so"
    bogus.write_bytes(b"not an ELF object")
    calls = []

    def fake_build(force=False):
        calls.append(force)
        return build.LIB_PATH if force else bogus

    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib._build, "build", fake_build)
    assert lib.get_lib() is not None
    assert calls == [False, True]
