"""Builds the native host library.

Usage: ``python -m picha_tpu.native.build`` or implicitly on first
import of :mod:`picha_tpu.native.lib` when the .so is missing or stale.

The library is compiled with ``c++`` straight from ``src/*.cc``. A stamp
beside it holds a hash of the sources, this file and the host, so a
library built from other sources or on another machine is rebuilt, not
loaded.

libjpeg is required. A host without the system library and headers
(some GPU hosts ship neither) links the libjpeg-turbo that the Pillow
wheel bundles, compiled against the ABI-62 headers in
``third_party/libjpeg``. libwebp and libdeflate are optional: without
them their shims report "unavailable" and the Python layer degrades
(WebP codec unregistered, zlib instead of libdeflate).
"""
from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import pathlib
import platform
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).parent
BUILD_DIR = HERE / "build"
LIB_PATH = BUILD_DIR / "libpicha_native.so"
STAMP = BUILD_DIR / "libpicha_native.stamp"
VENDORED_JPEG = HERE / "third_party" / "libjpeg"

SOURCES = ["pngfilter.cc", "jpegshim.cc", "jpegentropy.cc", "webpshim.cc",
           "lzw.cc", "sparsepack.cc", "fax.cc", "hostresize.cc",
           "deflateshim.cc", "rawguard.cc"]
SIMD_SOURCES = {"sparsepack.cc", "hostresize.cc", "pngfilter.cc",
                "rawguard.cc"}
# -ffp-contract=off EVERYWHERE, not just the x86 SIMD sources: the
# scalar resize fallback encodes its rounding events explicitly
# (std::fmaf body, double-rounded tail), and a default-contracting
# non-x86 build would fuse the tail multiplies into FMAs — breaking the
# cross-architecture bit-identity check_scalar_parity.sh guarantees
# (reproduced: default contraction diverges 7/60 trials).
CXXFLAGS = ["-std=c++17", "-O3", "-fPIC", "-fvisibility=hidden",
            "-ffp-contract=off", "-pthread"]
SIMD_FLAGS = ["-mavx2", "-mfma"]


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("c++") or "c++"


def source_key() -> str:
    """Hash of everything the built library depends on: sources,
    vendored headers, this script, the compiler and the host."""
    h = hashlib.sha256()
    files = sorted((HERE / "src").glob("*")) + sorted(
        VENDORED_JPEG.glob("*")) + [pathlib.Path(__file__)]
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(repr((_cxx(), platform.uname())).encode())
    return h.hexdigest()


def is_stale() -> bool:
    if not LIB_PATH.exists() or not STAMP.exists():
        return True
    return STAMP.read_text().strip() != source_key()


def _links(code: str, flags: list, link: list) -> bool:
    """True when `code` compiles and links as a shared object."""
    probe = BUILD_DIR / f"probe-{os.getpid()}"
    probe.mkdir(parents=True, exist_ok=True)
    try:
        (probe / "t.cc").write_text(code)
        r = subprocess.run(
            [_cxx(), *CXXFLAGS, "-shared", *flags, str(probe / "t.cc"),
             "-o", str(probe / "t.so"), *link],
            capture_output=True, text=True)
        return r.returncode == 0
    finally:
        shutil.rmtree(probe, ignore_errors=True)


_JPEG_PROBE = ("#include <cstdio>\n#include <jpeglib.h>\n"
               "int f() { jpeg_decompress_struct c; jpeg_error_mgr e;\n"
               "  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);\n"
               "  jpeg_destroy_decompress(&c); return 0; }\n")


def _bundled_libjpeg():
    """libjpeg-turbo shipped inside the Pillow wheel, or None. Found by
    path only: Pillow itself is never imported."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    libs = pathlib.Path(spec.origin).parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg*.so*"))
    return found[0] if found else None


def jpeg_flags():
    """(compile flags, link args) for libjpeg: the system library
    first, else Pillow's bundled copy with the vendored headers."""
    if _links(_JPEG_PROBE, [], ["-ljpeg"]):
        return [], ["-ljpeg"]
    lib = _bundled_libjpeg()
    if lib is not None:
        flags = ["-I", str(VENDORED_JPEG)]
        link = [str(lib), f"-Wl,-rpath,{lib.parent}"]
        if _links(_JPEG_PROBE, flags, link):
            return flags, link
    raise RuntimeError(
        "native build needs libjpeg: this host has no jpeglib.h/libjpeg "
        "and no Pillow wheel with a bundled libjpeg-turbo")


def optional_flags():
    """(defines, link args) for the optional libraries present."""
    defines, link = [], []
    if _links("#include <webp/encode.h>\n#include <webp/decode.h>\n"
              "int f() { return WebPGetEncoderVersion(); }\n",
              [], ["-lwebp"]):
        defines.append("-DWITH_LIBWEBP")
        link.append("-lwebp")
    if _links("#include <libdeflate.h>\nvoid* f() "
              "{ return libdeflate_alloc_decompressor(); }\n",
              [], ["-ldeflate"]):
        defines.append("-DWITH_LIBDEFLATE")
        link.append("-ldeflate")
    return defines, link


def _run(cmd):
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native build needs {cmd[0]} on PATH") from e
    except subprocess.CalledProcessError as e:
        # the auto-build-on-first-import path must surface the
        # compiler diagnostics, not just "returned non-zero"
        raise RuntimeError(
            f"native build failed ({' '.join(cmd[-3:])}):\n"
            f"{e.stdout}\n{e.stderr}") from e


def _compile_and_link(out: pathlib.Path, work: pathlib.Path):
    jflags, jlink = jpeg_flags()
    defines, olink = optional_flags()
    simd = (platform.machine() in ("x86_64", "AMD64")
            and _links("int f() { return 0; }\n", SIMD_FLAGS, []))

    def compile_one(name):
        obj = work / (name + ".o")
        extra = SIMD_FLAGS if simd and name in SIMD_SOURCES else []
        _run([_cxx(), *CXXFLAGS, *extra, *jflags, *defines, "-c",
              str(HERE / "src" / name), "-o", str(obj)])
        return str(obj)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        objs = list(pool.map(compile_one, SOURCES))
    _run([_cxx(), *CXXFLAGS, "-shared", *objs, "-o", str(out), *jlink,
          *olink])


def build(force: bool = False) -> pathlib.Path:
    """Build the library if it is missing or stale (always with
    `force`). Concurrent callers (test workers) serialise on a lock
    file; the library is replaced atomically."""
    if not force and not is_stale():
        return LIB_PATH
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not is_stale():
            return LIB_PATH  # another process built it meanwhile
        work = BUILD_DIR / f"work-{os.getpid()}"
        work.mkdir(exist_ok=True)
        try:
            tmp = work / LIB_PATH.name
            _compile_and_link(tmp, work)
            os.replace(tmp, LIB_PATH)
            STAMP.write_text(source_key())
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return LIB_PATH


if __name__ == "__main__":
    try:
        path = build(force=True)
    except RuntimeError as e:
        raise SystemExit(str(e))
    print(f"built {path}")
