"""Build-on-demand loader for the native IO library (g++ -O3, zlib, pthreads).

Falls back to pure Python when compilation is unavailable, and says so on
stderr (PHASER_TPU_NO_NATIVE=1 disables the library explicitly).  Callers
that must not run on the Python codecs assert `get_lib() is not None`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "phaser_io.cc")
_SO = os.path.join(_HERE, "libphaser_io.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", _SO, _SRC, "-lz", "-lpthread"]
    # libdeflate (2-3x faster BGZF inflate than zlib) when present
    for libdir in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu",
                   "/usr/lib", "/usr/local/lib"):
        if os.path.exists(os.path.join(libdir, "libdeflate.so")):
            cmd.append("-ldeflate")
            break
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0 and "-ldeflate" in cmd:
            cmd.remove("-ldeflate")
            cmd.insert(1, "-DPHASER_NO_LIBDEFLATE")
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        print("phaser_io: native build failed (%s); using the Python codecs"
              % e, file=sys.stderr)
        return False
    if res.returncode != 0:
        print("phaser_io: native build failed; using the Python codecs\n%s"
              % res.stderr[-2000:], file=sys.stderr)
    return res.returncode == 0


def get_lib():
    """Returns the ctypes library or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("PHASER_TPU_NO_NATIVE") == "1":
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        c = ctypes
        lib.bgzf_total_size.restype = c.c_int64
        lib.bgzf_total_size.argtypes = [c.c_void_p, c.c_int64]
        lib.bgzf_decompress.restype = c.c_int64
        lib.bgzf_decompress.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                        c.c_int]
        lib.bam_parse.restype = c.c_void_p
        lib.bam_parse.argtypes = [c.c_void_p, c.c_int64]
        lib.bam_header_only.restype = c.c_void_p
        lib.bam_header_only.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
        lib.bam_records_parse.restype = c.c_void_p
        lib.bam_records_parse.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
        for fn in ("bam_n_records", "bam_total_cigar", "bam_total_seq",
                   "bam_names_size", "bam_refnames_size", "bam_header_size"):
            getattr(lib, fn).restype = c.c_int64
            getattr(lib, fn).argtypes = [c.c_void_p]
        lib.bam_n_refs.restype = c.c_int32
        lib.bam_n_refs.argtypes = [c.c_void_p]
        lib.bam_fill.restype = None
        lib.bam_fill.argtypes = [c.c_void_p] + [c.c_void_p] * 16
        lib.bam_free.restype = None
        lib.bam_free.argtypes = [c.c_void_p]
        lib.exact_assign.restype = c.c_int64
        lib.exact_assign.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_int, c.c_int,
            c.c_int64, c.c_void_p, c.c_void_p,
            c.c_int64, c.c_void_p, c.c_void_p,
            c.c_int64, c.c_void_p, c.c_void_p]
        lib.bgzf_compress_bound.restype = c.c_int64
        lib.bgzf_compress_bound.argtypes = [c.c_int64]
        lib.bgzf_compress.restype = c.c_int64
        lib.bgzf_compress.argtypes = [c.c_void_p, c.c_int64, c.c_int,
                                      c.c_void_p, c.c_int]
        lib.bam_scan_v2.restype = c.c_int64
        lib.bam_scan_v2.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                    c.c_void_p, c.c_void_p, c.c_void_p]
        lib.bam_parse_v2.restype = c.c_int64
        lib.bam_parse_v2.argtypes = [c.c_void_p, c.c_int64, c.c_int64] + \
            [c.c_void_p] * 14 + [c.c_int]
        lib.map_simple_run.restype = c.c_void_p
        lib.map_simple_run.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int32,
            c.c_int, c.c_int, c.c_void_p, c.c_int]
        lib.map_simple_n.restype = c.c_int64
        lib.map_simple_n.argtypes = [c.c_void_p]
        lib.map_simple_fetch.restype = None
        lib.map_simple_fetch.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                         c.c_void_p]
        lib.scatter_rows.restype = None
        lib.scatter_rows.argtypes = [c.c_int64, c.c_void_p, c.c_void_p,
                                     c.c_int64, c.c_void_p, c.c_int]
        lib.prefault_alloc.restype = c.c_void_p
        lib.prefault_alloc.argtypes = [c.c_int64, c.c_int]
        lib.prefault_free.argtypes = [c.c_void_p]
        lib.pack_reads_native.restype = None
        lib.pack_reads_native.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_int]
        lib.pack_codes_quals_native.restype = None
        lib.pack_codes_quals_native.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
            c.c_void_p, c.c_void_p, c.c_int]
        lib.pack_affine_native.restype = None
        lib.pack_affine_native.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
        lib.pack_affine_masked_native.restype = None
        lib.pack_affine_masked_native.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_int, c.c_int64, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
        lib.pack_affine_nibble_native.restype = None
        lib.pack_affine_nibble_native.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_int, c.c_int64, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int]
        lib.pack_delta_nibble_native.restype = None
        lib.pack_delta_nibble_native.argtypes = [
            c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_int, c.c_int64, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_int]
        lib.bam_index_scan.restype = c.c_int64
        lib.bam_index_scan.argtypes = [
            c.c_void_p, c.c_int64, c.c_int64, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p]
        for fn in ("gather_ragged_u8", "gather_ragged_u32"):
            g = getattr(lib, fn)
            g.restype = None
            g.argtypes = [c.c_int64, c.c_void_p, c.c_void_p, c.c_void_p,
                          c.c_void_p, c.c_void_p, c.c_int]
        _lib = lib
    return _lib
