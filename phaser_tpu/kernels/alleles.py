"""Device allele-assignment kernel (the hot loop of the framework).

Semantics match mapper.host's fast path (single-base variants): every
reference-aligned, BASEQ-passing, non-N read base whose genome position hits
a variant produces one (read, variant, allele-class) hit.

Layout: reads are padded to (N, L) int tensors; the variant table is a sorted
position vector plus per-variant individual allele codes.  The kernel is a
fused mask -> vectorized binary search -> gather-compare -> stream-compaction,
all elementwise work with no data-dependent shapes (hit capacity is static).

The same XLA programs run on every backend.  A contig's variant table is
7 B per site (int32 position, two uint8 allele codes, int8 count), so even a
whole-chromosome table fits in a GPU's L2 cache and the searchsorted gather
is served from there (ARCHITECTURE.md, "Allele classification on the GPU").
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

OTHER = 2
NO_HIT = 3


@functools.partial(jax.jit, static_argnames=("baseq",))
def assign_alleles_device(codes: jax.Array, quals: jax.Array,
                          refpos: jax.Array, vpos: jax.Array,
                          ind_codes: jax.Array, n_ind: jax.Array,
                          baseq: int) -> Tuple[jax.Array, jax.Array]:
    """Per-base hit classification.

    codes:  (N, L) uint8 nibble codes (0 pad)
    quals:  (N, L) uint8
    refpos: (N, L) int32 1-based aligned genome position (0 = unaligned pad)
    vpos:   (M,) int32 sorted variant positions (must be unique; duplicate
            table entries are resolved host-side)
    ind_codes: (M, 2) uint8 individual's allele codes
    n_ind:  (M,) int8

    Returns (vidx, allele_class) each (N, L) int32:
      allele_class: 0/1 = ind allele index, 2 = other, 3 = no hit
    """
    masked = jnp.where(quals >= baseq, codes, jnp.uint8(15))
    return _classify_masked(masked, refpos, vpos, ind_codes, n_ind)


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact_hits(vidx: jax.Array, allele: jax.Array,
                 capacity: int) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Stream-compact per-base hits into (read, var, allele) triplets.

    Returns (read_idx, var_idx, allele_class, n_hits); rows beyond n_hits are
    -1 padded.  Order: read-major then base order == (read, variant-position)
    — the reference mapper's row order.
    """
    N, L = vidx.shape
    flat_v = vidx.reshape(-1)
    flat_a = allele.reshape(-1)
    is_hit = flat_a < NO_HIT
    pos = jnp.cumsum(is_hit) - 1
    n_hits = jnp.sum(is_hit)
    read_of = (jnp.arange(N * L, dtype=jnp.int32) // L)
    out_r = jnp.full(capacity, -1, jnp.int32)
    out_v = jnp.full(capacity, -1, jnp.int32)
    out_a = jnp.full(capacity, -1, jnp.int32)
    idx = jnp.where(is_hit, pos, capacity)  # dropped past capacity
    out_r = out_r.at[idx].set(read_of, mode="drop")
    out_v = out_v.at[idx].set(flat_v, mode="drop")
    out_a = out_a.at[idx].set(flat_a, mode="drop")
    return out_r, out_v, out_a, n_hits


import threading as _threading

_pack_tls = _threading.local()  # per-thread scratch: shard threads (the
# device-enabled multi-shard engine) each pack concurrently; a shared dict
# would hand one thread's live view to another mid-upload


def _reuse_buf(tag: str, n: int, L: int, dtype) -> np.ndarray:
    """Cached (n, L) scratch view; grown geometrically, pages stay hot.
    Thread-local: safe under concurrent shard-engine packers."""
    bufs = getattr(_pack_tls, "bufs", None)
    if bufs is None:
        bufs = _pack_tls.bufs = {}
    need = n * L
    flat = bufs.get(tag)
    if flat is None or flat.size < need:
        cap = max(need, 2 * (flat.size if flat is not None else 0), 1)
        flat = np.empty(cap, dtype)
        bufs[tag] = flat
    return flat[:need].reshape(n, L)


def pack_reads(bd, max_len: int = 0, native: bool = True,
               reuse: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side packing of a BamData subset into (codes, quals, refpos)
    padded (N, L) tensors. L is rounded up to a multiple of 128 (compile bucket).

    Uses the C++ packer (CIGAR expansion fused with the copy, multithreaded;
    zero-fills padding itself) when available; numpy fallback otherwise.
    With reuse=True the outputs are views of cached scratch buffers —
    INVALIDATED by the next reuse=True call — avoiding tens of MB of fresh
    page-faulted allocation per batch on the hot path.
    """
    n = len(bd)
    lens = np.diff(bd.seq_off)
    L = int(max(max_len, lens.max() if n else 1))
    L = ((L + 127) // 128) * 128
    native_ok = False
    if native and n:
        from ..io import native as native_mod
        native_ok = native_mod.get_lib() is not None
    if reuse and native_ok:
        codes = _reuse_buf("codes", n, L, np.uint8)
        quals = _reuse_buf("quals", n, L, np.uint8)
        refpos = _reuse_buf("refpos", n, L, np.int32)
    else:
        codes = np.zeros((n, L), np.uint8)
        quals = np.zeros((n, L), np.uint8)
        refpos = np.zeros((n, L), np.int32)
    if native and n:
        from ..io import native as native_mod
        lib = native_mod.get_lib()
        if lib is not None:
            import ctypes
            import os as _os
            ptr = ctypes.c_void_p
            pos = np.ascontiguousarray(bd.pos, np.int32)
            cig = np.ascontiguousarray(bd.cigar_flat, np.uint32)
            coff = np.ascontiguousarray(bd.cigar_off, np.int64)
            seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
            qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
            soff = np.ascontiguousarray(bd.seq_off, np.int64)
            lib.pack_reads_native(
                n, pos.ctypes.data_as(ptr), cig.ctypes.data_as(ptr),
                coff.ctypes.data_as(ptr), seq.ctypes.data_as(ptr),
                qual.ctypes.data_as(ptr), soff.ctypes.data_as(ptr),
                L, codes.ctypes.data_as(ptr), quals.ctypes.data_as(ptr),
                refpos.ctypes.data_as(ptr), min(_os.cpu_count() or 1, 8))
            return codes, quals, refpos
    from ..mapper.host import expand_refpos

    rp_flat, _, _ = expand_refpos(bd)
    idx = np.arange(len(bd.seq_flat)) - np.repeat(bd.seq_off[:-1], lens)
    rows = np.repeat(np.arange(n), lens)
    codes[rows, idx] = bd.seq_flat
    quals[rows, idx] = bd.qual_flat
    refpos[rows, idx] = rp_flat
    return codes, quals, refpos


def _pack_hits(vidx: jax.Array, allele: jax.Array, masked: jax.Array,
               capacity: int) -> jax.Array:
    """Compaction into ONE small (2, capacity+1) int32 array, so a chunk's
    hits come back in a single device->host transfer — row 0 is
    [n_hits, read_0, read_1, ...], row 1 is
    [-1, (var_0 << 8) | (base_code_0 << 4) | allele_0, ...]. An n_hits
    above the capacity means the chunk overflowed (the caller reruns it
    exactly on the host).  Embedding the observed (masked) base nibble means hit emission needs NO
    further host-side gathers into the read planes.

    Requires var_idx < 2^23 (dispatch guards this); int32 throughout —
    safe under disabled x64.
    """
    N, L = vidx.shape
    flat_v = vidx.reshape(-1).astype(jnp.int32)
    flat_a = allele.reshape(-1).astype(jnp.int32)
    flat_m = masked.reshape(-1).astype(jnp.int32)
    is_hit = flat_a < NO_HIT
    pos = jnp.cumsum(is_hit) - 1
    n_hits = jnp.sum(is_hit).astype(jnp.int32)
    read_of = (jnp.arange(N * L, dtype=jnp.int32) // L)
    word = (flat_v << 8) | (flat_m << 4) | flat_a
    out = jnp.full((2, capacity + 1), -1, jnp.int32)
    out = out.at[0, 0].set(n_hits)
    idx = jnp.where(is_hit, pos + 1, capacity + 1)  # dropped past capacity
    out = out.at[0, idx].set(read_of, mode="drop")
    return out.at[1, idx].set(word, mode="drop")


@functools.partial(jax.jit, static_argnames=("baseq", "capacity"))
def assign_compact_plane(codes: jax.Array, quals: jax.Array,
                         refpos: jax.Array, vpos: jax.Array,
                         ind_codes: jax.Array, n_ind: jax.Array,
                         baseq: int, capacity: int) -> jax.Array:
    """Fused assign_alleles_device + hit packing: ONE program whose only
    output is the small packed-hit buffer (the (N, L) classification planes
    never leave the device)."""
    masked = jnp.where(quals >= baseq, codes, jnp.uint8(15))
    vidx, allele = _classify_masked(masked, refpos, vpos, ind_codes, n_ind)
    return _pack_hits(vidx, allele, masked, capacity)


# jnp.searchsorted lowering used by every classifier: the binary search
# unrolled over its ~17 levels. On an H100 it runs a 262,144-read launch
# against a 100k-site table 2.2x faster than the rolled "scan" and within 7%
# of "sort", which is 7-9x slower on the CPU backend (ARCHITECTURE.md,
# "Allele classification on the GPU")
_SEARCH_METHOD = "scan_unrolled"


def _classify_masked(masked, refpos, vpos, ind_codes, n_ind):
    """Hit classification from a pre-masked plane (15 = low-qual/N/pad)."""
    vidx = jnp.searchsorted(vpos, refpos, side="left",
                            method=_SEARCH_METHOD).astype(jnp.int32)
    M = vpos.shape[0]
    safe = jnp.minimum(vidx, M - 1)
    hit = (refpos > 0) & (vidx < M) & (vpos[safe] == refpos) & (masked != 15)
    a0 = ind_codes[safe, 0]
    a1 = ind_codes[safe, 1]
    ni = n_ind[safe]
    allele = jnp.where(
        (masked == a0) & (ni > 0), 0,
        jnp.where((masked == a1) & (ni > 1), 1, OTHER)).astype(jnp.int32)
    allele = jnp.where(hit, allele, NO_HIT)
    return jnp.where(hit, vidx, -1), allele


@functools.partial(jax.jit, static_argnames=("capacity",))
def assign_compact_affine_masked(mcodes: jax.Array, start: jax.Array,
                                 lo: jax.Array, hi: jax.Array,
                                 vpos: jax.Array, ind_codes: jax.Array,
                                 n_ind: jax.Array,
                                 capacity: int) -> jax.Array:
    """Affine assign + packing from the 1-byte/base masked plane (BASEQ
    pre-applied by pack_affine_masked) — half the host->device traffic of
    the codes+quals form and no mask op on device."""
    i = jnp.arange(mcodes.shape[1], dtype=jnp.int32)[None, :]
    aligned = (i >= lo[:, None]) & (i < hi[:, None])
    refpos = jnp.where(aligned, start[:, None] + (i - lo[:, None]),
                       jnp.int32(0))
    vidx, allele = _classify_masked(mcodes, refpos, vpos, ind_codes, n_ind)
    return _pack_hits(vidx, allele, mcodes, capacity)


@functools.partial(jax.jit, static_argnames=("capacity",))
def assign_compact_affine_nibble(ncodes: jax.Array, start: jax.Array,
                                 lo: jax.Array, hi: jax.Array,
                                 vpos: jax.Array, ind_codes: jax.Array,
                                 n_ind: jax.Array,
                                 capacity: int) -> jax.Array:
    """Affine assign + packing from the NIBBLE-packed masked plane — two
    bases per byte (even base in the low nibble), HALF the host->device
    traffic of the 1-byte masked form. Unpack is two elementwise ops (mask, shift)
    plus an interleave that XLA fuses into the classification."""
    N, Lh = ncodes.shape
    lo_nib = (ncodes & jnp.uint8(0xF))
    hi_nib = (ncodes >> 4)
    mcodes = jnp.stack([lo_nib, hi_nib], axis=-1).reshape(N, 2 * Lh)
    i = jnp.arange(2 * Lh, dtype=jnp.int32)[None, :]
    aligned = (i >= lo[:, None]) & (i < hi[:, None])
    refpos = jnp.where(aligned, start[:, None] + (i - lo[:, None]),
                       jnp.int32(0))
    vidx, allele = _classify_masked(mcodes, refpos, vpos, ind_codes, n_ind)
    return _pack_hits(vidx, allele, mcodes, capacity)


def pack_affine_nibble(bd, baseq: int, max_len: int = 0,
                       reuse: bool = False):
    """One-pass native nibble-packed masked-plane packing + affine
    classification: (n, L/2) uint8 plane with two masked base nibbles per
    byte. Returns (ncodes, is_affine, start, lo, hi) or None without the
    native library."""
    n = len(bd)
    lens = np.diff(bd.seq_off)
    L = int(max(max_len, lens.max() if n else 1))
    L = ((L + 127) // 128) * 128
    from ..io import native as native_mod
    lib = native_mod.get_lib() if n else None
    if lib is None or not hasattr(lib, "pack_affine_nibble_native"):
        return None
    # Lh is a multiple of 64, not 128: the upload is of the packed host
    # buffer (Lh bytes/read — THE point of this path); any further padding
    # happens on device after the transfer
    Lh = L // 2
    if reuse:
        ncodes = _reuse_buf("ncodes", n, Lh, np.uint8)
    else:
        ncodes = np.empty((n, Lh), np.uint8)
    is_aff = np.empty(n, np.uint8)
    start = np.empty(n, np.int32)
    lo = np.empty(n, np.int32)
    hi = np.empty(n, np.int32)
    import ctypes
    import os as _os
    ptr = ctypes.c_void_p
    pos = np.ascontiguousarray(bd.pos, np.int32)
    cig = np.ascontiguousarray(bd.cigar_flat, np.uint32)
    coff = np.ascontiguousarray(bd.cigar_off, np.int64)
    seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
    qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
    soff = np.ascontiguousarray(bd.seq_off, np.int64)
    lib.pack_affine_nibble_native(
        n, pos.ctypes.data_as(ptr), cig.ctypes.data_as(ptr),
        coff.ctypes.data_as(ptr), seq.ctypes.data_as(ptr),
        qual.ctypes.data_as(ptr), soff.ctypes.data_as(ptr), baseq, Lh,
        ncodes.ctypes.data_as(ptr), is_aff.ctypes.data_as(ptr),
        start.ctypes.data_as(ptr), lo.ctypes.data_as(ptr),
        hi.ctypes.data_as(ptr), min(_os.cpu_count() or 1, 8))
    return ncodes, is_aff.astype(bool), start, lo, hi


def pack_delta_nibble(bd, baseq: int, max_len: int = 0,
                      reuse: bool = False):
    """int16 DELTA-encoded refpos packing for the non-affine, non-spliced
    remainder (deletion / split-M reads): (n, L/2) masked nibble plane +
    (n, L) int16 delta plane, 2.5 B/base vs the 6 B/base
    codes+quals+refpos form (ROADMAP round-3 item). Returns
    (ncodes, delta, ok, start, rp_min, rp_max) or None without the
    native library; rows with ok=False (affine / N/I/P / delta overflow)
    must be routed to other paths."""
    n = len(bd)
    lens = np.diff(bd.seq_off)
    L = int(max(max_len, lens.max() if n else 1))
    L = ((L + 127) // 128) * 128
    from ..io import native as native_mod
    lib = native_mod.get_lib() if n else None
    if lib is None or not hasattr(lib, "pack_delta_nibble_native"):
        return None
    Lh = L // 2
    if reuse:
        ncodes = _reuse_buf("d_ncodes", n, Lh, np.uint8)
        delta = _reuse_buf("d_delta", n, L, np.int16)
    else:
        ncodes = np.empty((n, Lh), np.uint8)
        delta = np.empty((n, L), np.int16)
    ok = np.empty(n, np.uint8)
    start = np.empty(n, np.int32)
    rp_min = np.empty(n, np.int32)
    rp_max = np.empty(n, np.int32)
    import ctypes
    import os as _os
    ptr = ctypes.c_void_p
    pos = np.ascontiguousarray(bd.pos, np.int32)
    cig = np.ascontiguousarray(bd.cigar_flat, np.uint32)
    coff = np.ascontiguousarray(bd.cigar_off, np.int64)
    seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
    qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
    soff = np.ascontiguousarray(bd.seq_off, np.int64)
    lib.pack_delta_nibble_native(
        n, pos.ctypes.data_as(ptr), cig.ctypes.data_as(ptr),
        coff.ctypes.data_as(ptr), seq.ctypes.data_as(ptr),
        qual.ctypes.data_as(ptr), soff.ctypes.data_as(ptr), baseq, Lh,
        ncodes.ctypes.data_as(ptr), delta.ctypes.data_as(ptr),
        ok.ctypes.data_as(ptr), start.ctypes.data_as(ptr),
        rp_min.ctypes.data_as(ptr), rp_max.ctypes.data_as(ptr),
        min(_os.cpu_count() or 1, 8))
    return ncodes, delta, ok.astype(bool), start, rp_min, rp_max


@functools.partial(jax.jit, static_argnames=("capacity",))
def assign_compact_delta_nibble(ncodes: jax.Array, start: jax.Array,
                                delta: jax.Array, vpos: jax.Array,
                                ind_codes: jax.Array, n_ind: jax.Array,
                                capacity: int) -> jax.Array:
    """Fused assign + hit packing from the DELTA-nibble format: refpos is
    reconstructed on device as start + i + delta[i]; masked (15) nibbles
    carry delta 0 and can never hit, so no separate aligned mask ships."""
    N, Lh = ncodes.shape
    L = 2 * Lh
    lo_nib = (ncodes & jnp.uint8(0xF))
    hi_nib = (ncodes >> 4)
    mcodes = jnp.stack([lo_nib, hi_nib], axis=-1).reshape(N, L)
    i = jnp.arange(L, dtype=jnp.int32)[None, :]
    refpos = jnp.where(mcodes != jnp.uint8(15),
                       start[:, None] + i + delta.astype(jnp.int32),
                       jnp.int32(0))
    vidx, allele = _classify_masked(mcodes, refpos, vpos, ind_codes, n_ind)
    return _pack_hits(vidx, allele, mcodes, capacity)


def pack_affine_masked(bd, baseq: int, max_len: int = 0,
                       reuse: bool = False):
    """One-pass native masked-plane packing + affine classification.
    Returns (mcodes, is_affine, start, lo, hi) or None without the
    native library."""
    n = len(bd)
    lens = np.diff(bd.seq_off)
    L = int(max(max_len, lens.max() if n else 1))
    L = ((L + 127) // 128) * 128
    from ..io import native as native_mod
    lib = native_mod.get_lib() if n else None
    if lib is None or not hasattr(lib, "pack_affine_masked_native"):
        return None
    if reuse:
        mcodes = _reuse_buf("mcodes", n, L, np.uint8)
    else:
        mcodes = np.empty((n, L), np.uint8)
    is_aff = np.empty(n, np.uint8)
    start = np.empty(n, np.int32)
    lo = np.empty(n, np.int32)
    hi = np.empty(n, np.int32)
    import ctypes
    import os as _os
    ptr = ctypes.c_void_p
    pos = np.ascontiguousarray(bd.pos, np.int32)
    cig = np.ascontiguousarray(bd.cigar_flat, np.uint32)
    coff = np.ascontiguousarray(bd.cigar_off, np.int64)
    seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
    qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
    soff = np.ascontiguousarray(bd.seq_off, np.int64)
    lib.pack_affine_masked_native(
        n, pos.ctypes.data_as(ptr), cig.ctypes.data_as(ptr),
        coff.ctypes.data_as(ptr), seq.ctypes.data_as(ptr),
        qual.ctypes.data_as(ptr), soff.ctypes.data_as(ptr), baseq, L,
        mcodes.ctypes.data_as(ptr), is_aff.ctypes.data_as(ptr),
        start.ctypes.data_as(ptr), lo.ctypes.data_as(ptr),
        hi.ctypes.data_as(ptr), min(_os.cpu_count() or 1, 8))
    return mcodes, is_aff.astype(bool), start, lo, hi


def decode_packed_hits(full: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray, int]:
    """Decode an already-fetched packed-hit buffer (see _pack_hits layout).
    Returns (read_idx, var_idx, allele_class, base_code, n_hits); n_hits may
    exceed the capacity (overflow — caller falls back)."""
    cap = int(full.shape[1]) - 1
    full = full.astype(np.int64)
    nh = int(full[0, 0])
    if nh > cap:
        return (np.zeros(0, np.int64),) * 2 + \
            (np.zeros(0, np.int16),) * 2 + (nh,)
    body = full[:, 1:1 + nh]
    r = body[0]
    v = body[1] >> 8
    a = (body[1] & 0xF).astype(np.int16)
    mc = ((body[1] >> 4) & 0xF).astype(np.int16)
    return r, v, a, mc, nh


def fetch_packed_hits(packed) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray, int]:
    """Host fetch of a packed-hit buffer as ONE whole-array transfer.

    Many chunks are better fetched together with
    mapper.dispatch.resolve_all (one concatenated transfer)."""
    return decode_packed_hits(np.asarray(packed))


def pack_codes_quals(bd, max_len: int = 0,
                     reuse: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """codes/quals planes only (no refpos) — the host half of the AFFINE
    device path, where refpos is reconstructed on device from per-read
    (start, lo, hi). Cuts host write traffic from 6 to 2 bytes/element."""
    n = len(bd)
    lens = np.diff(bd.seq_off)
    L = int(max(max_len, lens.max() if n else 1))
    L = ((L + 127) // 128) * 128
    from ..io import native as native_mod
    lib = native_mod.get_lib() if n else None
    if lib is not None and hasattr(lib, "pack_codes_quals_native"):
        if reuse:
            codes = _reuse_buf("codes", n, L, np.uint8)
            quals = _reuse_buf("quals", n, L, np.uint8)
        else:
            codes = np.empty((n, L), np.uint8)
            quals = np.empty((n, L), np.uint8)
        import ctypes
        import os as _os
        ptr = ctypes.c_void_p
        seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
        qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
        soff = np.ascontiguousarray(bd.seq_off, np.int64)
        lib.pack_codes_quals_native(
            n, seq.ctypes.data_as(ptr), qual.ctypes.data_as(ptr),
            soff.ctypes.data_as(ptr), L, codes.ctypes.data_as(ptr),
            quals.ctypes.data_as(ptr), min(_os.cpu_count() or 1, 8))
        return codes, quals
    c, q, _ = pack_reads(bd, max_len=max_len, native=False)
    return c, q


def pack_affine(bd, max_len: int = 0, reuse: bool = False):
    """One-pass native packing of codes/quals planes PLUS per-read affine
    CIGAR classification (is_affine, start, lo, hi). Returns None when the
    native library is unavailable (caller composes pack_codes_quals with
    the numpy classifier instead)."""
    n = len(bd)
    lens = np.diff(bd.seq_off)
    L = int(max(max_len, lens.max() if n else 1))
    L = ((L + 127) // 128) * 128
    from ..io import native as native_mod
    lib = native_mod.get_lib() if n else None
    if lib is None or not hasattr(lib, "pack_affine_native"):
        return None
    if reuse:
        codes = _reuse_buf("codes", n, L, np.uint8)
        quals = _reuse_buf("quals", n, L, np.uint8)
    else:
        codes = np.empty((n, L), np.uint8)
        quals = np.empty((n, L), np.uint8)
    is_aff = np.empty(n, np.uint8)
    start = np.empty(n, np.int32)
    lo = np.empty(n, np.int32)
    hi = np.empty(n, np.int32)
    import ctypes
    import os as _os
    ptr = ctypes.c_void_p
    pos = np.ascontiguousarray(bd.pos, np.int32)
    cig = np.ascontiguousarray(bd.cigar_flat, np.uint32)
    coff = np.ascontiguousarray(bd.cigar_off, np.int64)
    seq = np.ascontiguousarray(bd.seq_flat, np.uint8)
    qual = np.ascontiguousarray(bd.qual_flat, np.uint8)
    soff = np.ascontiguousarray(bd.seq_off, np.int64)
    lib.pack_affine_native(
        n, pos.ctypes.data_as(ptr), cig.ctypes.data_as(ptr),
        coff.ctypes.data_as(ptr), seq.ctypes.data_as(ptr),
        qual.ctypes.data_as(ptr), soff.ctypes.data_as(ptr), L,
        codes.ctypes.data_as(ptr), quals.ctypes.data_as(ptr),
        is_aff.ctypes.data_as(ptr), start.ctypes.data_as(ptr),
        lo.ctypes.data_as(ptr), hi.ctypes.data_as(ptr),
        min(_os.cpu_count() or 1, 8))
    return codes, quals, is_aff.astype(bool), start, lo, hi
