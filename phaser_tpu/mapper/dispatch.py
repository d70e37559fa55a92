"""Device/host dispatch for allele assignment.

The device kernels (kernels.alleles) cover the overwhelmingly common cases —
an AFFINE fast path for single-M-run reads (refpos reconstructed on device
from per-read (start, lo, hi); host ships only 2 bytes/base) and a
refpos-plane path for D/N/split-M reads — while the host path handles the
exact-semantics remainder (insertion splicing, multi-base alleles,
duplicate-position table entries). Row union and order are identical to the
pure host path (verified by tests).

Launch/resolve are SPLIT: `assign_alleles_auto(..., defer=True)` uploads and
launches the fused assign+compact programs and returns a PendingHits;
`.resolve()` fetches the packed hits and merges. Callers that process many
chunks launch them all first, then resolve them with one batched transfer
(resolve_all), so the host's packing of later chunks overlaps the device's
work on earlier ones.

Shapes are bucketed to powers of two to bound XLA recompilation.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..engine.varmap import VariantTable
from ..io.bam import (BamData, OP_EQ, OP_H, OP_I, OP_M, OP_N, OP_S, OP_X)
from .host import ContigHits, assign_alleles


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_SUB_ROWS = 1 << 18          # max reads per device launch
_cap_feedback: dict = {}     # bucket key -> max hits observed
_cap_loaded = False


def _cap_path() -> str:
    import os

    from ..utils.jaxtune import cache_dir
    return os.path.join(cache_dir(), "hit_caps.json")


def _cap_load() -> None:
    global _cap_loaded
    if _cap_loaded:
        return
    _cap_loaded = True
    import json
    try:
        with open(_cap_path()) as f:
            for k, v in json.load(f).items():
                kind, np_, l_ = k.rsplit(":", 2)
                _cap_feedback[(kind, int(np_), int(l_))] = int(v)
    except (OSError, ValueError):
        pass


def _cap_save() -> None:
    """Atomic write (tmp + os.replace), merged with the on-disk contents so
    concurrent batch processes don't drop each other's learned caps."""
    import json
    import os
    import tempfile
    try:
        merged = dict(_cap_feedback)
        try:
            with open(_cap_path()) as f:
                for k, v in json.load(f).items():
                    kind, np_, l_ = k.rsplit(":", 2)
                    kk = (kind, int(np_), int(l_))
                    merged[kk] = max(int(v), merged.get(kk, 0))
        except (OSError, ValueError):
            pass
        os.makedirs(os.path.dirname(_cap_path()), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_cap_path()),
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"%s:%d:%d" % k: v for k, v in merged.items()}, f)
        os.replace(tmp, _cap_path())
    except OSError:
        pass


def _adaptive_cap(fb_key, n_elems: int) -> int:
    """Packed-hit capacity for a launch bucket: conservative (elements/32)
    until a resolve reports real hit counts, then 8x the bucket's maximum —
    small results keep the post-launch fetches small, and an overflow
    reruns that chunk on the exact host path (counted in utils.trace).
    Feedback persists next to the XLA compile cache, so later runs size
    their buffers (and their compile buckets) right from the start."""
    _cap_load()
    seen = _cap_feedback.get(fb_key, 0)
    if seen:
        return _next_pow2(max(8 * seen, 8192))
    return _next_pow2(max(n_elems // 32, 8192))


def _read_op_masks(bd: BamData):
    opc = (bd.cigar_flat & 0xF)
    ops_per_read = np.diff(bd.cigar_off)
    op_read = np.repeat(np.arange(len(bd)), ops_per_read)
    has_ins = np.zeros(len(bd), bool)
    np.logical_or.at(has_ins, op_read, opc == OP_I)
    has_n = np.zeros(len(bd), bool)
    np.logical_or.at(has_n, op_read, opc == OP_N)
    return has_ins, has_n


def _affine_params(bd: BamData):
    """Per-read affine classification: reads whose CIGAR is one contiguous
    M/=/X run plus end clips (S/H) have refpos[i] = pos+1 + (i - lo) on
    [lo, hi) and 0 elsewhere. Returns (is_affine, start, lo, hi); reads
    classified non-affine (D/N/I/P or split M runs) are simply routed to
    the refpos-plane or host paths — classification is conservative."""
    n = len(bd)
    opc = (bd.cigar_flat & 0xF).astype(np.int64)
    oplen = (bd.cigar_flat >> 4).astype(np.int64)
    ops_per_read = np.diff(bd.cigar_off)
    op_read = np.repeat(np.arange(n), ops_per_read)
    within = np.arange(len(opc)) - np.repeat(bd.cigar_off[:-1], ops_per_read)

    is_m = (opc == OP_M) | (opc == OP_EQ) | (opc == OP_X)
    allowed = is_m | (opc == OP_S) | (opc == OP_H)
    has_bad = np.zeros(n, bool)
    np.logical_or.at(has_bad, op_read, ~allowed)

    n_m = np.zeros(n, np.int64)
    np.add.at(n_m, op_read, is_m.astype(np.int64))
    first_m = np.full(n, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_m, op_read[is_m], within[is_m])
    last_m = np.full(n, -1, np.int64)
    np.maximum.at(last_m, op_read[is_m], within[is_m])
    contig_m = (n_m >= 1) & (last_m - first_m + 1 == n_m)
    is_affine = ~has_bad & contig_m

    lo = np.zeros(n, np.int64)
    lead_s = (opc == OP_S) & (within < first_m[op_read])
    np.add.at(lo, op_read[lead_s], oplen[lead_s])
    m_total = np.zeros(n, np.int64)
    np.add.at(m_total, op_read[is_m], oplen[is_m])
    start = bd.pos.astype(np.int64) + 1
    return is_affine, start.astype(np.int32), lo.astype(np.int32), \
        (lo + m_total).astype(np.int32)


class PendingHits:
    """Launched device work + completed host parts for one chunk.

    resolve() performs the device->host fetches and the final merge; it is
    safe to call long after launch (device buffers are held alive here)."""

    def __init__(self, fallback: Callable[[], ContigHits],
                 dev_parts: List[Tuple[object, int, Optional[np.ndarray],
                                       np.ndarray, int, tuple]],
                 host_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 hits_map: dict):
        self._fallback = fallback
        # (packed_dev, cap, row_map, dev_vidx, row_offset, fb_key)
        self._dev = dev_parts
        self._host = host_parts        # (read_idx, var_idx, codes16)
        self._map = hits_map

    def wait(self) -> None:
        """Wait until all launched device programs have completed (no host
        fetch), so the device time is accounted to the device path."""
        import jax
        from ..utils.trace import device_section
        with device_section():
            for part in self._dev:
                jax.block_until_ready(part[0])

    def resolve(self, prefetched: Optional[List[np.ndarray]] = None
                ) -> ContigHits:
        from ..kernels.alleles import decode_packed_hits, fetch_packed_hits
        from ..utils.trace import count_device_fallback

        rows_parts = list(self._host)
        for k, (packed, cap, row_map, dev_vidx, offset, fb_key) in \
                enumerate(self._dev):
            if prefetched is not None:
                r, v, a, mc, nh = decode_packed_hits(prefetched[k])
            else:
                from ..utils.trace import device_section
                with device_section():
                    r, v, a, mc, nh = fetch_packed_hits(packed)
            if nh > _cap_feedback.get(fb_key, 0):
                _cap_feedback[fb_key] = nh
                _cap_save()
            if nh > cap:
                # capacity overflow: exact host rerun for the chunk (rare)
                count_device_fallback()
                return self._fallback()
            vfull = dev_vidx[v]
            codes_out = mc  # the observed masked nibble IS the allele code
            if row_map is not None:
                r = row_map[r]
            elif offset:
                r = r + offset
            rows_parts.append((r, vfull, codes_out))

        if not rows_parts:
            return ContigHits(np.zeros(0, np.int64), np.zeros(0, np.int64),
                              np.zeros(0, np.int16))
        all_r = np.concatenate([p[0] for p in rows_parts]).astype(np.int64)
        all_v = np.concatenate([p[1] for p in rows_parts]).astype(np.int64)
        all_c = np.concatenate([p[2] for p in rows_parts]).astype(np.int16)
        order = np.lexsort((all_v, all_r))
        hits = ContigHits(all_r[order], all_v[order], all_c[order])
        if self._map:
            for newpos, oldpos in enumerate(order):
                key = (int(all_r[oldpos]), int(all_v[oldpos]))
                if key in self._map:
                    hits.allele_strs[newpos] = self._map[key]
                    hits.allele_code[newpos] = -1
        return hits


def assign_alleles_auto(bd: BamData, vt: VariantTable, *, baseq: int,
                        splice: bool = True, isize_cutoff: float = 0,
                        device: str = "auto", defer: bool = False):
    """Device-accelerated assign_alleles with exact host fallback.

    With defer=True returns a PendingHits (launch only); otherwise returns
    the resolved ContigHits directly."""
    if device in ("host", "off") or len(bd) == 0 or len(vt) == 0:
        hits = assign_alleles(bd, vt, baseq=baseq, splice=splice,
                              isize_cutoff=isize_cutoff)
        return _ResolvedPending(hits) if defer else hits
    import jax
    import jax.numpy as jnp
    from ..kernels.alleles import (assign_compact_plane, pack_codes_quals,
                                   pack_reads)

    if np.any(np.diff(vt.pos) < 0):
        raise ValueError("variant table must be position-sorted")

    def _fallback():
        return assign_alleles(bd, vt, baseq=baseq, splice=splice,
                              isize_cutoff=isize_cutoff)

    has_ins, has_n = _read_op_masks(bd)
    keep_read = np.ones(len(bd), bool)
    if isize_cutoff != 0:
        keep_read &= np.abs(bd.tlen.astype(np.int64)) <= isize_cutoff
    if not splice:
        keep_read &= ~has_n

    # device-eligible variants: simple alleles at unique positions
    pos = vt.pos
    dup = np.zeros(len(vt), bool)
    if len(vt) > 1:
        d = np.diff(pos) == 0
        dup[1:] |= d
        dup[:-1] |= d
    dev_var = vt.is_simple & ~dup
    if len(vt) >= (1 << 23):  # packed-hit layout limit; never seen per-contig
        from ..utils.trace import count_device_fallback
        count_device_fallback()
        hits = _fallback()
        return _ResolvedPending(hits) if defer else hits
    dev_vidx = np.flatnonzero(dev_var)

    dev_read = keep_read & ~has_ins
    # CPU backend device_put can alias numpy buffers zero-copy — scratch
    # reuse is only safe where uploads are real copies
    reuse = jax.default_backend() not in ("cpu",)

    dev_parts = []
    host_parts = []
    from ..utils.trace import add_device_time
    _t_dev = time.perf_counter()
    if dev_vidx.size and dev_read.any():
        M = dev_vidx.size
        Mp = _next_pow2(max(M, 8))
        vpos = np.full(Mp, np.iinfo(np.int32).max, np.int32)
        vpos[:M] = pos[dev_vidx].astype(np.int32)
        ind = np.zeros((Mp, 2), np.uint8)
        ind[:M] = vt.ind_codes[dev_vidx]
        ni = np.zeros(Mp, np.int8)
        ni[:M] = vt.n_ind[dev_vidx]
        jv, ji, jn = jnp.asarray(vpos), jnp.asarray(ind), jnp.asarray(ni)

        from ..kernels.alleles import (assign_compact_affine_masked,
                                       assign_compact_affine_nibble,
                                       pack_affine_masked, pack_affine_nibble)
        nibble = pack_affine_nibble(bd, baseq, reuse=reuse)
        if nibble is not None:
            # nibble-packed plane: 2 bases/byte — half the host->device
            # upload of the masked plane
            mcodes, is_aff, a_start, a_lo, a_hi = nibble
            pad_val, kind, kern = 0xFF, "affine_nib", assign_compact_affine_nibble
        else:
            fused_pack = pack_affine_masked(bd, baseq, reuse=reuse)
            if fused_pack is not None:
                mcodes, is_aff, a_start, a_lo, a_hi = fused_pack
            else:
                is_aff, a_start, a_lo, a_hi = _affine_params(bd)
                mcodes = None
            pad_val, kind, kern = 15, "affine", assign_compact_affine_masked
        aff = dev_read & is_aff

        if aff.any():
            # affine fast path: masked plane (BASEQ pre-applied) with refpos
            # reconstructed on device. Launched in <=_SUB_ROWS sub-batches
            # so compile buckets are fixed-size (compiled once ever,
            # persisted) and each packed result stays small.
            if mcodes is None:
                codes, quals = pack_codes_quals(bd, reuse=reuse)
                mcodes = np.where(quals >= baseq, codes,
                                  np.uint8(15)).astype(np.uint8)
            N, L = mcodes.shape
            st_k = np.where(aff, a_start, 0).astype(np.int32)
            lo_k = np.where(aff, a_lo, 0).astype(np.int32)
            hi_k = np.where(aff, a_hi, 0).astype(np.int32)
            for s in range(0, N, _SUB_ROWS):
                e = min(s + _SUB_ROWS, N)
                if not aff[s:e].any():
                    continue
                n_sub = e - s
                Np = _next_pow2(max(n_sub, 8))
                cs = mcodes[s:e]
                ss, ls, hs = st_k[s:e], lo_k[s:e], hi_k[s:e]
                if Np != n_sub:
                    cs = np.pad(cs, ((0, Np - n_sub), (0, 0)),
                                constant_values=pad_val)
                    ss, ls, hs = (np.pad(x, (0, Np - n_sub))
                                  for x in (ss, ls, hs))
                jc = jnp.asarray(cs)
                if reuse:
                    # the scratch plane is rewritten by the next chunk's
                    # pack; wait for the copy to complete
                    jax.block_until_ready(jc)
                # L is the PACKED plane width for the nibble path (two
                # bases/byte): first-run cap must bound true base count
                n_bases = Np * L * (2 if kind == "affine_nib" else 1)
                fb_key = (kind, Np, L)
                cap = _adaptive_cap(fb_key, n_bases)
                packed = kern(
                    jc, jnp.asarray(ss), jnp.asarray(ls),
                    jnp.asarray(hs), jv, ji, jn, cap)
                dev_parts.append((packed, cap, None, dev_vidx, s, fb_key))

        plane_all = np.flatnonzero(dev_read & ~is_aff)
        for s in range(0, plane_all.size, _SUB_ROWS):
            # non-affine remainder: DELTA-nibble format for D/split-M reads
            # (2.5 B/base: masked nibble + int16 delta refpos), refpos
            # plane (6 B/base) only for what delta can't carry (N-spliced
            # reads, delta overflow)
            plane_sel = plane_all[s:s + _SUB_ROWS]
            sub = bd.select(plane_sel)
            from ..kernels.alleles import pack_delta_nibble
            dn = pack_delta_nibble(sub, baseq, reuse=reuse)
            if dn is not None:
                ncd, dlt, okm, dst, _, _ = dn
                ok_idx = np.flatnonzero(okm)
            else:
                ok_idx = np.zeros(0, np.int64)
            if ok_idx.size:
                Nd = ok_idx.size
                Npd = _next_pow2(max(Nd, 8))
                Ld = dlt.shape[1]
                nc = np.full((Npd, Ld // 2), 0xFF, np.uint8)
                nc[:Nd] = ncd[ok_idx]
                dl = np.zeros((Npd, Ld), np.int16)
                dl[:Nd] = dlt[ok_idx]
                st_d = np.zeros(Npd, np.int32)
                st_d[:Nd] = dst[ok_idx]
                from ..kernels.alleles import assign_compact_delta_nibble
                fb_key = ("delta_nib", Npd, Ld)
                cap_d = _adaptive_cap(fb_key, Npd * Ld)
                packed_d = assign_compact_delta_nibble(
                    jnp.asarray(nc), jnp.asarray(st_d),
                    jnp.asarray(dl), jv, ji, jn, cap_d)
                dev_parts.append((packed_d, cap_d, plane_sel[ok_idx],
                                  dev_vidx, 0, fb_key))
            if dn is not None:
                rest_idx = np.flatnonzero(~okm)
                if rest_idx.size == 0:
                    continue
                plane_sel = plane_sel[rest_idx]
                sub = sub.select(rest_idx)
            codes2, quals2, refpos2 = pack_reads(sub)
            N2, L2 = codes2.shape
            Np2 = _next_pow2(max(N2, 8))
            if Np2 != N2:
                codes2 = np.pad(codes2, ((0, Np2 - N2), (0, 0)))
                quals2 = np.pad(quals2, ((0, Np2 - N2), (0, 0)))
                refpos2 = np.pad(refpos2, ((0, Np2 - N2), (0, 0)))
            fb_key = ("plane", Np2, L2)
            cap2 = _adaptive_cap(fb_key, Np2 * L2)
            packed2 = assign_compact_plane(
                jnp.asarray(codes2), jnp.asarray(quals2),
                jnp.asarray(refpos2), jv, ji, jn, baseq, cap2)
            dev_parts.append((packed2, cap2, plane_sel, dev_vidx, 0, fb_key))
    # device-path time: table/read upload prep + launches (async); the
    # wait/fetch side is accounted in PendingHits.wait / resolve_all
    add_device_time(time.perf_counter() - _t_dev)

    # host remainder 1: insertion reads vs all variants
    hits_map = {}
    ins_sel = np.flatnonzero(has_ins & keep_read)
    if ins_sel.size:
        sub = bd.select(ins_sel)
        h = assign_alleles(sub, vt, baseq=baseq, splice=splice,
                           isize_cutoff=isize_cutoff)
        rr = ins_sel[h.read_idx]
        host_parts.append((rr, h.var_idx.copy(), h.allele_code.copy()))
        for row, s in h.allele_strs.items():
            hits_map[(int(rr[row]), int(h.var_idx[row]))] = s

    # host remainder 2: non-device variants vs non-insertion reads
    rem_vidx = np.flatnonzero(~dev_var)
    nonins_sel = np.flatnonzero(~has_ins)
    if rem_vidx.size and nonins_sel.size:
        sub_vt = VariantTable(
            chrom=vt.chrom, pos=vt.pos[rem_vidx],
            unique_ids=[vt.unique_ids[i] for i in rem_vidx],
            rs_ids=[vt.rs_ids[i] for i in rem_vidx],
            all_alleles=[vt.all_alleles[i] for i in rem_vidx],
            ref_len=vt.ref_len[rem_vidx],
            geno_strings=[vt.geno_strings[i] for i in rem_vidx],
            maf_strs=[vt.maf_strs[i] for i in rem_vidx])
        sub_vt.finalize()
        sub = bd.select(nonins_sel)
        h = assign_alleles(sub, sub_vt, baseq=baseq, splice=splice,
                           isize_cutoff=isize_cutoff)
        rr = nonins_sel[h.read_idx]
        vv = rem_vidx[h.var_idx]
        host_parts.append((rr, vv, h.allele_code.copy()))
        for row, s in h.allele_strs.items():
            hits_map[(int(rr[row]), int(vv[row]))] = s

    pending = PendingHits(_fallback, dev_parts, host_parts, hits_map)
    return pending if defer else pending.resolve()


class _ResolvedPending:
    """PendingHits-compatible wrapper around an already-resolved result."""

    def __init__(self, hits: ContigHits):
        self._hits = hits

    def wait(self) -> None:
        pass

    def resolve(self, prefetched=None) -> ContigHits:
        return self._hits


@functools.lru_cache(maxsize=None)
def _concat_jit(n: int):
    import jax
    import jax.numpy as jnp
    return jax.jit(lambda *bs: jnp.concatenate(bs, axis=1))


def resolve_all(pendings: List) -> List[ContigHits]:
    """Resolve many launched chunks with ONE batched device->host transfer.

    All pending device buffers are concatenated on device (a single program)
    and fetched in one transfer, which collapses N per-chunk fetches into
    one. Resolves per chunk when there is nothing to batch."""
    import jax

    from ..utils.trace import device_section

    parts = []
    for p in pendings:
        if isinstance(p, PendingHits):
            parts.extend(p._dev)
    views: List[np.ndarray] = []
    with device_section():
        if len(parts) > 1:
            bufs = [pt[0] for pt in parts]
            for b in bufs:
                jax.block_until_ready(b)
            cat = _concat_jit(len(bufs))(*bufs)
            full = np.asarray(cat)
            off = 0
            for b in bufs:
                w = int(b.shape[1])
                views.append(full[:, off:off + w])
                off += w
        elif len(parts) == 1:
            views.append(np.asarray(parts[0][0]))

    out: List[ContigHits] = []
    vi = 0
    for p in pendings:
        if isinstance(p, PendingHits):
            k = len(p._dev)
            out.append(p.resolve(prefetched=views[vi:vi + k]))
            vi += k
        else:
            out.append(p.resolve())
    return out
