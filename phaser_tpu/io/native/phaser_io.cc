// phaser_tpu native IO: multithreaded BGZF inflate + BAM parsing to
// struct-of-arrays buffers, plus padded read-tensor packing for the device
// allele-assignment kernel.
//
// Replaces the reference's `samtools view` pipes + Cython mapper front-end
// (/root/reference/phaser/phaser.py:1346) with an in-process decoder that
// feeds fixed-width int tensors. C API consumed via ctypes (no pybind11).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>
#include <zlib.h>

#if defined(__has_include) && !defined(PHASER_NO_LIBDEFLATE)
#if __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define PHASER_HAVE_LIBDEFLATE 1
#endif
#endif

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

struct BgzfBlock {
  int64_t coff;    // compressed offset
  int32_t bsize;   // compressed block size
  int64_t uoff;    // uncompressed offset
  int32_t isize;   // uncompressed size
};

static int scan_blocks(const uint8_t* data, int64_t size,
                       std::vector<BgzfBlock>* blocks) {
  int64_t off = 0;
  int64_t uoff = 0;
  while (off + 28 <= size) {
    if (data[off] != 0x1f || data[off + 1] != 0x8b) return -1;
    uint16_t xlen;
    memcpy(&xlen, data + off + 10, 2);
    int64_t xoff = off + 12, xend = xoff + xlen;
    int32_t bsize = -1;
    while (xoff + 4 <= xend) {
      uint8_t si1 = data[xoff], si2 = data[xoff + 1];
      uint16_t slen;
      memcpy(&slen, data + xoff + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, data + xoff + 4, 2);
        bsize = (int32_t)bs + 1;
        break;
      }
      xoff += 4 + slen;
    }
    if (bsize < 0) return -2;
    if (off + bsize > size) return -3;
    int32_t isize;
    memcpy(&isize, data + off + bsize - 4, 4);
    blocks->push_back({off, bsize, uoff, isize});
    uoff += isize;
    off += bsize;
  }
  return 0;
}

// Returns total uncompressed size, or negative error.
int64_t bgzf_total_size(const uint8_t* data, int64_t size) {
  std::vector<BgzfBlock> blocks;
  int rc = scan_blocks(data, size, &blocks);
  if (rc != 0) return rc;
  int64_t total = 0;
  for (auto& b : blocks) total += b.isize;
  return total;
}

// Parallel inflate of all blocks into out (caller sizes via bgzf_total_size).
int64_t bgzf_decompress(const uint8_t* data, int64_t size, uint8_t* out,
                        int n_threads) {
  std::vector<BgzfBlock> blocks;
  if (scan_blocks(data, size, &blocks) != 0) return -1;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  std::vector<int> errs(n_threads, 0);
  size_t nb = blocks.size();
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
#ifdef PHASER_HAVE_LIBDEFLATE
      struct libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
      if (!dec) { errs[t] = 1; return; }
#endif
      for (size_t i = t; i < nb; i += n_threads) {
        const BgzfBlock& b = blocks[i];
        if (b.isize == 0) continue;
        const uint8_t* src = data + b.coff;
        uint16_t xlen;
        memcpy(&xlen, src + 10, 2);
        const uint8_t* cdata = src + 12 + xlen;
        int64_t clen = b.bsize - 12 - xlen - 8;
#ifdef PHASER_HAVE_LIBDEFLATE
        size_t actual = 0;
        enum libdeflate_result r = libdeflate_deflate_decompress(
            dec, cdata, (size_t)clen, out + b.uoff, (size_t)b.isize, &actual);
        if (r != LIBDEFLATE_SUCCESS || actual != (size_t)b.isize) {
          errs[t] = 2;
          break;
        }
#else
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) { errs[t] = 1; return; }
        zs.next_in = const_cast<uint8_t*>(cdata);
        zs.avail_in = (uInt)clen;
        zs.next_out = out + b.uoff;
        zs.avail_out = (uInt)b.isize;
        int r = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (r != Z_STREAM_END) { errs[t] = 2; return; }
#endif
      }
#ifdef PHASER_HAVE_LIBDEFLATE
      libdeflate_free_decompressor(dec);
#endif
    });
  }
  for (auto& th : threads) th.join();
  for (int e : errs) if (e) return -2;
  int64_t total = 0;
  for (auto& b : blocks) total += b.isize;
  return total;
}

// ---------------------------------------------------------------------------
// BAM parse (operates on uncompressed BAM bytes)
// ---------------------------------------------------------------------------

struct BamIndexed {
  // per-record scalars
  std::vector<int32_t> refid, pos, tlen, as_score;
  std::vector<uint8_t> mapq, has_as;
  std::vector<uint16_t> flag;
  std::vector<int64_t> cigar_off, seq_off, name_off;
  // ragged
  std::vector<uint32_t> cigar;
  std::vector<uint8_t> seq, qual;   // seq = one nibble code per base
  std::vector<char> names;          // concatenated, no terminators
  // refs
  std::vector<char> ref_names;      // \0-joined
  std::vector<int32_t> ref_lens;
  int64_t header_text_off = 0, header_text_len = 0;
  int32_t n_refs = 0;
  std::string header_text;
};

static int32_t rd_i32(const uint8_t* p) { int32_t v; memcpy(&v, p, 4); return v; }

static void find_first_as(const uint8_t* p, const uint8_t* end, int32_t* as,
                          uint8_t* has) {
  *as = 0; *has = 0;
  while (p + 3 <= end) {
    char t0 = p[0], t1 = p[1], typ = p[2];
    p += 3;
    int sz = 0;
    switch (typ) {
      case 'A': case 'c': case 'C': sz = 1; break;
      case 's': case 'S': sz = 2; break;
      case 'i': case 'I': case 'f': sz = 4; break;
      case 'Z': case 'H': {
        while (p < end && *p) p++;
        p++;
        continue;
      }
      case 'B': {
        if (p + 5 > end) return;
        char sub = (char)p[0];
        int32_t cnt = rd_i32(p + 1);
        int esz = (sub=='c'||sub=='C') ? 1 : (sub=='s'||sub=='S') ? 2 : 4;
        p += 5 + (int64_t)esz * cnt;
        continue;
      }
      default: return;
    }
    if (t0 == 'A' && t1 == 'S' && typ != 'A' && typ != 'f') {
      int64_t v = 0;
      switch (typ) {
        case 'c': v = *(int8_t*)p; break;
        case 'C': v = *(uint8_t*)p; break;
        case 's': { int16_t x; memcpy(&x, p, 2); v = x; break; }
        case 'S': { uint16_t x; memcpy(&x, p, 2); v = x; break; }
        case 'i': { int32_t x; memcpy(&x, p, 4); v = x; break; }
        case 'I': { uint32_t x; memcpy(&x, p, 4); v = x; break; }
      }
      *as = (int32_t)v; *has = 1;
      return;
    }
    p += sz;
  }
}

// Parse the BAM header section only; returns bytes consumed (or -1).
static int64_t parse_bam_header(const uint8_t* data, int64_t size,
                                BamIndexed* bi) {
  if (size < 12 || memcmp(data, "BAM\x01", 4) != 0) return -1;
  int64_t off = 4;
  int32_t l_text = rd_i32(data + off); off += 4;
  bi->header_text.assign((const char*)data + off, l_text);
  size_t nul = bi->header_text.find('\0');
  if (nul != std::string::npos) bi->header_text.resize(nul);
  off += l_text;
  bi->n_refs = rd_i32(data + off); off += 4;
  for (int i = 0; i < bi->n_refs; i++) {
    int32_t l_name = rd_i32(data + off); off += 4;
    bi->ref_names.insert(bi->ref_names.end(), (const char*)data + off,
                         (const char*)data + off + l_name);  // includes \0
    off += l_name;
    bi->ref_lens.push_back(rd_i32(data + off)); off += 4;
  }
  return off;
}

// Parse as many COMPLETE records as fit in [start, size); returns bytes
// consumed (a partial trailing record is left for the caller to carry).
static int64_t parse_bam_records(const uint8_t* data, int64_t start,
                                 int64_t size, BamIndexed* bi) {
  int64_t off = start;
  while (off + 4 <= size) {
    int32_t block_size = rd_i32(data + off);
    if (off + 4 + block_size > size) break;  // partial record
    off += 4;
    const uint8_t* rec = data + off;
    const uint8_t* rec_end = rec + block_size;
    int32_t rid = rd_i32(rec);
    int32_t p = rd_i32(rec + 4);
    uint8_t l_read_name = rec[8];
    uint8_t mq = rec[9];
    uint16_t n_cigar; memcpy(&n_cigar, rec + 12, 2);
    uint16_t fl; memcpy(&fl, rec + 14, 2);
    int32_t l_seq = rd_i32(rec + 16);
    int32_t tl = rd_i32(rec + 28);
    const uint8_t* q = rec + 32;
    bi->names.insert(bi->names.end(), (const char*)q,
                     (const char*)q + l_read_name - 1);
    bi->name_off.push_back((int64_t)bi->names.size());
    q += l_read_name;
    const uint32_t* cig = (const uint32_t*)q;
    bi->cigar.insert(bi->cigar.end(), cig, cig + n_cigar);
    bi->cigar_off.push_back((int64_t)bi->cigar.size());
    q += 4 * (int64_t)n_cigar;
    int64_t nbytes = (l_seq + 1) / 2;
    size_t sbase = bi->seq.size();
    bi->seq.resize(sbase + l_seq);
    for (int64_t k = 0; k < l_seq; k++) {
      uint8_t byte = q[k >> 1];
      bi->seq[sbase + k] = (k & 1) ? (byte & 0xF) : (byte >> 4);
    }
    q += nbytes;
    bi->qual.insert(bi->qual.end(), q, q + l_seq);
    bi->seq_off.push_back((int64_t)bi->seq.size());
    q += l_seq;
    int32_t as; uint8_t has;
    find_first_as(q, rec_end, &as, &has);
    bi->refid.push_back(rid);
    bi->pos.push_back(p);
    bi->mapq.push_back(mq);
    bi->flag.push_back(fl);
    bi->tlen.push_back(tl);
    bi->as_score.push_back(as);
    bi->has_as.push_back(has);
    off += block_size;
  }
  return off;
}

// ---------------------------------------------------------------------------
// Parallel BGZF compression: BGZF members are independent, so blocks
// compress concurrently (libdeflate when available) and concatenate into a
// standard stream. Used for fast BAM/VCF output and bench fixtures.
// ---------------------------------------------------------------------------

static const int64_t kBgzfIn = 0xff00;        // uncompressed bytes per block
static const int64_t kBgzfSlot = 0x10800;     // per-block output slot bound

int64_t bgzf_compress_bound(int64_t size) {
  int64_t nb = (size + kBgzfIn - 1) / kBgzfIn;
  if (nb < 1) nb = 1;
  return nb * kBgzfSlot;
}

// Compresses [data, data+size) as BGZF members into out (caller sizes via
// bgzf_compress_bound). No EOF block. Returns compressed bytes or negative.
int64_t bgzf_compress(const uint8_t* data, int64_t size, int level,
                      uint8_t* out, int n_threads) {
  int64_t nb = (size + kBgzfIn - 1) / kBgzfIn;
  if (size == 0) nb = 0;
  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> block_len((size_t)nb, 0);
  std::vector<uint8_t> scratch((size_t)(nb * kBgzfSlot));
  std::vector<int> errs(n_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
#ifdef PHASER_HAVE_LIBDEFLATE
      struct libdeflate_compressor* comp =
          libdeflate_alloc_compressor(level < 1 ? 1 : level);
      if (!comp) { errs[t] = 1; return; }
#endif
      for (int64_t i = t; i < nb; i += n_threads) {
        const uint8_t* src = data + i * kBgzfIn;
        int64_t in_len = size - i * kBgzfIn;
        if (in_len > kBgzfIn) in_len = kBgzfIn;
        uint8_t* slot = scratch.data() + i * kBgzfSlot;
        // 18-byte gzip header with BC extra field (bsize patched below)
        static const uint8_t hdr[18] = {
            0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff,
            6, 0, 66, 67, 2, 0, 0, 0};
        memcpy(slot, hdr, 18);
        size_t clen = 0;
#ifdef PHASER_HAVE_LIBDEFLATE
        clen = libdeflate_deflate_compress(comp, src, (size_t)in_len,
                                           slot + 18,
                                           (size_t)(kBgzfSlot - 26));
        if (clen == 0) { errs[t] = 2; break; }
        uint32_t crc = libdeflate_crc32(0, src, (size_t)in_len);
#else
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, level < 1 ? 1 : level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) { errs[t] = 1; return; }
        zs.next_in = const_cast<uint8_t*>(src);
        zs.avail_in = (uInt)in_len;
        zs.next_out = slot + 18;
        zs.avail_out = (uInt)(kBgzfSlot - 26);
        int r = deflate(&zs, Z_FINISH);
        clen = zs.total_out;
        deflateEnd(&zs);
        if (r != Z_STREAM_END) { errs[t] = 2; break; }
        uint32_t crc = (uint32_t)crc32(0, src, (uInt)in_len);
#endif
        uint16_t bsize = (uint16_t)(clen + 26 - 1);
        memcpy(slot + 16, &bsize, 2);
        memcpy(slot + 18 + clen, &crc, 4);
        uint32_t isz = (uint32_t)in_len;
        memcpy(slot + 22 + clen, &isz, 4);
        block_len[(size_t)i] = (int64_t)clen + 26;
      }
#ifdef PHASER_HAVE_LIBDEFLATE
      libdeflate_free_compressor(comp);
#endif
    });
  }
  for (auto& th : threads) th.join();
  for (int e : errs) if (e) return -1;
  int64_t off = 0;
  for (int64_t i = 0; i < nb; i++) {
    memmove(out + off, scratch.data() + i * kBgzfSlot, block_len[(size_t)i]);
    off += block_len[(size_t)i];
  }
  return off;
}

// ---------------------------------------------------------------------------
// v2 record parse: two passes. Pass 1 (bam_scan_v2) jump-scans the record
// stream reading only the fixed headers, so the caller can allocate exact
// struct-of-arrays numpy buffers. Pass 2 (bam_parse_v2) re-walks the offsets
// sequentially (cheap) and then fills all payloads IN PARALLEL directly into
// the caller's buffers — no intermediate vectors, no second copy. This is
// what lets decode keep up with a multi-M-reads/s mapper on few cores.
// ---------------------------------------------------------------------------

// (first base in the low byte address) 256-entry packed-nibble expansion LUT
static uint16_t kNibLut[256];
static bool init_nib_lut() {
  for (int b = 0; b < 256; b++)
    kNibLut[b] = (uint16_t)((b >> 4) | ((b & 0xF) << 8));
  return true;
}
static bool _nib_lut_ready = init_nib_lut();

// Pass 1: counts records and ragged totals over complete records in
// [0, size); returns bytes consumed (partial trailing record excluded).
int64_t bam_scan_v2(const uint8_t* data, int64_t size, int64_t* out_n,
                    int64_t* tot_cigar, int64_t* tot_seq,
                    int64_t* tot_names) {
  int64_t off = 0, n = 0, tc = 0, ts = 0, tn = 0;
  while (off + 4 <= size) {
    int32_t bs = rd_i32(data + off);
    if (bs < 32 || off + 4 + bs > size) break;
    const uint8_t* rec = data + off + 4;
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    int32_t l_seq = rd_i32(rec + 16);
    n++;
    tc += n_cigar;
    ts += l_seq;
    tn += l_read_name > 0 ? l_read_name - 1 : 0;
    off += 4 + bs;
  }
  *out_n = n;
  *tot_cigar = tc;
  *tot_seq = ts;
  *tot_names = tn;
  return off;
}

// Pass 2: fill caller-allocated SoA buffers (sizes from bam_scan_v2).
// cigar_off/seq_off/name_off must have n+1 slots. Returns bytes consumed.
int64_t bam_parse_v2(const uint8_t* data, int64_t size, int64_t n,
                     int32_t* refid, int32_t* pos, uint8_t* mapq,
                     uint16_t* flag, int32_t* tlen, int32_t* as_score,
                     uint8_t* has_as, int64_t* cigar_off, int64_t* seq_off,
                     int64_t* name_off, uint32_t* cigar, uint8_t* seq,
                     uint8_t* qual, char* names, int n_threads) {
  // sequential offset walk (jump-only)
  std::vector<int64_t> rec_off((size_t)n);
  int64_t off = 0, tc = 0, ts = 0, tn = 0;
  cigar_off[0] = seq_off[0] = name_off[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t bs = rd_i32(data + off);
    const uint8_t* rec = data + off + 4;
    rec_off[(size_t)i] = off;
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    int32_t l_seq = rd_i32(rec + 16);
    tc += n_cigar;
    ts += l_seq;
    tn += l_read_name > 0 ? l_read_name - 1 : 0;
    cigar_off[i + 1] = tc;
    seq_off[i + 1] = ts;
    name_off[i + 1] = tn;
    off += 4 + bs;
  }
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([=, &rec_off]() {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      for (int64_t i = lo; i < hi; i++) {
        const uint8_t* rec = data + rec_off[(size_t)i] + 4;
        int32_t bs = rd_i32(data + rec_off[(size_t)i]);
        const uint8_t* rec_end = rec + bs;
        refid[i] = rd_i32(rec);
        pos[i] = rd_i32(rec + 4);
        uint8_t l_read_name = rec[8];
        mapq[i] = rec[9];
        uint16_t n_cigar;
        memcpy(&n_cigar, rec + 12, 2);
        memcpy(&flag[i], rec + 14, 2);
        int32_t l_seq = rd_i32(rec + 16);
        tlen[i] = rd_i32(rec + 28);
        const uint8_t* q = rec + 32;
        if (l_read_name > 0)
          memcpy(names + name_off[i], q, l_read_name - 1);
        q += l_read_name;
        memcpy(cigar + cigar_off[i], q, 4 * (int64_t)n_cigar);
        q += 4 * (int64_t)n_cigar;
        uint8_t* sdst = seq + seq_off[i];
        int64_t pairs = l_seq >> 1;
        for (int64_t k = 0; k < pairs; k++)
          memcpy(sdst + 2 * k, &kNibLut[q[k]], 2);
        if (l_seq & 1) sdst[l_seq - 1] = q[pairs] >> 4;
        q += (l_seq + 1) / 2;
        memcpy(qual + seq_off[i], q, l_seq);
        q += l_seq;
        find_first_as(q, rec_end, &as_score[i], &has_as[i]);
      }
    });
  }
  for (auto& th : threads) th.join();
  return off;
}

static void init_offsets(BamIndexed* bi) {
  bi->cigar_off.push_back(0);
  bi->seq_off.push_back(0);
  bi->name_off.push_back(0);
}

void* bam_parse(const uint8_t* data, int64_t size) {
  BamIndexed* bi = new BamIndexed();
  int64_t off = parse_bam_header(data, size, bi);
  if (off < 0) { delete bi; return nullptr; }
  init_offsets(bi);
  parse_bam_records(data, off, size, bi);
  return bi;
}

// Streaming: header-only parse; *consumed = bytes of the header section.
void* bam_header_only(const uint8_t* data, int64_t size, int64_t* consumed) {
  BamIndexed* bi = new BamIndexed();
  int64_t off = parse_bam_header(data, size, bi);
  if (off < 0) { delete bi; return nullptr; }
  init_offsets(bi);
  *consumed = off;
  return bi;
}

// Streaming: parse complete records from a headerless byte window;
// *consumed = bytes used (partial trailing record excluded).
void* bam_records_parse(const uint8_t* data, int64_t size,
                        int64_t* consumed) {
  BamIndexed* bi = new BamIndexed();
  init_offsets(bi);
  *consumed = parse_bam_records(data, 0, size, bi);
  return bi;
}

int64_t bam_n_records(void* h) { return (int64_t)((BamIndexed*)h)->refid.size(); }
int32_t bam_n_refs(void* h) { return ((BamIndexed*)h)->n_refs; }
int64_t bam_total_cigar(void* h) { return (int64_t)((BamIndexed*)h)->cigar.size(); }
int64_t bam_total_seq(void* h) { return (int64_t)((BamIndexed*)h)->seq.size(); }
int64_t bam_names_size(void* h) { return (int64_t)((BamIndexed*)h)->names.size(); }
int64_t bam_refnames_size(void* h) { return (int64_t)((BamIndexed*)h)->ref_names.size(); }
int64_t bam_header_size(void* h) { return (int64_t)((BamIndexed*)h)->header_text.size(); }

void bam_fill(void* h, int32_t* refid, int32_t* pos, uint8_t* mapq,
              uint16_t* flag, int32_t* tlen, int32_t* as_score,
              uint8_t* has_as, int64_t* cigar_off, int64_t* seq_off,
              int64_t* name_off, uint32_t* cigar, uint8_t* seq, uint8_t* qual,
              char* names, char* ref_names, int32_t* ref_lens, char* header) {
  BamIndexed* b = (BamIndexed*)h;
  int64_t n = (int64_t)b->refid.size();
  memcpy(refid, b->refid.data(), n * 4);
  memcpy(pos, b->pos.data(), n * 4);
  memcpy(mapq, b->mapq.data(), n);
  memcpy(flag, b->flag.data(), n * 2);
  memcpy(tlen, b->tlen.data(), n * 4);
  memcpy(as_score, b->as_score.data(), n * 4);
  memcpy(has_as, b->has_as.data(), n);
  memcpy(cigar_off, b->cigar_off.data(), (n + 1) * 8);
  memcpy(seq_off, b->seq_off.data(), (n + 1) * 8);
  memcpy(name_off, b->name_off.data(), (n + 1) * 8);
  memcpy(cigar, b->cigar.data(), b->cigar.size() * 4);
  memcpy(seq, b->seq.data(), b->seq.size());
  memcpy(qual, b->qual.data(), b->qual.size());
  memcpy(names, b->names.data(), b->names.size());
  memcpy(ref_names, b->ref_names.data(), b->ref_names.size());
  memcpy(ref_lens, b->ref_lens.data(), b->ref_lens.size() * 4);
  memcpy(header, b->header_text.data(), b->header_text.size());
}

void bam_free(void* h) { delete (BamIndexed*)h; }

// ---------------------------------------------------------------------------
// Padded read-tensor packing (codes/quals/refpos) with CIGAR expansion —
// the host half of the device allele-assignment kernel.
// ---------------------------------------------------------------------------

void pack_reads_native(
    // inputs (SoA for n reads)
    int64_t n, const int32_t* pos, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off,
    // outputs (n x L); may be UNinitialized — padding is zero-filled here
    int64_t L, uint8_t* codes, uint8_t* quals, int32_t* refpos,
    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        int64_t so = seq_off[i];
        int64_t slen = seq_off[i + 1] - so;
        if (slen > L) slen = L;
        memcpy(codes + i * L, seq + so, slen);
        memcpy(quals + i * L, qual + so, slen);
        memset(codes + i * L + slen, 0, L - slen);
        memset(quals + i * L + slen, 0, L - slen);
        int32_t* rp = refpos + i * L;
        memset(rp, 0, L * sizeof(int32_t));
        int64_t read_i = 0;
        int64_t g = (int64_t)pos[i] + 1;  // 1-based
        for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++) {
          uint32_t op = cigar[c];
          int64_t len = op >> 4;
          switch (op & 0xF) {
            case 0: case 7: case 8:  // M, =, X
              for (int64_t k = 0; k < len && read_i < L; k++, read_i++, g++)
                rp[read_i] = (int32_t)g;
              break;
            case 1: case 4:          // I, S
              read_i += len;
              break;
            case 2: case 3:          // D, N
              g += len;
              break;
            default: break;          // H, P
          }
          if (read_i >= L) break;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
}

// codes/quals-only packing for the affine device path (refpos is computed
// on device from per-read (start, lo, hi) — two-thirds less host traffic)
void pack_codes_quals_native(
    int64_t n, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, int64_t L, uint8_t* codes, uint8_t* quals,
    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        int64_t so = seq_off[i];
        int64_t slen = seq_off[i + 1] - so;
        if (slen > L) slen = L;
        memcpy(codes + i * L, seq + so, slen);
        memcpy(quals + i * L, qual + so, slen);
        memset(codes + i * L + slen, 0, L - slen);
        memset(quals + i * L + slen, 0, L - slen);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// masked single-plane packing fused with affine CIGAR classification:
// one pass emits ONE byte/base ((qual >= baseq) ? nibble : 15 — the BASEQ
// mask pre-applied so the device needs no quals plane) plus per-read
// (is_affine, start, lo, hi) for device-side refpos reconstruction
void pack_affine_masked_native(
    int64_t n, const int32_t* pos, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, int baseq, int64_t L, uint8_t* mcodes,
    uint8_t* is_affine, int32_t* start, int32_t* lo, int32_t* hi,
    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        int64_t so = seq_off[i];
        int64_t slen = seq_off[i + 1] - so;
        if (slen > L) slen = L;
        uint8_t* out = mcodes + i * L;
        const uint8_t* sq = seq + so;
        const uint8_t* qu = qual + so;
        const uint8_t bq = (uint8_t)baseq;
        // branchless select (auto-vectorizes): low-qual -> 15
        for (int64_t k = 0; k < slen; k++) {
          uint8_t bad = (uint8_t)-(qu[k] < bq);  // 0x00 or 0xFF
          out[k] = (uint8_t)(((sq[k] & 0xF) & ~bad) | (15 & bad));
        }
        memset(out + slen, 15, L - slen);  // pad = masked (never a hit)

        bool bad = false;
        int64_t first_m = -1, last_m = -1, n_m = 0;
        int64_t lead_s = 0, m_total = 0;
        for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++) {
          uint32_t opc = cigar[c] & 0xF;
          int64_t len = cigar[c] >> 4;
          int64_t w = c - cigar_off[i];
          bool m_type = (opc == 0 || opc == 7 || opc == 8);
          if (m_type) {
            if (first_m < 0) first_m = w;
            last_m = w;
            n_m++;
            m_total += len;
          } else if (opc == 4) {
            if (first_m < 0) lead_s += len;
          } else if (opc != 5) {
            bad = true;
          }
        }
        bool affine = !bad && n_m >= 1 && (last_m - first_m + 1 == n_m);
        is_affine[i] = affine ? 1 : 0;
        start[i] = pos[i] + 1;
        lo[i] = (int32_t)lead_s;
        hi[i] = (int32_t)(lead_s + m_total);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// nibble-packed variant of pack_affine_masked_native: TWO bases per output
// byte (even base in the low nibble, odd base in the high nibble), halving
// the host->device upload of the affine device path.
// Output plane is (n, Lh) with Lh = L/2; pad nibbles are 15 (0xFF bytes).
void pack_affine_nibble_native(
    int64_t n, const int32_t* pos, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, int baseq, int64_t Lh, uint8_t* ncodes,
    uint8_t* is_affine, int32_t* start, int32_t* lo, int32_t* hi,
    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        int64_t so = seq_off[i];
        int64_t slen = seq_off[i + 1] - so;
        if (slen > 2 * Lh) slen = 2 * Lh;
        uint8_t* out = ncodes + i * Lh;
        const uint8_t* sq = seq + so;
        const uint8_t* qu = qual + so;
        const uint8_t bq = (uint8_t)baseq;
        int64_t pairs = slen / 2;
        for (int64_t j = 0; j < pairs; j++) {
          uint8_t bad0 = (uint8_t)-(qu[2 * j] < bq);
          uint8_t bad1 = (uint8_t)-(qu[2 * j + 1] < bq);
          uint8_t m0 = (uint8_t)(((sq[2 * j] & 0xF) & ~bad0) | (15 & bad0));
          uint8_t m1 =
              (uint8_t)(((sq[2 * j + 1] & 0xF) & ~bad1) | (15 & bad1));
          out[j] = (uint8_t)(m0 | (m1 << 4));
        }
        if (slen & 1) {
          uint8_t bad0 = (uint8_t)-(qu[slen - 1] < bq);
          uint8_t m0 =
              (uint8_t)(((sq[slen - 1] & 0xF) & ~bad0) | (15 & bad0));
          out[pairs] = (uint8_t)(m0 | 0xF0);  // odd tail: high nibble = pad
          pairs++;
        }
        memset(out + pairs, 0xFF, Lh - pairs);  // pad = masked (never a hit)

        bool bad = false;
        int64_t first_m = -1, last_m = -1, n_m = 0;
        int64_t lead_s = 0, m_total = 0;
        for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++) {
          uint32_t opc = cigar[c] & 0xF;
          int64_t len = cigar[c] >> 4;
          int64_t w = c - cigar_off[i];
          bool m_type = (opc == 0 || opc == 7 || opc == 8);
          if (m_type) {
            if (first_m < 0) first_m = w;
            last_m = w;
            n_m++;
            m_total += len;
          } else if (opc == 4) {
            if (first_m < 0) lead_s += len;
          } else if (opc != 5) {
            bad = true;
          }
        }
        bool affine = !bad && n_m >= 1 && (last_m - first_m + 1 == n_m);
        is_affine[i] = affine ? 1 : 0;
        start[i] = pos[i] + 1;
        lo[i] = (int32_t)lead_s;
        hi[i] = (int32_t)(lead_s + m_total);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// int16 DELTA-encoded refpos packing for non-affine, non-spliced,
// non-insertion reads (deletion / split-M CIGARs): the device
// reconstructs refpos[i] = start + i + delta[i] for bases whose nibble is
// not 15, so the plane ships at 0.5 B/base (masked nibble) + 2 B/base
// (delta) instead of the 6 B/base codes+quals+refpos form. Unaligned
// bases (S clips) are masked to 15 unconditionally — they can never hit,
// and that removes any need for a separate aligned mask. ok[i]=0 routes
// the read elsewhere (affine reads use the cheaper affine path; N/I/P or
// delta overflow falls back to the refpos-plane path).
void pack_delta_nibble_native(
    int64_t n, const int32_t* pos, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, int baseq, int64_t Lh, uint8_t* ncodes,
    int16_t* delta, uint8_t* ok, int32_t* start, int32_t* rp_min,
    int32_t* rp_max, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  int64_t L = 2 * Lh;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        int64_t so = seq_off[i];
        int64_t slen = seq_off[i + 1] - so;
        if (slen > L) slen = L;
        const uint8_t* sq = seq + so;
        const uint8_t* qu = qual + so;
        const uint8_t bq = (uint8_t)baseq;
        uint8_t* out = ncodes + i * Lh;
        int16_t* dl = delta + i * L;
        int32_t st = pos[i] + 1;
        start[i] = st;

        // CIGAR scan: classify + per-base refpos
        bool bad = false, affine_ok = true;
        int64_t n_m = 0, first_m = -1, last_m = -1, w = 0;
        for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++, w++) {
          uint32_t opc = cigar[c] & 0xF;
          bool m_type = (opc == 0 || opc == 7 || opc == 8);
          if (m_type) {
            if (first_m < 0) first_m = w;
            last_m = w;
            n_m++;
          } else if (opc == 1 || opc == 3 || opc == 6) {  // I, N, P
            bad = true;
          } else if (opc != 2 && opc != 4 && opc != 5) {  // not D/S/H
            bad = true;
          }
        }
        bool affine = n_m >= 1 && (last_m - first_m + 1 == n_m);
        // per-op D between M runs breaks affinity; recheck: affine means
        // ONLY M runs + clips (no D at all)
        for (int64_t c = cigar_off[i]; affine && c < cigar_off[i + 1];
             c++) {
          if ((cigar[c] & 0xF) == 2) affine = false;
        }
        (void)affine_ok;
        if (bad || affine || n_m == 0) {
          ok[i] = 0;
          rp_min[i] = 0;
          rp_max[i] = 0;
          // still zero the planes so reuse buffers stay defined
          memset(out, 0xFF, (size_t)Lh);
          memset(dl, 0, (size_t)(L * 2));
          continue;
        }

        int64_t qi = 0;       // query index
        int64_t gpos = st;    // next reference position (1-based)
        bool overflow = false;
        int32_t rmin = 0x7fffffff, rmax = 0;
        // init planes: masked / zero
        memset(out, 0xFF, (size_t)Lh);
        memset(dl, 0, (size_t)(L * 2));
        for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++) {
          uint32_t opc = cigar[c] & 0xF;
          int64_t len = cigar[c] >> 4;
          if (opc == 0 || opc == 7 || opc == 8) {        // M/=/X
            for (int64_t k = 0; k < len && qi < slen; k++, qi++, gpos++) {
              uint8_t nib = (qu[qi] < bq) ? 15 : (uint8_t)(sq[qi] & 0xF);
              if (qi & 1)
                out[qi >> 1] = (uint8_t)((out[qi >> 1] & 0x0F) | (nib << 4));
              else
                out[qi >> 1] = (uint8_t)((out[qi >> 1] & 0xF0) | nib);
              int64_t d = gpos - (st + qi);
              if (d < -32768 || d > 32767) overflow = true;
              dl[qi] = (int16_t)d;
              if ((int32_t)gpos < rmin) rmin = (int32_t)gpos;
              if ((int32_t)gpos > rmax) rmax = (int32_t)gpos;
            }
          } else if (opc == 2) {                          // D
            gpos += len;
          } else if (opc == 4) {                          // S
            qi += len;  // stays masked (0xFF init)
          }                                               // H: nothing
        }
        if (overflow) {
          ok[i] = 0;
          rp_min[i] = 0;
          rp_max[i] = 0;
          memset(out, 0xFF, (size_t)Lh);
          memset(dl, 0, (size_t)(L * 2));
        } else {
          ok[i] = 1;
          rp_min[i] = (rmin == 0x7fffffff) ? 0 : rmin;
          rp_max[i] = rmax;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
}

// codes/quals packing fused with affine CIGAR classification: one pass
// emits the planes plus per-read (is_affine, start, lo, hi) for the
// device-side refpos reconstruction (mapper.dispatch._affine_params
// semantics, at native speed)
void pack_affine_native(
    int64_t n, const int32_t* pos, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, int64_t L, uint8_t* codes, uint8_t* quals,
    uint8_t* is_affine, int32_t* start, int32_t* lo, int32_t* hi,
    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) {
        int64_t so = seq_off[i];
        int64_t slen = seq_off[i + 1] - so;
        if (slen > L) slen = L;
        memcpy(codes + i * L, seq + so, slen);
        memcpy(quals + i * L, qual + so, slen);
        memset(codes + i * L + slen, 0, L - slen);
        memset(quals + i * L + slen, 0, L - slen);

        bool bad = false;
        int64_t first_m = -1, last_m = -1, n_m = 0;
        int64_t lead_s = 0, m_total = 0;
        for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++) {
          uint32_t opc = cigar[c] & 0xF;
          int64_t len = cigar[c] >> 4;
          int64_t w = c - cigar_off[i];
          bool m_type = (opc == 0 || opc == 7 || opc == 8);  // M,=,X
          if (m_type) {
            if (first_m < 0) first_m = w;
            last_m = w;
            n_m++;
            m_total += len;
          } else if (opc == 4) {                             // S
            if (first_m < 0) lead_s += len;
          } else if (opc != 5) {                             // H allowed
            bad = true;
          }
        }
        bool affine = !bad && n_m >= 1 && (last_m - first_m + 1 == n_m);
        is_affine[i] = affine ? 1 : 0;
        start[i] = pos[i] + 1;
        lo[i] = (int32_t)lead_s;
        hi[i] = (int32_t)(lead_s + m_total);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Exact allele extraction (the reference's split_read + identify_allele
// string algorithm, /root/reference/phaser/read_variant_map.py:165-258) for
// reads that need insertion splicing / deletion stripping — the host-Python
// fallback's hot loop, at native speed.
// ---------------------------------------------------------------------------

static const char kNibbleChars[17] = "=ACMGRSVTWYHKDBN";

struct Segment {
  int64_t gstart = 0;         // genome offset of segment start (incl. gaps)
  std::string pseudo;         // aligned bases + 'D' placeholders
  std::vector<std::pair<int64_t, std::string>> insertions;  // (offset, bases)
};

// Emits one row per (read, variant) with a non-empty, non-"N" allele.
// Returns number of rows, or -1 on capacity overflow.
int64_t exact_assign(
    int64_t n, const int32_t* pos1, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const uint8_t* quals,
    const int64_t* seq_off, int baseq, int splice,
    int64_t n_vars, const int64_t* vpos, const int32_t* ref_len,
    int64_t cap, int64_t* out_read, int64_t* out_var,
    int64_t alleles_cap, char* out_alleles, int64_t* out_allele_off) {
  int64_t n_rows = 0;
  int64_t a_used = 0;
  out_allele_off[0] = 0;
  std::string bases;
  std::vector<Segment> segments;
  for (int64_t r = 0; r < n; r++) {
    // splice==0: skip reads with N ops
    bool hasN = false;
    for (int64_t c = cigar_off[r]; c < cigar_off[r + 1]; c++)
      if ((cigar[c] & 0xF) == 3) { hasN = true; break; }
    if (!splice && hasN) continue;

    int64_t slen = seq_off[r + 1] - seq_off[r];
    bases.resize(slen);
    for (int64_t k = 0; k < slen; k++) {
      uint8_t q = quals[seq_off[r] + k];
      bases[k] = (q >= (uint8_t)baseq) ? kNibbleChars[seq[seq_off[r] + k] & 0xF]
                                       : 'N';
    }
    segments.clear();
    segments.emplace_back();
    int64_t genome_pos = 0, read_pos = 0, ref_span = 0;
    for (int64_t c = cigar_off[r]; c < cigar_off[r + 1]; c++) {
      int64_t len = cigar[c] >> 4;
      switch (cigar[c] & 0xF) {
        case 0: case 7: case 8:   // M/=/X
          segments.back().pseudo.append(bases, read_pos, len);
          read_pos += len; genome_pos += len; ref_span += len;
          break;
        case 3:                   // N: close segment
          segments.emplace_back();
          genome_pos += len; ref_span += len;
          segments.back().gstart = genome_pos;
          break;
        case 2:                   // D
          segments.back().pseudo.append(len, 'D');
          genome_pos += len; ref_span += len;
          break;
        case 1: {                 // I
          // dict semantics: a later insertion at the same offset replaces
          // the earlier one (reference keys insertions by genome_pos-1)
          auto& ins = segments.back().insertions;
          if (!ins.empty() && ins.back().first == genome_pos - 1) {
            ins.back().second = bases.substr(read_pos, len);
          } else {
            ins.emplace_back(genome_pos - 1, bases.substr(read_pos, len));
          }
          read_pos += len;
          break;
        }
        case 4: read_pos += len; break;  // S
        default: break;                  // H/P
      }
    }
    // variant window [pos1-1, pos1+span] via binary search
    int64_t p1 = pos1[r];
    const int64_t* lo_it = std::lower_bound(vpos, vpos + n_vars, p1 - 1);
    int64_t vi = lo_it - vpos;
    for (; vi < n_vars && vpos[vi] <= p1 + ref_span; vi++) {
      int64_t vp = vpos[vi];
      int32_t rl = ref_len[vi];
      for (const Segment& seg : segments) {
        int64_t map_start = p1 + seg.gstart;
        int64_t rs = vp - map_start;
        int64_t re = vp + rl - map_start;
        if (rs < 0 || re > (int64_t)seg.pseudo.size()) continue;
        std::string read_seq = seg.pseudo.substr(rs, re - rs);
        int64_t offset = 0;
        for (const auto& ins : seg.insertions) {
          if (ins.first >= rs && ins.first < re) {
            int64_t insert_pos = (ins.first - rs) + offset + 1;
            read_seq.insert(insert_pos, ins.second);
            offset += (int64_t)ins.second.size();
          }
        }
        read_seq.erase(std::remove(read_seq.begin(), read_seq.end(), 'D'),
                       read_seq.end());
        if (!read_seq.empty() && read_seq != "N") {
          if (n_rows >= cap ||
              a_used + (int64_t)read_seq.size() > alleles_cap)
            return -1;
          out_read[n_rows] = r;
          out_var[n_rows] = vi;
          memcpy(out_alleles + a_used, read_seq.data(), read_seq.size());
          a_used += read_seq.size();
          n_rows++;
          out_allele_off[n_rows] = a_used;
        }
        break;
      }
    }
  }
  return n_rows;
}

// ---------------------------------------------------------------------------
// Fused simple-variant mapper: the production replacement for the reference's
// whole `samtools view | call_read_variant_map.py` pipe on the host side
// (/root/reference/phaser/phaser.py:1346, read_variant_map.py:3-124). One
// multithreaded pass: per read, walk the aligned M/=/X runs of the CIGAR,
// binary-search the position-sorted variant table for overlaps, and emit one
// (read, variant, BASEQ-masked nibble) row per overlapping single-base
// variant. Semantics mirror mapper.host's numpy fast path exactly:
//   - rows with masked code 15 (low qual / N) are dropped (ref :255)
//   - reads with insertions are skipped entirely and flagged need_exact
//   - reads coarsely overlapping a non-simple variant are flagged need_exact
//     (their simple rows are still emitted here; the exact path skips them)
//   - splice==0 drops reads with N ops outright
//   - duplicate-position table entries each get a row
// ---------------------------------------------------------------------------

struct MapPart {
  std::vector<int32_t> read, vidx;
  std::vector<uint8_t> code;
};
struct MapResult {
  std::vector<MapPart> parts;
};

void* map_simple_run(
    int64_t n, const int32_t* pos, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, const uint8_t* keep,
    int64_t n_vars, const int64_t* vpos, const int32_t* ref_len,
    const uint8_t* is_simple, int32_t max_rl,
    int baseq, int splice, uint8_t* need_exact, int n_threads) {
  MapResult* res = new MapResult();
  if (n_threads < 1) n_threads = 1;
  res->parts.resize(n_threads);
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  const uint8_t bq = (uint8_t)baseq;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([=]() {
      MapPart& out = res->parts[t];
      out.read.reserve(4096);
      int64_t lo_r = t * chunk;
      int64_t hi_r = lo_r + chunk < n ? lo_r + chunk : n;
      // reused per-read aligned-run list: (genome_start, len, read_off)
      std::vector<int64_t> run_g, run_len, run_ro;
      for (int64_t r = lo_r; r < hi_r; r++) {
        need_exact[r] = 0;
        if (keep && !keep[r]) continue;
        bool hasI = false, hasN = false;
        run_g.clear(); run_len.clear(); run_ro.clear();
        int64_t p1 = (int64_t)pos[r] + 1;
        int64_t g = p1, read_i = 0;
        for (int64_t c = cigar_off[r]; c < cigar_off[r + 1]; c++) {
          uint32_t opc = cigar[c] & 0xF;
          int64_t len = cigar[c] >> 4;
          switch (opc) {
            case 0: case 7: case 8:   // M/=/X
              run_g.push_back(g); run_len.push_back(len);
              run_ro.push_back(read_i);
              g += len; read_i += len;
              break;
            case 1: hasI = true; read_i += len; break;  // I
            case 2: g += len; break;                    // D
            case 3: hasN = true; g += len; break;       // N
            case 4: read_i += len; break;               // S
            default: break;                             // H/P
          }
        }
        if (!splice && hasN) continue;       // read dropped (ref :170)
        if (hasI) { need_exact[r] = 1; continue; }  // exact path owns it
        int64_t span = g - p1;
        // variant window: non-simple coarse test needs vp >= p1 - ref_len
        const int64_t* it = std::lower_bound(vpos, vpos + n_vars,
                                             p1 - (int64_t)max_rl - 1);
        for (int64_t vi = it - vpos;
             vi < n_vars && vpos[vi] <= p1 + span; vi++) {
          int64_t vp = vpos[vi];
          if (is_simple[vi]) {
            if (vp < p1) continue;
            for (size_t u = 0; u < run_g.size(); u++) {
              if (vp >= run_g[u] && vp < run_g[u] + run_len[u]) {
                int64_t k = seq_off[r] + run_ro[u] + (vp - run_g[u]);
                uint8_t c = (qual[k] >= bq) ? (uint8_t)(seq[k] & 0xF)
                                            : (uint8_t)15;
                if (c != 15) {
                  out.read.push_back((int32_t)r);
                  out.vidx.push_back((int32_t)vi);
                  out.code.push_back(c);
                }
                break;
              }
            }
          } else {
            // host coarse test: starts <= vp+rl && ends+1 >= vp
            if (p1 <= vp + (int64_t)ref_len[vi] && p1 + span + 1 >= vp)
              need_exact[r] = 1;
          }
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return res;
}

int64_t map_simple_n(void* h) {
  MapResult* res = (MapResult*)h;
  int64_t total = 0;
  for (auto& p : res->parts) total += (int64_t)p.read.size();
  return total;
}

// Concatenates thread parts in order (== read order) and frees the handle.
void map_simple_fetch(void* h, int32_t* out_read, int32_t* out_vidx,
                      uint8_t* out_code) {
  MapResult* res = (MapResult*)h;
  int64_t off = 0;
  for (auto& p : res->parts) {
    memcpy(out_read + off, p.read.data(), p.read.size() * 4);
    memcpy(out_vidx + off, p.vidx.data(), p.vidx.size() * 4);
    memcpy(out_code + off, p.code.data(), p.code.size());
    off += (int64_t)p.read.size();
  }
  delete res;
}

// Scatter fixed-width rows to arbitrary byte offsets (ragged assembly
// without giant numpy index temporaries): out[dst_off[i] : +width] = src row i.
void scatter_rows(int64_t n_rows, const int64_t* dst_off, const uint8_t* src,
                  int64_t width, uint8_t* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([=]() {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
      for (int64_t i = lo; i < hi; i++)
        memcpy(out + dst_off[i], src + i * width, width);
    });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Heap pre-faulting: this class of VM serves first-touch page faults of
// private anonymous memory remotely (~0.5 ms/page). Faulting the working set
// up front with many threads (faults pipeline across threads), combined with
// malloc no-trim so the pages are reused, removes the stall from the
// steady-state pipeline.
// ---------------------------------------------------------------------------

void* prefault_alloc(int64_t bytes, int n_threads) {
  uint8_t* p = (uint8_t*)malloc(bytes);
  if (!p) return nullptr;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  int64_t chunk = (bytes + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([=]() {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < bytes ? lo + chunk : bytes;
      for (int64_t off = lo; off < hi; off += 4096) p[off] = 0;
    });
  }
  for (auto& th : threads) th.join();
  return p;
}

void prefault_free(void* p) { free(p); }

// single-pass record scan for BAM index building: for each record in the
// headerless record buffer, emit (refid, pos0, end0 from the CIGAR's
// reference span, record's uncompressed begin/end offsets). Returns the
// record count, or -1 on a malformed/truncated buffer.
int64_t bam_index_scan(const uint8_t* data, int64_t size, int64_t cap,
                       int32_t* rid, int32_t* pos0, int32_t* end0,
                       int64_t* ubeg, int64_t* uend) {
  int64_t off = 0;
  int64_t n = 0;
  while (off + 4 <= size) {
    int32_t block_size;
    memcpy(&block_size, data + off, 4);
    int64_t rec_end = off + 4 + (int64_t)block_size;
    if (block_size < 32 || rec_end > size) return -1;
    if (n >= cap) return -1;
    int32_t r, p;
    memcpy(&r, data + off + 4, 4);
    memcpy(&p, data + off + 8, 4);
    uint8_t l_read_name = data[off + 12];
    uint16_t n_cigar;
    memcpy(&n_cigar, data + off + 16, 2);
    int64_t span = 0;
    int64_t coff = off + 36 + (int64_t)l_read_name;
    // the CIGAR array must lie inside the record: a corrupt block_size /
    // n_cigar pair (n_cigar up to 65535) must return -1, not read past
    // rec_end or the buffer (round-4 advisor finding)
    if (coff + 4LL * n_cigar > rec_end) return -1;
    for (uint16_t c = 0; c < n_cigar; c++) {
      uint32_t op;
      memcpy(&op, data + coff + 4LL * c, 4);
      uint32_t opc = op & 0xF;
      if (opc == 0 || opc == 2 || opc == 3 || opc == 7 || opc == 8)
        span += op >> 4;
    }
    rid[n] = r;
    pos0[n] = p;
    end0[n] = (int32_t)(p + (span > 0 ? span : 1));
    ubeg[n] = off;
    uend[n] = rec_end;
    n++;
    off = rec_end;
  }
  return (off == size) ? n : -1;
}

// ragged row gather: out[new_off[r] : new_off[r+1]] =
// src[off[idx[r]] : off[idx[r]+1]] for r in [0, k). Parallel memcpy per
// row — replaces numpy's repeat-based fancy gather (the dominant cost of
// BamData.select on scattered flag/mapq masks).
void gather_ragged_u8(int64_t k, const int64_t* idx, const uint8_t* src,
                      const int64_t* off, const int64_t* new_off,
                      uint8_t* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([=]() {
      for (int64_t r = t; r < k; r += n_threads) {
        int64_t i = idx[r];
        int64_t n = off[i + 1] - off[i];
        memcpy(out + new_off[r], src + off[i], (size_t)n);
      }
    });
  }
  for (auto& th : threads) th.join();
}

void gather_ragged_u32(int64_t k, const int64_t* idx, const uint32_t* src,
                       const int64_t* off, const int64_t* new_off,
                       uint32_t* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([=]() {
      for (int64_t r = t; r < k; r += n_threads) {
        int64_t i = idx[r];
        int64_t n = off[i + 1] - off[i];
        memcpy(out + new_off[r], src + off[i], (size_t)(n * 4));
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
