/* Baseline JPEG entropy coding (ITU-T T.81, Annex F): the Huffman decoding
 * of one scan into quantised DCT coefficients, and the Huffman encoding of
 * coefficients into one interleaved scan. Everything else of the codec
 * (markers, tables, the DCTs, sampling and colour) is numpy in
 * lidarseg3d_torch/datasets/pipelines/jpeg_read.py and jpeg.py; this file
 * holds the bit-serial part that numpy cannot do at speed.
 *
 * Built with the system C compiler into a shared library and called
 * through ctypes (lidarseg3d_torch/ops/cuda_build.py, HOST_SOURCES).
 *
 * Coefficients are int16 blocks of 64 in natural (row-major) order. Each
 * component's blocks form a [rows, cols, 64] array; ``cols`` is its row
 * stride in blocks. A scan of several components is interleaved: MCU by
 * MCU, each component's v x h blocks in raster order. A scan of one
 * component is not: its blocks in raster order over ``mcus_y`` rows of
 * ``mcus_x`` blocks. */
#include <stdint.h>
#include <string.h>

/* natural index of each zig-zag position, with 16 extra entries so that a
 * corrupt run past position 63 stays in the block */
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { kMaxComps = 4 };
enum {
  kErrTable = -1, kErrCode = -2, kErrRestart = -3, kErrRange = -4,
  kErrFull = -5
};

/* ---- decoding ---------------------------------------------------------- */

typedef struct {
  int32_t mincode[17], maxcode[18], valptr[17];
  const uint8_t *vals;
} Table;

/* canonical codes from the 16 code-length counts (T.81 Annex C) */
static int make_table(Table *t, const uint8_t *bits, const uint8_t *vals) {
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t->valptr[len] = k;
    t->mincode[len] = code;
    code += bits[len];
    k += bits[len];
    t->maxcode[len] = bits[len] ? code - 1 : -1;
    if (k > 256 || code > (1 << len)) return kErrTable;
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  t->vals = vals;
  return 0;
}

typedef struct {
  const uint8_t *p, *end;
  uint64_t acc;
  int nbits;
  int marker; /* the marker the data ran into; zeros are fed after it */
} Bits;

static void fill(Bits *b) {
  while (b->nbits <= 56) {
    int c = 0;
    if (!b->marker && b->p < b->end) {
      c = *b->p++;
      if (c == 0xFF) {
        while (b->p < b->end && *b->p == 0xFF) ++b->p;
        int m = b->p < b->end ? *b->p++ : 0xD9;
        if (m != 0) {
          b->marker = m;
          c = 0;
        }
      }
    }
    b->acc = (b->acc << 8) | (uint64_t)c;
    b->nbits += 8;
  }
}

static inline int get_bits(Bits *b, int n) {
  if (n == 0) return 0;
  if (b->nbits < n) fill(b);
  b->nbits -= n;
  return (int)((b->acc >> b->nbits) & ((1u << n) - 1));
}

static inline int decode(Bits *b, const Table *t) {
  if (b->nbits < 16) fill(b);
  int code = 0;
  for (int len = 1; len <= 16; ++len) {
    code = (code << 1) | (int)((b->acc >> (b->nbits - len)) & 1);
    if (code <= t->maxcode[len]) {
      b->nbits -= len;
      return t->vals[t->valptr[len] + code - t->mincode[len]];
    }
  }
  return kErrCode;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static int decode_block(Bits *b, const Table *dc, const Table *ac,
                        int *pred, int16_t *blk) {
  memset(blk, 0, 64 * sizeof(int16_t));
  int s = decode(b, dc);
  if (s < 0 || s > 15) return kErrCode;
  *pred += s ? extend(get_bits(b, s), s) : 0;
  blk[0] = (int16_t)*pred;
  for (int k = 1; k < 64; ++k) {
    int rs = decode(b, ac);
    if (rs < 0) return kErrCode;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(get_bits(b, s), s);
    } else if (r == 15) {
      k += 15;
    } else {
      break;
    }
  }
  return 0;
}

/* A restart: drop the bits left of the byte, consume the RSTn marker
 * (the data may already have run into it), reset the DC predictions. */
static int restart(Bits *b, int *pred, int ncomp) {
  b->nbits = 0;
  b->acc = 0;
  int m = b->marker;
  if (!m) {
    if (b->p + 1 >= b->end || *b->p != 0xFF) return kErrRestart;
    while (b->p < b->end && *b->p == 0xFF) ++b->p;
    m = b->p < b->end ? *b->p++ : 0;
  }
  if (m < 0xD0 || m > 0xD7) return kErrRestart;
  b->marker = 0;
  for (int c = 0; c < ncomp; ++c) pred[c] = 0;
  return 0;
}

/* Decode one scan of ``ncomp`` components from ``data`` (the bytes after
 * the SOS header). Component c writes its blocks to out[c] (stride
 * cols[c] blocks), with v[c] x h[c] blocks per MCU in an interleaved scan,
 * Huffman tables dc/ac[c] among ``ntables`` (bits: [ntables][17], counts
 * of lengths 1-16 at 1..16; vals: [ntables][256]). Returns the offset in
 * ``data`` of the marker after the scan (or the bytes consumed), or a
 * negative error code. */
int64_t jpeg_decode_scan(const uint8_t *data, int64_t len, int32_t ncomp,
                         const int32_t *h, const int32_t *v,
                         const int32_t *dc, const int32_t *ac,
                         const int32_t *cols, int32_t ntables,
                         const uint8_t *bits, const uint8_t *vals,
                         int32_t mcus_x, int32_t mcus_y,
                         int32_t restart_interval, int16_t **out) {
  if (ncomp < 1 || ncomp > kMaxComps) return kErrRange;
  Table tabs[8];
  if (ntables > 8) return kErrRange;
  for (int t = 0; t < ntables; ++t)
    if (make_table(&tabs[t], bits + 17 * t, vals + 256 * t)) return kErrTable;
  for (int c = 0; c < ncomp; ++c)
    if (dc[c] < 0 || dc[c] >= ntables || ac[c] < 0 || ac[c] >= ntables)
      return kErrTable;
  Bits b = {data, data + len, 0, 0, 0};
  int pred[kMaxComps] = {0};
  int64_t nmcu = (int64_t)mcus_x * mcus_y, left = restart_interval;
  for (int64_t m = 0; m < nmcu; ++m) {
    if (restart_interval && left == 0) {
      int err = restart(&b, pred, ncomp);
      if (err) return err;
      left = restart_interval;
    }
    int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      int hc = ncomp == 1 ? 1 : h[c], vc = ncomp == 1 ? 1 : v[c];
      for (int by = 0; by < vc; ++by)
        for (int bx = 0; bx < hc; ++bx) {
          int64_t row = my * vc + by, col = mx * hc + bx;
          int16_t *blk = out[c] + (row * cols[c] + col) * 64;
          int err = decode_block(&b, &tabs[dc[c]], &tabs[ac[c]], &pred[c],
                                 blk);
          if (err) return err;
        }
    }
    --left;
  }
  /* where the data ends: at the marker it ran into, or after the bytes
   * taken whole; the caller resumes its marker search there */
  if (b.marker) {
    const uint8_t *q = b.p - 2;
    while (q > data && *q == 0xFF && q[-1] == 0xFF) --q;
    return (int64_t)(q - data);
  }
  return (int64_t)(b.p - data) - b.nbits / 8;
}

/* ---- encoding ---------------------------------------------------------- */

typedef struct {
  uint8_t *p, *end;
  uint64_t acc;
  int nbits;
  int full;
} Out;

static inline void put_bits(Out *o, uint32_t code, int size) {
  o->acc = (o->acc << size) | (code & ((1u << size) - 1));
  o->nbits += size;
  while (o->nbits >= 8) {
    o->nbits -= 8;
    uint8_t c = (uint8_t)(o->acc >> o->nbits);
    if (o->p + 2 > o->end) {
      o->full = 1;
      return;
    }
    *o->p++ = c;
    if (c == 0xFF) *o->p++ = 0; /* byte stuffing */
  }
}

static inline int nbits_of(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

static void encode_block(Out *o, const int16_t *blk, int *pred,
                         const uint32_t *dcode, const uint8_t *dsize,
                         const uint32_t *acode, const uint8_t *asize) {
  int diff = blk[0] - *pred;
  *pred = blk[0];
  int s = nbits_of(diff);
  put_bits(o, dcode[s], dsize[s]);
  if (s) put_bits(o, (uint32_t)(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int c = blk[kNatural[k]];
    if (c == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) put_bits(o, acode[0xF0], asize[0xF0]);
    s = nbits_of(c);
    put_bits(o, acode[(run << 4) + s], asize[(run << 4) + s]);
    put_bits(o, (uint32_t)(c < 0 ? c - 1 : c), s);
    run = 0;
  }
  if (run) put_bits(o, acode[0], asize[0]);
}

/* Encode one interleaved scan of ``ncomp`` components (layout as in
 * jpeg_decode_scan; code / size: [ntables][256] Huffman codes and their
 * lengths) into ``dst``, padding the last byte with 1-bits. Returns the
 * bytes written, or kErrFull when ``cap`` is too small. */
int64_t jpeg_encode_scan(int32_t ncomp, const int32_t *h, const int32_t *v,
                         const int32_t *dc, const int32_t *ac,
                         const int32_t *cols, const uint32_t *code,
                         const uint8_t *size, int32_t mcus_x, int32_t mcus_y,
                         int16_t **coefs, uint8_t *dst, int64_t cap) {
  if (ncomp < 1 || ncomp > kMaxComps) return kErrRange;
  Out o = {dst, dst + cap, 0, 0, 0};
  int pred[kMaxComps] = {0};
  for (int64_t my = 0; my < mcus_y; ++my)
    for (int64_t mx = 0; mx < mcus_x; ++mx)
      for (int c = 0; c < ncomp; ++c)
        for (int by = 0; by < v[c]; ++by)
          for (int bx = 0; bx < h[c]; ++bx) {
            int64_t row = my * v[c] + by, col = mx * h[c] + bx;
            encode_block(&o, coefs[c] + (row * cols[c] + col) * 64, &pred[c],
                         code + 256 * dc[c], size + 256 * dc[c],
                         code + 256 * ac[c], size + 256 * ac[c]);
            if (o.full) return kErrFull;
          }
  if (o.nbits) put_bits(&o, 0x7F, 8 - o.nbits);
  return o.full ? kErrFull : (int64_t)(o.p - dst);
}
