// JPEG decoding equal to libjpeg-turbo at its defaults, as PIL calls it
// (``np.asarray(PIL.Image.open(path))``): Huffman-coded 8-bit sequential
// (SOF0 / SOF1) and progressive (SOF2) frames, the accurate integer IDCT
// (jidctint.c ``jpeg_idct_islow`` with jdmaster.c's range-limit table), fancy
// chroma upsampling (jdsample.c ``h2v1_fancy_upsample`` /
// ``h2v2_fancy_upsample``, box replication below three chroma columns, the
// edge rows replicated as jdmainct.c's context rows do) and fixed-point
// YCbCr -> RGB (jdcolor.c). The colour space follows jdapimin.c's
// ``default_decompress_parms``: JFIF means YCbCr, else an Adobe APP14
// transform of 0 means RGB, else component ids 'R', 'G', 'B'.
//
// Everything libjpeg would only warn about (a bad Huffman code, entropy
// data that runs out, a wrong restart marker, a bogus progression) is
// refused here, as are the frames and layouts outside the list above:
// arithmetic coding, lossless, hierarchical and 12-bit frames, 2 or 4
// components, sampling factors other than 1x1 for every component or
// 2x1 / 2x2 luma with 1x1 chroma, and a progressive file whose first nine
// AC coefficients are left unrefined (libjpeg would smooth its blocks).
//
// C interface (ctypes):
//   jpeg_header(data, len, info[3], err, errlen)  -> 0, info = width, height, components
//   jpeg_decode(data, len, out, out_len, err, errlen) -> 0; out = height x width x components
// Both return -1 and write a message into err on failure.

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Refused {
  std::string msg;
};

[[noreturn]] void refuse(const std::string& msg) { throw Refused{msg}; }

// jutils.c jpeg_natural_order, with libjpeg's 16 guard entries
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

constexpr int kLook = 9;  // bits resolved by one table lookup

struct Huff {
  bool defined = false;
  int nvals = 0;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint16_t look[1 << kLook];  // (length << 8) | value; 0 for longer codes
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_huff(Huff& h, const uint8_t bits[17], const uint8_t* vals, int nvals) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1 << si)) refuse("bad Huffman table (a code overflows its length)");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      h.valoffset[l] = p - huffcode[p];
      p += bits[l];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0xFFFFF;
  std::memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= kLook; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      int lookbits = huffcode[p] << (kLook - l);
      for (int ctr = 1 << (kLook - l); ctr > 0; ctr--) h.look[lookbits++] = (l << 8) | vals[p];
    }
  }
  std::memcpy(h.vals, vals, nvals);
  h.nvals = nvals;
  h.defined = true;
}

// ------------------------------------------------------------- bit reader

// Entropy-coded bytes: 0xFF 0x00 is a stuffed 0xFF; 0xFF then a non-zero
// byte (after any 0xFF fill) is a marker, where the data ends. Past the end
// the buffer fills with zero bits, which no decode may consume.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos;        // next byte to read
  size_t marker;     // index of the marker code byte once seen (n at the end of data)
  bool at_marker;
  uint64_t buf;
  int cnt;           // bits held in buf (the low cnt bits, oldest first)
  int fill_bits;     // of which the last fill_bits are zero fill past the data

  void reset(size_t p) {
    pos = p;
    marker = n;
    at_marker = false;
    buf = 0;
    cnt = 0;
    fill_bits = 0;
  }

  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      if (at_marker) {
        fill_bits += 8;
      } else if (pos >= n) {
        at_marker = true;
        marker = n;
        fill_bits += 8;
      } else {
        c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;
            marker = q;
            c = 0;
            fill_bits += 8;
          }
        } else {
          pos++;
        }
      }
      buf = (buf << 8) | c;
      cnt += 8;
    }
  }

  void consume(int k) {
    cnt -= k;
    if (cnt < fill_bits) refuse("truncated or corrupt entropy-coded data");
  }

  int get(int k) {  // k in 0..16
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = (int)((buf >> (cnt - k)) & ((1u << k) - 1));
    consume(k);
    return v;
  }

  int decode(const Huff& h) {
    if (cnt < 16) fill();
    uint32_t p = (uint32_t)(buf >> (cnt - 16)) & 0xFFFF;
    uint16_t e = h.look[p >> (16 - kLook)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLook + 1; l <= 16; l++) {
      int32_t code = (int32_t)(p >> (16 - l));
      if (code <= h.maxcode[l]) {
        int idx = code + h.valoffset[l];
        if (idx < 0 || idx >= h.nvals) refuse("corrupt entropy-coded data (bad Huffman code)");
        consume(l);
        return h.vals[idx];
      }
    }
    refuse("corrupt entropy-coded data (bad Huffman code)");
  }

  // The next marker's code byte after the entropy data (whole bytes
  // before it are skipped, as libjpeg's next_marker does).
  size_t next_marker() {
    if (at_marker) return marker;
    size_t q = pos;
    while (q < n) {
      if (d[q] == 0xFF) {
        size_t r = q + 1;
        while (r < n && d[r] == 0xFF) r++;
        if (r >= n) break;
        if (d[r] != 0x00) return r;
        q = r + 1;
      } else {
        q++;
      }
    }
    refuse("truncated file (no marker after the entropy-coded data)");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int)((-1u) << s) + 1 : v; }

// ----------------------------------------------------------------- frame

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;          // downsampled width / height in samples
  int bw = 0, bh = 0;          // blocks covering the samples: ceil(dw / 8), ceil(dh / 8)
  int pbw = 0, pbh = 0;        // blocks allocated: whole MCUs
  std::vector<int16_t> coef;   // pbh x pbw blocks of 64, natural order
  int16_t q[64];               // the quantisation table latched at the first scan
  bool latched = false;
  int coef_bits[64];           // progressive: the last scan's Al per coefficient, -1 before any
  int scans = 0;
  int last_dc = 0;
  int dc_tbl = 0, ac_tbl = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false;
  bool have_frame = false, saw_scan = false, saw_eoi = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool rgb = false;  // colour space decided at the first scan
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;

  int u16(size_t p) const { return (d[p] << 8) | d[p + 1]; }

  size_t segment(size_t p, int* len) const {  // p: the code byte; returns the body's start
    if (p + 3 > n) refuse("truncated file (a marker segment is cut off)");
    *len = u16(p + 1);
    if (*len < 2 || p + 1 + *len > n) refuse("truncated file (a marker segment is cut off)");
    *len -= 2;
    return p + 3;
  }

  void sof(int code, size_t b, int len) {
    if (have_frame) refuse("more than one frame header (SOF)");
    if (len < 6) refuse("corrupt frame header");
    int precision = d[b];
    height = u16(b + 1);
    width = u16(b + 3);
    ncomp = d[b + 5];
    if (precision != 8) refuse(std::to_string(precision) + "-bit samples (only 8-bit JPEG is read)");
    if (height == 0) refuse("the height is defined by a DNL marker (not supported)");
    if (width == 0) refuse("empty image (width 0)");
    if (ncomp == 4)
      refuse("4 components (CMYK / YCCK): PIL would open the file as CMYK; the port reads "
             "grayscale and 3-component JPEG only");
    if (ncomp != 1 && ncomp != 3)
      refuse(std::to_string(ncomp) + " components (only 1 or 3 are read)");
    if (len != 6 + 3 * ncomp) refuse("corrupt frame header (bad length)");
    progressive = code == 0xC2;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = d[b + 6 + 3 * i];
      c.h = d[b + 7 + 3 * i] >> 4;
      c.v = d[b + 7 + 3 * i] & 15;
      c.tq = d[b + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) refuse("bad sampling factors");
      if (c.tq > 3) refuse("bad quantisation table index");
      for (int j = 0; j < i; j++)
        if (comp[j].id == c.id) refuse("two components share one id");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (ncomp == 1) {  // one component is always coded block by block, at full size
      hmax = vmax = comp[0].h = comp[0].v = 1;
    } else {
      bool ok = comp[1].h == 1 && comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1 &&
                ((comp[0].h == 1 && comp[0].v == 1) || (comp[0].h == 2 && comp[0].v == 1) ||
                 (comp[0].h == 2 && comp[0].v == 2));
      if (!ok) {
        char msg[160];
        std::snprintf(msg, sizeof msg,
                      "sampling factors %dx%d, %dx%d, %dx%d (only 4:4:4, 4:2:2 and 4:2:0 "
                      "are read)", comp[0].h, comp[0].v, comp[1].h, comp[1].v, comp[2].h,
                      comp[2].v);
        refuse(msg);
      }
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.pbw = mcux * c.h;
      c.pbh = mcuy * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void alloc() {
    for (int i = 0; i < ncomp; i++) comp[i].coef.assign((size_t)comp[i].pbw * comp[i].pbh * 64, 0);
  }

  void dht(size_t b, int len) {
    size_t end = b + len;
    while (b < end) {
      if (b + 17 > end) refuse("corrupt Huffman table segment");
      int tc = d[b] >> 4, th = d[b] & 15;
      if (tc > 1 || th > 3) refuse("bad Huffman table class or index");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = d[b + i];
        count += bits[i];
      }
      if (count > 256 || b + 17 + count > end) refuse("corrupt Huffman table segment");
      build_huff(tc ? ac[th] : dc[th], bits, d + b + 17, count);
      b += 17 + count;
    }
  }

  void dqt(size_t b, int len) {
    size_t end = b + len;
    while (b < end) {
      int pq = d[b] >> 4, tq = d[b] & 15;
      if (pq > 1 || tq > 3) refuse("bad quantisation table precision or index");
      size_t need = 1 + 64 * (pq + 1);
      if (b + need > end) refuse("corrupt quantisation table segment");
      for (int i = 0; i < 64; i++)
        qt[tq][kNatural[i]] = pq ? (uint16_t)u16(b + 1 + 2 * i) : d[b + 1 + i];
      qt_defined[tq] = true;
      b += need;
    }
  }

  void app(int code, size_t b, int len) {
    if (saw_scan) return;  // libjpeg fixes the colour space at the first scan
    if (code == 0xE0 && len >= 14 && std::memcmp(d + b, "JFIF\0", 5) == 0) saw_jfif = true;
    if (code == 0xEE && len >= 12 && std::memcmp(d + b, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[b + 11];
    }
  }

  void choose_colour_space() {  // jdapimin.c default_decompress_parms
    if (ncomp != 3) return;
    if (saw_jfif) rgb = false;
    else if (saw_adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // ------------------------------------------------------------- scans

  struct Scan {
    int ns;
    Comp* c[4];
    int ss, se, ah, al;
  };

  int16_t* block(Comp& c, int by, int bx) { return &c.coef[((size_t)by * c.pbw + bx) * 64]; }

  void decode_block(const Scan& s, Comp& c, int16_t* blk, Bits& br, int& eobrun) {
    if (!progressive) {
      int t = br.decode(dc[c.dc_tbl]);
      int diff = t ? extend(br.get(t), t) : 0;
      if ((c.last_dc >= 0 && diff > INT_MAX - c.last_dc) ||
          (c.last_dc < 0 && diff < INT_MIN - c.last_dc))
        refuse("corrupt entropy-coded data (DC overflow)");
      c.last_dc += diff;
      blk[0] = (int16_t)c.last_dc;
      const Huff& h = ac[c.ac_tbl];
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          if (k > 63) refuse("corrupt entropy-coded data (coefficient index past 63)");
          blk[kNatural[k]] = (int16_t)extend(br.get(sz), sz);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (s.ss == 0) {  // DC band
      if (s.ah == 0) {
        int t = br.decode(dc[c.dc_tbl]);
        int diff = t ? extend(br.get(t), t) : 0;
        if ((c.last_dc >= 0 && diff > INT_MAX - c.last_dc) ||
            (c.last_dc < 0 && diff < INT_MIN - c.last_dc))
          refuse("corrupt entropy-coded data (DC overflow)");
        c.last_dc += diff;
        blk[0] = (int16_t)((unsigned)c.last_dc << s.al);
      } else if (br.get(1)) {
        blk[0] = (int16_t)(blk[0] | (1 << s.al));
      }
      return;
    }
    const Huff& h = ac[c.ac_tbl];
    if (s.ah == 0) {  // AC first
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = s.ss; k <= s.se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          if (k > s.se) refuse("corrupt entropy-coded data (coefficient past the band)");
          blk[kNatural[k]] = (int16_t)((unsigned)extend(br.get(sz), sz) << s.al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << s.al, m1 = (int)((-1u) << s.al);
    int k = s.ss;
    if (eobrun == 0) {
      for (; k <= s.se; k++) {
        int rs = br.decode(h);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          if (sz != 1) refuse("corrupt entropy-coded data (bad refinement code)");
          sz = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= s.se);
        if (sz) {
          if (k > s.se) refuse("corrupt entropy-coded data (coefficient past the band)");
          blk[kNatural[k]] = (int16_t)sz;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= s.se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun--;
    }
  }

  void check_progression(const Scan& s) {  // jdphuff.c start_pass_phuff_decoder
    bool bad = false;
    if (s.ss == 0) {
      if (s.se != 0) bad = true;
    } else {
      if (s.ss > s.se || s.se > 63 || s.ns != 1) bad = true;
    }
    if (s.ah != 0 && s.al != s.ah - 1) bad = true;
    if (s.al > 13) bad = true;
    if (bad) refuse("bad progressive scan parameters");
    for (int i = 0; i < s.ns; i++) {
      Comp& c = *s.c[i];
      if (s.ss != 0 && c.coef_bits[0] < 0) refuse("bogus progression (an AC scan before the DC scan)");
      for (int k = s.ss; k <= s.se; k++) {
        int expected = c.coef_bits[k] < 0 ? 0 : c.coef_bits[k];
        if (s.ah != expected) refuse("bogus progression (a scan out of order)");
        c.coef_bits[k] = s.al;
      }
    }
  }

  size_t sos(size_t b, int len) {
    if (!have_frame) refuse("a scan before the frame header");
    if (!saw_scan) {
      choose_colour_space();
      alloc();
      saw_scan = true;
    }
    Scan s;
    s.ns = len > 0 ? d[b] : 0;
    if (s.ns < 1 || s.ns > 4 || len != 4 + 2 * s.ns) refuse("corrupt scan header");
    for (int i = 0; i < s.ns; i++) {
      int id = d[b + 1 + 2 * i], tables = d[b + 2 + 2 * i];
      Comp* found = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) found = &comp[j];
      if (!found) refuse("a scan names a component the frame lacks");
      for (int j = 0; j < i; j++)
        if (s.c[j] == found) refuse("a scan names one component twice");
      found->dc_tbl = tables >> 4;
      found->ac_tbl = tables & 15;
      s.c[i] = found;
    }
    size_t t = b + 1 + 2 * s.ns;
    s.ss = d[t];
    s.se = d[t + 1];
    s.ah = d[t + 2] >> 4;
    s.al = d[t + 2] & 15;
    if (progressive) {
      check_progression(s);
    } else if (s.ss != 0 || s.se != 63 || s.ah != 0 || s.al != 0) {
      refuse("a sequential scan with progressive parameters");
    }
    for (int i = 0; i < s.ns; i++) {
      Comp& c = *s.c[i];
      if (!progressive && c.scans) refuse("a sequential frame codes one component twice");
      c.scans++;
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (!qt_defined[c.tq]) refuse("a component's quantisation table is not defined");
        for (int k = 0; k < 64; k++) c.q[k] = (int16_t)qt[c.tq][k];
        c.latched = true;
      }
      bool needs_dc = !progressive || (s.ss == 0 && s.ah == 0);
      bool needs_ac = !progressive || s.ss != 0;
      if (needs_dc) {
        if (c.dc_tbl > 3 || !dc[c.dc_tbl].defined) refuse("a scan uses an undefined DC Huffman table");
        const Huff& h = dc[c.dc_tbl];
        for (int k = 0; k < h.nvals; k++)
          if (h.vals[k] > 15) refuse("bad DC Huffman table (a value above 15)");
      }
      if (needs_ac && (c.ac_tbl > 3 || !ac[c.ac_tbl].defined)) refuse("a scan uses an undefined AC Huffman table");
      c.last_dc = 0;
    }

    Bits br{d, n, 0, n, false, 0, 0, 0};
    br.reset(t + 3);
    int eobrun = 0;
    int next_rst = 0;
    int64_t mcus, per_row;
    if (s.ns == 1) {
      per_row = s.c[0]->bw;
      mcus = per_row * s.c[0]->bh;
    } else {
      per_row = mcux;
      mcus = (int64_t)mcux * mcuy;
      int blocks = 0;
      for (int i = 0; i < s.ns; i++) blocks += s.c[i]->h * s.c[i]->v;
      if (blocks > 10) refuse("more than 10 blocks in an MCU");
    }
    int64_t to_go = restart_interval;
    for (int64_t m = 0; m < mcus; m++) {
      if (restart_interval && m > 0 && to_go == 0) {
        size_t mk = br.next_marker();
        if (mk >= n || d[mk] != 0xD0 + next_rst) refuse("corrupt entropy-coded data (a restart marker is missing)");
        br.reset(mk + 1);
        next_rst = (next_rst + 1) & 7;
        to_go = restart_interval;
        eobrun = 0;
        for (int i = 0; i < s.ns; i++) s.c[i]->last_dc = 0;
      }
      int64_t my = m / per_row, mx = m % per_row;
      if (s.ns == 1) {
        decode_block(s, *s.c[0], block(*s.c[0], (int)my, (int)mx), br, eobrun);
      } else {
        for (int i = 0; i < s.ns; i++) {
          Comp& c = *s.c[i];
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++)
              decode_block(s, c, block(c, (int)my * c.v + by, (int)mx * c.h + bx), br, eobrun);
        }
      }
      to_go--;
    }
    return br.next_marker();
  }

  void parse(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) refuse("not a JPEG file (no SOI marker)");
    size_t p = 2;
    for (;;) {
      // find the next marker: 0xFF (any fill), then its code
      while (p < n && d[p] != 0xFF) p++;
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) refuse("truncated file (no EOI marker)");
      int code = d[p];
      if (code == 0xD9) {
        if (!saw_scan) refuse("no image data (EOI before any scan)");
        saw_eoi = true;
        return;
      }
      if (code == 0x01 || (code >= 0xD0 && code <= 0xD7)) {  // parameterless
        p++;
        continue;
      }
      if (code == 0xD8) refuse("a second SOI marker");
      int len;
      size_t b = segment(p, &len);
      size_t next = b + len;
      switch (code) {
        case 0xC0: case 0xC1: case 0xC2:
          sof(code, b, len);
          if (header_only) return;
          break;
        case 0xC3: refuse("lossless JPEG (SOF3) is not read");
        case 0xC5: case 0xC6: case 0xC7: refuse("hierarchical JPEG is not read");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          refuse("arithmetic-coded JPEG is not read");
        case 0xCC: refuse("arithmetic-coded JPEG is not read (DAC marker)");
        case 0xC4: dht(b, len); break;
        case 0xDB: dqt(b, len); break;
        case 0xDD:
          if (len != 2) refuse("corrupt restart interval segment");
          restart_interval = u16(b);
          break;
        case 0xDC: refuse("DNL marker (not supported)");
        case 0xDA: {
          size_t mk = sos(b, len);
          p = mk - 1;  // the 0xFF before the code
          continue;
        }
        case 0xFE: break;
        default:
          if (code >= 0xE0 && code <= 0xEF) {
            app(code, b, len);
            break;
          }
          char msg[48];
          std::snprintf(msg, sizeof msg, "unknown marker 0xFF%02X", code);
          refuse(msg);
      }
      p = next;
    }
  }

  void check_complete() {
    for (int i = 0; i < ncomp; i++)
      if (!comp[i].scans || (progressive && comp[i].coef_bits[0] < 0))
        refuse("a component has no scan (incomplete file)");
    if (!progressive) return;
    // jdcoefct.c smoothing_ok: libjpeg smooths blocks whose first nine AC
    // coefficients are not fully refined; those files are refused
    static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      for (int k = 0; k < 10; k++)
        if (comp[i].q[pos[k]] == 0) return;
      for (int k = 1; k < 10; k++)
        if (comp[i].coef_bits[k] != 0) useful = true;
    }
    if (useful)
      refuse("a progressive file leaves its first AC coefficients unrefined (libjpeg would "
             "smooth the blocks; not supported)");
  }

  // ------------------------------------------------------------- output

  void output(uint8_t* out) const;
};

// jdmaster.c prepare_range_limit_table, the post-IDCT part: index x & 1023
// of the IDCT's centred output x
struct RangeTables {
  uint8_t idct[1024];
  uint8_t clamp[1024];  // clamp[x + 384] = x clipped to 0..255
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  RangeTables() {
    for (int i = 0; i < 1024; i++)
      idct[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    for (int i = 0; i < 1024; i++) {
      int x = i - 384;
      clamp[i] = (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
    }
    // jdcolor.c build_ycc_rgb_table
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = (int)(-fix(0.71414) * x);
      cb_g[i] = (int)(-fix(0.34414) * x + one_half);
    }
  }
};

const RangeTables& tables() {
  static const RangeTables t;
  return t;
}

// jidctint.c jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride,
                const uint8_t* range) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const int16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dcval = (int)((int64_t)((int)ip[0] * (int)qp[0]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
      continue;
    }
    int64_t z2 = (int)ip[16] * (int)qp[16], z3 = (int)ip[48] * (int)qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int)ip[0] * (int)qp[0];
    z3 = (int)ip[32] * (int)qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int)ip[56] * (int)qp[56];
    tmp1 = (int)ip[40] * (int)qp[40];
    tmp2 = (int)ip[24] * (int)qp[24];
    tmp3 = (int)ip[8] * (int)qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int row = 0; row < 8; row++) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + (size_t)row * stride;
    const int sh = kConstBits + kPass1Bits + 3;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = range[(int)descale(wp[0], kPass1Bits + 3) & 1023];
      for (int i = 0; i < 8; i++) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = range[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = range[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = range[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = range[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = range[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = range[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = range[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = range[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// The IDCT of a component's coefficient blocks into a plane of samples,
// ``stride`` = 8 x its blocks a row.
void idct_plane(const Comp& c, std::vector<uint8_t>& plane, int stride) {
  const uint8_t* range = tables().idct;
  plane.assign((size_t)stride * c.bh * 8, 0);
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++)
      idct_islow(&c.coef[((size_t)by * c.pbw + bx) * 64], c.q,
                 &plane[(size_t)by * 8 * stride + bx * 8], stride, range);
}

// One chroma row upsampled 2x horizontally, out[0 .. 2 dw) (jdsample.c
// h2v1_fancy_upsample: 3/4 of the nearer pixel, 1/4 of the further, the
// rounding bias alternating 1 / 2; the end columns copied).
inline void fancy_row_h2v1(const uint8_t* in, int dw, uint8_t* out) {
  out[0] = in[0];
  out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < dw - 1; i++) {
    int v = in[i] * 3;
    out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
  }
  out[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
  out[2 * dw - 1] = in[dw - 1];
}

// The same with the row nearer and further in y (h2v2_fancy_upsample: the
// column sums 3 near + far, then 3/4 and 1/4 of those, biases 8 / 7).
inline void fancy_row_h2v2(const uint8_t* near, const uint8_t* far, int dw, uint8_t* out) {
  int thiscol = near[0] * 3 + far[0];
  int nextcol = near[1] * 3 + far[1];
  out[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
  out[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
  int lastcol = thiscol;
  thiscol = nextcol;
  for (int i = 1; i < dw - 1; i++) {
    nextcol = near[i + 1] * 3 + far[i + 1];
    out[2 * i] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
    out[2 * i + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
    lastcol = thiscol;
    thiscol = nextcol;
  }
  out[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
  out[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
}

void Decoder::output(uint8_t* out) const {
  std::vector<uint8_t> planes[3];
  int stride[3];
  for (int i = 0; i < ncomp; i++) {
    stride[i] = comp[i].bw * 8;
    idct_plane(comp[i], planes[i], stride[i]);
  }
  const int W = width, H = height;
  if (ncomp == 1) {
    for (int y = 0; y < H; y++) std::memcpy(out + (size_t)y * W, &planes[0][(size_t)y * stride[0]], W);
    return;
  }
  const RangeTables& t = tables();
  const uint8_t* clamp = t.clamp + 384;
  int h0 = comp[0].h, v0 = comp[0].v;
  std::vector<uint8_t> up[2];  // the chroma rows of one output row, at full width
  for (int k = 0; k < 2; k++) up[k].assign((size_t)2 * (comp[1 + k].dw + 1), 0);
  for (int y = 0; y < H; y++) {
    const uint8_t* yrow = &planes[0][(size_t)y * stride[0]];
    const uint8_t* crow[2];
    for (int k = 0; k < 2; k++) {
      const Comp& c = comp[1 + k];
      const std::vector<uint8_t>& pl = planes[1 + k];
      int st = stride[1 + k];
      if (h0 == 1) {
        crow[k] = &pl[(size_t)y * st];
        continue;
      }
      int dw = c.dw;
      uint8_t* o = up[k].data();
      if (v0 == 1) {
        const uint8_t* in = &pl[(size_t)y * st];
        if (dw > 2) {
          fancy_row_h2v1(in, dw, o);
        } else {
          for (int i = 0; i < dw; i++) o[2 * i] = o[2 * i + 1] = in[i];
        }
      } else {
        int j = y >> 1;
        if (dw > 2) {
          // the row above for even output rows, below for odd, the edge rows replicated
          int f = (y & 1) ? (j + 1 < c.dh ? j + 1 : c.dh - 1) : (j > 0 ? j - 1 : 0);
          fancy_row_h2v2(&pl[(size_t)j * st], &pl[(size_t)f * st], dw, o);
        } else {
          const uint8_t* in = &pl[(size_t)j * st];
          for (int i = 0; i < dw; i++) o[2 * i] = o[2 * i + 1] = in[i];
        }
      }
      crow[k] = o;
    }
    uint8_t* op = out + (size_t)y * W * 3;
    if (rgb) {
      for (int x = 0; x < W; x++) {
        op[3 * x] = yrow[x];
        op[3 * x + 1] = crow[0][x];
        op[3 * x + 2] = crow[1][x];
      }
      continue;
    }
    for (int x = 0; x < W; x++) {
      int yy = yrow[x], cb = crow[0][x], cr = crow[1][x];
      op[3 * x] = clamp[yy + t.cr_r[cr]];
      op[3 * x + 1] = clamp[yy + (int)(((int64_t)t.cb_g[cb] + t.cr_g[cr]) >> 16)];
      op[3 * x + 2] = clamp[yy + t.cb_b[cb]];
    }
  }
}

void write_err(char* err, int64_t errlen, const std::string& msg) {
  if (err && errlen > 0) {
    size_t k = msg.size() < (size_t)(errlen - 1) ? msg.size() : (size_t)(errlen - 1);
    std::memcpy(err, msg.data(), k);
    err[k] = 0;
  }
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, int64_t len, int64_t* info, char* err, int64_t errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)len;
    dec.parse(true);
    if (!dec.have_frame) refuse("no frame header");
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    return 0;
  } catch (const Refused& r) {
    write_err(err, errlen, r.msg);
  } catch (const std::exception& e) {
    write_err(err, errlen, e.what());
  }
  return -1;
}

int jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int64_t out_len, char* err,
                int64_t errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = (size_t)len;
    dec.parse(false);
    if (!dec.have_frame) refuse("no frame header");
    dec.check_complete();
    if ((int64_t)dec.width * dec.height * dec.ncomp != out_len)
      refuse("the output buffer does not match the frame");
    dec.output(out);
    return 0;
  } catch (const Refused& r) {
    write_err(err, errlen, r.msg);
  } catch (const std::exception& e) {
    write_err(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
