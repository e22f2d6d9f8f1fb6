// JPEG decoder for the host (the port's counterpart of the `cv2.imread`
// calls that `lemo_tpu` reads Color frames, and any JPEG Depth or mask
// frame, with).
//
// Decodes sequential (SOF0, SOF1) and progressive (SOF2) Huffman JPEG at
// 8-bit precision with 1 or 3 components, any integer sampling factors up
// to 4, DQT/DHT anywhere before a scan, restart intervals, several scans,
// and image sizes that are no multiple of the MCU. Lossless,
// hierarchical, arithmetic-coded, 12-bit and 4-component files are
// refused with the marker named, and so is a progressive file whose scans
// leave AC coefficients 1-9 of a component unrefined (where libjpeg-turbo
// would smooth the blocks: "progressive scans incomplete").
//
// A sequential scan's blocks go through the IDCT as they are decoded. A
// progressive file's scans decode into a whole-image buffer of
// coefficients per component (libjpeg's coefficient controller in
// buffered mode): DC first and refine bits (interleaved or not), AC first
// and refine bands of one component (spectral selection Ss..Se,
// successive approximation Ah/Al, EOB runs, restarts; jdphuff.c), and
// the IDCT runs over the buffer after the last scan. Either way the
// latched quantization table of each component (the table when its first
// scan began, jdinput.c) dequantizes its blocks.
//
// The pixels equal libjpeg-turbo's default decode (which cv2 bundles)
// bit for bit: its ISLOW integer IDCT (jidctint.c), its fancy upsampling
// (jdsample.c: the h2v1, h1v2 and h2v2 triangle filters with their
// alternating rounding biases, edge rows and columns replicated, plain
// replication for other ratios and for components two samples wide or
// less), and its fixed-point colour tables (jdcolor.c): YCbCr -> RGB,
// and for grayscale output the Y component alone (YCbCr) or
// rgb_gray_convert's weights (RGB). A grayscale image is repeated into
// three channels for RGB output; the colour space of a 3-component file
// follows jdapimin.c (a JFIF marker means YCbCr, else an Adobe marker's
// transform, else the component ids). The EXIF orientation is left to
// the caller (`data/jpeg.py`).
//
// C interface, bound with ctypes:
//   int lemo_jpeg_dims(const uint8_t* data, int64_t n, int32_t* hwc,
//                      char* err, int32_t err_len)
//     (height, width, components)
//   int lemo_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
//                        int64_t out_bytes, int32_t channels, char* err,
//                        int32_t err_len)
//     (channels 3: RGB [H, W, 3]; 1: grayscale [H, W])
// Both return 0 on success and -1 on failure (`err` holds the reason).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag index -> natural (row-major) index, with 16 guard entries so a
// run past the end of a corrupt block lands on 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // (length << 8) | value for codes of at most kLookBits bits, else 0
  uint16_t look[1 << kLookBits] = {};

  void build(const uint8_t* counts, const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++code, ++k) {
        if (len <= kLookBits) {
          int lo = code << (kLookBits - len);
          for (int j = 0; j < (1 << (kLookBits - len)); ++j)
            look[lo + j] = static_cast<uint16_t>((len << 8) | vals[k]);
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code > (1 << len)) throw JpegError("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// zigzag positions 0-9 in natural order: the coefficients whose
// unrefined bits make libjpeg-turbo smooth blocks (jdcoefct.c)
const int kSmoothed[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;          // downsampled width, height
  int bw = 0, bh = 0;          // blocks across and down in the plane
  int stride = 0;
  std::vector<int16_t> coef;   // progressive: bw x bh blocks of 64
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  int q[64] = {};              // latched quantization table
  bool latched = false;
  int coef_bits[64];           // progressive: bits still unknown (-1: none)
  int pred = 0;
  int16_t* block(int64_t row, int64_t col) {
    return &coef[(size_t(row) * bw + col) * 64];
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t n) : d_(data), n_(n) {}

  void read_header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      throw JpegError("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) { pending_sos_ = true; break; }
      if (m == 0xD9) throw JpegError("EOI before any scan");
      segment(m);
    }
    if (!have_frame_) throw JpegError("no SOF marker before the scan");
  }

  void decode(uint8_t* out, int channels) {
    for (;;) {
      if (pending_sos_) {
        scan();
        pending_sos_ = false;
      }
      int m = next_marker();
      if (m == 0xD9 || m < 0) break;
      if (m == 0xDA) { pending_sos_ = true; continue; }
      segment(m);
    }
    if (progressive_ && would_smooth())
      throw JpegError("progressive scans incomplete (AC coefficients 1-9 "
                      "of a component left unrefined, where libjpeg-turbo "
                      "smooths the blocks)");
    if (progressive_) {
      for (auto& c : comps_)
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct(c.block(by, bx), c.q,
                 &c.plane[size_t(by) * 8 * c.stride + size_t(bx) * 8],
                 c.stride);
    }
    if (channels == 1)
      to_gray(out);
    else
      to_rgb(out);
  }

  int height = 0, width = 0;
  int components() const { return int(comps_.size()); }

 private:
  const uint8_t* d_;
  int64_t n_;
  int64_t pos_ = 0;
  bool pending_sos_ = false, have_frame_ = false, progressive_ = false;
  int eobrun_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int qt_[4][64] = {};  // natural order
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;

  // bit reader over the entropy-coded data
  uint32_t bitbuf_ = 0;
  int bitcnt_ = 0;
  bool hit_marker_ = false;

  int u8() {
    if (pos_ >= n_) throw JpegError("unexpected end of data");
    return d_[pos_++];
  }
  int u16() { int a = u8(); return (a << 8) | u8(); }

  int next_marker() {
    // skip anything up to 0xFF, then fill bytes; a stuffed 0xFF00 or an
    // RSTn left in the data after a scan is no marker of a segment
    for (;;) {
      while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
      while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
      if (pos_ >= n_) return -1;
      int m = d_[pos_++];
      if (m != 0x00 && (m < 0xD0 || m > 0xD7)) return m;
    }
  }

  void segment(int m) {
    int len = u16();
    if (len < 2 || pos_ + len - 2 > n_) throw JpegError("bad segment length");
    int64_t end = pos_ + len - 2;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      sof(end, m == 0xC2);
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      char buf[96];
      const char* what = (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
                             ? "progressive"
                         : (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
                             ? "lossless"
                             : "sequential";
      const bool hierarchical = (m >= 0xC5 && m <= 0xC7) || m >= 0xCD;
      std::snprintf(buf, sizeof(buf), "SOF%d (%s%s%s) is not supported",
                    m - 0xC0, (m >= 0xC9) ? "arithmetic-coded " : "",
                    hierarchical ? "hierarchical " : "", what);
      throw JpegError(buf);
    } else if (m == 0xCC) {
      throw JpegError("DAC (arithmetic coding) is not supported");
    } else if (m == 0xC4) {
      dht(end);
    } else if (m == 0xDB) {
      dqt(end);
    } else if (m == 0xDD) {
      if (len < 4) throw JpegError("bad DRI segment");
      restart_interval_ = u16();
    } else if (m == 0xDC) {
      throw JpegError("DNL (height defined by a DNL marker) is not supported");
    } else if (m == 0xE0) {
      if (len - 2 >= 14 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0)
        saw_jfif_ = true;
    } else if (m == 0xEE) {
      if (len - 2 >= 12 && std::memcmp(d_ + pos_, "Adobe", 5) == 0) {
        saw_adobe_ = true;
        adobe_transform_ = d_[pos_ + 11];
      }
    }
    pos_ = end;
  }

  void sof(int64_t end, bool progressive) {
    if (have_frame_) throw JpegError("a second SOF marker");
    progressive_ = progressive;
    int precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (precision != 8) {
      char buf[64];
      std::snprintf(buf, sizeof(buf), "%d-bit precision is not supported",
                    precision);
      throw JpegError(buf);
    }
    if (height == 0) throw JpegError("DNL (height 0 in SOF) is not supported");
    if (width == 0) throw JpegError("image width 0");
    if (nc != 1 && nc != 3) {
      char buf[64];
      std::snprintf(buf, sizeof(buf), "%d components are not supported", nc);
      throw JpegError(buf);
    }
    if (pos_ + 3 * nc > end) throw JpegError("bad SOF segment");
    comps_.resize(nc);
    for (auto& c : comps_) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw JpegError("bad sampling factors or quantization table id");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v)
        throw JpegError("fractional sampling ratios are not supported");
      c.dw = static_cast<int>((int64_t(width) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((int64_t(height) * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.stride = c.bw * 8;
      c.plane.assign(size_t(c.stride) * c.bh * 8, 0);
      if (progressive) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    have_frame_ = true;
  }

  void dht(int64_t end) {
    while (pos_ < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw JpegError("bad DHT table id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) { counts[i] = u8(); total += counts[i]; }
      if (total > 256 || pos_ + total > end) throw JpegError("bad DHT segment");
      uint8_t values[256];
      for (int i = 0; i < total; ++i) values[i] = u8();
      (tc ? ac_ : dc_)[th].build(counts, values, total);
    }
  }

  void dqt(int64_t end) {
    while (pos_ < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw JpegError("bad DQT table id");
      for (int k = 0; k < 64; ++k)
        qt_[tq][kNatural[k]] = pq ? u16() : u8();
      qt_defined_[tq] = true;
    }
  }

  // ---- entropy decoding ----
  void fill() {
    while (bitcnt_ <= 24) {
      int byte = 0;
      if (!hit_marker_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          int64_t p = pos_ + 1;
          while (p < n_ && d_[p] == 0xFF) ++p;  // fill bytes
          if (p < n_ && d_[p] == 0x00) {
            pos_ = p + 1;
          } else {
            hit_marker_ = true;  // leave pos_ on the marker's 0xFF
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      bitbuf_ |= uint32_t(byte) << (24 - bitcnt_);
      bitcnt_ += 8;
    }
  }

  int bits(int s) {
    if (s == 0) return 0;
    if (bitcnt_ < s) fill();
    int v = int(bitbuf_ >> (32 - s));
    bitbuf_ <<= s;
    bitcnt_ -= s;
    return v;
  }

  int huff(const Huffman& h) {
    if (bitcnt_ < 16) fill();
    int look = h.look[bitbuf_ >> (32 - kLookBits)];
    if (look) {
      int len = look >> 8;
      bitbuf_ <<= len;
      bitcnt_ -= len;
      return look & 0xFF;
    }
    int len = kLookBits + 1;
    int code = int(bitbuf_ >> (32 - len));
    while (len <= 16 && code > h.maxcode[len]) {
      ++len;
      code = int(bitbuf_ >> (32 - len));
    }
    if (len > 16) {
      // corrupt data: libjpeg warns and takes 0
      bitbuf_ <<= 16;
      bitcnt_ -= 16;
      return 0;
    }
    bitbuf_ <<= len;
    bitcnt_ -= len;
    return h.vals[(code + h.valoffset[len]) & 0xFF];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void restart() {
    bitbuf_ = 0;
    bitcnt_ = 0;
    hit_marker_ = false;
    // the RSTn marker (fill bytes before it skipped)
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
    int64_t p = pos_;
    while (p < n_ && d_[p] == 0xFF) ++p;
    if (p < n_ && d_[p] >= 0xD0 && d_[p] <= 0xD7) pos_ = p + 1;
    for (auto& c : comps_) c.pred = 0;
    eobrun_ = 0;
  }

  void block(Component& c, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    const Huffman& dc = dc_[c.td];
    const Huffman& ac = ac_[c.ta];
    int s = huff(dc);
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = huff(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // ---- progressive scans (jdphuff.c) ----
  void dc_first(Component& c, int16_t* coef, int al) {
    int s = huff(dc_[c.td]);
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(unsigned(c.pred) << al);
  }

  void dc_refine(int16_t* coef, int al) {
    if (bits(1)) coef[0] = static_cast<int16_t>(coef[0] | (1 << al));
  }

  void ac_first(const Component& c, int16_t* coef, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huffman& ac = ac_[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] =
            static_cast<int16_t>(unsigned(extend(bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits(r);
        --eobrun_;
        break;
      }
    }
  }

  // one correction bit for an already nonzero coefficient
  void refine(int16_t* p, int p1) {
    if (bits(1) && (*p & p1) == 0)
      *p = static_cast<int16_t>(*p >= 0 ? *p + p1 : *p - p1);
  }

  void ac_refine(const Component& c, int16_t* coef, int ss, int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun_ == 0) {
      const Huffman& ac = ac_[c.ta];
      for (; k <= se; ++k) {
        int rs = huff(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits(1) ? p1 : -p1;  // the size of a new coefficient is 1
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += bits(r);
          break;                   // the EOB run's logic below
        }
        // pass the nonzero coefficients (a correction bit each) and r
        // zero ones; a new coefficient goes into the zero after them
        do {
          int16_t* p = coef + kNatural[k];
          if (*p != 0) {
            refine(p, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) coef[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t* p = coef + kNatural[k];
        if (*p != 0) refine(p, p1);
      }
      --eobrun_;
    }
  }

  // libjpeg-turbo's smoothing_ok (jdcoefct.c): whether the output pass
  // would smooth the blocks (every component latched, with nonzero
  // quantizers at zigzag 0-9 and a DC scan, and some AC coefficient 1-9
  // of some component with bits still unknown)
  bool would_smooth() const {
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.latched) return false;
      for (int k : kSmoothed)
        if (c.q[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  static inline uint8_t range_limit(int64_t x) {
    int idx = static_cast<int>(x & 1023);
    if (idx < 512) return static_cast<uint8_t>(idx + 128 > 255 ? 255 : idx + 128);
    return static_cast<uint8_t>(idx >= 896 ? idx - 896 : 0);
  }

  // libjpeg-turbo's jpeg_idct_islow (jidctint.c), 8-bit samples
  static void idct(const int16_t* in, const int* q, uint8_t* out,
                   int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    const int CB = 13, P1 = 2;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const int* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        int dc = (ip[0] * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB - P1;
      const int64_t rnd = int64_t(1) << (sh - 1);
      wp[0] = int((tmp10 + tmp3 + rnd) >> sh);
      wp[56] = int((tmp10 - tmp3 + rnd) >> sh);
      wp[8] = int((tmp11 + tmp2 + rnd) >> sh);
      wp[48] = int((tmp11 - tmp2 + rnd) >> sh);
      wp[16] = int((tmp12 + tmp1 + rnd) >> sh);
      wp[40] = int((tmp12 - tmp1 + rnd) >> sh);
      wp[24] = int((tmp13 + tmp0 + rnd) >> sh);
      wp[32] = int((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + size_t(r) * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
          !wp[7]) {
        uint8_t v = range_limit((int64_t(wp[0]) + (1 << (P1 + 2))) >> (P1 + 3));
        for (int k = 0; k < 8; ++k) op[k] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << CB);
      int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      const int64_t rnd = int64_t(1) << (sh - 1);
      op[0] = range_limit((tmp10 + tmp3 + rnd) >> sh);
      op[7] = range_limit((tmp10 - tmp3 + rnd) >> sh);
      op[1] = range_limit((tmp11 + tmp2 + rnd) >> sh);
      op[6] = range_limit((tmp11 - tmp2 + rnd) >> sh);
      op[2] = range_limit((tmp12 + tmp1 + rnd) >> sh);
      op[5] = range_limit((tmp12 - tmp1 + rnd) >> sh);
      op[3] = range_limit((tmp13 + tmp0 + rnd) >> sh);
      op[4] = range_limit((tmp13 - tmp0 + rnd) >> sh);
    }
  }

  void scan() {
    int len = u16();
    int ns = u8();
    if (len != 6 + 2 * ns) throw JpegError("bad SOS segment length");
    if (ns < 1 || ns > int(comps_.size())) throw JpegError("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& cc : comps_)
        if (cc.id == id) c = &cc;
      if (!c) throw JpegError("SOS names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) throw JpegError("bad SOS table id");
      sc.push_back(c);
    }
    int ss = u8(), se = u8(), ahal = u8();
    int ah = ahal >> 4, al = ahal & 15;
    bool need_dc, need_ac;
    if (!progressive_) {
      if (ss != 0 || se != 63 || ahal != 0)
        throw JpegError("spectral selection or successive approximation in "
                        "a sequential scan");
      need_dc = need_ac = true;
    } else {
      // jdphuff.c's start_pass_phuff_decoder
      bool dc = ss == 0;
      bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) throw JpegError("bad progression parameters in a scan");
      need_dc = dc && ah == 0;
      need_ac = !dc;
      for (auto* c : sc)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
    for (auto* c : sc) {
      if ((need_dc && !dc_[c->td].defined) || (need_ac && !ac_[c->ta].defined))
        throw JpegError("SOS uses an undefined Huffman table");
      if (!c->latched) {  // jdinput.c's latch_quant_tables
        if (!qt_defined_[c->tq])
          throw JpegError("a component uses an undefined quantization table");
        std::memcpy(c->q, qt_[c->tq], sizeof(c->q));
        c->latched = true;
      }
    }
    bitbuf_ = 0;
    bitcnt_ = 0;
    hit_marker_ = false;
    eobrun_ = 0;
    for (auto* c : sc) c->pred = 0;
    int64_t mcus, per_row;
    if (ns == 1) {
      Component& c = *sc[0];
      per_row = (c.dw + 7) / 8;
      mcus = per_row * ((c.dh + 7) / 8);
    } else {
      per_row = mcux_;
      mcus = int64_t(mcux_) * mcuy_;
    }
    // a sequential block goes through the IDCT at once; a progressive one
    // stays in the coefficient buffer until the last scan
    int16_t seq[64];
    auto unit = [&](Component& c, int64_t row, int64_t col) {
      if (!progressive_) {
        block(c, seq);
        idct(seq, c.q, &c.plane[size_t(row) * 8 * c.stride + size_t(col) * 8],
             c.stride);
        return;
      }
      int16_t* coef = c.block(row, col);
      if (ss == 0 && ah == 0)
        dc_first(c, coef, al);
      else if (ss == 0)
        dc_refine(coef, al);
      else if (ah == 0)
        ac_first(c, coef, ss, se, al);
      else
        ac_refine(c, coef, ss, se, al);
    };
    int64_t todo = restart_interval_;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval_ && todo == 0) {
        restart();
        todo = restart_interval_;
      }
      int64_t my = m / per_row, mx = m % per_row;
      if (ns == 1) {
        unit(*sc[0], my, mx);
      } else {
        for (auto* cp : sc)
          for (int by = 0; by < cp->v; ++by)
            for (int bx = 0; bx < cp->h; ++bx)
              unit(*cp, my * cp->v + by, mx * cp->h + bx);
      }
      --todo;
    }
    // the next marker follows; bits left over are padding
    bitbuf_ = 0;
    bitcnt_ = 0;
    hit_marker_ = false;
  }

  // ---- upsampling and colour conversion ----
  // one output row (full width, `width` samples) of component c; `tmp`
  // and `o` are scratch rows of at least 2 * c.dw + 2 entries
  void upsample_row(const Component& c, int y, int* tmp, uint8_t* o,
                    uint8_t* out) const {
    const int hr = hmax_ / c.h, vr = vmax_ / c.v;
    const uint8_t* P = c.plane.data();
    const int S = c.stride;
    if (hr == 1 && vr == 1) {
      std::memcpy(out, P + size_t(y) * S, width);
      return;
    }
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
      return P + size_t(r) * S;
    };
    const int dw = c.dw;
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      o[0] = in[0];
      o[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = in[i] * 3;
        o[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
        o[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = in[dw - 1];
      std::memcpy(out, o, width);
      return;
    }
    if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      int r = y >> 1;
      bool below = y & 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(below ? r + 1 : r - 1);
      int bias = below ? 2 : 1;
      for (int x = 0; x < width; ++x)
        out[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      int r = y >> 1;
      bool below = y & 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(below ? r + 1 : r - 1);
      for (int i = 0; i < dw; ++i) tmp[i] = in0[i] * 3 + in1[i];
      o[0] = uint8_t((tmp[0] * 4 + 8) >> 4);
      o[1] = uint8_t((tmp[0] * 3 + tmp[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; ++i) {
        o[2 * i] = uint8_t((tmp[i] * 3 + tmp[i - 1] + 8) >> 4);
        o[2 * i + 1] = uint8_t((tmp[i] * 3 + tmp[i + 1] + 7) >> 4);
      }
      o[2 * dw - 2] = uint8_t((tmp[dw - 1] * 3 + tmp[dw - 2] + 8) >> 4);
      o[2 * dw - 1] = uint8_t((tmp[dw - 1] * 4 + 7) >> 4);
      std::memcpy(out, o, width);
      return;
    }
    // int_upsample / h2v1_upsample / h2v2_upsample: replication
    const uint8_t* in = P + size_t(y / vr) * S;
    for (int x = 0; x < width; ++x) out[x] = in[x / hr];
  }

  bool rgb_colour_space() const {
    if (saw_jfif_) return false;
    if (saw_adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
  }

  size_t scratch_size() const {
    size_t scratch = 8;
    for (const auto& c : comps_)
      scratch = std::max(scratch, size_t(c.stride) * 2 + 8);
    return scratch;
  }

  // jdcolor.c's grayscale output: the Y component of a grayscale or YCbCr
  // file (grayscale_convert), rgb_gray_convert's weights for an RGB one
  void to_gray(uint8_t* out) const {
    const size_t W = width;
    std::vector<int> tmp(scratch_size());
    std::vector<uint8_t> o(scratch_size());
    if (comps_.size() == 1 || !rgb_colour_space()) {
      for (int y = 0; y < height; ++y)
        upsample_row(comps_[0], y, tmp.data(), o.data(), out + size_t(y) * W);
      return;
    }
    auto FIX = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    std::vector<uint8_t> a(W), b(W), c(W);
    for (int y = 0; y < height; ++y) {
      upsample_row(comps_[0], y, tmp.data(), o.data(), a.data());
      upsample_row(comps_[1], y, tmp.data(), o.data(), b.data());
      upsample_row(comps_[2], y, tmp.data(), o.data(), c.data());
      uint8_t* op = out + size_t(y) * W;
      for (size_t x = 0; x < W; ++x)
        op[x] = uint8_t((FIX(0.29900) * a[x] + FIX(0.58700) * b[x] +
                         FIX(0.11400) * c[x] + 32768) >> 16);
    }
  }

  void to_rgb(uint8_t* out) const {
    const size_t W = width;
    std::vector<int> tmp(scratch_size());
    std::vector<uint8_t> o(scratch_size());
    if (comps_.size() == 1) {
      std::vector<uint8_t> g(W);
      for (int y = 0; y < height; ++y) {
        upsample_row(comps_[0], y, tmp.data(), o.data(), g.data());
        uint8_t* o = out + size_t(y) * W * 3;
        for (size_t x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    const bool rgb = rgb_colour_space();
    // jdcolor.c's build_ycc_rgb_table
    auto FIX = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((FIX(1.40200) * x + 32768) >> 16);
      cb_b[i] = int((FIX(1.77200) * x + 32768) >> 16);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + 32768;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    std::vector<uint8_t> a(W), b(W), c(W);
    for (int y = 0; y < height; ++y) {
      upsample_row(comps_[0], y, tmp.data(), o.data(), a.data());
      upsample_row(comps_[1], y, tmp.data(), o.data(), b.data());
      upsample_row(comps_[2], y, tmp.data(), o.data(), c.data());
      uint8_t* o = out + size_t(y) * W * 3;
      if (rgb) {
        for (size_t x = 0; x < W; ++x) {
          o[3 * x] = a[x];
          o[3 * x + 1] = b[x];
          o[3 * x + 2] = c[x];
        }
        continue;
      }
      for (size_t x = 0; x < W; ++x) {
        int yy = a[x], cb = b[x], cr = c[x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(yy + int((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

void set_err(char* err, int32_t len, const char* msg) {
  if (err && len > 0) {
    std::strncpy(err, msg, size_t(len) - 1);
    err[len - 1] = 0;
  }
}

}  // namespace

extern "C" int lemo_jpeg_dims(const uint8_t* data, int64_t n, int32_t* hwc,
                              char* err, int32_t err_len) {
  try {
    Decoder dec(data, n);
    dec.read_header();
    hwc[0] = dec.height;
    hwc[1] = dec.width;
    hwc[2] = dec.components();
    return 0;
  } catch (const std::exception& e) {
    set_err(err, err_len, e.what());
    return -1;
  }
}

extern "C" int lemo_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                                int64_t out_bytes, int32_t channels,
                                char* err, int32_t err_len) {
  try {
    if (channels != 1 && channels != 3)
      throw JpegError("channels must be 1 or 3");
    Decoder dec(data, n);
    dec.read_header();
    if (int64_t(dec.height) * dec.width * channels != out_bytes)
      throw JpegError("output buffer size does not match the image");
    dec.decode(out, channels);
    return 0;
  } catch (const std::exception& e) {
    set_err(err, err_len, e.what());
    return -1;
  }
}
