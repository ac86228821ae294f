// Baseline JPEG decoding for utils/jpeg.py: the entropy decoding of one
// Huffman-coded sequential scan with its dequantisation and libjpeg's
// accurate integer IDCT (jidctint.c, JDCT_ISLOW), then libjpeg's fancy
// (triangle) upsampling (jdsample.c) and its fixed-point YCbCr -> RGB
// tables (jdcolor.c), so that the bytes equal what libjpeg(-turbo) gives
// PIL.  The marker parsing, the refusals and the plain Python version of
// the scan decoder live in utils/jpeg.py.  Host code: built by native.py
// with g++ into the repository's native library.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the end lands here (libjpeg's jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  bool present = false;
};

void build_huffman(const uint8_t* bits, const uint8_t* vals, Huffman& h) {
  // bits[1..16]: the number of codes of each length (jdhuff.c's derived table)
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      h.valoffset[l] = k - code;
      code += bits[l];
      k += bits[l];
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  std::memcpy(h.vals, vals, 256);
  h.present = true;
}

struct BitReader {
  const uint8_t* data;
  int len;
  int pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 24) {
      uint32_t byte = 0;
      if (!hit_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          int next = pos + 1 < len ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;   // a marker: libjpeg feeds zeros from here
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= byte << (24 - nbits);
      nbits += 8;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    fill();
    int v = static_cast<int>(acc >> (32 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int bit() { return get(1); }
  // after a restart interval: drop the bits left, step over the RSTn marker
  void restart() {
    acc = 0;
    nbits = 0;
    hit_marker = false;
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 < len) pos += 2;
  }
};

int decode_symbol(BitReader& br, const Huffman& h) {
  int code = br.bit();
  int l = 1;
  while (code > h.maxcode[l]) {
    code = (code << 1) | br.bit();
    if (++l > 16) return -1;
  }
  return h.vals[code + h.valoffset[l]];
}

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (-1 << s) + 1 : x; }

// jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
              F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
              F2562 = 20995, F3072 = 25172;
const int kConstBits = 13, kPass1Bits = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: table[x & 1023] of jdmaster.c's layout
inline uint8_t idct_limit(int64_t x) {
  int j = static_cast<int>(x) & 1023;
  if (j < 128) return static_cast<uint8_t>(j + 128);
  if (j < 512) return 255;
  if (j < 896) return 0;
  return static_cast<uint8_t>(j - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = static_cast<int>(int64_t(in[0]) * q[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16], z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
    tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
    z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
    z3 += z5; z4 += z5;
    tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, n)); w[56] = int(descale(tmp10 - tmp3, n));
    w[8] = int(descale(tmp11 + tmp2, n)); w[48] = int(descale(tmp11 - tmp2, n));
    w[16] = int(descale(tmp12 + tmp1, n)); w[40] = int(descale(tmp12 - tmp1, n));
    w[24] = int(descale(tmp13 + tmp0, n)); w[32] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7]; tmp1 = w[5]; tmp2 = w[3]; tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
    tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
    z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
    z3 += z5; z4 += z5;
    tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n)); o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n)); o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n)); o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n)); o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

enum { kH, kV, kOffset, kStride, kBlocksW, kBlocksH, kDc, kAc, kQuant, kInfo };

}  // namespace

extern "C" {

// One sequential Huffman scan.  ``info`` holds kInfo ints a component of
// the scan (sampling factors within the MCU, 1 x 1 for a one-component
// scan; the plane's offset in ``planes`` and its stride; the blocks to
// decode across and down; DC and AC table and quantisation table
// numbers).  ``bits`` (8 x 17) and ``vals`` (8 x 256) are the DC tables
// 0-3 then the AC tables 0-3; ``quant`` 4 x 64 in natural order.  Each
// block's IDCT lands in its component's plane.  Returns 0, or -1 for a
// code no table holds, -2 for a missing table.
int d2t_jpeg_scan(const uint8_t* data, int len, int ncomp, const int* info,
                  const uint8_t* bits, const uint8_t* vals, const uint8_t* present,
                  const uint16_t* quant, int mcux, int mcuy, int restart_interval,
                  uint8_t* planes) {
  std::vector<Huffman> tables(8);
  for (int t = 0; t < 8; ++t)
    if (present[t]) build_huffman(bits + 17 * t, vals + 256 * t, tables[t]);
  for (int c = 0; c < ncomp; ++c) {
    const int* ci = info + kInfo * c;
    if (!tables[ci[kDc]].present || !tables[4 + ci[kAc]].present) return -2;
  }
  BitReader br{data, len};
  std::vector<int> pred(ncomp, 0);
  int16_t coef[64];
  long mcus_left = restart_interval;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart_interval && mcus_left == 0) {
        br.restart();
        std::fill(pred.begin(), pred.end(), 0);
        mcus_left = restart_interval;
      }
      for (int c = 0; c < ncomp; ++c) {
        const int* ci = info + kInfo * c;
        const Huffman& dc = tables[ci[kDc]];
        const Huffman& ac = tables[4 + ci[kAc]];
        const uint16_t* q = quant + 64 * ci[kQuant];
        for (int v = 0; v < ci[kV]; ++v) {
          for (int h = 0; h < ci[kH]; ++h) {
            std::memset(coef, 0, sizeof(coef));
            int s = decode_symbol(br, dc);
            if (s < 0 || s > 15) return -1;
            if (s) pred[c] += extend(br.get(s), s);
            coef[0] = static_cast<int16_t>(pred[c]);
            for (int k = 1; k < 64; ++k) {
              int rs = decode_symbol(br, ac);
              if (rs < 0) return -1;
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                coef[kZigzag[k]] = static_cast<int16_t>(extend(br.get(s), s));
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            int by = my * ci[kV] + v, bx = mx * ci[kH] + h;
            if (by < ci[kBlocksH] && bx < ci[kBlocksW])
              idct_islow(coef, q, planes + ci[kOffset] + long(by) * 8 * ci[kStride] + bx * 8,
                         ci[kStride]);
          }
        }
      }
      --mcus_left;
    }
  }
  return 0;
}

// libjpeg's fancy upsampling of one component plane (``ds_w`` x ``ds_h``
// samples at ``stride``) by (``fh``, ``fv``) to ``out_w`` x ``out_h``:
// the triangle filters h2v1 (its width > 2), h1v2 and h2v2 (width > 2),
// otherwise every sample repeated (int_upsample).  Rows above the first
// and below the last repeat them, as jdmainct.c's context rows do.
int d2t_jpeg_upsample(const uint8_t* in, int stride, int ds_w, int ds_h, int fh, int fv,
                      uint8_t* out, int out_w, int out_h) {
  std::vector<uint8_t> row(static_cast<size_t>(ds_w) * fh + 2);
  auto src = [&](int y) { return in + static_cast<long>(y < 0 ? 0 : (y >= ds_h ? ds_h - 1 : y)) * stride; };
  for (int oy = 0; oy < out_h; ++oy) {
    uint8_t* o = row.data();
    int iy = oy / fv;
    const uint8_t* p0 = src(iy);
    if (fh == 2 && fv == 1 && ds_w > 2) {
      int v = p0[0];
      o[0] = uint8_t(v);
      o[1] = uint8_t((v * 3 + p0[1] + 2) >> 2);
      for (int x = 1; x < ds_w - 1; ++x) {
        v = p0[x] * 3;
        o[2 * x] = uint8_t((v + p0[x - 1] + 1) >> 2);
        o[2 * x + 1] = uint8_t((v + p0[x + 1] + 2) >> 2);
      }
      v = p0[ds_w - 1];
      o[2 * ds_w - 2] = uint8_t((v * 3 + p0[ds_w - 2] + 1) >> 2);
      o[2 * ds_w - 1] = uint8_t(v);
    } else if (fh == 1 && fv == 2) {
      bool above = oy % 2 == 0;
      const uint8_t* p1 = src(above ? iy - 1 : iy + 1);
      int bias = above ? 1 : 2;
      for (int x = 0; x < ds_w; ++x) o[x] = uint8_t((p0[x] * 3 + p1[x] + bias) >> 2);
    } else if (fh == 2 && fv == 2 && ds_w > 2) {
      const uint8_t* p1 = src(oy % 2 == 0 ? iy - 1 : iy + 1);
      int this_sum = p0[0] * 3 + p1[0], next_sum = p0[1] * 3 + p1[1], last_sum;
      o[0] = uint8_t((this_sum * 4 + 8) >> 4);
      o[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 1; x < ds_w - 1; ++x) {
        next_sum = p0[x + 1] * 3 + p1[x + 1];
        o[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * x + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      o[2 * ds_w - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * ds_w - 1] = uint8_t((this_sum * 4 + 7) >> 4);
    } else {
      for (int x = 0; x < ds_w; ++x)
        for (int k = 0; k < fh; ++k) o[x * fh + k] = p0[x];
    }
    std::memcpy(out + static_cast<long>(oy) * out_w, o, out_w);
  }
  return 0;
}

// Full-size Y, Cb, Cr planes (n pixels each) -> RGB (``gray`` 0) or PIL's
// convert("L") of it (``gray`` 1): jdcolor.c's tables, then
// (19595 R + 38470 G + 7471 B + 0x8000) >> 16.
void d2t_jpeg_ycc(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, long n, int gray,
                  uint8_t* out) {
  const int64_t one_half = int64_t(1) << 15;
  auto fix = [](double v) { return static_cast<int64_t>(v * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + one_half;
  }
  auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (long i = 0; i < n; ++i) {
    int Y = y[i], b = cb[i], r = cr[i];
    uint8_t R = clamp(Y + cr_r[r]);
    uint8_t G = clamp(Y + static_cast<int>((cb_g[b] + cr_g[r]) >> 16));
    uint8_t B = clamp(Y + cb_b[b]);
    if (gray) {
      out[i] = uint8_t((19595 * R + 38470 * G + 7471 * B + 0x8000) >> 16);
    } else {
      out[3 * i] = R;
      out[3 * i + 1] = G;
      out[3 * i + 2] = B;
    }
  }
}

}  // extern "C"
