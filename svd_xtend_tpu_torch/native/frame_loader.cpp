// Native frame loader: threaded JPEG decode + bilinear resize + [-1,1]
// normalize, for the video-frame training pipeline.
//
// The port's copy of svd_xtend_tpu/native/frame_loader.cpp: the same C API,
// the same PIL-style triangular resize and the same normalize, so on the
// same decoded pixels it gives the same floats. The decode has two builds:
//   - libjpeg (the default, as in the JAX package), where jpeglib.h and
//     libjpeg are installed;
//   - a built-in baseline decoder (-DSVDX_BUILTIN_JPEG) for a machine
//     without libjpeg: Huffman decoding, then libjpeg's own integer IDCT,
//     chroma upsampling and colour conversion, so on the files it takes
//     (baseline, 8-bit, one scan) it decodes libjpeg's pixels. nvJPEG,
//     the CUDA toolkit's decoder, does not: its IDCT is not libjpeg's
//     (svd_xtend_tpu_torch/scripts/probe_nvjpeg.py measures by how much).
//
// C API (ctypes-friendly, see native/__init__.py):
//   fl_decode_resize(path, out_w, out_h, out)         -> 0 on success
//   fl_load_clip(paths, n, out_w, out_h, threads, out)-> #frames decoded OK
//   fl_version()                                      -> build tag

#include <cstddef>
#include <cstdio>

#ifndef SVDX_BUILTIN_JPEG
#include <jpeglib.h>
#endif

#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// libjpeg's YCbCr -> RGB (jdcolor.c: 16-bit fixed point, the same tables)
// and its "fancy" chroma upsampling (jdsample.c: h2v1 and h2v2 triangle
// filters; the rows above the first and below the last repeat them), for
// the built-in decoder's planes.
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16, kHalf = 1 << (kScale - 1);
    auto fix = [](double x) { return static_cast<int>(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

inline unsigned char clamp255(int v) {
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One chroma row upsampled 2x horizontally (h2v1_fancy_upsample); `in` has
// n >= 2 samples, `out` 2n.
void h2v1_row(const unsigned char* in, int n, unsigned char* out) {
  out[0] = in[0];
  out[1] = static_cast<unsigned char>((in[0] * 3 + in[1] + 2) >> 2);
  for (int i = 1; i < n - 1; ++i) {
    const int v = in[i] * 3;
    out[2 * i] = static_cast<unsigned char>((v + in[i - 1] + 1) >> 2);
    out[2 * i + 1] = static_cast<unsigned char>((v + in[i + 1] + 2) >> 2);
  }
  out[2 * n - 2] = static_cast<unsigned char>((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
  out[2 * n - 1] = in[n - 1];
}

// One output row of h2v2_fancy_upsample: `near` is the chroma row nearest
// the output row, `far` the next nearest (above for even rows, below for
// odd ones); n >= 2 samples, 2n out.
void h2v2_row(const unsigned char* near, const unsigned char* far, int n,
              unsigned char* out) {
  int last = 0, cur = near[0] * 3 + far[0], next = 0;
  for (int i = 0; i < n; ++i) {
    next = i + 1 < n ? near[i + 1] * 3 + far[i + 1] : 0;
    out[2 * i] = static_cast<unsigned char>(
        i == 0 ? (cur * 4 + 8) >> 4 : (cur * 3 + last + 8) >> 4);
    out[2 * i + 1] = static_cast<unsigned char>(
        i == n - 1 ? (cur * 4 + 7) >> 4 : (cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
  }
}

// Planar Y (w x h, pitch w) and Cb, Cr (cw x ch, pitch cw) -> interleaved
// RGB. The layouts libjpeg upsamples are taken: 4:4:4, h2v1 (4:2:2) and
// h2v2 (4:2:0); false for any other.
bool ycc_planes_to_rgb(const unsigned char* y, const unsigned char* cb,
                       const unsigned char* cr, int w, int h, int cw, int ch,
                       unsigned char* rgb) {
  static const YccTables t;
  const int hx = cw == w ? 1 : 2, hy = ch == h ? 1 : 2;
  if ((hx == 2 && (cw != (w + 1) / 2 || cw < 2)) || (hy == 2 && ch != (h + 1) / 2) ||
      (hy == 2 && hx == 1))
    return false;
  std::vector<unsigned char> ub(static_cast<size_t>(cw) * 2), vb(ub.size());
  for (int r = 0; r < h; ++r) {
    const unsigned char *u, *v;
    if (hx == 1) {
      u = cb + static_cast<size_t>(r) * cw;
      v = cr + static_cast<size_t>(r) * cw;
    } else if (hy == 1) {
      h2v1_row(cb + static_cast<size_t>(r) * cw, cw, ub.data());
      h2v1_row(cr + static_cast<size_t>(r) * cw, cw, vb.data());
      u = ub.data();
      v = vb.data();
    } else {
      const int near = r / 2;
      int far = r % 2 == 0 ? near - 1 : near + 1;
      far = far < 0 ? 0 : (far > ch - 1 ? ch - 1 : far);
      h2v2_row(cb + static_cast<size_t>(near) * cw, cb + static_cast<size_t>(far) * cw,
               cw, ub.data());
      h2v2_row(cr + static_cast<size_t>(near) * cw, cr + static_cast<size_t>(far) * cw,
               cw, vb.data());
      u = ub.data();
      v = vb.data();
    }
    const unsigned char* yr = y + static_cast<size_t>(r) * w;
    unsigned char* o = rgb + static_cast<size_t>(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = yr[x], b = u[x], rr = v[x];
      o[3 * x + 0] = clamp255(yy + t.cr_r[rr]);
      o[3 * x + 1] = clamp255(yy + ((t.cb_g[b] + t.cr_g[rr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[b]);
    }
  }
  return true;
}

#ifdef SVDX_BUILTIN_JPEG

// A baseline JPEG decoder (sequential DCT, Huffman, 8-bit: SOF0/SOF1) with
// libjpeg's arithmetic, for a machine without libjpeg: the IDCT is
// jidctint.c's jpeg_idct_islow (13-bit fixed point, two passes, the
// post-IDCT range-limit table), the chroma goes through the fancy
// upsampling and YCbCr -> RGB above. Progressive, arithmetic-coded,
// 12-bit, multi-scan and CMYK files return false (the caller's fallback).

struct Huff {
  int maxcode[18], valptr[17], mincode[17];
  unsigned char vals[256];
  bool ok = false;
  void build(const unsigned char* counts, const unsigned char* v, int n) {
    memcpy(vals, v, n);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    ok = true;
  }
};

struct Bits {
  const unsigned char* p;
  const unsigned char* end;
  unsigned int acc = 0;
  int n = 0;
  int bit() {
    if (n == 0) {
      unsigned int b = 0;
      if (p < end) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {
            b = 0;  // a marker: zeros from here, as libjpeg fills
          }
        } else {
          ++p;
        }
      }
      acc = b;
      n = 8;
    }
    --n;
    return (acc >> n) & 1;
  }
  int get(int k) {
    int v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | bit();
    return v;
  }
  int decode(const Huff& h) {
    int code = bit(), l = 1;
    while (l <= 16 && code > h.maxcode[l]) {
      code = (code << 1) | bit();
      ++l;
    }
    if (l > 16) return -1;
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }
  // the restart marker after an interval: drop the partial byte, skip it
  bool restart() {
    n = 0;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) ++p;
    if (p + 1 >= end) return false;
    p += 2;
    return true;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                         11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                         13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                         36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                         38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jpeg_idct_islow: coef (natural order) times quant -> 8x8 samples
void idct_islow(const int* coef, const int* q, unsigned char* out, int stride) {
  const long kC0298 = 2446, kC0390 = 3196, kC0541 = 4433, kC0765 = 6270,
             kC0899 = 7373, kC1175 = 9633, kC1501 = 12299, kC1847 = 15137,
             kC1961 = 16069, kC2053 = 16819, kC2562 = 20995, kC3072 = 25172;
  const int kConst = 13, kPass1 = 2;
  auto descale = [](long x, int n) { return (x + (1L << (n - 1))) >> n; };
  // the post-IDCT range limit: centred x in [-128, 127] -> x + 128, above
  // (to 511) 255, below (to -512) 0, indexed by x & 1023
  static const struct Limit {
    unsigned char t[1024];
    Limit() {
      for (int j = 0; j < 1024; ++j) {
        const int x = j < 512 ? j : j - 1024;
        t[j] = static_cast<unsigned char>(x < -128 ? 0 : (x > 127 ? 255 : x + 128));
      }
    }
  } limit;
  long ws[64];
  for (int c = 0; c < 8; ++c) {
    const int* in = coef + c;
    const int* qq = q + c;
    long z2 = static_cast<long>(in[16]) * qq[16], z3 = static_cast<long>(in[48]) * qq[48];
    long z1 = (z2 + z3) * kC0541;
    long tmp2 = z1 + z3 * -kC1847, tmp3 = z1 + z2 * kC0765;
    z2 = static_cast<long>(in[0]) * qq[0];
    z3 = static_cast<long>(in[32]) * qq[32];
    long tmp0 = (z2 + z3) << kConst, tmp1 = (z2 - z3) << kConst;
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
               tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<long>(in[56]) * qq[56];
    tmp1 = static_cast<long>(in[40]) * qq[40];
    tmp2 = static_cast<long>(in[24]) * qq[24];
    tmp3 = static_cast<long>(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    const long z5 = (z3 + z4) * kC1175;
    tmp0 *= kC0298;
    tmp1 *= kC2053;
    tmp2 *= kC3072;
    tmp3 *= kC1501;
    z1 *= -kC0899;
    z2 *= -kC2562;
    z3 = z3 * -kC1961 + z5;
    z4 = z4 * -kC0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConst - kPass1;
    ws[c] = descale(tmp10 + tmp3, sh);
    ws[56 + c] = descale(tmp10 - tmp3, sh);
    ws[8 + c] = descale(tmp11 + tmp2, sh);
    ws[48 + c] = descale(tmp11 - tmp2, sh);
    ws[16 + c] = descale(tmp12 + tmp1, sh);
    ws[40 + c] = descale(tmp12 - tmp1, sh);
    ws[24 + c] = descale(tmp13 + tmp0, sh);
    ws[32 + c] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const long* w = ws + 8 * r;
    long z2 = w[2], z3 = w[6];
    long z1 = (z2 + z3) * kC0541;
    long tmp2 = z1 + z3 * -kC1847, tmp3 = z1 + z2 * kC0765;
    long tmp0 = (w[0] + w[4]) << kConst, tmp1 = (w[0] - w[4]) << kConst;
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
               tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    const long z5 = (z3 + z4) * kC1175;
    tmp0 *= kC0298;
    tmp1 *= kC2053;
    tmp2 *= kC3072;
    tmp3 *= kC1501;
    z1 *= -kC0899;
    z2 *= -kC2562;
    z3 = z3 * -kC1961 + z5;
    z4 = z4 * -kC0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConst + kPass1 + 3;
    unsigned char* o = out + static_cast<size_t>(r) * stride;
    o[0] = limit.t[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = limit.t[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = limit.t[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = limit.t[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = limit.t[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = limit.t[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = limit.t[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = limit.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

bool read_file(const char* path, std::vector<unsigned char>& bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  bytes.resize(n > 0 ? static_cast<size_t>(n) : 0);
  const bool ok = n > 0 && fread(bytes.data(), 1, bytes.size(), f) == bytes.size();
  fclose(f);
  return ok;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;                 // blocks across and down in its plane
  std::vector<unsigned char> plane;   // bw*8 x bh*8 samples
};

bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb, int& w,
                 int& h) {
  std::vector<unsigned char> d;
  if (!read_file(path, d) || d.size() < 4 || d[0] != 0xFF || d[1] != 0xD8) return false;
  int quant[4][64];
  Huff dc[4], ac[4];
  std::vector<Comp> comps;
  int restart = 0, hmax = 1, vmax = 1, adobe_transform = -1;
  w = h = 0;
  size_t i = 2;
  while (i + 4 <= d.size()) {
    if (d[i] != 0xFF) return false;
    const int m = d[i + 1];
    if (m == 0xFF) {
      ++i;
      continue;
    }
    if (m == 0xD9) return false;  // EOI before any scan
    const size_t len = (static_cast<size_t>(d[i + 2]) << 8) | d[i + 3];
    const unsigned char* seg = &d[i + 4];
    if (len < 2 || i + 2 + len > d.size()) return false;
    const size_t n = len - 2;
    if (m == 0xDB) {  // DQT
      for (size_t k = 0; k < n;) {
        const int pq = seg[k] >> 4, tq = seg[k] & 15;
        if (tq > 3 || k + 1 + 64 * (pq + 1) > n) return false;
        for (int j = 0; j < 64; ++j)
          quant[tq][kZigzag[j]] = pq ? (seg[k + 1 + 2 * j] << 8) | seg[k + 2 + 2 * j]
                                     : seg[k + 1 + j];
        k += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xC4) {  // DHT
      for (size_t k = 0; k < n;) {
        if (k + 17 > n) return false;
        const int tc = seg[k] >> 4, th = seg[k] & 15;
        int total = 0;
        for (int j = 0; j < 16; ++j) total += seg[k + 1 + j];
        if (th > 3 || tc > 1 || total > 256 || k + 17 + total > n) return false;
        (tc ? ac : dc)[th].build(seg + k + 1, seg + k + 17, total);
        k += 17 + total;
      }
    } else if (m == 0xC0 || m == 0xC1) {  // baseline / extended sequential, Huffman
      if (n < 6 || seg[0] != 8) return false;
      h = (seg[1] << 8) | seg[2];
      w = (seg[3] << 8) | seg[4];
      const int nf = seg[5];
      if ((nf != 1 && nf != 3) || n < 6 + 3 * static_cast<size_t>(nf) || w <= 0 || h <= 0)
        return false;
      comps.resize(nf);
      for (int c = 0; c < nf; ++c) {
        comps[c].id = seg[6 + 3 * c];
        comps[c].h = seg[7 + 3 * c] >> 4;
        comps[c].v = seg[7 + 3 * c] & 15;
        comps[c].tq = seg[8 + 3 * c] & 3;
        if (comps[c].h < 1 || comps[c].v < 1 || comps[c].h > 2 || comps[c].v > 2) return false;
        hmax = comps[c].h > hmax ? comps[c].h : hmax;
        vmax = comps[c].v > vmax ? comps[c].v : vmax;
      }
    } else if ((m >= 0xC2 && m <= 0xCB && m != 0xC4 && m != 0xC8) || (m >= 0xCD && m <= 0xCF)) {
      return false;  // progressive, lossless, arithmetic, hierarchical
    } else if (m == 0xDD) {  // DRI
      if (n < 2) return false;
      restart = (seg[0] << 8) | seg[1];
    } else if (m == 0xEE && n >= 12 && memcmp(seg, "Adobe", 5) == 0) {
      adobe_transform = seg[11];
    } else if (m == 0xDA) {  // SOS: the one interleaved scan
      if (comps.empty() || n < 1) return false;
      const int ns = seg[0];
      if (ns != static_cast<int>(comps.size()) || n < 4 + 2 * static_cast<size_t>(ns))
        return false;
      for (int c = 0; c < ns; ++c) {
        if (seg[1 + 2 * c] != comps[c].id) return false;
        comps[c].td = seg[2 + 2 * c] >> 4;
        comps[c].ta = seg[2 + 2 * c] & 15;
        if (comps[c].td > 3 || comps[c].ta > 3 || !dc[comps[c].td].ok ||
            !ac[comps[c].ta].ok)
          return false;
      }
      const bool single = ns == 1;
      const int mcux = single ? (w + 7) / 8 : (w + 8 * hmax - 1) / (8 * hmax);
      const int mcuy = single ? (h + 7) / 8 : (h + 8 * vmax - 1) / (8 * vmax);
      for (auto& c : comps) {
        c.bw = single ? mcux : mcux * c.h;
        c.bh = single ? mcuy : mcuy * c.v;
        c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      }
      Bits bits{&d[i + 2 + len], d.data() + d.size()};
      int pred[3] = {0, 0, 0}, coef[64];
      for (int my = 0, mcu = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx, ++mcu) {
          if (restart && mcu && mcu % restart == 0) {
            if (!bits.restart()) return false;
            pred[0] = pred[1] = pred[2] = 0;
          }
          for (int ci = 0; ci < ns; ++ci) {
            Comp& c = comps[ci];
            const int hb = single ? 1 : c.h, vb = single ? 1 : c.v;
            for (int by = 0; by < vb; ++by) {
              for (int bx = 0; bx < hb; ++bx) {
                memset(coef, 0, sizeof(coef));
                const int s = bits.decode(dc[c.td]);
                if (s < 0 || s > 11) return false;
                pred[ci] += s ? extend(bits.get(s), s) : 0;
                coef[0] = pred[ci];
                for (int k = 1; k < 64;) {
                  const int rs = bits.decode(ac[c.ta]);
                  if (rs < 0) return false;
                  const int r = rs >> 4, sz = rs & 15;
                  if (sz) {
                    k += r;
                    if (k > 63) return false;
                    coef[kZigzag[k]] = extend(bits.get(sz), sz);
                    ++k;
                  } else if (r == 15) {
                    k += 16;
                  } else {
                    break;
                  }
                }
                const int row = (my * vb + by) * 8, col = (mx * hb + bx) * 8;
                const int stride = c.bw * 8;
                idct_islow(coef, quant[c.tq],
                           &c.plane[static_cast<size_t>(row) * stride + col], stride);
              }
            }
          }
        }
      }
      // crop each plane to its real samples (libjpeg's downsampled size)
      std::vector<std::vector<unsigned char>> real(comps.size());
      std::vector<int> cw(comps.size()), ch(comps.size());
      for (size_t c = 0; c < comps.size(); ++c) {
        cw[c] = (w * comps[c].h + hmax - 1) / hmax;
        ch[c] = (h * comps[c].v + vmax - 1) / vmax;
        real[c].resize(static_cast<size_t>(cw[c]) * ch[c]);
        for (int r = 0; r < ch[c]; ++r)
          memcpy(&real[c][static_cast<size_t>(r) * cw[c]],
                 &comps[c].plane[static_cast<size_t>(r) * comps[c].bw * 8], cw[c]);
      }
      rgb.resize(static_cast<size_t>(w) * h * 3);
      if (comps.size() == 1) {
        for (size_t k = 0; k < real[0].size(); ++k)
          rgb[3 * k] = rgb[3 * k + 1] = rgb[3 * k + 2] = real[0][k];
        return true;
      }
      if (cw[1] != cw[2] || ch[1] != ch[2] || cw[0] != w || ch[0] != h) return false;
      const bool is_rgb = adobe_transform == 0 ||
                          (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
      if (is_rgb) {
        if (cw[1] != w || ch[1] != h) return false;
        for (size_t k = 0; k < real[0].size(); ++k)
          for (int c = 0; c < 3; ++c) rgb[3 * k + c] = real[c][k];
        return true;
      }
      return ycc_planes_to_rgb(real[0].data(), real[1].data(), real[2].data(), w, h,
                               cw[1], ch[1], rgb.data());
    }
    i += 2 + len;
  }
  return false;
}

#else

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb, int& w,
                 int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row =
        rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

#endif  // SVDX_BUILTIN_JPEG

// PIL-style triangular (BILINEAR) resampling: separable two-pass with
// adaptive filter support (anti-aliased on downscale — matches
// Image.resize(..., BILINEAR), which the PIL fallback path uses), fused with
// the [0,255] -> [-1,1] normalize the reference applies (train_svd.py:125).
// Output: HWC float32.

struct Taps {
  std::vector<int> xmin, xlen;
  std::vector<float> weights;   // per output index: xlen[i] weights at
  int ksize = 0;                // stride ksize (max support)
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support = 1
  t.ksize = static_cast<int>(support * 2.0) + 2;
  t.xmin.resize(out_size);
  t.xlen.resize(out_size);
  t.weights.assign(static_cast<size_t>(out_size) * t.ksize, 0.0);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    float* w = &t.weights[static_cast<size_t>(i) * t.ksize];
    double total = 0.0;
    for (int k = xmin; k < xmax; ++k) {
      double x = (k - center + 0.5) / filterscale;
      if (x < 0.0) x = -x;
      const double v = x < 1.0 ? 1.0 - x : 0.0;
      w[k - xmin] = static_cast<float>(v);
      total += v;
    }
    if (total > 0.0)
      for (int k = 0; k < xmax - xmin; ++k)
        w[k] = static_cast<float>(w[k] / total);
    t.xmin[i] = xmin;
    t.xlen[i] = xmax - xmin;
  }
  return t;
}

void resize_normalize(const std::vector<unsigned char>& src, int sw, int sh,
                      int dw, int dh, float* out) {
  const Taps tx = make_taps(sw, dw);
  const Taps ty = make_taps(sh, dh);
  // horizontal pass: (sh, sw, 3) u8 -> (sh, dw, 3) float
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const unsigned char* row = &src[static_cast<size_t>(y) * sw * 3];
    float* trow = &tmp[static_cast<size_t>(y) * dw * 3];
    for (int x = 0; x < dw; ++x) {
      const float* w = &tx.weights[static_cast<size_t>(x) * tx.ksize];
      const int x0 = tx.xmin[x], n = tx.xlen[x];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      for (int k = 0; k < n; ++k) {
        const unsigned char* p = row + (static_cast<size_t>(x0) + k) * 3;
        acc0 += w[k] * p[0];
        acc1 += w[k] * p[1];
        acc2 += w[k] * p[2];
      }
      trow[x * 3 + 0] = acc0;
      trow[x * 3 + 1] = acc1;
      trow[x * 3 + 2] = acc2;
    }
  }
  // vertical pass + normalize: (sh, dw, 3) -> (dh, dw, 3) in [-1, 1]
  for (int y = 0; y < dh; ++y) {
    const float* w = &ty.weights[static_cast<size_t>(y) * ty.ksize];
    const int y0 = ty.xmin[y], n = ty.xlen[y];
    float* orow = out + static_cast<size_t>(y) * dw * 3;
    const int row_elems = dw * 3;
    // k-outer / x-inner: unit-stride FMA over the row, auto-vectorizes
    for (int x = 0; x < row_elems; ++x) orow[x] = 0.f;
    for (int k = 0; k < n; ++k) {
      const float wk = w[k];
      const float* trow = &tmp[(static_cast<size_t>(y0) + k) * row_elems];
      for (int x = 0; x < row_elems; ++x) orow[x] += wk * trow[x];
    }
    for (int x = 0; x < row_elems; ++x)
      orow[x] = orow[x] * (2.0f / 255.0f) - 1.0f;
  }
}

}  // namespace

extern "C" {

int fl_decode_resize(const char* path, int out_w, int out_h, float* out) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(path, rgb, w, h)) return 1;
  resize_normalize(rgb, w, h, out_w, out_h, out);
  return 0;
}

// Decode n frames concurrently; out is (n, out_h, out_w, 3) float32.
// Returns the number of successfully decoded frames (== n when all OK).
int fl_load_clip(const char** paths, int n, int out_w, int out_h,
                 int num_threads, float* out) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0), ok(0);
  const size_t frame_elems = static_cast<size_t>(out_w) * out_h * 3;
  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0;
      if (decode_jpeg(paths[i], rgb, w, h)) {
        resize_normalize(rgb, w, h, out_w, out_h, out + i * frame_elems);
        ok.fetch_add(1);
      } else {
        memset(out + i * frame_elems, 0, frame_elems * sizeof(float));
      }
    }
  };
  const int t = num_threads < n ? num_threads : n;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

#ifdef SVDX_BUILTIN_JPEG
const char* fl_version() { return "frame_loader 1.0 (builtin, bilinear)"; }
#else
const char* fl_version() { return "frame_loader 1.0 (libjpeg, bilinear)"; }
#endif

}  // extern "C"
