// Native JPEG decoder (baseline + progressive, Huffman, 8-bit) for the
// texture-ingest path.  Fulfils the role of the reference's vendored
// stb_image (3rd_parties/stb/stb_image.h) for image_texture decode
// (texture.h:70-86): both reference assets are JPEG — earthmap.jpg is
// baseline (SOF0), capsule.jpg is progressive (SOF2).  Written from the
// ITU-T T.81 spec (sections F.2 sequential decode, G.1.2 progressive
// control; no third-party code).  Cold path: runs once per texture at
// scene-build time.
//
// A copy of the JAX package's native/jpegdec.cpp.
//
// Exported C ABI (ctypes bridge in another_raytracer_tpu_torch/utils/native.py):
//   unsigned char* artpu_decode_jpeg(const char* path, int* w, int* h);
//     -> malloc'd RGB8 (w*h*3), caller frees with artpu_image_free; NULL on
//        any parse error / unsupported coding (arithmetic, lossless, 12-bit,
//        hierarchical).
//   void artpu_image_free(unsigned char*);

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kZigZag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
  bool present = false;
  int mincode[17];
  int maxcode[18];
  int valptr[17];
  uint8_t symbols[256];
  void build(const uint8_t counts[16], const uint8_t* syms, int nsyms) {
    std::memcpy(symbols, syms, static_cast<size_t>(nsyms));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;  // sentinel (never matched; decode fails at 16)
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;             // huffman table selectors (per scan)
  int blocks_w = 0, blocks_h = 0; // MCU-padded block dims (coef storage)
  int nblocks_w = 0, nblocks_h = 0;  // ceil(samples/8) (non-interleaved scan)
  std::vector<int16_t> coef;      // [blocks_w*blocks_h][64]
  int dcpred = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;

  // frame
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false;
  Component comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64] = {};
  HuffTable hdc[4], hac[4];
  int restart_interval = 0;

  // entropy bit reader
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;  // saw a non-RST marker inside entropy data
  int eobrun = 0;

  bool err(const char* what) {
    std::fprintf(stderr, "artpu jpegdec: %s\n", what);
    return false;
  }

  int byte() { return pos < size ? data[pos++] : -1; }
  int be16() {
    int a = byte(), b = byte();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }

  void bits_reset() { bitbuf = 0; bitcnt = 0; hit_marker = false; }

  int next_bit() {
    if (bitcnt == 0) {
      if (hit_marker || pos >= size) return 0;  // pad past marker with zeros
      int c = data[pos++];
      if (c == 0xFF) {
        int c2 = pos < size ? data[pos] : 0xD9;
        if (c2 == 0x00) {
          ++pos;  // byte stuffing
        } else {
          // Entropy segment ended (RST handled by caller via align+marker).
          hit_marker = true;
          --pos;  // leave the marker in the stream
          return 0;
        }
      }
      bitbuf = static_cast<uint32_t>(c);
      bitcnt = 8;
    }
    --bitcnt;
    return static_cast<int>((bitbuf >> bitcnt) & 1u);
  }

  int get_bits(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | next_bit();
    return v;
  }

  // F.2.2.3 DECODE
  int decode_huff(const HuffTable& t) {
    int code = next_bit();
    for (int l = 1; l <= 16; ++l) {
      if (code <= t.maxcode[l]) return t.symbols[t.valptr[l] + code - t.mincode[l]];
      code = (code << 1) | next_bit();
    }
    return -1;
  }

  // F.2.2.1 EXTEND
  int receive_extend(int s) {
    int v = get_bits(s);
    if (v < (1 << (s - 1))) v -= (1 << s) - 1;
    return v;
  }

  bool parse_dqt(int len) {
    int end = static_cast<int>(pos) + len - 2;
    while (static_cast<int>(pos) < end) {
      int pq_tq = byte();
      if (pq_tq < 0) return err("DQT truncated");
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) return err("DQT id");
      for (int i = 0; i < 64; ++i)
        qt[tq][kZigZag[i]] = static_cast<uint16_t>(pq ? be16() : byte());
    }
    return true;
  }

  bool parse_dht(int len) {
    int end = static_cast<int>(pos) + len - 2;
    while (static_cast<int>(pos) < end) {
      int tc_th = byte();
      if (tc_th < 0) return err("DHT truncated");
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) return err("DHT id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = static_cast<uint8_t>(byte());
        total += counts[i];
      }
      if (total > 256) return err("DHT counts");
      uint8_t syms[256];
      for (int i = 0; i < total; ++i) syms[i] = static_cast<uint8_t>(byte());
      (tc ? hac[th] : hdc[th]).build(counts, syms, total);
    }
    return true;
  }

  bool parse_sof(int marker, int len) {
    (void)len;
    progressive = marker == 0xC2;
    int prec = byte();
    height = be16();
    width = be16();
    ncomp = byte();
    if (prec != 8) return err("only 8-bit precision supported");
    if (width <= 0 || height <= 0) return err("bad dimensions");
    if (ncomp != 1 && ncomp != 3) return err("only 1 or 3 components");
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = byte();
      int hv = byte();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = byte();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4)
        return err("bad sampling factors");
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.blocks_w = mcux * c.h;
      c.blocks_h = mcuy * c.v;
      int sw = (width * c.h + hmax - 1) / hmax;   // component samples
      int sh = (height * c.v + vmax - 1) / vmax;
      c.nblocks_w = (sw + 7) / 8;
      c.nblocks_h = (sh + 7) / 8;
      c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
    }
    return true;
  }

  int16_t* block(Component& c, int brow, int bcol) {
    return &c.coef[(static_cast<size_t>(brow) * c.blocks_w + bcol) * 64];
  }

  // --- per-block entropy decoders -----------------------------------------

  bool decode_block_baseline(Component& c, int16_t* b) {
    int s = decode_huff(hdc[c.td]);
    if (s < 0 || s > 11) return err("bad DC code");
    int diff = s ? receive_extend(s) : 0;
    c.dcpred += diff;
    b[0] = static_cast<int16_t>(c.dcpred);
    int k = 1;
    while (k < 64) {
      int rs = decode_huff(hac[c.ta]);
      if (rs < 0) return err("bad AC code");
      int r = rs >> 4, sz = rs & 15;
      if (sz == 0) {
        if (r != 15) break;
        k += 16;
      } else {
        k += r;
        if (k > 63) return err("AC index overflow");
        b[kZigZag[k]] = static_cast<int16_t>(receive_extend(sz));
        ++k;
      }
    }
    return true;
  }

  bool decode_dc_first(Component& c, int16_t* b, int al) {
    int s = decode_huff(hdc[c.td]);
    if (s < 0 || s > 11) return err("bad DC code");
    int diff = s ? receive_extend(s) : 0;
    c.dcpred += diff;
    b[0] = static_cast<int16_t>(c.dcpred << al);
    return true;
  }

  bool decode_dc_refine(int16_t* b, int al) {
    if (next_bit()) b[0] = static_cast<int16_t>(b[0] | (1 << al));
    return true;
  }

  bool decode_ac_first(Component& c, int16_t* b, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return true;
    }
    int k = ss;
    while (k <= se) {
      int rs = decode_huff(hac[c.ta]);
      if (rs < 0) return err("bad AC code");
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r < 15) {
          eobrun = (1 << r) - 1;
          if (r) eobrun += get_bits(r);
          break;
        }
        k += 16;
      } else {
        k += r;
        if (k > 63) return err("AC index overflow");
        b[kZigZag[k]] = static_cast<int16_t>(receive_extend(s) << al);
        ++k;
      }
    }
    return true;
  }

  // G.1.2.3 successive-approximation AC refinement
  bool decode_ac_refine(Component& c, int16_t* b, int ss, int se, int al) {
    int p1 = 1 << al;
    int m1 = -1 << al;
    int k = ss;
    if (eobrun == 0) {
      while (k <= se) {
        int rs = decode_huff(hac[c.ta]);
        if (rs < 0) return err("bad AC code");
        int r = rs >> 4, s = rs & 15;
        int newval = 0;
        if (s == 0) {
          if (r < 15) {
            eobrun = 1 << r;
            if (r) eobrun += get_bits(r);
            break;
          }
          // r == 15: pass over 16 zero-history coefficients
        } else {
          if (s != 1) return err("AC refine size != 1");
          newval = next_bit() ? p1 : m1;
        }
        while (k <= se) {
          int16_t* cp = &b[kZigZag[k]];
          if (*cp != 0) {
            if (next_bit() && (*cp & p1) == 0)
              *cp = static_cast<int16_t>(*cp + (*cp >= 0 ? p1 : m1));
          } else {
            if (r == 0) {
              if (s) *cp = static_cast<int16_t>(newval);
              ++k;
              break;
            }
            --r;
          }
          ++k;
        }
      }
    }
    if (eobrun > 0) {
      while (k <= se) {
        int16_t* cp = &b[kZigZag[k]];
        if (*cp != 0) {
          if (next_bit() && (*cp & p1) == 0)
            *cp = static_cast<int16_t>(*cp + (*cp >= 0 ? p1 : m1));
        }
        ++k;
      }
      --eobrun;
    }
    return true;
  }

  bool restart(int& next_rst) {
    bits_reset();
    if (pos + 1 >= size || data[pos] != 0xFF) return err("expected RST marker");
    int m = data[pos + 1];
    if (m < 0xD0 || m > 0xD7) return err("expected RSTn");
    if (m != 0xD0 + next_rst) return err("RST out of order");
    pos += 2;
    next_rst = (next_rst + 1) & 7;
    for (int i = 0; i < ncomp; ++i) comp[i].dcpred = 0;
    eobrun = 0;
    return true;
  }

  bool parse_sos(int len) {
    (void)len;
    int ns = byte();
    if (ns < 1 || ns > 4) return err("bad scan component count");
    int scomp[4];
    for (int i = 0; i < ns; ++i) {
      int cid = byte(), tdta = byte();
      int found = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) found = j;
      if (found < 0) return err("scan references unknown component");
      comp[found].td = tdta >> 4;
      comp[found].ta = tdta & 15;
      scomp[i] = found;
    }
    int ss = byte(), se = byte(), ahal = byte();
    int ah = ahal >> 4, al = ahal & 15;
    if (!progressive) { ss = 0; se = 63; ah = 0; al = 0; }
    if (ss < 0 || se > 63 || ss > se) return err("bad spectral range");

    bits_reset();
    eobrun = 0;
    for (int i = 0; i < ncomp; ++i) comp[i].dcpred = 0;
    int next_rst = 0;

    if (ns > 1 || (!progressive)) {
      // Interleaved MCU scan (baseline always; progressive DC when ns > 1).
      if (progressive && ss != 0) return err("interleaved AC scan");
      int mcus = 0;
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && mcus && mcus % restart_interval == 0) {
            if (!restart(next_rst)) return false;
          }
          ++mcus;
          for (int i = 0; i < ns; ++i) {
            Component& c = comp[scomp[i]];
            for (int by = 0; by < c.v; ++by) {
              for (int bx = 0; bx < c.h; ++bx) {
                int16_t* b = block(c, my * c.v + by, mx * c.h + bx);
                bool ok = progressive
                              ? (ah == 0 ? decode_dc_first(c, b, al)
                                         : decode_dc_refine(b, al))
                              : decode_block_baseline(c, b);
                if (!ok) return false;
              }
            }
          }
        }
      }
    } else {
      // Non-interleaved scan: one component, blocks in its own raster.
      Component& c = comp[scomp[0]];
      int mcus = 0;
      for (int by = 0; by < c.nblocks_h; ++by) {
        for (int bx = 0; bx < c.nblocks_w; ++bx) {
          if (restart_interval && mcus && mcus % restart_interval == 0) {
            if (!restart(next_rst)) return false;
          }
          ++mcus;
          int16_t* b = block(c, by, bx);
          bool ok;
          if (ss == 0) {
            ok = ah == 0 ? decode_dc_first(c, b, al) : decode_dc_refine(b, al);
          } else {
            ok = ah == 0 ? decode_ac_first(c, b, ss, se, al)
                         : decode_ac_refine(c, b, ss, se, al);
          }
          if (!ok) return false;
        }
      }
    }
    // Byte-align; main loop resumes marker parsing.
    bitcnt = 0;
    return true;
  }

  // Float separable IDCT (T.81 A.3.3) + level shift, writing an 8x8 patch.
  void idct_block(const int16_t* coefs, const uint16_t* q, uint8_t* out,
                  int stride) {
    static float cs[8][8];
    static bool init = false;
    if (!init) {
      for (int x = 0; x < 8; ++x)
        for (int u = 0; u < 8; ++u)
          cs[x][u] = static_cast<float>(
              (u == 0 ? 0.35355339059327373 : 0.5) *
              std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0));
      init = true;
    }
    float tmp[64], row[64];
    for (int i = 0; i < 64; ++i) tmp[i] = static_cast<float>(coefs[i] * q[i]);
    for (int y = 0; y < 8; ++y) {  // 1D over rows
      for (int x = 0; x < 8; ++x) {
        float s = 0.f;
        for (int u = 0; u < 8; ++u) s += cs[x][u] * tmp[y * 8 + u];
        row[y * 8 + x] = s;
      }
    }
    for (int x = 0; x < 8; ++x) {  // 1D over columns
      for (int y = 0; y < 8; ++y) {
        float s = 0.f;
        for (int v = 0; v < 8; ++v) s += cs[y][v] * row[v * 8 + x];
        int val = static_cast<int>(std::lrintf(s)) + 128;
        out[y * stride + x] =
            static_cast<uint8_t>(val < 0 ? 0 : (val > 255 ? 255 : val));
      }
    }
  }

  unsigned char* finish() {
    // Decode coefficient planes -> component sample planes.
    std::vector<std::vector<uint8_t>> planes(static_cast<size_t>(ncomp));
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      int pw = c.blocks_w * 8, ph = c.blocks_h * 8;
      planes[i].assign(static_cast<size_t>(pw) * ph, 0);
      for (int by = 0; by < c.blocks_h; ++by)
        for (int bx = 0; bx < c.blocks_w; ++bx)
          idct_block(block(c, by, bx), qt[c.tq],
                     &planes[i][static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
    }
    auto* rgb = static_cast<unsigned char*>(
        std::malloc(static_cast<size_t>(width) * height * 3));
    if (!rgb) return nullptr;
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        unsigned char* px = &rgb[(static_cast<size_t>(y) * width + x) * 3];
        if (ncomp == 1) {
          uint8_t g = planes[0][static_cast<size_t>(y) * comp[0].blocks_w * 8 + x];
          px[0] = px[1] = px[2] = g;
        } else {
          auto sample = [&](int i) -> int {
            Component& c = comp[i];
            int sx = x * c.h / hmax, sy = y * c.v / vmax;
            return planes[i][static_cast<size_t>(sy) * c.blocks_w * 8 + sx];
          };
          float Y = static_cast<float>(sample(0));
          float Cb = static_cast<float>(sample(1)) - 128.f;
          float Cr = static_cast<float>(sample(2)) - 128.f;
          auto clamp8 = [](float v) -> unsigned char {
            int i = static_cast<int>(std::lrintf(v));
            return static_cast<unsigned char>(i < 0 ? 0 : (i > 255 ? 255 : i));
          };
          px[0] = clamp8(Y + 1.402f * Cr);
          px[1] = clamp8(Y - 0.344136f * Cb - 0.714136f * Cr);
          px[2] = clamp8(Y + 1.772f * Cb);
        }
      }
    }
    return rgb;
  }

  unsigned char* run(int* out_w, int* out_h) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) {
      err("not a JPEG (no SOI)");
      return nullptr;
    }
    pos = 2;
    bool have_frame = false;
    while (pos + 1 < size) {
      if (data[pos] != 0xFF) {
        err("marker desync");
        return nullptr;
      }
      int m = data[pos + 1];
      pos += 2;
      if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD9) break;  // EOI
      int len = be16();
      if (len < 2) {
        err("bad segment length");
        return nullptr;
      }
      size_t seg_end = pos + static_cast<size_t>(len) - 2;
      bool ok = true;
      switch (m) {
        case 0xDB: ok = parse_dqt(len); break;
        case 0xC4: ok = parse_dht(len); break;
        case 0xC0: case 0xC1: case 0xC2:
          ok = parse_sof(m, len);
          have_frame = ok;
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
        case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          err("unsupported SOF variant (arithmetic/lossless/hierarchical)");
          return nullptr;
        case 0xDD:
          restart_interval = be16();
          break;
        case 0xDA:
          if (!have_frame) {
            err("SOS before SOF");
            return nullptr;
          }
          if (!parse_sos(len)) return nullptr;
          continue;  // parse_sos consumed entropy data up to next marker
        default:
          pos = seg_end;  // APPn / COM / DNL: skip
          break;
      }
      if (!ok) return nullptr;
      if (m != 0xDA && pos != seg_end) pos = seg_end;
    }
    if (!have_frame) {
      err("no frame");
      return nullptr;
    }
    unsigned char* rgb = finish();
    if (rgb) {
      *out_w = width;
      *out_h = height;
    }
    return rgb;
  }
};

}  // namespace

extern "C" {

unsigned char* artpu_decode_jpeg(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return nullptr;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(n));
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(n), f);
  std::fclose(f);
  if (got != static_cast<size_t>(n)) return nullptr;
  Decoder dec;
  dec.data = buf.data();
  dec.size = buf.size();
  return dec.run(w, h);
}

void artpu_image_free(unsigned char* p) { std::free(p); }

}  // extern "C"
