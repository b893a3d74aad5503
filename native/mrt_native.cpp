// mrt_native: native runtime components for micro_raytracer_tpu.
//
// The reference implements its runtime in native code (Rust): a hand-rolled
// HTTP/1.1 server (reference src/http.rs) and PNG/JPEG encoding via
// the `image` crate. This library is the C++ equivalent for this build:
//
//   * a zlib-based PNG encoder (RGB8, filter 0) for the CLI's image output;
//   * a baseline JPEG encoder (JFIF, YCbCr 4:4:4, ITU T.81 Annex K tables
//     scaled by quality as libjpeg scales them) for the HTTP responses;
//   * a thread-per-connection HTTP/1.1 transport reproducing the reference's
//     request validation order (http.rs:73-113), which calls back into the
//     host (Python) only for the render itself.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

void* mrt_alloc(size_t n) { return std::malloc(n); }
void mrt_free(void* p) { std::free(p); }

// ---------------------------------------------------------------- PNG ----

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8); v.push_back(x);
}

static void put_chunk(std::vector<uint8_t>& out, const char type[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, (uInt)(len + 4));
  put_be32(out, crc);
}

// Encode an RGB8 image (h rows of w pixels, tightly packed) as a PNG byte
// stream. Returns malloc'd buffer in *out (caller frees with mrt_free).
int mrt_png_encode(const uint8_t* rgb, int w, int h,
                   uint8_t** out, size_t* out_len) {
  if (!rgb || w <= 0 || h <= 0 || !out || !out_len) return -1;

  // raw stream: one filter byte (0) per row
  std::vector<uint8_t> raw((size_t)h * (w * 3 + 1));
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + (size_t)y * (w * 3 + 1);
    row[0] = 0;
    std::memcpy(row + 1, rgb + (size_t)y * w * 3, (size_t)w * 3);
  }

  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<uint8_t> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -2;
  z.resize(zcap);

  std::vector<uint8_t> png;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  png.insert(png.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = w >> 24; ihdr[1] = w >> 16; ihdr[2] = w >> 8; ihdr[3] = w;
  ihdr[4] = h >> 24; ihdr[5] = h >> 16; ihdr[6] = h >> 8; ihdr[7] = h;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", z.data(), z.size());
  put_chunk(png, "IEND", nullptr, 0);

  *out = (uint8_t*)std::malloc(png.size());
  if (!*out) return -3;
  std::memcpy(*out, png.data(), png.size());
  *out_len = png.size();
  return 0;
}

int mrt_png_write(const char* path, const uint8_t* rgb, int w, int h) {
  uint8_t* buf = nullptr;
  size_t len = 0;
  int rc = mrt_png_encode(rgb, w, h, &buf, &len);
  if (rc != 0) return rc;
  FILE* f = std::fopen(path, "wb");
  if (!f) { std::free(buf); return -4; }
  size_t written = std::fwrite(buf, 1, len, f);
  std::fclose(f);
  std::free(buf);
  return written == len ? 0 : -5;
}

// --------------------------------------------------------------- JPEG ----
// Same algorithm as micro_raytracer_tpu/utils/codecs.py:encode_jpeg.

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kQLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kQChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
  uint16_t code[256];
  uint8_t len[256];
  Huff(const uint8_t bits[16], const uint8_t* vals) {
    std::memset(code, 0, sizeof code);
    std::memset(len, 0, sizeof len);
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
        code[vals[k]] = (uint16_t)c;
        len[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t bits, int n) {
    for (int i = n - 1; i >= 0; --i) {
      acc_ = (acc_ << 1) | ((bits >> i) & 1);
      if (++nacc_ == 8) flush_byte();
    }
  }
  void finish() {
    while (nacc_ != 0) {  // pad the last byte with 1s
      acc_ = (acc_ << 1) | 1;
      if (++nacc_ == 8) flush_byte();
    }
  }

 private:
  void flush_byte() {
    out_.push_back((uint8_t)acc_);
    if ((uint8_t)acc_ == 0xFF) out_.push_back(0);  // byte stuffing
    acc_ = 0;
    nacc_ = 0;
  }
  std::vector<uint8_t>& out_;
  uint32_t acc_ = 0;
  int nacc_ = 0;
};

int bit_length(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) { ++n; a >>= 1; }
  return n;
}

void put_amplitude(BitWriter& bw, int v, int size) {
  if (size) bw.put((uint32_t)(v >= 0 ? v : v + (1 << size) - 1), size);
}

void put_segment(std::vector<uint8_t>& o, uint8_t marker,
                 const std::vector<uint8_t>& body) {
  o.push_back(0xFF); o.push_back(marker);
  size_t n = body.size() + 2;
  o.push_back((uint8_t)(n >> 8)); o.push_back((uint8_t)n);
  o.insert(o.end(), body.begin(), body.end());
}

void put_dht(std::vector<uint8_t>& b, uint8_t cls_id, const uint8_t bits[16],
             const uint8_t* vals) {
  b.push_back(cls_id);
  int n = 0;
  for (int i = 0; i < 16; ++i) { b.push_back(bits[i]); n += bits[i]; }
  b.insert(b.end(), vals, vals + n);
}

}  // namespace

// Encode an RGB8 image as a baseline JPEG byte stream at `quality` (1-100).
// Returns malloc'd buffer in *out (caller frees with mrt_free).
int mrt_jpeg_encode(const uint8_t* rgb, int w, int h, int quality,
                    uint8_t** out, size_t* out_len) {
  if (!rgb || w <= 0 || h <= 0 || w > 65535 || h > 65535 || !out || !out_len)
    return -1;
  int q = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = q < 50 ? 5000 / q : 200 - 2 * q;
  int qt[2][64];
  for (int i = 0; i < 64; ++i) {
    int a = (kQLuma[i] * scale + 50) / 100, b = (kQChroma[i] * scale + 50) / 100;
    qt[0][i] = a < 1 ? 1 : (a > 255 ? 255 : a);
    qt[1][i] = b < 1 ? 1 : (b > 255 ? 255 : b);
  }
  double dct[8][8];
  for (int k = 0; k < 8; ++k)
    for (int n = 0; n < 8; ++n)
      dct[k][n] = (k == 0 ? std::sqrt(0.125) : 0.5) *
                  std::cos((2 * n + 1) * k * M_PI / 16.0);
  static const Huff dc_l(kDcLumaBits, kDcVals), dc_c(kDcChromaBits, kDcVals);
  static const Huff ac_l(kAcLumaBits, kAcLumaVals),
      ac_c(kAcChromaBits, kAcChromaVals);

  std::vector<uint8_t> o;
  o.push_back(0xFF); o.push_back(0xD8);
  put_segment(o, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  std::vector<uint8_t> b;
  for (int t = 0; t < 2; ++t) {
    b.push_back((uint8_t)t);
    for (int i = 0; i < 64; ++i) b.push_back((uint8_t)qt[t][kZigzag[i]]);
  }
  put_segment(o, 0xDB, b);
  put_segment(o, 0xC0, {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8),
                        (uint8_t)w, 3, 1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1});
  b.clear();
  put_dht(b, 0x00, kDcLumaBits, kDcVals);
  put_dht(b, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(b, 0x01, kDcChromaBits, kDcVals);
  put_dht(b, 0x11, kAcChromaBits, kAcChromaVals);
  put_segment(o, 0xC4, b);
  put_segment(o, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  double blk[3][64], tmp[64];
  for (int by = 0; by < h; by += 8) {
    for (int bx = 0; bx < w; bx += 8) {
      for (int y = 0; y < 8; ++y) {   // edge-replicated block, YCbCr
        const uint8_t* row = rgb + (size_t)(by + y < h ? by + y : h - 1) * w * 3;
        for (int x = 0; x < 8; ++x) {
          const uint8_t* p = row + (size_t)(bx + x < w ? bx + x : w - 1) * 3;
          double r = p[0], g = p[1], bb = p[2];
          blk[0][y * 8 + x] = 0.299 * r + 0.587 * g + 0.114 * bb - 128.0;
          blk[1][y * 8 + x] = -0.168736 * r - 0.331264 * g + 0.5 * bb;
          blk[2][y * 8 + x] = 0.5 * r - 0.418688 * g - 0.081312 * bb;
        }
      }
      for (int c = 0; c < 3; ++c) {
        const int* qc = qt[c ? 1 : 0];
        const Huff& dc = c ? dc_c : dc_l;
        const Huff& ac = c ? ac_c : ac_l;
        for (int k = 0; k < 8; ++k)    // rows: tmp = D * blk
          for (int x = 0; x < 8; ++x) {
            double s = 0;
            for (int n = 0; n < 8; ++n) s += dct[k][n] * blk[c][n * 8 + x];
            tmp[k * 8 + x] = s;
          }
        int coef[64];
        for (int k = 0; k < 8; ++k)    // cols: (D * blk) * D^T, quantized
          for (int l = 0; l < 8; ++l) {
            double s = 0;
            for (int n = 0; n < 8; ++n) s += tmp[k * 8 + n] * dct[l][n];
            coef[k * 8 + l] = (int)std::nearbyint(s / qc[k * 8 + l]);
          }
        int diff = coef[0] - pred[c];
        pred[c] = coef[0];
        int size = bit_length(diff);
        bw.put(dc.code[size], dc.len[size]);
        put_amplitude(bw, diff, size);
        int run = 0;
        for (int i = 1; i < 64; ++i) {
          int v = coef[kZigzag[i]];
          if (v == 0) { ++run; continue; }
          while (run >= 16) { bw.put(ac.code[0xF0], ac.len[0xF0]); run -= 16; }
          size = bit_length(v);
          int sym = (run << 4) | size;
          bw.put(ac.code[sym], ac.len[sym]);
          put_amplitude(bw, v, size);
          run = 0;
        }
        if (run) bw.put(ac.code[0x00], ac.len[0x00]);
      }
    }
  }
  bw.finish();
  o.push_back(0xFF); o.push_back(0xD9);

  *out = (uint8_t*)std::malloc(o.size());
  if (!*out) return -3;
  std::memcpy(*out, o.data(), o.size());
  *out_len = o.size();
  return 0;
}

// --------------------------------------------------------------- HTTP ----

// Host render callback: receives the JSON body, fills *out (allocated with
// mrt_alloc) with the JPEG response body. Returns 0 on success.
typedef int (*mrt_render_cb)(const char* body, size_t len,
                             uint8_t** out, size_t* out_len);

static std::atomic<int> g_stop_fd{-1};

static void send_all(int fd, const char* data, size_t len) {
  size_t off = 0;
  while (off < len) {
    ssize_t n = send(fd, data + off, len - off, MSG_NOSIGNAL);
    if (n <= 0) return;
    off += (size_t)n;
  }
}

static void send_status(int fd, const char* line) {
  send_all(fd, line, std::strlen(line));
}

static void handle_conn(int fd, mrt_render_cb cb) {
  // Drain until the header block terminator arrives (it may span several TCP
  // segments), bounded by the reference's 1 MB request buffer (http.rs:66).
  // The Python fallback transport (frontends/http.py) does the same.
  std::string buf;
  size_t hdr_end = std::string::npos;
  while (buf.size() < (1u << 20)) {
    char tmp[1 << 16];
    ssize_t n = recv(fd, tmp, sizeof tmp, 0);
    if (n <= 0) break;
    size_t scan_from = buf.size() > 3 ? buf.size() - 3 : 0;
    buf.append(tmp, (size_t)n);
    hdr_end = buf.find("\r\n\r\n", scan_from);
    if (hdr_end != std::string::npos) break;
  }
  if (buf.empty()) { close(fd); return; }
  if (hdr_end == std::string::npos) {
    send_status(fd, "HTTP/1.1 400 Bad Request\r\n"); close(fd); return;
  }
  std::string head = buf.substr(0, hdr_end);
  std::string body = buf.substr(hdr_end + 4);

  // status line
  size_t sp1 = head.find(' '), sp2 = head.find(' ', sp1 + 1);
  size_t eol = head.find("\r\n");
  if (sp1 == std::string::npos || sp2 == std::string::npos) {
    send_status(fd, "HTTP/1.1 400 Bad Request\r\n"); close(fd); return;
  }
  std::string method = head.substr(0, sp1);
  std::string version = head.substr(sp2 + 1, (eol == std::string::npos ?
                                              head.size() : eol) - sp2 - 1);

  auto header = [&](const char* name) -> std::string {
    std::string key = std::string("\r\n") + name + ": ";
    size_t p = head.find(key);
    if (p == std::string::npos) return "";
    p += key.size();
    size_t e = head.find("\r\n", p);
    return head.substr(p, (e == std::string::npos ? head.size() : e) - p);
  };

  // validation order mirrors http.rs:73-113
  if (version != "HTTP/1.1") {
    send_status(fd, "HTTP/1.1 505 HTTP Version Not Supported\r\n");
    close(fd); return;
  }
  if (method != "POST") {
    send_status(fd, "HTTP/1.1 405 Method Not Allowed\r\n"); close(fd); return;
  }
  std::string ctype = header("Content-Type");
  if (ctype.empty()) {
    send_status(fd, "HTTP/1.1 400 Bad Request\r\n"); close(fd); return;
  }
  if (ctype.rfind("application/json", 0) != 0) {
    send_status(fd, "HTTP/1.1 415 Unsupported Media Type\r\n");
    close(fd); return;
  }
  std::string clen = header("Content-Length");
  if (clen.empty()) {
    send_status(fd, "HTTP/1.1 411 Length Required\r\n"); close(fd); return;
  }
  size_t want = (size_t)std::strtoull(clen.c_str(), nullptr, 10);
  while (body.size() < want) {  // drain the remainder (beyond the ref's 1 MB)
    char tmp[1 << 16];
    ssize_t m = recv(fd, tmp, sizeof tmp, 0);
    if (m <= 0) break;
    body.append(tmp, (size_t)m);
  }
  if (body.size() != want) {
    send_status(fd, "HTTP/1.1 400 Bad Request\r\n"); close(fd); return;
  }

  uint8_t* jpg = nullptr;
  size_t jpg_len = 0;
  int rc = cb(body.data(), body.size(), &jpg, &jpg_len);
  if (rc != 0 || !jpg) {
    send_status(fd, "HTTP/1.1 500 Internal Server Error\r\n");
    close(fd); return;
  }
  char hdr[160];
  int hl = std::snprintf(hdr, sizeof hdr,
                         "HTTP/1.1 200 OK\r\nContent-Type: image/jpeg\r\n"
                         "Content-Length: %zu\r\n\r\n", jpg_len);
  send_all(fd, hdr, (size_t)hl);
  send_all(fd, (const char*)jpg, jpg_len);
  send_all(fd, "\r\n", 2);
  std::free(jpg);
  close(fd);
}

// Blocking accept loop (http.rs:150-163). Returns 0 on clean shutdown
// (mrt_http_stop), negative on setup errors.
int mrt_http_serve(const char* host, int port, mrt_render_cb cb) {
  int srv = socket(AF_INET, SOCK_STREAM, 0);
  if (srv < 0) return -1;
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr = host && *host ? inet_addr(host) : INADDR_ANY;
  if (bind(srv, (sockaddr*)&addr, sizeof addr) != 0) { close(srv); return -2; }
  if (listen(srv, 64) != 0) { close(srv); return -3; }
  g_stop_fd.store(srv);

  for (;;) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) break;  // closed by mrt_http_stop
    std::thread(handle_conn, fd, cb).detach();
  }
  return 0;
}

void mrt_http_stop(void) {
  int fd = g_stop_fd.exchange(-1);
  if (fd >= 0) { shutdown(fd, SHUT_RDWR); close(fd); }
}

}  // extern "C"
