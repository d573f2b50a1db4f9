// Batch PNG writer of the port (nvae_torch/utils/native_png.py).
//
// The sample and FID directories hold thousands of small PNGs a pass
// (reference util.py:31-36, evaluate.py:148-157: 10,000+ files per FID
// pass), and per-file Python overhead dominates on small images.  This
// writer emits valid 8-bit greyscale/RGB PNGs with stored (uncompressed)
// DEFLATE blocks and its own CRC32 and Adler-32, no zlib, and writes a
// whole (N, H, W, C) uint8 batch in one call through ctypes.  Its bytes are
// those of the JAX package's writer, native/pngio.cpp, for the same image.
//
// Build: g++ -O2 -fPIC -shared -Wall -o libpngio.so pngio.cpp (done at first
// use by native_png.py, into nvae_torch/utils/_build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

uint32_t crc_table[256];
bool crc_ready = false;

void init_crc() {
  if (crc_ready) return;
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_ready = true;
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

struct Writer {
  FILE* f;
  bool ok;
  explicit Writer(const char* path) : f(fopen(path, "wb")), ok(f != nullptr) {}
  ~Writer() { if (f) fclose(f); }
  void raw(const uint8_t* p, size_t n) {
    if (ok && fwrite(p, 1, n, f) != n) ok = false;
  }
  void chunk(const char type[4], const uint8_t* data, size_t len) {
    uint8_t hdr[8];
    put_be32(hdr, static_cast<uint32_t>(len));
    memcpy(hdr + 4, type, 4);
    raw(hdr, 8);
    if (len) raw(data, len);
    // CRC32 over chunk type + data.
    uint32_t crc = 0xFFFFFFFFu;
    for (size_t i = 0; i < 4; ++i)
      crc = crc_table[(crc ^ static_cast<uint8_t>(type[i])) & 0xFF] ^ (crc >> 8);
    for (size_t i = 0; i < len; ++i)
      crc = crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    crc ^= 0xFFFFFFFFu;
    uint8_t tail[4];
    put_be32(tail, crc);
    raw(tail, 4);
  }
};

// Build the zlib stream (stored blocks) for filtered scanlines.
// Returns length written into out (caller sizes it generously).
size_t build_idat(const uint8_t* img, int h, int w, int ch, uint8_t* out) {
  const size_t row = static_cast<size_t>(w) * ch;
  const size_t raw_len = (row + 1) * h;
  size_t o = 0;
  out[o++] = 0x78; out[o++] = 0x01;  // zlib header, no compression preset
  // Adler over the raw (filtered) bytes.
  uint32_t a = 1, b = 0;
  // Emit stored deflate blocks of up to 65535 bytes.
  size_t emitted = 0;
  size_t ri = 0;       // raw index within the virtual filtered stream
  size_t block_left = 0;
  while (emitted < raw_len) {
    if (block_left == 0) {
      block_left = raw_len - emitted;
      if (block_left > 65535) block_left = 65535;
      out[o++] = (emitted + block_left == raw_len) ? 1 : 0;  // BFINAL
      out[o++] = block_left & 0xFF;
      out[o++] = block_left >> 8;
      out[o++] = ~(block_left & 0xFF) & 0xFF;
      out[o++] = ~(block_left >> 8) & 0xFF;
    }
    // Produce the next raw byte: filter byte at row start, else pixel data.
    size_t r = ri / (row + 1);
    size_t c = ri % (row + 1);
    uint8_t byte = (c == 0) ? 0 : img[r * row + (c - 1)];
    out[o++] = byte;
    a = (a + byte) % 65521;
    b = (b + a) % 65521;
    ++ri; ++emitted; --block_left;
  }
  put_be32(out + o, (b << 16) | a);
  o += 4;
  return o;
}

bool write_png(const char* path, const uint8_t* img, int h, int w, int ch) {
  init_crc();
  Writer wr(path);
  if (!wr.ok) return false;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  wr.raw(sig, 8);
  uint8_t ihdr[13];
  put_be32(ihdr, w);
  put_be32(ihdr + 4, h);
  ihdr[8] = 8;                          // bit depth
  ihdr[9] = (ch == 1) ? 0 : 2;          // greyscale / truecolor
  ihdr[10] = ihdr[11] = ihdr[12] = 0;   // deflate, adaptive, no interlace
  wr.chunk("IHDR", ihdr, 13);
  const size_t row = static_cast<size_t>(w) * ch;
  const size_t raw_len = (row + 1) * h;
  const size_t max_idat = 2 + raw_len + 5 * (raw_len / 65535 + 1) + 4;
  std::string buf(max_idat, '\0');
  size_t n = build_idat(img, h, w, ch,
                        reinterpret_cast<uint8_t*>(&buf[0]));
  wr.chunk("IDAT", reinterpret_cast<const uint8_t*>(buf.data()), n);
  wr.chunk("IEND", nullptr, 0);
  return wr.ok;
}

}  // namespace

extern "C" {

// Write one image. Returns 0 on success.
int pngio_write(const char* path, const uint8_t* img, int h, int w, int ch) {
  return write_png(path, img, h, w, ch) ? 0 : 1;
}

// Write a batch of n images (contiguous NHWC uint8) to files whose paths are
// given as a NUL-separated buffer. Returns number successfully written.
int pngio_write_batch(const char* paths, const uint8_t* imgs, int n, int h,
                      int w, int ch) {
  const size_t stride = static_cast<size_t>(h) * w * ch;
  int ok = 0;
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    if (write_png(p, imgs + i * stride, h, w, ch)) ++ok;
    p += strlen(p) + 1;
  }
  return ok;
}

}  // extern "C"
