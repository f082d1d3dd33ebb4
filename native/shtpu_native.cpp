// shtpu_native — host-side native runtime for steroscopic_hardware_tpu.
//
// Native equivalent of the reference's host/embedded native tier:
//   * PNG scanline unfilter   (hot path of image decode; the reference relies
//     on Go's image/png, pkg/despair/png.go:10-53)
//   * stereo frame wire protocol (start 0xFF 0xD8 / ack 0x01 / stop 0xFF 0xD9,
//     raw W*H grayscale) — semantics of pkg/camera/serial.go:17-27,133-326 and
//     Vitis/.../camera_app.c:11-12,130-233, reimplemented for TCP ingest
//   * adaptive range coder with +/-8 locality model — capability of
//     image_capture/encoding/range_code.c:1-299, re-designed (not copied)
//
// Exposed with a plain C ABI for ctypes binding (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// PNG unfilter
// ---------------------------------------------------------------------------

static inline uint8_t paeth(uint8_t a, uint8_t b, uint8_t c) {
  int p = (int)a + (int)b - (int)c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// rows: height * (stride+1) bytes, each row starts with its filter byte.
// out:  height * stride bytes.
// Returns 0 on success, -1 on unknown filter type.
int shtpu_png_unfilter(const uint8_t* rows, int64_t height, int64_t stride,
                       int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = rows + y * (stride + 1);
    uint8_t f = in[0];
    const uint8_t* line = in + 1;
    uint8_t* cur = out + y * stride;
    switch (f) {
      case 0:
        memcpy(cur, line, stride);
        break;
      case 1:  // Sub
        for (int64_t x = 0; x < bpp; ++x) cur[x] = line[x];
        for (int64_t x = bpp; x < stride; ++x)
          cur[x] = (uint8_t)(line[x] + cur[x - bpp]);
        break;
      case 2:  // Up
        if (prev) {
          for (int64_t x = 0; x < stride; ++x)
            cur[x] = (uint8_t)(line[x] + prev[x]);
        } else {
          memcpy(cur, line, stride);
        }
        break;
      case 3:  // Average
        for (int64_t x = 0; x < stride; ++x) {
          int left = x >= bpp ? cur[x - bpp] : 0;
          int up = prev ? prev[x] : 0;
          cur[x] = (uint8_t)(line[x] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t x = 0; x < stride; ++x) {
          uint8_t left = x >= bpp ? cur[x - bpp] : 0;
          uint8_t up = prev ? prev[x] : 0;
          uint8_t ul = (prev && x >= bpp) ? prev[x - bpp] : 0;
          cur[x] = (uint8_t)(line[x] + paeth(left, up, ul));
        }
        break;
      default:
        return -1;
    }
    prev = cur;
  }
  return 0;
}

// PNG "Sub" filter for encoding (used by write_png fast path).
void shtpu_png_filter_sub(const uint8_t* data, int64_t height, int64_t stride,
                          int bpp, uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* cur = data + y * stride;
    uint8_t* o = out + y * (stride + 1);
    o[0] = 1;
    for (int64_t x = 0; x < bpp; ++x) o[1 + x] = cur[x];
    for (int64_t x = bpp; x < stride; ++x)
      o[1 + x] = (uint8_t)(cur[x] - cur[x - bpp]);
  }
}

// ---------------------------------------------------------------------------
// Stereo frame wire protocol (start/ack/stop + raw grayscale payload)
// ---------------------------------------------------------------------------
// Wire format (host view), matching the reference UART protocol semantics:
//   host -> camera : 0xFF 0xD8                  (start request)
//   camera -> host : 0x01                       (ack)
//   camera -> host : width*height raw gray bytes (row-major)
//   host -> camera : 0xFF 0xD9                  (stop request)
// For the TCP ingest service we frame each image as:
//   0xFF 0xD8 | u32le width | u32le height | u8 codec | u32le payload_len |
//   payload | 0xFF 0xD9
// codec: 0 = raw, 1 = range-coded, 2 = lzma (encoded by the Python layer).

typedef struct {
  // incremental parser state
  int state;          // 0=want_start, 1=want_header, 2=want_payload, 3=want_end
  uint8_t header[13]; // width,height,codec,payload_len
  int64_t header_got;
  uint32_t width, height, payload_len;
  uint8_t codec;
  uint8_t* payload;
  int64_t payload_got;
  int64_t frames_done;
  int64_t bytes_dropped;
} shtpu_frame_parser;

shtpu_frame_parser* shtpu_parser_new(void) {
  shtpu_frame_parser* p =
      (shtpu_frame_parser*)calloc(1, sizeof(shtpu_frame_parser));
  return p;
}

void shtpu_parser_free(shtpu_frame_parser* p) {
  if (!p) return;
  free(p->payload);
  free(p);
}

// Feed bytes. Returns number of bytes consumed before a complete frame is
// available (so the caller can re-feed the remainder), or n if no complete
// frame yet. Check shtpu_parser_frame_ready() afterwards.
int64_t shtpu_parser_feed(shtpu_frame_parser* p, const uint8_t* data,
                          int64_t n) {
  int64_t i = 0;
  while (i < n) {
    switch (p->state) {
      case 0: {  // scan for 0xFF 0xD8
        if (i + 1 < n && data[i] == 0xFF && data[i + 1] == 0xD8) {
          p->state = 1;
          p->header_got = 0;
          i += 2;
        } else if (data[i] == 0xFF && i + 1 == n) {
          return i;  // partial start marker; let caller re-feed
        } else {
          p->bytes_dropped++;
          i++;
        }
        break;
      }
      case 1: {  // 13-byte header
        int64_t want = 13 - p->header_got;
        int64_t take = n - i < want ? n - i : want;
        memcpy(p->header + p->header_got, data + i, take);
        p->header_got += take;
        i += take;
        if (p->header_got == 13) {
          memcpy(&p->width, p->header, 4);
          memcpy(&p->height, p->header + 4, 4);
          p->codec = p->header[8];
          memcpy(&p->payload_len, p->header + 9, 4);
          if (p->width == 0 || p->width > 16384 || p->height == 0 ||
              p->height > 16384 || p->codec > 2 ||
              p->payload_len > (uint32_t)1 << 28) {
            p->state = 0;  // garbage header; resync
            p->bytes_dropped += 15;
            break;
          }
          free(p->payload);
          p->payload = (uint8_t*)malloc(p->payload_len);
          p->payload_got = 0;
          p->state = 2;
        }
        break;
      }
      case 2: {  // payload
        int64_t want = (int64_t)p->payload_len - p->payload_got;
        int64_t take = n - i < want ? n - i : want;
        memcpy(p->payload + p->payload_got, data + i, take);
        p->payload_got += take;
        i += take;
        if (p->payload_got == (int64_t)p->payload_len) p->state = 3;
        break;
      }
      case 3: {  // end marker 0xFF 0xD9 (tolerant: resync if absent)
        if (i + 1 < n || (n - i) >= 2) {
          if (data[i] == 0xFF && data[i + 1] == 0xD9) {
            i += 2;
          } else {
            p->bytes_dropped += 2;
          }
          p->state = 4;  // frame ready
          p->frames_done++;
          return i;
        }
        return i;  // need more bytes for end marker
      }
      case 4:
        return i;  // frame ready and not yet collected
    }
  }
  return i;
}

int shtpu_parser_frame_ready(const shtpu_frame_parser* p) {
  return p->state == 4;
}
uint32_t shtpu_parser_width(const shtpu_frame_parser* p) { return p->width; }
uint32_t shtpu_parser_height(const shtpu_frame_parser* p) { return p->height; }
uint32_t shtpu_parser_payload_len(const shtpu_frame_parser* p) {
  return p->payload_len;
}
uint8_t shtpu_parser_codec(const shtpu_frame_parser* p) { return p->codec; }
int64_t shtpu_parser_frames(const shtpu_frame_parser* p) {
  return p->frames_done;
}
int64_t shtpu_parser_dropped(const shtpu_frame_parser* p) {
  return p->bytes_dropped;
}

// Copy out the payload and reset for the next frame.
int shtpu_parser_take(shtpu_frame_parser* p, uint8_t* out) {
  if (p->state != 4) return -1;
  memcpy(out, p->payload, p->payload_len);
  p->state = 0;
  return 0;
}

// Encode a frame into the wire format. out must hold 15 + payload_len + 2.
int64_t shtpu_frame_encode(const uint8_t* payload, uint32_t payload_len,
                           uint32_t width, uint32_t height, uint8_t codec,
                           uint8_t* out) {
  int64_t i = 0;
  out[i++] = 0xFF;
  out[i++] = 0xD8;
  memcpy(out + i, &width, 4);
  i += 4;
  memcpy(out + i, &height, 4);
  i += 4;
  out[i++] = codec;
  memcpy(out + i, &payload_len, 4);
  i += 4;
  memcpy(out + i, payload, payload_len);
  i += payload_len;
  out[i++] = 0xFF;
  out[i++] = 0xD9;
  return i;
}

// ---------------------------------------------------------------------------
// Adaptive range coder with locality model
// ---------------------------------------------------------------------------
// 32-bit range coder over 256 symbols with adaptive frequencies; on each
// update the coded symbol and its +/-8 neighbors get a locality boost —
// same capability as the reference's image_capture/encoding/range_code.c
// (adaptive counts + neighborhood model), independently implemented.

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kBot = 1u << 16;
constexpr int kNSym = 256;
constexpr uint32_t kMaxTotal = kBot - 1;

struct Model {
  uint32_t freq[kNSym];
  uint32_t total;
  void init() {
    for (int i = 0; i < kNSym; ++i) freq[i] = 1;
    total = kNSym;
  }
  void update(int sym) {
    // locality boost: symbol +8, neighbors +1 within +/-8
    freq[sym] += 8;
    total += 8;
    for (int d = 1; d <= 8; ++d) {
      if (sym - d >= 0) { freq[sym - d] += 1; total += 1; }
      if (sym + d < kNSym) { freq[sym + d] += 1; total += 1; }
    }
    if (total > kMaxTotal) {
      total = 0;
      for (int i = 0; i < kNSym; ++i) {
        freq[i] = (freq[i] >> 1) | 1;
        total += freq[i];
      }
    }
  }
};

// Carryless range coder (Subbotin scheme): 32-bit wrapping arithmetic; the
// (low ^ (low+range)) test settles top bytes, and the range clamp at kBot
// avoids carry propagation entirely.
struct Encoder {
  uint8_t* out;
  int64_t cap, len;
  uint32_t low, range;
  void init(uint8_t* buf, int64_t capacity) {
    out = buf; cap = capacity; len = 0; low = 0; range = 0xFFFFFFFFu;
  }
  void normalize() {
    while ((low ^ (low + range)) < kTop ||
           (range < kBot && ((range = (0u - low) & (kBot - 1)), true))) {
      out[len++] = (uint8_t)(low >> 24);
      low <<= 8;
      range <<= 8;
    }
  }
  void encode(uint32_t cum, uint32_t f, uint32_t total) {
    uint32_t r = range / total;
    low += r * cum;
    range = r * f;
    normalize();
  }
  void flush() {
    for (int i = 0; i < 4; ++i) {
      out[len++] = (uint8_t)(low >> 24);
      low <<= 8;
    }
  }
};

struct Decoder {
  const uint8_t* in;
  int64_t len, pos;
  uint32_t low, range, code;
  void init(const uint8_t* buf, int64_t n) {
    in = buf; len = n; pos = 0; low = 0; range = 0xFFFFFFFFu; code = 0;
    for (int i = 0; i < 4; ++i)
      code = (code << 8) | (pos < len ? in[pos++] : 0);
  }
  uint32_t decode_freq(uint32_t total) {
    uint32_t r = range / total;
    uint32_t v = (code - low) / r;
    return v >= total ? total - 1 : v;
  }
  void decode_update(uint32_t cum, uint32_t f, uint32_t total) {
    uint32_t r = range / total;
    low += r * cum;
    range = r * f;
    while ((low ^ (low + range)) < kTop ||
           (range < kBot && ((range = (0u - low) & (kBot - 1)), true))) {
      code = (code << 8) | (pos < len ? in[pos++] : 0);
      low <<= 8;
      range <<= 8;
    }
  }
};

}  // namespace

// Encode n bytes; returns encoded length, or -1 if out buffer too small
// (cap should be n + n/2 + 64 to be safe).
int64_t shtpu_rc_encode(const uint8_t* data, int64_t n, uint8_t* out,
                        int64_t cap) {
  Model m;
  m.init();
  Encoder e;
  e.init(out, cap);
  for (int64_t i = 0; i < n; ++i) {
    if (e.len + 16 > cap) return -1;
    int sym = data[i];
    uint32_t cum = 0;
    for (int s = 0; s < sym; ++s) cum += m.freq[s];
    e.encode(cum, m.freq[sym], m.total);
    m.update(sym);
  }
  e.flush();
  return e.len;
}

// Decode exactly n_out bytes from the encoded stream.
int64_t shtpu_rc_decode(const uint8_t* enc, int64_t enc_len, uint8_t* out,
                        int64_t n_out) {
  Model m;
  m.init();
  Decoder d;
  d.init(enc, enc_len);
  for (int64_t i = 0; i < n_out; ++i) {
    uint32_t target = d.decode_freq(m.total);
    uint32_t cum = 0;
    int sym = 0;
    while (sym < kNSym - 1 && cum + m.freq[sym] <= target) {
      cum += m.freq[sym];
      sym++;
    }
    d.decode_update(cum, m.freq[sym], m.total);
    out[i] = (uint8_t)sym;
    m.update(sym);
  }
  return n_out;
}

}  // extern "C"
