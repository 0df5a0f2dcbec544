// blackstar_native — the port's native IO runtime (PNG writing).
//
// Forked from the JAX package's native/blackstar_native.cpp, which stays that
// package's runtime. The sRGB encode and the synchronous writers are the
// same code and write the same bytes; the frame-writer pool differs:
//
//   * sRGB gamma encode + uint8 quantisation (multithreaded, matches
//     Raytracer.hs:23-27 semantics incl. round-half-even `toWord8`)
//   * PNG encoding (zlib deflate, level as given, filter 0) and file write
//   * an asynchronous frame-writer pool: the render loop submits frames and
//     keeps the card busy while every worker thread deflates bands of them.
//     A frame's filtered rows are cut at row boundaries into bands of about
//     kBandBytes; each band is one task of one FIFO. Band i > 0 is a raw
//     deflate primed with the 32 KiB of input before it and ends in a sync
//     flush, the last band ends the stream, and the IDAT is the zlib header,
//     the bands in order and the Adler-32 of the whole input (combined from
//     the bands'). The thread that deflates a frame's last band writes the
//     file. A frame of one band gets exactly compress2's bytes.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (blackstar_tpu_torch/native.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// sRGB encode (linear float -> gamma uint8)
// ---------------------------------------------------------------------------

inline uint8_t srgb_u8(float x) {
  float v = x < 0.0031308f ? 12.92f * x
                           : 1.055f * std::pow(std::max(x, 0.0031308f),
                                               1.0f / 2.4f) -
                                 0.055f;
  v = std::min(std::max(v, 0.0f), 1.0f) * 255.0f;
  // Round-half-even to match numpy rint / Haskell toWord8.
  return static_cast<uint8_t>(std::nearbyint(v));
}

void srgb_encode_rows(const float* in, uint8_t* out, int64_t n, int n_threads) {
  if (n_threads <= 1 || n < (1 << 16)) {
    for (int64_t i = 0; i < n; ++i) out[i] = srgb_u8(in[i]);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) out[i] = srgb_u8(in[i]);
    });
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// PNG encoding
// ---------------------------------------------------------------------------

void put_u32be(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char tag[4],
               const uint8_t* data, size_t len) {
  put_u32be(out, static_cast<uint32_t>(len));
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + tag_pos, static_cast<uInt>(4 + len));
  put_u32be(out, crc);
}

// The PNG signature and the IHDR chunk of a w x h 8-bit RGB image.
void put_png_head(std::vector<uint8_t>& out, int w, int h) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = w >> 24; ihdr[1] = (w >> 16) & 0xff; ihdr[2] = (w >> 8) & 0xff;
  ihdr[3] = w & 0xff;
  ihdr[4] = h >> 24; ihdr[5] = (h >> 16) & 0xff; ihdr[6] = (h >> 8) & 0xff;
  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // colour type: truecolour RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
}

// RGB8 rows -> complete PNG byte stream (filter 0 per row).
bool encode_png(const uint8_t* rgb, int w, int h, int level,
                std::vector<uint8_t>& out) {
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;  // filter type 0 (None)
    std::memcpy(&raw[y * (stride + 1) + 1], rgb + y * stride, stride);
  }

  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> z(bound);
  if (compress2(z.data(), &bound, raw.data(), static_cast<uLong>(raw.size()),
                level) != Z_OK)
    return false;
  z.resize(bound);

  out.clear();
  put_png_head(out, w, h);
  put_chunk(out, "IDAT", z.data(), z.size());
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

bool write_file(const char* path, const std::vector<uint8_t>& bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  size_t n = std::fwrite(bytes.data(), 1, bytes.size(), f);
  std::fclose(f);
  return n == bytes.size();
}

// ---------------------------------------------------------------------------
// Async frame-writer pool: frames deflated in primed bands
// ---------------------------------------------------------------------------

constexpr size_t kBandBytes = 512 * 1024;  // filtered input a band, about
constexpr size_t kWindow = 32768;          // deflate's window: 15 bits

// The two bytes of the zlib header deflateInit(level) writes for a 15-bit
// window, the default strategy and no preset dictionary.
void zlib_header(int level, uint8_t out[2]) {
  if (level == Z_DEFAULT_COMPRESSION) level = 6;
  const int flags = level < 2 ? 0 : level < 6 ? 1 : level == 6 ? 2 : 3;
  unsigned header = ((Z_DEFLATED + ((15 - 8) << 4)) << 8) | (flags << 6);
  header += 31 - header % 31;
  out[0] = header >> 8;
  out[1] = header & 0xff;
}

using Clock = std::chrono::steady_clock;

int64_t ns_since(Clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(Clock::now() - t0)
      .count();
}

struct Frame {
  std::string path;
  std::vector<float> linear;  // owned copy of the linear RGB frame, or
  std::vector<uint8_t> rgb8;  // an already-encoded sRGB frame (one is empty)
  int w, h, level;
  int rows;                   // image rows a band
  std::vector<std::vector<uint8_t>> deflated;  // each band's raw deflate
  std::vector<uLong> adler;   // each band's Adler-32 of its input
  std::atomic<int> left{0};   // bands not yet deflated
  std::atomic<bool> failed{false};

  Frame(const char* p, int w_, int h_, int level_)
      : path(p), w(w_), h(h_), level(level_) {
    const size_t total = row_bytes() * h;
    const size_t n = std::max<size_t>(1, (total + kBandBytes - 1) / kBandBytes);
    rows = std::max(1, static_cast<int>((h + n - 1) / n));
    deflated.resize(bands());
    adler.resize(bands());
    left = bands();
  }

  size_t row_bytes() const { return static_cast<size_t>(w) * 3 + 1; }
  int bands() const { return std::max(1, (h + rows - 1) / rows); }
  size_t band_start(int i) const {
    return static_cast<size_t>(std::min(h, i * rows)) * row_bytes();
  }

  // The filtered bytes [lo, hi) of the frame: each row's filter byte (0,
  // None) before its pixels, sRGB-encoded here if the frame is linear.
  void filtered(size_t lo, size_t hi, uint8_t* out) const {
    const size_t rb = row_bytes();
    while (lo < hi) {
      const size_t row = lo / rb, col = lo % rb;
      const size_t end = std::min(hi, (row + 1) * rb);
      size_t px = col;  // offset + 1 into the row's pixel bytes
      if (col == 0) {
        *out++ = 0;
        px = 1;
      }
      const size_t n = end - (row * rb + px);
      const size_t src = row * (rb - 1) + px - 1;
      if (rgb8.empty()) {
        for (size_t k = 0; k < n; ++k) out[k] = srgb_u8(linear[src + k]);
      } else {
        std::memcpy(out, rgb8.data() + src, n);
      }
      out += n;
      lo = end;
    }
  }

  // Deflates band i into deflated[i] and its Adler-32 into adler[i].
  bool deflate_band(int i) {
    const size_t lo = band_start(i), hi = band_start(i + 1);
    const size_t window = std::min(lo, kWindow), n = hi - lo;
    std::vector<uint8_t> in(window + n);  // the window before the band, then the band
    filtered(lo - window, hi, in.data());
    adler[i] = adler32(adler32(0L, Z_NULL, 0), in.data() + window,
                       static_cast<uInt>(n));

    z_stream zs{};
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
      return false;
    bool ok = window == 0 ||
              deflateSetDictionary(&zs, in.data(), static_cast<uInt>(window)) == Z_OK;
    const bool last = i + 1 == bands();
    const int flush = last ? Z_FINISH : Z_SYNC_FLUSH;
    std::vector<uint8_t>& out = deflated[i];
    out.resize(deflateBound(&zs, static_cast<uLong>(n)) + 16);  // + a sync flush's marker
    zs.next_in = in.data() + window;
    zs.avail_in = static_cast<uInt>(n);
    while (ok) {
      zs.next_out = out.data() + zs.total_out;
      zs.avail_out = static_cast<uInt>(out.size() - zs.total_out);
      const int rc = deflate(&zs, flush);
      ok = rc == Z_OK || rc == Z_STREAM_END || rc == Z_BUF_ERROR;
      if (rc == Z_STREAM_END || (!last && zs.avail_in == 0 && zs.avail_out > 0)) break;
      out.resize(out.size() * 2);  // out of room: go on with more
    }
    out.resize(zs.total_out);
    deflateEnd(&zs);
    return ok;
  }

  // Writes the PNG of the deflated bands to path; its size into bytes.
  bool write(int64_t& bytes) const {
    std::vector<uint8_t> head;
    put_png_head(head, w, h);
    size_t idat = 2 + 4;  // the zlib header and the Adler-32
    for (const auto& d : deflated) idat += d.size();
    put_u32be(head, static_cast<uint32_t>(idat));
    const size_t tag = head.size();
    head.insert(head.end(), {'I', 'D', 'A', 'T'});
    head.resize(head.size() + 2);
    zlib_header(level, &head[head.size() - 2]);
    uLong crc = crc32(0L, head.data() + tag, 6);
    uLong sum = adler[0];
    for (int i = 0; i < bands(); ++i) {
      crc = crc32(crc, deflated[i].data(), static_cast<uInt>(deflated[i].size()));
      if (i > 0)
        sum = adler32_combine(sum, adler[i],
                              static_cast<z_off_t>(band_start(i + 1) - band_start(i)));
    }
    std::vector<uint8_t> tail;
    put_u32be(tail, static_cast<uint32_t>(sum));
    crc = crc32(crc, tail.data(), 4);
    put_u32be(tail, static_cast<uint32_t>(crc));
    put_chunk(tail, "IEND", nullptr, 0);

    FILE* f = std::fopen(path.c_str(), "wb");
    if (!f) return false;
    bytes = static_cast<int64_t>(head.size() + idat - 6 + tail.size());
    bool ok = std::fwrite(head.data(), 1, head.size(), f) == head.size();
    for (const auto& d : deflated)
      ok = ok && std::fwrite(d.data(), 1, d.size(), f) == d.size();
    ok = ok && std::fwrite(tail.data(), 1, tail.size(), f) == tail.size();
    return std::fclose(f) == 0 && ok;
  }
};

struct Task {
  std::shared_ptr<Frame> frame;
  int band;
};

struct Writer {
  std::deque<Task> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::vector<std::thread> threads;
  std::atomic<int> errors{0};
  int in_flight = 0;  // frames submitted and not yet written or failed
  bool stop = false;
  // Since the pool was made (bs_writer_stats).
  std::atomic<int64_t> frames{0}, bands{0}, deflate_ns{0}, write_ns{0}, bytes{0};

  explicit Writer(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      threads.emplace_back([this] { run(); });
  }

  void run() {
    for (;;) {
      Task task;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !queue.empty(); });
        if (queue.empty()) return;  // stop && drained
        task = std::move(queue.front());
        queue.pop_front();
      }
      Frame& f = *task.frame;
      if (!f.failed) {
        const auto t0 = Clock::now();
        if (!f.deflate_band(task.band)) f.failed = true;
        deflate_ns += ns_since(t0);
        ++bands;
      }
      if (f.left.fetch_sub(1) == 1) finish(f);  // the frame's last band
    }
  }

  void finish(const Frame& f) {
    const auto t0 = Clock::now();
    int64_t n = 0;
    if (!f.failed && f.write(n)) {
      ++frames;
      bytes += n;
    } else {
      errors.fetch_add(1);
    }
    write_ns += ns_since(t0);
    {
      std::lock_guard<std::mutex> lk(mu);
      --in_flight;
    }
    done_cv.notify_all();
  }

  void submit(const char* path, const float* linear, int w, int h, int level) {
    auto f = std::make_shared<Frame>(path, w, h, level);
    f->linear.assign(linear, linear + static_cast<int64_t>(w) * h * 3);
    enqueue(std::move(f));
  }

  void submit_rgb8(const char* path, const uint8_t* rgb, int w, int h,
                   int level) {
    auto f = std::make_shared<Frame>(path, w, h, level);
    f->rgb8.assign(rgb, rgb + static_cast<int64_t>(w) * h * 3);
    enqueue(std::move(f));
  }

  void enqueue(std::shared_ptr<Frame>&& f) {
    const int n = f->bands();
    {
      std::lock_guard<std::mutex> lk(mu);
      for (int i = 0; i < n; ++i) queue.push_back({f, i});
      ++in_flight;
    }
    if (n > 1)
      cv.notify_all();
    else
      cv.notify_one();
  }

  int wait() {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this] { return in_flight == 0; });
    return errors.load();
  }

  void stats(double* out) const {
    out[0] = static_cast<double>(frames.load());
    out[1] = static_cast<double>(bands.load());
    out[2] = deflate_ns.load() * 1e-9;
    out[3] = write_ns.load() * 1e-9;
    out[4] = static_cast<double>(bytes.load());
  }

  ~Writer() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : threads) t.join();
  }
};

}  // namespace

extern "C" {

// Linear float RGB (h*w*3) -> sRGB uint8, multithreaded.
void bs_srgb_encode(const float* in, uint8_t* out, int64_t n, int n_threads) {
  srgb_encode_rows(in, out, n, n_threads);
}

// Synchronous: uint8 RGB -> PNG file, one deflate stream (compress2).
// Returns 0 on success.
int bs_write_png_rgb8(const char* path, const uint8_t* rgb, int w, int h,
                      int level) {
  std::vector<uint8_t> png;
  if (!encode_png(rgb, w, h, level, png)) return 1;
  return write_file(path, png) ? 0 : 2;
}

// Synchronous: linear float RGB -> sRGB -> PNG file. Returns 0 on success.
int bs_write_png_linear(const char* path, const float* linear, int w, int h,
                        int level, int n_threads) {
  const int64_t n = static_cast<int64_t>(w) * h * 3;
  std::vector<uint8_t> rgb8(n);
  srgb_encode_rows(linear, rgb8.data(), n, n_threads);
  return bs_write_png_rgb8(path, rgb8.data(), w, h, level);
}

void* bs_writer_create(int n_threads) {
  return new Writer(n_threads > 0 ? n_threads : 2);
}

void bs_writer_submit(void* writer, const char* path, const float* linear,
                      int w, int h, int level) {
  static_cast<Writer*>(writer)->submit(path, linear, w, h, level);
}

// Like bs_writer_submit but for frames already quantised to sRGB uint8
// (e.g. encoded on-device so only a quarter of the bytes cross the host
// boundary).
void bs_writer_submit_rgb8(void* writer, const char* path, const uint8_t* rgb,
                           int w, int h, int level) {
  static_cast<Writer*>(writer)->submit_rgb8(path, rgb, w, h, level);
}

// Blocks until all submitted frames are on disk; returns the error count.
int bs_writer_wait(void* writer) { return static_cast<Writer*>(writer)->wait(); }

// Since the pool was made: out[0] frames written, out[1] bands deflated,
// out[2] seconds in the bands' deflate (summed over threads), out[3]
// seconds in the file writes (summed, failed ones too), out[4] bytes written.
void bs_writer_stats(void* writer, double* out) {
  static_cast<Writer*>(writer)->stats(out);
}

void bs_writer_destroy(void* writer) { delete static_cast<Writer*>(writer); }

}  // extern "C"
