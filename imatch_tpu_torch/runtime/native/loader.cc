// imatch native runtime: multi-threaded image decode pool.
//
// A copy of the JAX package's decode pool (imatch_tpu/runtime/native/
// loader.cc), unchanged but for this comment, so both packages decode an
// upload to the same pixels. The reference app decodes one upload at a
// time on the request thread with PIL; this pool decodes JPEG/PNG/WebP on
// a worker thread pool (libjpeg/libpng/libwebp, the same codecs PIL wraps)
// into malloc'd RGB8 buffers handed to Python via ctypes. A 16-bit PNG is
// stripped to its high byte (png_set_strip_16), as libpng's own 8-bit
// reduction; PIL's convert("RGB") clips mode I;16 instead.
//
// C ABI:
//   iml_create(threads) -> pool*            iml_destroy(pool*)
//   iml_submit_file(pool*, path) -> ticket  (>=0; <0 on queue error)
//   iml_submit_mem(pool*, buf, len) -> ticket  (input copied)
//   iml_wait(pool*, ticket, &w, &h, &err) -> uint8* RGB (NULL on error)
//   iml_free(ptr)
//   iml_decode_probe(buf, len, &w, &h) -> 0/err   (header-only, no pool)
//
// err codes: 1 unsupported format, 2 decode failure, 3 io failure,
//            4 bad ticket.

#include <cstddef>
#include <cstdio>  // jpeglib.h needs size_t/FILE declared first

#include <jpeglib.h>
#include <png.h>
#include <webp/decode.h>

#include <sys/stat.h>

#include <cassert>
#include <condition_variable>
#include <csetjmp>
#include <exception>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// 180 MP ~= 540 MB RGB: far above any sane photo, far below OOM territory.
constexpr size_t kMaxPixels = 180ull * 1000 * 1000;

struct Result {
  unsigned char* data = nullptr;
  int w = 0, h = 0, err = 0;
  bool done = false;
};

struct Job {
  long long ticket;
  std::vector<unsigned char> bytes;  // input (file already read, or mem)
  int io_err = 0;
};

struct Pool {
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::deque<Job> jobs;
  std::unordered_map<long long, Result> results;
  std::unordered_set<long long> pending;  // issued, not yet consumed
  std::vector<std::thread> workers;
  long long next_ticket = 0;
  bool stopping = false;
};

// ---------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

unsigned char* decode_jpeg(const unsigned char* buf, size_t len, int* w,
                           int* h, int* err) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // volatile: `out` is written between setjmp and longjmp; without it
  // the longjmp return path reads an indeterminate (register-restored)
  // value and the cleanup free() leaks the decoded buffer — or worse.
  unsigned char* volatile out = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    *err = 2;
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  // decompression-bomb guard: a few-KB file can declare 65500x65500
  // (~13 GB) — cap pixels and check malloc, else scanlines write via NULL
  if (static_cast<size_t>(*w) * *h > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    *err = 2;
    return nullptr;
  }
  size_t stride = static_cast<size_t>(*w) * 3;
  out = static_cast<unsigned char*>(malloc(stride * *h));
  if (!out) {
    jpeg_destroy_decompress(&cinfo);
    *err = 2;
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

// ----------------------------------------------------------------- PNG

struct PngReadState {
  const unsigned char* data;
  size_t len, pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "truncated");
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

unsigned char* decode_png(const unsigned char* buf, size_t len, int* w,
                          int* h, int* err) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {  // allocation failure: png_jmpbuf(NULL) would derefence NULL
    *err = 2;
    return nullptr;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    *err = 2;
    return nullptr;
  }
  unsigned char* volatile out = nullptr;  // volatile: see decode_jpeg
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(out);
    *err = 2;
    return nullptr;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // composite alpha over white like PIL convert("RGB") on RGBA+white bg
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  if (static_cast<size_t>(*w) * *h > kMaxPixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    *err = 2;
    return nullptr;
  }
  size_t stride = static_cast<size_t>(*w) * 3;
  out = static_cast<unsigned char*>(malloc(stride * *h));
  if (!out) {
    png_destroy_read_struct(&png, &info, nullptr);
    *err = 2;
    return nullptr;
  }
  rows.resize(*h);
  for (int y = 0; y < *h; ++y) rows[y] = out + stride * y;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return out;
}

// ---------------------------------------------------------------- WebP

unsigned char* decode_webp(const unsigned char* buf, size_t len, int* w,
                           int* h, int* err) {
  unsigned char* rgb = WebPDecodeRGB(buf, len, w, h);
  if (!rgb) {
    *err = 2;
    return nullptr;
  }
  if (static_cast<size_t>(*w) * *h > kMaxPixels) {
    WebPFree(rgb);
    *err = 2;
    return nullptr;
  }
  // WebPDecodeRGB uses its own allocator; copy into malloc so one
  // iml_free covers every decoder.
  size_t n = static_cast<size_t>(*w) * *h * 3;
  unsigned char* out = static_cast<unsigned char*>(malloc(n));
  if (!out) {
    WebPFree(rgb);
    *err = 2;
    return nullptr;
  }
  memcpy(out, rgb, n);
  WebPFree(rgb);
  return out;
}

// --------------------------------------------------------------- sniff

unsigned char* decode_any(const unsigned char* buf, size_t len, int* w,
                          int* h, int* err) {
  *err = 0;
  if (len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF)
    return decode_jpeg(buf, len, w, h, err);
  if (len >= 8 && memcmp(buf, "\x89PNG\r\n\x1a\n", 8) == 0)
    return decode_png(buf, len, w, h, err);
  if (len >= 12 && memcmp(buf, "RIFF", 4) == 0 && memcmp(buf + 8, "WEBP", 4) == 0)
    return decode_webp(buf, len, w, h, err);
  *err = 1;  // unsupported (e.g. AVIF) -> caller falls back to PIL
  return nullptr;
}

void worker_loop(Pool* p) {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_job.wait(lk, [p] { return p->stopping || !p->jobs.empty(); });
      if (p->stopping && p->jobs.empty()) return;
      job = std::move(p->jobs.front());
      p->jobs.pop_front();
    }
    Result r;
    if (job.io_err) {
      r.err = job.io_err;
    } else {
      r.data = decode_any(job.bytes.data(), job.bytes.size(), &r.w, &r.h,
                          &r.err);
    }
    r.done = true;
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->results[job.ticket] = r;
    }
    p->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

void* iml_create(int threads) {
  Pool* p = new Pool();
  if (threads < 1) threads = 1;
  for (int i = 0; i < threads; ++i) p->workers.emplace_back(worker_loop, p);
  return p;
}

void iml_destroy(void* pool) {
  Pool* p = static_cast<Pool*>(pool);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopping = true;
  }
  p->cv_job.notify_all();
  for (auto& t : p->workers) t.join();
  for (auto& kv : p->results) free(kv.second.data);
  delete p;
}

long long iml_submit_mem(void* pool, const unsigned char* buf, long long len) {
  Pool* p = static_cast<Pool*>(pool);
  Job job;
  job.bytes.assign(buf, buf + len);
  long long t;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    t = p->next_ticket++;
    p->pending.insert(t);
    job.ticket = t;
    p->jobs.push_back(std::move(job));
  }
  p->cv_job.notify_one();
  return t;
}

long long iml_submit_file(void* pool, const char* path) {
  Pool* p = static_cast<Pool*>(pool);
  Job job;
  FILE* f = fopen(path, "rb");
  if (!f) {
    job.io_err = 3;
  } else {
    // fopen succeeds on directories (and ftell then reports a huge
    // bogus size), and ftell returns -1 on pipes; either way resize()
    // would throw std::length_error/bad_alloc through the extern "C"
    // boundary and abort the process instead of reporting an io error.
    struct stat st;
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    if (fstat(fileno(f), &st) != 0 || !S_ISREG(st.st_mode) || n < 0) {
      job.io_err = 3;
    } else {
      fseek(f, 0, SEEK_SET);
      try {
        job.bytes.resize(n);
      } catch (const std::exception&) {
        job.io_err = 3;
      }
      if (!job.io_err &&
          fread(job.bytes.data(), 1, n, f) != static_cast<size_t>(n))
        job.io_err = 3;
    }
    fclose(f);
  }
  long long t;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    t = p->next_ticket++;
    p->pending.insert(t);
    job.ticket = t;
    p->jobs.push_back(std::move(job));
  }
  p->cv_job.notify_one();
  return t;
}

unsigned char* iml_wait(void* pool, long long ticket, int* w, int* h,
                        int* err) {
  Pool* p = static_cast<Pool*>(pool);
  std::unique_lock<std::mutex> lk(p->mu);
  if (!p->pending.count(ticket)) {
    // unknown or already-consumed ticket: the documented err 4 instead
    // of parking the caller on cv_done forever
    *w = *h = 0;
    *err = 4;
    return nullptr;
  }
  p->cv_done.wait(lk, [&] {
    auto it = p->results.find(ticket);
    return it != p->results.end() && it->second.done;
  });
  Result r = p->results[ticket];
  p->results.erase(ticket);
  p->pending.erase(ticket);
  *w = r.w;
  *h = r.h;
  *err = r.err;
  return r.data;  // ownership to caller (iml_free)
}

void iml_free(unsigned char* ptr) { free(ptr); }

int iml_decode_probe(const unsigned char* buf, long long len, int* w, int* h) {
  // genuinely header-only (the old implementation fully decoded,
  // allocating up to 540 MB per call despite the API comment)
  *w = *h = 0;
  size_t n = static_cast<size_t>(len);
  if (n >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return 2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
                 static_cast<unsigned long>(n));
    jpeg_read_header(&cinfo, TRUE);
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  if (n >= 8 && memcmp(buf, "\x89PNG\r\n\x1a\n", 8) == 0) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return 2;
    png_infop info = png_create_info_struct(png);
    if (!info) {
      png_destroy_read_struct(&png, nullptr, nullptr);
      return 2;
    }
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      return 2;
    }
    PngReadState st{buf, n, 0};
    png_set_read_fn(png, &st, png_read_fn);
    png_read_info(png, info);
    *w = png_get_image_width(png, info);
    *h = png_get_image_height(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  if (n >= 12 && memcmp(buf, "RIFF", 4) == 0 &&
      memcmp(buf + 8, "WEBP", 4) == 0) {
    return WebPGetInfo(buf, n, w, h) ? 0 : 2;
  }
  return 1;
}

}  // extern "C"
