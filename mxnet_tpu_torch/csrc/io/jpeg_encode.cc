// libjpeg encoder entry: RGB8 (H, W, 3) -> baseline JPEG bytes.
//
// Test tooling, not on any user path: it lets chip_smoke.py and the
// tests write JPEG record files from seeded pixels on a machine without
// cv2 or PIL (the reference's pack_img needs cv2 for that).  Built into
// the port's native IO library beside recordio.cc / image_pipeline.cc.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <csetjmp>
#include <jpeglib.h>

namespace {

struct EncErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void enc_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<EncErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

}  // namespace

extern "C" {

// Encodes `rgb` (height rows of width*3 bytes) at `quality` into a buffer
// that libjpeg allocates; *out / *out_len receive it.  Free it with
// mxtpu_jpeg_free.  Returns 0 on success, -1 on failure.
int mxtpu_jpeg_compress(const uint8_t* rgb, int width, int height,
                        int quality, uint8_t** out, uint64_t* out_len) {
  if (!rgb || width <= 0 || height <= 0 || !out || !out_len) return -1;
  jpeg_compress_struct cinfo;
  EncErr jerr;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = enc_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) std::free(mem);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(width);
  cinfo.image_height = static_cast<JDIMENSION>(height);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + size_t(cinfo.next_scanline) * size_t(width) * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = mem;
  *out_len = mem_len;
  return 0;
}

void mxtpu_jpeg_free(uint8_t* buf) { std::free(buf); }

}  // extern "C"
