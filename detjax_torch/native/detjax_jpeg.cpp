// JPEG decode for the detjax input pipeline (SURVEY.md §2a: the
// reference's decode path is libjpeg via PIL/cv2 inside DataLoader worker
// processes; this is the in-repo native equivalent feeding the fixed-shape
// letterbox stage). Built separately from detjax_native.cpp because it
// links against the system libjpeg — if that is absent the rest of the
// native layer still loads and decode falls back to PIL.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -ljpeg (detjax_torch.native; a
// copy of detjax/native/detjax_jpeg.cpp).
//
// Plain C ABI for ctypes; ctypes releases the GIL during calls, so decode
// threads overlap with device dispatch and with each other on multi-core
// hosts (this box has one core; see BASELINE.md pipeline measurements).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void emit_message(j_common_ptr, int) {}  // silence warnings

}  // namespace

extern "C" {

// Parse the header only: fills (h, w); output channels are always 3 (we
// force RGB on decode, matching PIL convert("RGB")). Returns 0 on success.
int64_t detjax_jpeg_info(const uint8_t* data, int64_t len,
                         int64_t* h, int64_t* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to interleaved RGB uint8 into caller-allocated out[h*w*3].
// Returns 0 on success, nonzero on corrupt input / size mismatch.
int64_t detjax_jpeg_decode(const uint8_t* data, int64_t len,
                           uint8_t* out, int64_t out_len) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // gray/CMYK → RGB like PIL convert
  jpeg_start_decompress(&cinfo);
  const int64_t w = cinfo.output_width;
  const int64_t h = cinfo.output_height;
  const int64_t stride = w * 3;
  if (h * stride != out_len || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
