// Native JPEG decode for the vision input pipeline (the system libjpeg
// ABI).  DCT-domain scaling decodes at 1/8..8/8 of full resolution straight
// out of the entropy decoder, near the augmentation's target size, so a
// large photo is never materialized at full resolution; the Python
// pipeline crops and resizes the small remainder.  Called through ctypes
// from ptdeco_tpu_torch/data/native_jpeg.py.
//
// C ABI:
//   jpeg_scaled_dims(data, len, target_min_side, &w, &h) -> 0 | -1
//     dims the decode below would produce (smallest DCT scale whose short
//     side still >= target_min_side; target<=0 means full size)
//   jpeg_decode_rgb(data, len, target_min_side, out, cap, &w, &h) -> 0 | -1
//     decode into caller-provided RGB8 buffer (cap bytes), row-major HWC.

#include <csetjmp>
#include <cstdint>
#include <cstdio>

#include <jpeglib.h>
#include <jerror.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  long data_warnings;  // warnings that imply synthesized/garbage pixels
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// decodes rejected because of data-corruption warnings, for fallback-rate
// visibility on the Python side (single counter; racy increments under
// threads only under-count diagnostics, never affect correctness)
int64_t g_rejected_decodes = 0;

void on_emit(j_common_ptr cinfo, int msg_level) {
  // swallow stderr chatter, but flag warnings implying the decoder
  // synthesized pixels (premature EOF fills fake scanlines, corrupt entropy
  // data inserts zero blocks) so such files FAIL over to PIL.  Deny by
  // default: ONLY warnings known to leave every pixel faithfully decoded
  // (extraneous bytes before a marker, bogus Adobe markers — both common
  // in ImageNet) keep the native fast path; any other warning code is
  // treated as corruption.
  if (msg_level < 0) {
    cinfo->err->num_warnings++;
    switch (cinfo->err->msg_code) {
      case JWRN_EXTRANEOUS_DATA:
      case JWRN_ADOBE_XFORM:
        break;  // fully decodable; keep the native fast path
      default:
        reinterpret_cast<ErrMgr*>(cinfo->err)->data_warnings++;
        break;
    }
  }
}

void pick_scale(jpeg_decompress_struct* cinfo, int target_min_side) {
  cinfo->scale_denom = 8;
  cinfo->scale_num = 8;
  if (target_min_side <= 0) return;
  const int full_min =
      cinfo->image_width < cinfo->image_height ? cinfo->image_width
                                               : cinfo->image_height;
  for (int num = 1; num <= 8; ++num) {
    // libjpeg rounds scaled dims up
    if ((full_min * num + 7) / 8 >= target_min_side) {
      cinfo->scale_num = num;
      return;
    }
  }
}

}  // namespace

extern "C" {

int jpeg_scaled_dims(const uint8_t* data, int64_t len, int target_min_side,
                     int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  pick_scale(&cinfo, target_min_side);
  jpeg_calc_output_dimensions(&cinfo);
  *out_w = static_cast<int>(cinfo.output_width);
  *out_h = static_cast<int>(cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode_rgb(const uint8_t* data, int64_t len, int target_min_side,
                    uint8_t* out, int64_t cap, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_emit;
  err.data_warnings = 0;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  pick_scale(&cinfo, target_min_side);
  jpeg_calc_output_dimensions(&cinfo);
  const int64_t w = cinfo.output_width;
  const int64_t h = cinfo.output_height;
  if (w * h * 3 > cap) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_start_decompress(&cinfo);
  const int64_t stride = w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  const long bad = err.data_warnings;
  jpeg_destroy_decompress(&cinfo);
  if (bad > 0) {
    // truncated/corrupt entropy data: let the caller fall back to PIL
    ++g_rejected_decodes;
    return -1;
  }
  *out_w = static_cast<int>(w);
  *out_h = static_cast<int>(h);
  return 0;
}

int64_t jpeg_rejected_decodes(void) { return g_rejected_decodes; }

}  // extern "C"
