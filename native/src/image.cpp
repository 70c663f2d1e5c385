// Image decode + letterbox preprocessing (native host stage).
//
// Rebuild of the reference's C++ input path (src/input.cpp
// [LOW name; empty reference mount — SURVEY.md §2]): JPEG/PNG decode via
// libjpeg/libpng, bilinear letterbox resize into the fixed network input
// geometry. Normalization to float happens ON DEVICE (engine.py), so this
// stage moves only uint8 — 4x less host-to-device traffic than the
// reference's float CHW uploads.

#include <algorithm>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

#include "pose_host/image.hpp"
#include "pose_host/tracer.hpp"

namespace pose_host {

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out, int target_h, int target_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-scaled decode: when the caller's letterbox target is known,
  // decode at the coarsest M/8 scale that still keeps the decoded image
  // at least as large as the letterboxed content (never upsampled), so a
  // 4000px photo headed for 368x656 decodes at ~1/8 scale — IDCT +
  // scanline cost drops ~4-8x on large photos, the dominant host cost in
  // stream mode on small-core rigs. The actual output dims are read back
  // below, so libjpeg variants that round the requested scale stay
  // correct.
  if (target_h > 0 && target_w > 0 && cinfo.image_width > 0 &&
      cinfo.image_height > 0) {
    const float ts = std::min(float(target_w) / cinfo.image_width,
                              float(target_h) / cinfo.image_height);
    if (ts < 1.0f) {
      int m = int(ts * 8.0f) + (ts * 8.0f > float(int(ts * 8.0f)) ? 1 : 0);
      cinfo.scale_num = std::clamp(m, 1, 8);
      cinfo.scale_denom = 8;
    }
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->full_w = cinfo.image_width;   // original dims: the letterbox
  out->full_h = cinfo.image_height;  // scale/pad contract is vs these
  out->rgb.resize(std::size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->rgb.data() + std::size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* out) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->rgb.resize(std::size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + std::size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

}  // namespace

bool decode_image(const char* path, Image* out, int target_h, int target_w) {
  PH_TRACE_SCOPE("decode");
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char sig[2] = {0, 0};
  if (std::fread(sig, 1, 2, f) != 2) {
    std::fclose(f);
    return false;
  }
  std::rewind(f);
  bool ok = false;
  if (sig[0] == 0xFF && sig[1] == 0xD8) {
    ok = decode_jpeg(f, out, target_h, target_w);
  } else if (sig[0] == 0x89 && sig[1] == 'P') {
    ok = decode_png(f, out);  // PNG has no cheap scaled decode
  }
  std::fclose(f);
  return ok;
}

// Bilinear letterbox resize into a (hin, win, 3) uint8 RGB buffer
// (half-pixel-center sampling, zero-padded borders). Writes the applied
// scale and (pad_x, pad_y) so detections map back to source pixels —
// identical math to data/augment.py :: letterbox.
//
// The scale/pad CONTRACT is against the ORIGINAL image dims (src.full_*,
// falling back to the decoded dims): when the JPEG decoder produced a
// DCT-downscaled plane, sampling coordinates pass through the
// decoded/original ratio but the reported scale/pads stay in original
// pixels, so `det_xy = (net_xy - pad) / scale` is decoder-independent.
void letterbox_resize(const Image& src, int hin, int win, std::uint8_t* dst,
                      float* scale_out, float* pad_out) {
  PH_TRACE_SCOPE("resize");
  const int fw = src.full_w > 0 ? src.full_w : src.w;
  const int fh = src.full_h > 0 ? src.full_h : src.h;
  const float scale = std::min(float(win) / fw, float(hin) / fh);
  const float pad_x = win / 2.0f - scale * fw / 2.0f;
  const float pad_y = hin / 2.0f - scale * fh / 2.0f;
  // decoded-plane pixels per original pixel (1 unless DCT-scaled)
  const float rx = float(src.w) / fw, ry = float(src.h) / fh;
  *scale_out = scale;
  pad_out[0] = pad_x;
  pad_out[1] = pad_y;
  std::memset(dst, 0, std::size_t(hin) * win * 3);

  const int x0 = std::max(0, int(pad_x));
  const int x1 = std::min(win, int(pad_x + scale * fw + 0.999f));
  const int y0 = std::max(0, int(pad_y));
  const int y1 = std::min(hin, int(pad_y + scale * fh + 0.999f));

  for (int y = y0; y < y1; ++y) {
    const float sy = (y + 0.5f - pad_y) / scale * ry - 0.5f;
    const int iy = std::clamp(int(sy <= 0 ? 0 : sy), 0, src.h - 1);
    const int iy1 = std::min(iy + 1, src.h - 1);
    const float fy = sy <= 0 ? 0.0f : std::min(sy - iy, 1.0f);
    const std::uint8_t* r0 = src.rgb.data() + std::size_t(iy) * src.w * 3;
    const std::uint8_t* r1 = src.rgb.data() + std::size_t(iy1) * src.w * 3;
    std::uint8_t* drow = dst + (std::size_t(y) * win + x0) * 3;
    for (int x = x0; x < x1; ++x) {
      const float sx = (x + 0.5f - pad_x) / scale * rx - 0.5f;
      const int ix = std::clamp(int(sx <= 0 ? 0 : sx), 0, src.w - 1);
      const int ix1 = std::min(ix + 1, src.w - 1);
      const float fx = sx <= 0 ? 0.0f : std::min(sx - ix, 1.0f);
      for (int c = 0; c < 3; ++c) {
        const float top = r0[ix * 3 + c] * (1 - fx) + r0[ix1 * 3 + c] * fx;
        const float bot = r1[ix * 3 + c] * (1 - fx) + r1[ix1 * 3 + c] * fx;
        *drow++ = std::uint8_t(top * (1 - fy) + bot * fy + 0.5f);
      }
    }
  }
}

// Space-to-depth permutation of a letterboxed (h, w, 3) uint8 buffer into
// (h/2, w/2, 12), channel = (wy*2+wx)*3 + c — the engine's fast input
// layout (models/common.py space_to_depth): the stem conv then runs on a
// 12-channel grid instead of relayouting 3-channel data on device. Pure
// byte movement on the host.
void space_to_depth_u8(const std::uint8_t* src, int h, int w,
                       std::uint8_t* dst) {
  PH_TRACE_SCOPE("s2d");
  const int ho = h / 2, wo = w / 2;
  for (int y = 0; y < ho; ++y) {
    const std::uint8_t* r0 = src + std::size_t(2 * y) * w * 3;
    const std::uint8_t* r1 = r0 + std::size_t(w) * 3;
    std::uint8_t* d = dst + std::size_t(y) * wo * 12;
    for (int x = 0; x < wo; ++x) {
      std::memcpy(d, r0 + x * 6, 6);      // (wy=0, wx=0|1)
      std::memcpy(d + 6, r1 + x * 6, 6);  // (wy=1, wx=0|1)
      d += 12;
    }
  }
}

// Space-to-depth applied twice: (h, w, 3) -> (h/4, w/4, 48), channel
// ((vy*2+vx)*4 + wy*2+wx)*3 + c for pixel (4I+2vy+wy, 4J+2vx+wx) — the
// engine's fastest input layout: the whole stride-2 region of the CNN
// then runs as dense convs on the block grid (deep-s2d
// lowering, models/common.py).
void space_to_depth2_u8(const std::uint8_t* src, int h, int w,
                        std::uint8_t* dst) {
  PH_TRACE_SCOPE("s2d2");
  const int wo = w / 4;
  for (int y = 0; y < (h / 4) * 4; ++y) {
    const int I = y / 4, vy = (y / 2) % 2, wy = y % 2;
    const std::uint8_t* s = src + std::size_t(y) * w * 3;
    std::uint8_t* drow = dst + std::size_t(I) * wo * 48;
    for (int x = 0; x < wo * 4; ++x) {
      const int J = x / 4, vx = (x / 2) % 2, wx = x % 2;
      std::uint8_t* d =
          drow + J * 48 + ((vy * 2 + vx) * 4 + wy * 2 + wx) * 3;
      d[0] = s[x * 3];
      d[1] = s[x * 3 + 1];
      d[2] = s[x * 3 + 2];
    }
  }
}

}  // namespace pose_host
