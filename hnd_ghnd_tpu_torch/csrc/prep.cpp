// Fused image-prep kernel for the detection data pipeline.
//
// The reference's input pipeline runs inside torch DataLoader C++ workers
// (decode -> PIL/torch resize -> normalize -> pad).  Here the equivalent
// hot loop after JPEG decode — bilinear resize (with optional horizontal
// flip), /255 normalization, and zero-padding into the static bucket — is
// ONE pass from the decoded uint8 HWC buffer straight into the padded
// float32 batch slot: no intermediate resized image, no flip copy, no
// separate pad/normalize materializations (loader fallback path:
// hnd_ghnd_tpu/data/{transforms.py,loader.py}).
//
// Sampling semantics match cv2.INTER_LINEAR geometry (half-pixel centers,
// replicated borders); interpolation is computed in float rather than
// cv2's 11-bit fixed point, so values may differ from the numpy path by
// ~1/255 — the loader's parity test bounds this.
//
// The port's copy of native/pipeline/prep.cpp (hnd_ghnd_tpu_torch/_build.py
// builds it with g++ into build/torch_kernels/).  It differs in one way:
// the libjpeg decode half is compiled only where <jpeglib.h> exists and
// HND_NO_JPEG is not defined, so the fused resize and pad still build on a
// host without libjpeg; prep_has_jpeg() says which.  The resize is the
// same code, so the bytes equal build/libprep.so's.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>

namespace {

// OutT = float: normalized to [0, 1].  OutT = uint8_t: rounded to the
// nearest code (the uint8-wire mode — 4x less batch/H2D traffic; the
// device dequantizes with a fused *1/255 at the jit boundary).
template <typename OutT>
void prep_image_impl(const uint8_t* src, int64_t sh, int64_t sw,
                     int64_t nh, int64_t nw, int32_t flip,
                     int64_t bh, int64_t bw, OutT* out) {
    const double sy_scale = (double)sh / (double)nh;
    const double sx_scale = (double)sw / (double)nw;
    const float inv255 = 1.0f / 255.0f;

    // precompute x sampling (after optional mirror) once per row span
    std::vector<int64_t> x0(nw), x1(nw);
    std::vector<float> wx1(nw);
    for (int64_t x = 0; x < nw; ++x) {
        int64_t xd = flip ? (nw - 1 - x) : x;
        double sx = (xd + 0.5) * sx_scale - 0.5;
        if (sx < 0) sx = 0;
        if (sx > (double)(sw - 1)) sx = (double)(sw - 1);
        int64_t lo = (int64_t)sx;
        int64_t hi = std::min(lo + 1, sw - 1);
        x0[x] = lo;
        x1[x] = hi;
        wx1[x] = (float)(sx - (double)lo);
    }

    for (int64_t y = 0; y < bh; ++y) {
        OutT* row = out + y * bw * 3;
        if (y >= nh) {
            std::memset(row, 0, sizeof(OutT) * bw * 3);
            continue;
        }
        double sy = (y + 0.5) * sy_scale - 0.5;
        if (sy < 0) sy = 0;
        if (sy > (double)(sh - 1)) sy = (double)(sh - 1);
        int64_t y0 = (int64_t)sy;
        int64_t y1 = std::min(y0 + 1, sh - 1);
        float wy1 = (float)(sy - (double)y0);
        float wy0 = 1.0f - wy1;
        const uint8_t* r0 = src + y0 * sw * 3;
        const uint8_t* r1 = src + y1 * sw * 3;
        for (int64_t x = 0; x < nw; ++x) {
            const uint8_t* p00 = r0 + x0[x] * 3;
            const uint8_t* p01 = r0 + x1[x] * 3;
            const uint8_t* p10 = r1 + x0[x] * 3;
            const uint8_t* p11 = r1 + x1[x] * 3;
            float w1 = wx1[x];
            float w0 = 1.0f - w1;
            for (int c = 0; c < 3; ++c) {
                float top = w0 * p00[c] + w1 * p01[c];
                float bot = w0 * p10[c] + w1 * p11[c];
                float v = wy0 * top + wy1 * bot;
                if constexpr (std::is_same_v<OutT, float>) {
                    row[x * 3 + c] = v * inv255;
                } else {
                    row[x * 3 + c] = (uint8_t)(v + 0.5f);
                }
            }
        }
        std::memset(row + nw * 3, 0, sizeof(OutT) * (bw - nw) * 3);
    }
}

}  // namespace

extern "C" {

// src: [sh, sw, 3] uint8 (decoded RGB); out: [bh, bw, 3] float32 slot.
// Writes the (nh, nw) resized image (flipped when flip != 0) normalized to
// [0, 1] at the top-left and zeroes the padding region.
void prep_image(const uint8_t* src, int64_t sh, int64_t sw,
                int64_t nh, int64_t nw, int32_t flip,
                int64_t bh, int64_t bw, float* out) {
    prep_image_impl<float>(src, sh, sw, nh, nw, flip, bh, bw, out);
}

// uint8-wire variant: same geometry, output left as rounded uint8 codes.
void prep_image_u8(const uint8_t* src, int64_t sh, int64_t sw,
                   int64_t nh, int64_t nw, int32_t flip,
                   int64_t bh, int64_t bw, uint8_t* out) {
    prep_image_impl<uint8_t>(src, sh, sw, nh, nw, flip, bh, bw, out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native JPEG decode (libjpeg): completes the decode->prep pipeline in C so
// loader worker threads never touch Python between file bytes and the
// float32 batch slot (the torch-DataLoader-worker analog).
// ---------------------------------------------------------------------------
#if !defined(HND_NO_JPEG) && __has_include(<jpeglib.h>)
#define HND_HAVE_JPEG 1
#include <csetjmp>
#include <cstdio>

#include <jpeglib.h>

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    std::jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
    auto* mgr = reinterpret_cast<ErrMgr*>(cinfo->err);
    std::longjmp(mgr->jump, 1);
}

}  // namespace

extern "C" {

// Parse the header only.  Returns 0 on success and fills (h, w).
int64_t jpeg_info(const uint8_t* buf, int64_t len, int64_t* h, int64_t* w) {
    jpeg_decompress_struct cinfo;
    ErrMgr err;
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    *h = cinfo.image_height;
    *w = cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode to RGB uint8 [h, w, 3] (grayscale/CMYK converted).  Returns 0 on
// success; out must hold h*w*3 bytes (from jpeg_info).
int64_t jpeg_decode(const uint8_t* buf, int64_t len, uint8_t* out,
                    int64_t out_h, int64_t out_w) {
    jpeg_decompress_struct cinfo;
    ErrMgr err;
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if ((int64_t)cinfo.output_height != out_h ||
        (int64_t)cinfo.output_width != out_w ||
        cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + (int64_t)cinfo.output_scanline * out_w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

}  // extern "C"
#endif  // HND_HAVE_JPEG

extern "C" int prep_has_jpeg() {
#ifdef HND_HAVE_JPEG
    return 1;
#else
    return 0;
#endif
}
