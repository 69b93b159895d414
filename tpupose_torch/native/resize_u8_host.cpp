// cv2's fixed-point INTER_LINEAR resize of uint8 HW / HWC images, on the
// host, one thread.
//
// The port resizes camera frames to the network's input on the host, as the
// JAX package does with cv2.resize; the port has no cv2.  This routine keeps
// cv2's separable design (resizeGeneric with HResizeLinear and
// VResizeLinear's SIMD descale) and gives ops/resize.py's numpy version,
// `resize_u8_linear_plain`, byte for byte:
//
//   horizontal, per needed source row, into a row buffer of int16:
//     H[x*cn + c] = (S[sx0*cn + c] * a0[x] + S[sx1*cn + c] * a1[x]) >> 4
//     with sx1 = min(sx0 + 1, in_w - 1); each buffered row serves every
//     output row that reads it (two buffers, source rows only grow);
//   vertical, per output row y, rows r0 = clamp(sy[y]), r1 = clamp(sy[y]+1):
//     D[i] = sat_u8((((H0[i] * b0) >> 16) + ((H1[i] * b1) >> 16) + 2) >> 2).
//
// The taps (source index, two 11-bit coefficients) come from the caller,
// computed in Python by `_cv2_linear_taps`, so the float rounding rules
// have one definition and this file does no floating point.  Buffered
// values are at most 255 * 2049 >> 4 = 32655 and coefficients at most
// 2048, so int16 holds both and (H * b) >> 16 is SSE2's `pmulhw`.
//
// Build: g++ -O3 -shared -fPIC resize_u8_host.cpp -o libresize_u8_host.so
// (tpupose_torch/native/__init__.py does this at first use).

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

struct Taps {
    std::vector<int32_t> x0, x1;    // byte offsets of the two source pixels
    std::vector<int32_t> coef;      // a0 in the low 16 bits, a1 in the high
    std::vector<int16_t> a0, a1;
    int simd_end = 0;               // pixels [0, simd_end) take the SIMD path
};

// One source row through the horizontal pass into `out` (out_w * cn
// int16, plus 4 of slack the SIMD stores may touch).
void horizontal(const uint8_t* row, int cn, int out_w, const Taps& t,
                int16_t* out) {
    const int32_t* x0 = t.x0.data();
    const int32_t* x1 = t.x1.data();
    int x = 0;
#if defined(__SSE2__)
    // Per pixel: 4 bytes from each tap, interleaved to 16-bit (p0 p1)
    // pairs, one pmaddwd by (a0 a1): 4 int32 sums, of which the first cn
    // are the pixel's.  A 3-channel pixel's fourth lane lands on the next
    // pixel's first value, which that pixel's own store then overwrites.
    const int32_t* coef = t.coef.data();
    const __m128i zero = _mm_setzero_si128();
    for (; x < t.simd_end; ++x) {
        int32_t v0, v1;
        std::memcpy(&v0, row + x0[x], 4);
        std::memcpy(&v1, row + x1[x], 4);
        __m128i p = _mm_unpacklo_epi8(_mm_cvtsi32_si128(v0),
                                      _mm_cvtsi32_si128(v1));
        p = _mm_unpacklo_epi8(p, zero);
        __m128i s = _mm_madd_epi16(p, _mm_set1_epi32(coef[x]));
        s = _mm_srai_epi32(s, 4);
        _mm_storel_epi64(reinterpret_cast<__m128i*>(out + x * cn),
                         _mm_packs_epi32(s, s));
    }
#endif
    const int16_t* a0 = t.a0.data();
    const int16_t* a1 = t.a1.data();
    for (; x < out_w; ++x) {
        const uint8_t* p0 = row + x0[x];
        const uint8_t* p1 = row + x1[x];
        const int c0 = a0[x], c1 = a1[x];
        for (int c = 0; c < cn; ++c)
            out[x * cn + c] = static_cast<int16_t>((p0[c] * c0 + p1[c] * c1) >> 4);
    }
}

// Two buffered rows through the vertical pass into one output row of n
// bytes.
void vertical(const int16_t* h0, const int16_t* h1, int b0, int b1, int n,
              uint8_t* out) {
    int i = 0;
#if defined(__SSE2__)
    const __m128i w0 = _mm_set1_epi16(static_cast<int16_t>(b0));
    const __m128i w1 = _mm_set1_epi16(static_cast<int16_t>(b1));
    const __m128i two = _mm_set1_epi16(2);
    for (; i + 16 <= n; i += 16) {
        __m128i lo = _mm_add_epi16(
            _mm_mulhi_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(h0 + i)), w0),
            _mm_mulhi_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(h1 + i)), w1));
        __m128i hi = _mm_add_epi16(
            _mm_mulhi_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(h0 + i + 8)), w0),
            _mm_mulhi_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(h1 + i + 8)), w1));
        lo = _mm_srai_epi16(_mm_add_epi16(lo, two), 2);
        hi = _mm_srai_epi16(_mm_add_epi16(hi, two), 2);
        _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i),
                         _mm_packus_epi16(lo, hi));
    }
#endif
    for (; i < n; ++i) {
        int v = (((h0[i] * b0) >> 16) + ((h1[i] * b1) >> 16) + 2) >> 2;
        out[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
}

}  // namespace

extern "C" {

// Resize a C-contiguous (in_h, in_w, cn) uint8 image into a C-contiguous
// (out_h, out_w, cn) one.  sx, a0, a1 hold out_w column taps (sx already
// clamped to the row); sy, b0, b1 hold out_h row taps (sy unclamped).
// Returns 0, or -1 if the row buffers cannot be allocated.
int resize_u8_linear_host(const uint8_t* src, int in_h, int in_w, int cn,
                          uint8_t* dst, int out_h, int out_w,
                          const int32_t* sx, const int32_t* a0,
                          const int32_t* a1, const int32_t* sy,
                          const int32_t* b0, const int32_t* b1) {
    try {
        Taps t;
        t.x0.resize(out_w);
        t.x1.resize(out_w);
        t.coef.resize(out_w);
        t.a0.resize(out_w);
        t.a1.resize(out_w);
        for (int x = 0; x < out_w; ++x) {
            const int s1 = sx[x] + 1 < in_w ? sx[x] + 1 : in_w - 1;
            t.x0[x] = sx[x] * cn;
            t.x1[x] = s1 * cn;
            t.a0[x] = static_cast<int16_t>(a0[x]);
            t.a1[x] = static_cast<int16_t>(a1[x]);
            t.coef[x] = static_cast<int32_t>(
                (static_cast<uint32_t>(a1[x]) << 16) |
                (static_cast<uint32_t>(a0[x]) & 0xFFFFu));
        }
#if defined(__SSE2__)
        // The SIMD path reads 4 bytes a tap, which must stay inside the
        // row; source offsets only grow, so the pixels that fit lead.
        if (cn == 3 || cn == 4)
            while (t.simd_end < out_w && t.x1[t.simd_end] + 4 <= in_w * cn)
                ++t.simd_end;
#endif
        const int n = out_w * cn;
        const int stride = n + 8;
        std::vector<int16_t> bufs(2 * static_cast<size_t>(stride));
        int16_t* buf[2] = {bufs.data(), bufs.data() + stride};
        int held[2] = {-1, -1};
        const size_t row_bytes = static_cast<size_t>(in_w) * cn;

        // The buffer holding source row r, filled if neither does, in the
        // slot that does not hold `keep`.
        auto row = [&](int r, int keep) -> const int16_t* {
            if (held[0] == r) return buf[0];
            if (held[1] == r) return buf[1];
            const int slot = held[0] == keep ? 1 : 0;
            horizontal(src + r * row_bytes, cn, out_w, t, buf[slot]);
            held[slot] = r;
            return buf[slot];
        };
        for (int y = 0; y < out_h; ++y) {
            int r0 = sy[y], r1 = sy[y] + 1;
            r0 = r0 < 0 ? 0 : (r0 > in_h - 1 ? in_h - 1 : r0);
            r1 = r1 < 0 ? 0 : (r1 > in_h - 1 ? in_h - 1 : r1);
            const int16_t* h0 = row(r0, r1);
            const int16_t* h1 = row(r1, r0);
            vertical(h0, h1, b0[y], b1[y], n,
                     dst + static_cast<size_t>(y) * n);
        }
    } catch (const std::bad_alloc&) {
        return -1;
    }
    return 0;
}

}  // extern "C"
