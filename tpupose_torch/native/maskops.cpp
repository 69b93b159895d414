// Native mask ops for the COCO data pipeline.
//
// The reference leans on pycocotools' C extension for RLE mask decoding
// (`coco_data_loader.py:9`, `gen_ignore_mask.py:7` use COCO.annToMask).
// This is the framework's native equivalent: COCO compressed-RLE string
// decoding and run-length rasterization, called from
// `tpupose_torch/data/coco_json.py` through ctypes (a copy of
// `tpupose/native/maskops.cpp`; the numpy decoder there is the plain
// version the tests compare against).
//
// Build: g++ -O3 -shared -fPIC maskops.cpp -o libmaskops.so
// (tpupose_torch/native/__init__.py does this at first use).

#include <cstdint>
#include <cstring>

extern "C" {

// Rasterize run-length counts into a row-major (h, w) uint8 mask.
// COCO RLE runs are column-major (Fortran order), alternating 0/1 runs
// starting with 0.  Returns 0 on success, -1 if counts overflow h*w.
int rle_counts_to_mask(const int64_t* counts, int n_counts,
                       int h, int w, uint8_t* out /* h*w, row-major */) {
    const int64_t total = static_cast<int64_t>(h) * w;
    std::memset(out, 0, total);
    int64_t pos = 0;
    int val = 0;
    for (int i = 0; i < n_counts; ++i) {
        int64_t c = counts[i];
        if (c < 0 || pos + c > total) return -1;
        if (val) {
            // column-major run [pos, pos+c) -> out[row][col] with
            // col = p / h, row = p % h
            for (int64_t p = pos; p < pos + c; ++p) {
                out[(p % h) * w + (p / h)] = 1;
            }
        }
        pos += c;
        val ^= 1;
    }
    return 0;
}

// Decode COCO's LEB128-style compressed RLE char string into counts.
// Returns the number of counts written, or -1 on malformed input /
// capacity overflow.
int rle_string_to_counts(const char* s, int len,
                         int64_t* counts, int max_counts) {
    int n = 0;
    int i = 0;
    while (i < len) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= len) return -1;
            int64_t c = static_cast<int64_t>(s[i]) - 48;
            x |= (c & 0x1F) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
            if (!more && (c & 0x10)) {
                x |= ~int64_t(0) << (5 * k);
            }
        }
        if (n > 2) x += counts[n - 2];
        if (n >= max_counts) return -1;
        counts[n++] = x;
    }
    return n;
}

// One-shot: compressed RLE string -> row-major uint8 mask.
int rle_decode(const char* s, int len, int h, int w, uint8_t* out,
               int64_t* scratch_counts, int max_counts) {
    int n = rle_string_to_counts(s, len, scratch_counts, max_counts);
    if (n < 0) return -1;
    return rle_counts_to_mask(scratch_counts, n, h, w, out);
}

}  // extern "C"
