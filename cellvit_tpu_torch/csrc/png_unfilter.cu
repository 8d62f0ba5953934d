// Undo the row filters of an 8-bit PNG image (PNG specification, section 9):
// None, Sub, Up, Average and Paeth. Host code only: it is built by nvcc like
// the kernels (`_build.py`) and called through ctypes, which releases the
// Python interpreter's lock for the call, so the patch loader's threads
// decode in parallel.
//
// raw:  height rows of 1 + row_bytes bytes, each a filter type and the row
// out:  height rows of row_bytes bytes
// bpp:  bytes a pixel (the filters' left neighbour is bpp bytes back)
// Returns 0, or 1 + the index of the first row with an unknown filter type.

#include <stdlib.h>
#include <string.h>

static inline unsigned char paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (unsigned char)a;
    return (unsigned char)(pb <= pc ? b : c);
}

extern "C" int png_unfilter(const unsigned char* raw, unsigned char* out, int height,
                            int row_bytes, int bpp) {
    const unsigned char* prior = NULL;  // the row above, NULL for the first
    for (int r = 0; r < height; ++r) {
        const unsigned char* src = raw + (size_t)r * (row_bytes + 1);
        unsigned char* dst = out + (size_t)r * row_bytes;
        const int kind = *src++;
        int i = 0;
        switch (kind) {
            case 0:
                memcpy(dst, src, row_bytes);
                break;
            case 1:
                for (; i < bpp && i < row_bytes; ++i) dst[i] = src[i];
                for (; i < row_bytes; ++i) dst[i] = (unsigned char)(src[i] + dst[i - bpp]);
                break;
            case 2:
                if (prior == NULL) {
                    memcpy(dst, src, row_bytes);
                } else {
                    for (; i < row_bytes; ++i) dst[i] = (unsigned char)(src[i] + prior[i]);
                }
                break;
            case 3:
                for (; i < row_bytes; ++i) {
                    const int left = i >= bpp ? dst[i - bpp] : 0;
                    const int up = prior != NULL ? prior[i] : 0;
                    dst[i] = (unsigned char)(src[i] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (; i < row_bytes; ++i) {
                    const int left = i >= bpp ? dst[i - bpp] : 0;
                    const int up = prior != NULL ? prior[i] : 0;
                    const int up_left = (prior != NULL && i >= bpp) ? prior[i - bpp] : 0;
                    dst[i] = (unsigned char)(src[i] + paeth(left, up, up_left));
                }
                break;
            default:
                return r + 1;
        }
        prior = dst;
    }
    return 0;
}
