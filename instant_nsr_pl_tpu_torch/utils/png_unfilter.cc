// PNG scanline unfiltering (PNG specification section 9), the host half of
// utils/image_io.py's decoder. Built with g++ at first use and called through
// ctypes. Sub and Paeth are sequential along a row and every filter but None
// reads the previous row, so the loop runs here rather than in numpy.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Undo the filters of `rows` scanlines. `raw` holds each row as its filter
// byte followed by `stride` filtered bytes; `out` receives rows * stride
// bytes. `bpp` is the filter's byte distance: bytes per complete pixel,
// rounded up to 1. Returns 0, or -(row + 1) at the first row whose filter
// byte is not 0-4.
int64_t png_unfilter(const uint8_t* raw, int64_t rows, int64_t stride, int64_t bpp,
                     uint8_t* out) {
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = raw + r * (stride + 1);
        const uint8_t filter = src[0];
        ++src;
        uint8_t* dst = out + r * stride;
        const uint8_t* up = r > 0 ? dst - stride : nullptr;
        switch (filter) {
            case 0:
                for (int64_t i = 0; i < stride; ++i) dst[i] = src[i];
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i)
                    dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i) dst[i] = src[i] + (up ? up[i] : 0);
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    dst[i] = src[i] + ((a + b) >> 1);
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    dst[i] = src[i] + pred;
                }
                break;
            default:
                return -(r + 1);
        }
    }
    return 0;
}

}  // extern "C"
