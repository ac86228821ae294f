// Undo PNG's per-row filters (host code of doc2tex_tpu_torch.utils.png).
//
// PNG stores each row as one filter byte and `stride` filtered bytes.  The
// Average and Paeth filters predict every byte from the byte `bpp` to its
// left in the same, already unfiltered row, so a row is undone byte after
// byte; PIL's writer picks a filter per row, mostly Paeth, so stores of PIL
// files take this loop for nearly every row.  The plain version that the
// tests hold this to is `utils.png._unfilter_py`.

#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

// raw: h rows of 1 + stride bytes; out: h * stride bytes.  Returns 0, or
// -1 - y where row y has a filter type other than 0..4.
extern "C" int d2t_png_unfilter(const uint8_t* raw, int h, int stride, int bpp,
                                uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + static_cast<int64_t>(y) * (stride + 1);
    const uint8_t kind = *line++;
    uint8_t* cur = out + static_cast<int64_t>(y) * stride;
    const uint8_t* up = y ? cur - stride : nullptr;
    switch (kind) {
      case 0:
        for (int i = 0; i < stride; ++i) cur[i] = line[i];
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = up && i >= bpp ? up[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + paeth(a, b, c));
        }
        break;
      default:
        return -1 - y;
    }
  }
  return 0;
}
