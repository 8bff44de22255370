// Native OpenEXR bridge — the analog of the reference's Bitmap EXR path
// (src/libcore/bitmap.cpp links OpenEXR; so does this framework, via this
// ctypes-loaded shared library). Handles every OpenEXR compression
// (NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/DWAA/DWAB) for scanline images.
// The pure-Python codec in utils/bitmap.py remains the fallback when the
// system libOpenEXR is absent; this bridge is also the golden oracle the
// native PIZ/PXR24 codec tests validate against.
//
// Build: see csrc/build.py (g++ -shared -fPIC, links -lOpenEXR-3_1).
// C ABI only — loaded with ctypes, no pybind11.

#include <ImfChannelList.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImfInputFile.h>
#include <ImfOutputFile.h>
#include <ImfStandardAttributes.h>
#include <ImathBox.h>

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

using namespace Imf;
using namespace Imath;

static thread_local std::string g_error;

extern "C" {

const char *exr_last_error() { return g_error.c_str(); }

// Read a scanline EXR. On success returns 0 and fills:
//   *w, *h, *c        image size and channel count
//   *data             malloc'd float32 buffer, H*W*C, scanline interleaved
//                     (channel order = file's alphabetical chlist order)
//   *names            malloc'd, c entries of malloc'd NUL-terminated names
// Caller frees via exr_free / exr_free_names.
int exr_read(const char *path, int *w, int *h, int *c, float **data,
             char ***names) {
  try {
    InputFile file(path);
    Box2i dw = file.header().dataWindow();
    int W = dw.max.x - dw.min.x + 1;
    int H = dw.max.y - dw.min.y + 1;

    std::vector<std::string> chans;
    const ChannelList &cl = file.header().channels();
    for (ChannelList::ConstIterator it = cl.begin(); it != cl.end(); ++it)
      chans.push_back(it.name());
    int C = (int)chans.size();

    float *buf = (float *)malloc(sizeof(float) * (size_t)W * H * C);
    if (!buf) { g_error = "alloc failed"; return 1; }

    FrameBuffer fb;
    for (int i = 0; i < C; ++i) {
      // signed offset: data windows may legally have negative min coords;
      // size_t casts would underflow into UB pointer arithmetic
      char *base = (char *)(buf + (size_t)i) -
                   ((ptrdiff_t)dw.min.y * W + dw.min.x) *
                       (ptrdiff_t)(C * sizeof(float));
      fb.insert(chans[i].c_str(),
                Slice(FLOAT, base, sizeof(float) * C,
                      sizeof(float) * C * (size_t)W));
    }
    file.setFrameBuffer(fb);
    file.readPixels(dw.min.y, dw.max.y);

    char **nm = (char **)malloc(sizeof(char *) * C);
    for (int i = 0; i < C; ++i) {
      nm[i] = (char *)malloc(chans[i].size() + 1);
      std::memcpy(nm[i], chans[i].c_str(), chans[i].size() + 1);
    }
    *w = W; *h = H; *c = C; *data = buf; *names = nm;
    return 0;
  } catch (const std::exception &e) {
    g_error = e.what();
    return 1;
  }
}

// Write a scanline EXR. data: H*W*C float32, scanline interleaved.
// names: C channel names. compression: Imf::Compression enum value
// (0 none, 1 rle, 2 zips, 3 zip, 4 piz, 5 pxr24, 6 b44, 7 b44a,
//  8 dwaa, 9 dwab). pixel_type: 1 = HALF, 2 = FLOAT.
int exr_write(const char *path, int w, int h, int c, const float *data,
              const char **names, int compression, int pixel_type) {
  try {
    Header header(w, h);
    header.compression() = (Compression)compression;
    PixelType pt = pixel_type == 1 ? HALF : FLOAT;

    std::vector<std::vector<half>> halves;
    FrameBuffer fb;
    for (int i = 0; i < c; ++i) {
      header.channels().insert(names[i], Channel(pt));
    }
    if (pt == HALF) {
      halves.resize(c);
      for (int i = 0; i < c; ++i) {
        halves[i].resize((size_t)w * h);
        for (size_t p = 0; p < (size_t)w * h; ++p)
          halves[i][p] = half(data[p * c + i]);
        fb.insert(names[i], Slice(HALF, (char *)halves[i].data(),
                                  sizeof(half), sizeof(half) * (size_t)w));
      }
    } else {
      for (int i = 0; i < c; ++i)
        fb.insert(names[i],
                  Slice(FLOAT, (char *)(data + i), sizeof(float) * c,
                        sizeof(float) * c * (size_t)w));
    }
    OutputFile file(path, header);
    file.setFrameBuffer(fb);
    file.writePixels(h);
    return 0;
  } catch (const std::exception &e) {
    g_error = e.what();
    return 1;
  }
}

void exr_free(float *data) { free(data); }

void exr_free_names(char **names, int c) {
  for (int i = 0; i < c; ++i) free(names[i]);
  free(names);
}

}  // extern "C"
