// The o/h/q pyramid of one image for the multi-scale detector, for Hopper
// (sm_90a): the h and q levels written from o in one launch.
//
// This kernel replaces no TPU kernel.  The JAX package builds the pyramid on
// the host in numpy (jda_tpu/ops/resize.py: pyramid_c, stack_pyramid), and
// so did the port: about 10.5 ms of host time an image, then a pageable copy
// of the stacked levels, on the critical path of the non-fused path's
// per-image loop (PERF.md).  Now the host uploads o alone, into the head of
// the stacked buffer, and this kernel writes h and q behind it.  The plain
// PyTorch twin it is held to, bit for bit, is
// ops/pyramid.fill_levels_reference, itself equal to ops/resize.pyramid_c.
//
// What it computes.  The buffer holds o (H x W) at 0, h (hh x hw) at H*W and
// q (qh x qw) at H*W + hh*hw, each row-major, F bytes in all.  Each output
// pixel (i, j) of a level of ratios (xr, yr) is c/jda.c's bilinear resize
// (c/jda.c:203-230): xf = xr * j, x = (int)xf, xd = xf - x, y alike; with a,
// b, c, d the o pixels at (y, x), (y, x+1), (y+1, x), (y+1, x+1),
//   v = ((a*(1-xd))*(1-yd) + (b*xd)*(1-yd)) + (c*(1-xd))*yd + (d*xd)*yd,
// added left to right and truncated to uint8.  The ratios (src - 1) / dst
// are divided on the host in float32 and come in by value, so no multiply
// by a reciprocal stands in for the division (through one, the q ratio
// 479/240 rounds differently).  Every float op is IEEE round-to-nearest
// (__fmul_rn, __fsub_rn, __fadd_rn), so nothing is contracted into an FMA.  x + 1 and
// y + 1 stay inside o for every level size pyramid_c gives (xr * (dst - 1)
// stays below src - 1 by about xr), so the reads never touch h or q.
//
// What bounds it.  Bytes: o read once (0.31 MB for VGA) and h and q written
// once (0.23 MB), about 0.16 us at 3.35 TB/s; 1080p 3.6 MB, about 1.1 us.
// The arithmetic (some 25 float ops a pixel) is negligible.  So at these
// sizes the launch itself sets the pace.  Design: one grid over both
// levels.  The first blocks cover h, the rest q (blockIdx picks the level);
// each thread owns one aligned 4-byte word of the buffer and writes its
// 4 pixels with one 32-bit store.  Rows need not be a multiple of 4 wide
// (1080p's h is 1357), so a thread walks its pixels across a row's end.  The
// words at a level's two ends may hold bytes of the level before or after
// it: those go byte by byte, each level writing only its own bytes, so no
// two threads write one byte.  o's reads hit L2 (the image is 0.3-2 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace pyramid {

constexpr int kThreads = 256;

struct Level {
  long long lo, hi;  // the level's bytes [lo, hi) in the buffer
  int cols;          // its width
  float xr, yr;      // resize ratios
  long long words;   // aligned words that touch [lo, hi)
};

__device__ __forceinline__ unsigned pixel(const uint8_t* __restrict__ o, int W, int i, int j,
                                          float xr, float yr) {
  const float xf = __fmul_rn(xr, (float)j);
  const float yf = __fmul_rn(yr, (float)i);
  const int x = (int)xf;  // truncation toward zero
  const int y = (int)yf;
  const float xd = __fsub_rn(xf, (float)x);
  const float yd = __fsub_rn(yf, (float)y);
  const uint8_t* p = o + (long long)y * W + x;
  const float a = p[0], b = p[1], c = p[W], d = p[W + 1];
  const float mx = __fsub_rn(1.0f, xd), my = __fsub_rn(1.0f, yd);
  float v = __fmul_rn(__fmul_rn(a, mx), my);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(b, xd), my));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(c, mx), yd));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(d, xd), yd));
  return __float2uint_rz(v);  // (unsigned char) cast: truncation, v in [0, 256)
}

__global__ void __launch_bounds__(kThreads)
levels_kernel(uint8_t* __restrict__ buf, int W, Level h, Level q, long long hblocks) {
  const bool isq = blockIdx.x >= hblocks;
  const Level L = isq ? q : h;
  const long long w = (long long)(isq ? blockIdx.x - hblocks : blockIdx.x) * kThreads +
                      threadIdx.x;
  if (w >= L.words) return;
  const long long p = (L.lo & ~3LL) + 4 * w;  // this thread's word
  // the level's pixel at byte p (or at lo, if p lies before it)
  const int k = (int)((p > L.lo ? p : L.lo) - L.lo);  // F < 2^31 (the wrapper checks)
  int i = k / L.cols, j = k - i * L.cols;
  if (p >= L.lo && p + 4 <= L.hi) {
    unsigned word = 0;
    for (int b = 0; b < 4; ++b) {
      word |= pixel(buf, W, i, j, L.xr, L.yr) << (8 * b);
      if (++j == L.cols) j = 0, ++i;
    }
    *reinterpret_cast<unsigned*>(buf + p) = word;  // little-endian: byte b at p + b
    return;
  }
  for (long long at = p; at < p + 4; ++at) {  // a word at either end of the level
    if (at < L.lo || at >= L.hi) continue;
    buf[at] = (uint8_t)pixel(buf, W, i, j, L.xr, L.yr);
    if (++j == L.cols) j = 0, ++i;
  }
}

Level level(long long lo, int rows, int cols, float xr, float yr) {
  Level L;
  L.lo = lo;
  L.hi = lo + (long long)rows * cols;
  L.cols = cols;
  L.xr = xr;
  L.yr = yr;
  L.words = L.hi > L.lo ? (L.hi - (L.lo & ~3LL) + 3) / 4 : 0;
  return L;
}

}  // namespace pyramid

// buf: the [F] uint8 buffer, o in its first H*W bytes, 4-byte aligned.
// Writes h (hh x hw, ratios hx, hy) and q (qh x qw, ratios qx, qy) behind o
// on `stream`; *launched is the number of kernels launched (0 or 1).
// Returns 0 or the cudaError of the launch.
extern "C" int pyramid_levels(void* buf, int H, int W, int hh, int hw, int qh, int qw,
                              float hx, float hy, float qx, float qy, void* stream,
                              int* launched) {
  using namespace pyramid;
  if (launched) *launched = 0;
  if (!buf || H < 0 || W < 0 || hh < 0 || hw < 0 || qh < 0 || qw < 0 ||
      ((uintptr_t)buf & 3))
    return (int)cudaErrorInvalidValue;
  const long long oh = (long long)H * W;
  const Level h = level(oh, hh, hw, hx, hy);
  const Level q = level(h.hi, qh, qw, qx, qy);
  const long long hblocks = (h.words + kThreads - 1) / kThreads;
  const long long blocks = hblocks + (q.words + kThreads - 1) / kThreads;
  if (q.hi >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  levels_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)buf, W, h, q, hblocks);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (launched) *launched = 1;
  return 0;
}
