// Dense stage-0 filter of the JDA cascade, one scan scale, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of jda_tpu/ops/dense0.py that compute this
// function on the fused detection path:
//   _scale_filter_pallas_resident  (dense0.py:833)
//   _scale_filter_pallas_rolled    (dense0.py:1063)
//   _scale_filter_pallas_tiled     (dense0.py:1253)
// They differ only in how the image's phase planes fit the TPU's VMEM; on the
// card they are one function, and this kernel serves every scale.
//
// What it computes, for every window (b, iy, ix) of the [B, ny, nx] grid of
// one scale (window origin at (iy*step, ix*step)): run the K stage-0 carts.
// Each visited node compares the pixel difference
//   img[b, iy*step + yr1, ix*step + xr1] - img[b, iy*step + yr2, ix*step + xr2]
// against its threshold; (yr, xr) are fixed per (cart, node, point), so the
// host passes them as flat offsets yr*W + xr.  The path picks a leaf, then
//   score = (score + leaf - mean) / std;  nvis += 1;  alive = score >= cart_th
// in float32, rounded to nearest at each op, in that order (jda.c:395-399).
// With lbf != nullptr the leaf indices are packed 4 bits per cart, cart k at
// nibble k%8 of word k/8 of the window's [nw] words.
//
// Design.  One thread per window; score, alive and nvis live in registers;
// each cart descends only its visited path (depth-1 nodes, two pixel reads
// each, where the TPU kernels read every node).  The thread stops at the first
// cart that rejects its window, as the C library does (native/jda_native.c:301):
// a dead window's score is frozen from then on, so score, alive and nvis equal
// the TPU kernels' outputs.  LBF words are written up to that cart only; the
// contract is that LBF is defined where alive is true (the fused tail reads
// survivors' words only).  Cart tables are read warp-uniformly through __ldg;
// the image is read straight from uint8 device memory (no phase planes).
//
// What bounds it.  By bytes, the image is read once (4.9 MB for 16 VGA frames,
// resident in the 50 MB L2) and each window writes 9 B (score, alive, nvis)
// plus 4*ceil(K/8) B of LBF words if it survives: for VGA at B=16, 2.7 M
// windows, ~25 MB, ~7.5 us at 3.35 TB/s.  The operations (three node steps and
// four float ops per visited cart) are of the same order at the fp32/int32
// rate.  In practice the kernel is bound by neither: the per-thread cart loop
// is a chain of dependent L1/L2 loads, and warps diverge on the early exit, so
// a warp runs as long as its longest-living window.  Skipping the LBF stores of
// dead windows keeps the write traffic at what the tail reads (4*68 B per
// survivor at K=540, not per window: 0.74 GB for every window of the batch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLbfBits = 4;
constexpr int kLbfPerWord = 32 / kLbfBits;

__global__ void __launch_bounds__(kThreads)
dense0_filter_kernel(const uint8_t* __restrict__ img, int H, int W,
                     const int4* __restrict__ nodes,  // [K, node_n]: off1, off2, th, 0
                     const float* __restrict__ tabf,  // [K, leaf_n + 3]
                     int K, int depth, int step, int ny, int nx, long long total,
                     float* __restrict__ score, bool* __restrict__ alive,
                     int* __restrict__ nvis, int* __restrict__ lbf) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ix = (int)(idx % nx);
  const long long rest = idx / nx;
  const int iy = (int)(rest % ny);
  const long long b = rest / ny;
  const uint8_t* p = img + (b * H + (long long)iy * step) * W + (long long)ix * step;

  const int node_n = (1 << (depth - 1)) - 1;
  const int leaf_n = node_n + 1;
  const int nf = leaf_n + 3;
  const int nw = (K + kLbfPerWord - 1) / kLbfPerWord;
  int* words = lbf ? lbf + idx * nw : nullptr;

  float s = 0.f;
  int nv = 0;
  bool al = true;
  unsigned word = 0;
  for (int k = 0; k < K && al; ++k) {
    const int4* cn = nodes + (long long)k * node_n;
    int node = 0;
    for (int d = 0; d < depth - 1; ++d) {
      const int4 e = __ldg(cn + node);
      const int v = (int)__ldg(p + e.x) - (int)__ldg(p + e.y);
      node = 2 * node + 1 + (v > e.z ? 1 : 0);
    }
    const int leaf = node - node_n;
    const float* cf = tabf + (long long)k * nf;
    // (s + b - mean) / std, each op IEEE round-to-nearest, no contraction
    s = __fdiv_rn(__fsub_rn(__fadd_rn(s, __ldg(cf + leaf)), __ldg(cf + leaf_n)),
                  __ldg(cf + leaf_n + 1));
    ++nv;
    al = s >= __ldg(cf + leaf_n + 2);
    if (words) {
      word |= (unsigned)leaf << (kLbfBits * (k % kLbfPerWord));
      if (k % kLbfPerWord == kLbfPerWord - 1 || k == K - 1) {
        words[k / kLbfPerWord] = (int)word;
        word = 0;
      }
    }
  }
  score[idx] = s;
  alive[idx] = al;
  nvis[idx] = nv;
}

}  // namespace

// All pointers are device pointers; lbf may be null.  Returns cudaGetLastError()
// after the launch (0 on success).  Launches on `stream`, does not synchronise.
extern "C" int dense0_filter(const void* img, int B, int H, int W, const void* nodes,
                             const void* tabf, int K, int depth, int step, int ny,
                             int nx, void* score, void* alive, void* nvis, void* lbf,
                             void* stream) {
  const long long total = (long long)B * ny * nx;
  if (total > 0) {
    const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
    dense0_filter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img, H, W, (const int4*)nodes, (const float*)tabf, K, depth,
        step, ny, nx, total, (float*)score, (bool*)alive, (int*)nvis, (int*)lbf);
  }
  return (int)cudaGetLastError();
}
