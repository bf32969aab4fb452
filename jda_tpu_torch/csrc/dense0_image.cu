// Dense stage-0 filter of the JDA cascade over the whole window ladder of one
// image, for Hopper (sm_90a).
//
// Replaces the TPU kernel _scale_filter_pallas (jda_tpu/ops/dense0.py:592)
// together with stage0_filter_all_scales_pallas (dense0.py:753), which calls
// it once per scan scale inside one program.  On the TPU the grid
// runs over the K carts in order, score / alive / nvis stay resident on chip
// from one cart to the next, every one of the 7 nodes of a cart is evaluated
// for every window, and the 14 pixel crops of a cart are DMA'd from HBM.
//
// What it computes.  The ladder has S scan scales; scale s has an ny x nx grid
// of windows of one size, origins at (iy*step, ix*step), and its windows take
// the flat indices [first, first + ny*nx) of the reference's enumeration order
// (win outer, y middle, x inner; jda.c:331-339).  For every window the K
// stage-0 carts run from the mean shape: each visited node compares
//   img[iy*step + yr1, ix*step + xr1] - img[iy*step + yr2, ix*step + xr2]
// (int32) against its threshold; (yr, xr) depend on (scale, cart, node, point)
// only, so the host passes them as flat offsets yr*W + xr.  The path picks a
// leaf, then
//   score = (score + leaf - mean) / std;  nvis += 1;  alive = score >= cart_th
// in float32, rounded to nearest at each op, in that order (jda.c:395-399).
// Outputs are flat [n]: index i is window i of the enumeration.  There are no
// leaf words: the TPU kernel has none.
//
// Design.  One launch for the whole ladder, one thread per window.  A thread
// finds its scale by walking the S records (first, nx, step, ny), at most a
// few dozen, then does what dense0_filter does (csrc/dense0.cu): it descends
// the visited path only and stops at the cart that rejects its window, as the
// C library does (native/jda_native.c:301).  A dead window's score is frozen
// on the TPU, so score, alive and nvis are the same.  Only the node offsets
// depend on the scale (they hold step and W); leaf scores, mean, std and
// cart_th are shared, so there is one tabf and a [S, K, node_n] node table.
// Windows of a block are neighbours in the enumeration, so all but the blocks
// at a scale boundary read one scale's rows warp-uniformly.
//
// What bounds it.  By bytes: the image once (0.3 MB for VGA), the tables
// (S*K*node_n*16 B, 0.85 MB for the VGA ladder) and 9 B per window (1.5 MB for
// VGA's 169,706 windows): under a microsecond at 3.35 TB/s.  By operations:
// sixteen per visited cart, a few million visits: the same order.  In practice
// neither: a launch lasts as long as its longest-living window's serial walk
// through the K carts, a chain of dependent table and pixel loads.  With one
// launch per image that walk is paid once, not once per scale.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dense0_image_kernel(const uint8_t* __restrict__ img, int W,
                    const int4* __restrict__ recs,   // [S]: first, nx, step, ny
                    int S,
                    const int4* __restrict__ nodes,  // [S, K, node_n]: off1, off2, th, 0
                    const float* __restrict__ tabf,  // [K, leaf_n + 3]
                    int K, int depth, int n,
                    float* __restrict__ score, bool* __restrict__ alive,
                    int* __restrict__ nvis) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int s = 0;
  while (s + 1 < S && idx >= __ldg(recs + s + 1).x) ++s;
  const int4 rec = __ldg(recs + s);
  const int local = idx - rec.x;
  const int iy = local / rec.y;
  const int ix = local - iy * rec.y;
  const uint8_t* p = img + ((long long)iy * W + ix) * rec.z;

  const int node_n = (1 << (depth - 1)) - 1;
  const int leaf_n = node_n + 1;
  const int nf = leaf_n + 3;
  const int4* sn = nodes + (long long)s * K * node_n;

  float sc = 0.f;
  int nv = 0;
  bool al = true;
  for (int k = 0; k < K && al; ++k) {
    const int4* cn = sn + (long long)k * node_n;
    int node = 0;
    for (int d = 0; d < depth - 1; ++d) {
      const int4 e = __ldg(cn + node);
      const int v = (int)__ldg(p + e.x) - (int)__ldg(p + e.y);
      node = 2 * node + 1 + (v > e.z ? 1 : 0);
    }
    const int leaf = node - node_n;
    const float* cf = tabf + (long long)k * nf;
    // (s + b - mean) / std, each op IEEE round-to-nearest, no contraction
    sc = __fdiv_rn(__fsub_rn(__fadd_rn(sc, __ldg(cf + leaf)), __ldg(cf + leaf_n)),
                   __ldg(cf + leaf_n + 1));
    ++nv;
    al = sc >= __ldg(cf + leaf_n + 2);
  }
  score[idx] = sc;
  alive[idx] = al;
  nvis[idx] = nv;
}

}  // namespace

// All pointers are device pointers.  Returns cudaGetLastError() after the
// launch (0 on success).  Launches on `stream`, does not synchronise.
extern "C" int dense0_image(const void* img, int W, const void* recs, int S,
                            const void* nodes, const void* tabf, int K, int depth,
                            int n, void* score, void* alive, void* nvis,
                            void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    dense0_image_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img, W, (const int4*)recs, S, (const int4*)nodes,
        (const float*)tabf, K, depth, n, (float*)score, (bool*)alive, (int*)nvis);
  }
  return (int)cudaGetLastError();
}
