// The survivor tail of the JDA cascade, for Hopper (sm_90a): stages 0..T-1 of
// a queue of windows in one launch.  Two callers: the fused detection pass
// (every stage-0 survivor of a gather group) and the C API's non-fused path
// for multi-scale models (every window of one image's ladder).
//
// This kernel replaces no TPU kernel.  The JAX package's tail is XLA
// (jda_tpu/ops/fused.py, cascade.py); the port ran it as plain PyTorch
// (ops/cascade.py: carts_descend, score_chain, apply_regression), one launch
// per cart and per op: about 24,470 kernels a VGA call of 16, whose launches
// kept the card idle 96-97 % of the time the tail took, and about 33,600 an
// image for a multi-scale model.  Those functions stay as the plain
// counterpart it is held to, bit for bit, and serve the CPU.
//
// What it computes.  A lane is one window: flat id g = b*n + w into the
// [B, n] ladder (from `sel`, or the lane's own index), window w at (x, y) of
// size win in image b.  With a dense result (the fused pass), the lane
// survived the dense stage-0 filter: from the mean shape, stage 0's leaves
// (the filter's packed words, 4 bits per cart, cart k at nibble k%8 of word
// k/8; or a descent of stage 0 where no words are given) give the exact
// regression: each of the 2L coordinates adds the K weight rows
// W[0][k*leaf_n + leaf_k] one after another in cart order, in float32, and
// stages 1..T-1 follow.  Without one (the multi-scale path), stage 0 runs
// like every later stage from score 0 and no visit.  In a stage every cart
// descends on the current shape:
//   x = to_int((shape[2*lmk] + ox) * win), clamped to [0, win-1], y alike,
//   v = P(y1, x1) - P(y2, x2) (int32), node = 2*node + 1 + (v > th),
// to_int truncating (C API) or rounding half away from zero (C++ route); the
// chain score = (score + leaf - mean) / std, nvis += 1, alive = score >=
// cart_th runs in cart order and stops at the first reject; a lane still alive
// after the stage's last cart gets the stage's exact regression.  Every float
// op is IEEE round-to-nearest (__fadd_rn, __fmul_rn, __fdiv_rn), so nothing
// is contracted into an FMA, in the plain version's order.
//
// The pixel P.  Single scale: img[b, y + wy, x + wx].  Multi-scale (the
// template's second instantiation, for models whose nodes name a level): the
// image is its stacked o/h/q pyramid (ops/resize.stack_pyramid), each node
// names its level l (the fourth int of its table entry) for both its points,
// and P = pyr[b, base[w, l] + y * stride[l] + x], with the window's patch
// base on each level from detect.window_geometry.  The half and quarter
// patches claim win x win pixels of smaller levels, so near the bottom edge a
// read may fall at or past the pyramid's end: it gives the int32 minimum and
// the difference wraps in int32, as ops/cascade.take_fill does; the
// difference is taken in unsigned arithmetic.
//
// The plain pass compacts its lanes after the first `split` carts of each
// stage >= 1 (split > 0) and after each stage >= 1 but the last.  Lanes are
// independent, so the kernel needs no compaction: it counts the lanes alive at
// each such point (one atomic per lane and point) and records how many points
// each lane passed alive (`reach`).  The caller keeps the lanes that passed
// them all, which are the plain pass's final lanes, in the same order.  Each
// lane banks its visits beyond the dense filter's into its image's count.
// The multi-scale path's plain version (detect.Detector._run_batch) keeps
// every window's result in place, so there `reach` goes unread.
//
// Design: one warp per lane, lanes taken from the queue [0, N) by an atomic
// ticket, as in the stage-0 walk's survivor phase (dense0_walk.cuh).  A
// lane's stage t+1 reads only its own stage-t shape, so the warp carries its
// lane through every stage in one launch; a rejected lane frees its warp for
// the next ticket.  Per round of 32 carts lane j descends cart c0 + j and
// stages its leaf score, mean, std and threshold in shared memory; every lane
// then runs the same chain over the round in cart order.  The leaves go to
// shared memory, and the regression spreads the 2L coordinates over the
// warp's lanes, each adding its column of the K rows.
//
// What bounds it.  Fused pass: the regressions' weight rows: a VGA call of
// 16 has about 13.5 k stage-0 survivors and about 20 k lane-stages that end
// in a regression, each reading K rows of 2L floats (540 x 216 B) from L2:
// about 2.3 GB of L2 traffic, roughly 0.2-0.4 ms at the H100's L2 bandwidth.
// Next come the chain's dependent divides and the descents' dependent loads;
// the tail's ~1.7 M cart visits a call at 16 operations each are negligible
// arithmetic.  Multi-scale path: a VGA image queues about 170 k windows, and
// stage 0 rejects about 99.5 % of them, nearly all within its first round of
// 32 carts.  So a lane is mostly one round: its ticket, 32 descents of six
// dependent pixel loads (about 0.5 MB of pyramid, resident in L2), the chain,
// and its result (230 B, the shape included: about 39 MB of writes an image,
// some 12 us at HBM bandwidth).  The ticket and the round's latency bound it,
// not bytes or operations.  The measured time stands beside this in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_step.cuh"

namespace tail {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLbfBits = 4;
constexpr int kLbfPerWord = 32 / kLbfBits;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChainBytes = 32 * sizeof(float4);

struct Walk {
  const uint8_t* img;       // [B, H, W]; multi-scale: [B, F] stacked pyramids (H 1, W F)
  long long plane;          // H * W
  int W;
  int n;                    // windows per image
  const int* xywin;         // [n, 3]: x, y, win
  const long long* sel;     // [N]: flat window id b*n + w of each lane, or null: lane i is i
  int N;
  const float* score0;      // [B * n]: the dense filter's score, or null: stage 0 runs its chain
  const int* nvis0;         // [B * n]: its cart visits (null with score0)
  const int* lbf;           // [B * n, nw] stage-0 leaf words, or null: descend stage 0
  const int* lbase;         // multi-scale: [n, 3] each window's o/h/q patch base
  int3 lstride;             // multi-scale: the row stride of each level
  const int4* nodes_i;      // [T, K, node_n]: lmk1, lmk2, th, level
  const float4* nodes_f;    // [T, K, node_n]: off1 x, y, off2 x, y
  const float* cartf;       // [T, K, leaf_n + 3]: leaf scores, mean, std, cart_th
  const float* wts;         // [T, K * leaf_n, L2]
  const float* mean_shape;  // [L2]
  int T;
  int K;
  int depth;
  int L2;
  int split;                // carts of a stage before its first compaction point; 0: none
  int rounding;             // 1: round half away from zero; 0: truncate
  float* score;             // [N]
  int* nvis;                // [N]
  bool* alive;              // [N]
  float* shape;             // [N, L2]
  int* reach;               // [N]: compaction points the lane passed alive
  int* nvis_img;            // [B] or null: visits beyond the dense filter's are added here
  int* counters;            // [1 + points], zero at entry: next ticket, lanes at each point
};

// shared memory of one warp: the round's chain entries, the shape, the leaves
__host__ __device__ inline int warp_bytes(int L2, int K) {
  return kChainBytes + 4 * ((L2 + 3) & ~3) + ((K + 15) & ~15);
}

__device__ __forceinline__ int to_int(float v, int rounding) {
  if (rounding) v = v >= 0.f ? floorf(__fadd_rn(v, 0.5f)) : ceilf(__fsub_rn(v, 0.5f));
  return __float2int_rz(v);  // truncates and saturates, as PyTorch's cast
}

__device__ __forceinline__ int coord(float s, float o, float winf, int win, int rounding) {
  return min(max(to_int(__fmul_rn(__fadd_rn(s, o), winf), rounding), 0), win - 1);
}

__device__ __forceinline__ int pick(int3 v, int l) { return l == 0 ? v.x : l == 1 ? v.y : v.z; }

// a pyramid's pixel, or the int32 minimum at or past its end (take_fill)
__device__ __forceinline__ unsigned level_pixel(const uint8_t* __restrict__ p, long long i,
                                                long long end) {
  return i < end ? (unsigned)__ldg(p + i) : 0x80000000u;
}

// One cart's descent on the lane's current shape; returns the leaf index.
// Single scale: p is the window's origin in its image.  Multi-scale: p is the
// image's stacked pyramid and lb the window's patch base on each level.
template <bool kMs>
__device__ __forceinline__ int descend(const Walk& a, const uint8_t* __restrict__ p, int win,
                                       int3 lb, const float* shp, long long ck, int node_n) {
  const int4* __restrict__ ni = a.nodes_i + ck * node_n;
  const float4* __restrict__ nf = a.nodes_f + ck * node_n;
  const float winf = (float)win;
  int node = 0;
  for (int d = 0; d < a.depth - 1; ++d) {
    const int4 e = __ldg(ni + node);
    const float4 o = __ldg(nf + node);
    const int x1 = coord(shp[2 * e.x], o.x, winf, win, a.rounding);
    const int y1 = coord(shp[2 * e.x + 1], o.y, winf, win, a.rounding);
    const int x2 = coord(shp[2 * e.y], o.z, winf, win, a.rounding);
    const int y2 = coord(shp[2 * e.y + 1], o.w, winf, win, a.rounding);
    int v;
    if constexpr (kMs) {
      const long long base = pick(lb, e.w), st = pick(a.lstride, e.w);
      v = (int)(level_pixel(p, base + y1 * st + x1, a.plane) -
                level_pixel(p, base + y2 * st + x2, a.plane));
    } else {
      v = (int)__ldg(p + (long long)y1 * a.W + x1) - (int)__ldg(p + (long long)y2 * a.W + x2);
    }
    node = 2 * node + 1 + (v > e.z ? 1 : 0);
  }
  return node - node_n;
}

// Stage t's exact regression of the warp's lane: coordinates c0 + lane and
// c0 + 32 + lane of every 64, each adding the K rows in cart order.
__device__ __forceinline__ void regress(const Walk& a, int t, int leaf_n, float* shp,
                                        const uint8_t* leaves, int lane) {
  const float* w = a.wts + (long long)t * a.K * leaf_n * a.L2;
  for (int c0 = 0; c0 < a.L2; c0 += 64) {
    const int ca = c0 + lane, cb = c0 + 32 + lane;
    const bool ha = ca < a.L2, hb = cb < a.L2;
    const int ia = ha ? ca : 0, ib = hb ? cb : 0;  // every lane loads, in bounds
    float ra = shp[ia], rb = shp[ib];
#pragma unroll 8
    for (int k = 0; k < a.K; ++k) {
      const float* row = w + (long long)(k * leaf_n + leaves[k]) * a.L2;
      ra = __fadd_rn(ra, __ldg(row + ia));
      rb = __fadd_rn(rb, __ldg(row + ib));
    }
    __syncwarp();
    if (ha) shp[ca] = ra;
    if (hb) shp[cb] = rb;
  }
  __syncwarp();
}

template <bool kMs>
__global__ void __launch_bounds__(kThreads) walk_kernel(const Walk a) {
  extern __shared__ float4 sm[];
  const int lane = threadIdx.x & 31;
  char* mine = reinterpret_cast<char*>(sm) + (threadIdx.x >> 5) * warp_bytes(a.L2, a.K);
  float4* chain = reinterpret_cast<float4*>(mine);
  float* shp = reinterpret_cast<float*>(mine + kChainBytes);
  uint8_t* leaves = reinterpret_cast<uint8_t*>(shp + ((a.L2 + 3) & ~3));
  const int node_n = (1 << (a.depth - 1)) - 1;
  const int leaf_n = node_n + 1;
  const int nf = leaf_n + 3;
  const int nw = (a.K + kLbfPerWord - 1) / kLbfPerWord;
  for (;;) {
    int ticket = 0;
    if (lane == 0) ticket = atomicAdd(a.counters, 1);
    ticket = __shfl_sync(kFull, ticket, 0);
    if (ticket >= a.N) break;
    const long long g = a.sel ? a.sel[ticket] : (long long)ticket;
    const int b = (int)(g / a.n);
    const int w = (int)(g - (long long)b * a.n);
    const int win = __ldg(a.xywin + 3 * w + 2);
    const uint8_t* p = a.img + b * a.plane;
    int3 lb = make_int3(0, 0, 0);
    if constexpr (kMs) {
      lb = make_int3(__ldg(a.lbase + 3 * w), __ldg(a.lbase + 3 * w + 1),
                     __ldg(a.lbase + 3 * w + 2));
    } else {
      p += (long long)__ldg(a.xywin + 3 * w + 1) * a.W + __ldg(a.xywin + 3 * w);
    }
    for (int c = lane; c < a.L2; c += 32) shp[c] = __ldg(a.mean_shape + c);
    __syncwarp();

    float sc = 0.f;
    int nv = 0;
    int t0 = 0;
    if (a.score0) {
      // stage 0 done by the dense filter: its leaves (words or a descent),
      // its regression
      for (int k = lane; k < a.K; k += 32) {
        leaves[k] = a.lbf
            ? (uint8_t)(((unsigned)__ldg(a.lbf + g * nw + k / kLbfPerWord) >>
                         (kLbfBits * (k % kLbfPerWord))) & ((1u << kLbfBits) - 1))
            : (uint8_t)descend<kMs>(a, p, win, lb, shp, k, node_n);
      }
      __syncwarp();
      regress(a, 0, leaf_n, shp, leaves, lane);
      sc = a.score0[g];
      nv = a.nvis0[g];
      t0 = 1;
    }
    const int nv0 = nv;
    bool al = true;  // the same on every lane of the warp
    int reach = 0;
    for (int t = t0; t < a.T && al; ++t) {
      for (int c0 = 0; c0 < a.K && al; c0 += 32) {
        const int k = c0 + lane;
        float4 f = make_float4(0.f, 0.f, 1.f, 0.f);
        if (k < a.K) {
          const long long ck = (long long)t * a.K + k;
          const int leaf = descend<kMs>(a, p, win, lb, shp, ck, node_n);
          leaves[k] = (uint8_t)leaf;
          const float* cf = a.cartf + ck * nf;
          f = make_float4(__ldg(cf + leaf), __ldg(cf + leaf_n), __ldg(cf + leaf_n + 1),
                          __ldg(cf + leaf_n + 2));
        }
        chain[lane] = f;
        __syncwarp();
        // the chain over the round's carts in cart order, four between two
        // looks at the reject, as the stage-0 walk's survivor phase runs it
        const int jend = min(32, a.K - c0);
        for (int j0 = 0; j0 < jend && al; j0 += 4) {
          float4 q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) q[i] = chain[j0 + i];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool v = al && j0 + i < jend;
            const float s = jda::score_step(sc, q[i].x, q[i].y, q[i].z);
            sc = v ? s : sc;
            nv += v;
            al = v ? s >= q[i].w : al;
          }
        }
        __syncwarp();
        if (t > 0 && c0 + 32 == a.split && al) {  // the split's compaction point
          if (lane == 0) atomicAdd(a.counters + 1 + reach, 1);
          ++reach;
        }
      }
      if (!al) break;
      regress(a, t, leaf_n, shp, leaves, lane);
      if (t > 0 && t < a.T - 1) {  // the compaction point after the stage
        if (lane == 0) atomicAdd(a.counters + 1 + reach, 1);
        ++reach;
      }
    }

    for (int c = lane; c < a.L2; c += 32) a.shape[(long long)ticket * a.L2 + c] = shp[c];
    if (lane == 0) {
      a.score[ticket] = sc;
      a.nvis[ticket] = nv;
      a.alive[ticket] = al;
      a.reach[ticket] = reach;
      if (a.nvis_img) atomicAdd(a.nvis_img + b, nv - nv0);
    }
    __syncwarp();
  }
}

}  // namespace tail

// All pointers are device pointers; sel, score0 with nvis0, lbf, lbase and
// nvis_img may be null.  lbase non-null runs the multi-scale walk (img holds
// B stacked pyramids of H * W bytes each, strides so, sh, sq).  lbf needs
// score0.  counters must be zero at entry.  Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments the kernel
// does not take, and the kernels launched in *launched.  Launches on
// `stream`, does not synchronise.
extern "C" int tail_walk(const void* img, int H, int W, int n, const void* xywin,
                         const void* sel, int N, const void* score0, const void* nvis0,
                         const void* lbf, const void* lbase, int so, int sh, int sq,
                         const void* nodes_i, const void* nodes_f, const void* cartf,
                         const void* wts, const void* mean_shape, int T, int K, int depth,
                         int L2, int split, int rounding, void* score, void* nvis, void* alive,
                         void* shape, void* reach, void* nvis_img, void* counters, void* stream,
                         int* launched) {
  using namespace tail;
  if (launched) *launched = 0;
  if (T < 1 || K < 1 || L2 < 2 || N < 0 || depth < 2 || depth > kLbfBits + 1 ||
      (split && (split % 32 || split >= K)) || !score0 != !nvis0 || (lbf && !score0) ||
      (lbase && (so < 1 || sh < 1 || sq < 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * warp_bytes(L2, K);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  Walk a;
  a.img = (const uint8_t*)img;
  a.plane = (long long)H * W;
  a.W = W;
  a.n = n;
  a.xywin = (const int*)xywin;
  a.sel = (const long long*)sel;
  a.N = N;
  a.score0 = (const float*)score0;
  a.nvis0 = (const int*)nvis0;
  a.lbf = (const int*)lbf;
  a.lbase = (const int*)lbase;
  a.lstride = make_int3(so, sh, sq);
  a.nodes_i = (const int4*)nodes_i;
  a.nodes_f = (const float4*)nodes_f;
  a.cartf = (const float*)cartf;
  a.wts = (const float*)wts;
  a.mean_shape = (const float*)mean_shape;
  a.T = T;
  a.K = K;
  a.depth = depth;
  a.L2 = L2;
  a.split = split;
  a.rounding = rounding;
  a.score = (float*)score;
  a.nvis = (int*)nvis;
  a.alive = (bool*)alive;
  a.shape = (float*)shape;
  a.reach = (int*)reach;
  a.nvis_img = (int*)nvis_img;
  a.counters = (int*)counters;
  if (N == 0) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  // enough warps to fill the card; a warp takes lanes until the queue is empty
  long long blocks = ((long long)N + kWarps - 1) / kWarps;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (lbase)
    walk_kernel<true><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  else
    walk_kernel<false><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (launched) *launched = 1;
  return 0;
}
