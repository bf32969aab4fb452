// The survivor tail of the JDA cascade's fused detection pass, for Hopper
// (sm_90a): stages 0..T-1 of every stage-0 survivor of a gather group in one
// launch.
//
// This kernel replaces no TPU kernel.  The JAX package's tail is XLA
// (jda_tpu/ops/fused.py, cascade.py); the port ran it as plain PyTorch
// (ops/cascade.py: carts_descend, score_chain, apply_regression), one launch
// per cart and per op: about 24,470 kernels a VGA call of 16, whose launches
// kept the card idle 96-97 % of the time the tail took.  Those functions stay
// as the plain counterpart it is held to, bit for bit, and serve the CPU.
//
// What it computes.  A lane is one window that survived the dense stage-0
// filter: flat id g = b*n + w into the [B, n] ladder, window w at (x, y) of
// size win in image b.  From the mean shape, stage 0's leaves (the filter's
// packed words, 4 bits per cart, cart k at nibble k%8 of word k/8; or a
// descent of stage 0 where no words are given) give the exact regression:
// each of the 2L coordinates adds the K weight rows W[0][k*leaf_n + leaf_k]
// one after another in cart order, in float32.  Then for t = 1..T-1 every
// cart descends on the current shape, single scale:
//   x = to_int((shape[2*lmk] + ox) * win), clamped to [0, win-1], y alike,
//   v = img[b, y + y1, x + x1] - img[b, y + y2, x + x2] (int32),
//   node = 2*node + 1 + (v > th),
// to_int truncating (C API) or rounding half away from zero (C++ route); the
// chain score = (score + leaf - mean) / std, nvis += 1, alive = score >=
// cart_th runs in cart order and stops at the first reject; a lane still alive
// after the stage's last cart gets the stage's exact regression.  Every float
// op is IEEE round-to-nearest (__fadd_rn, __fmul_rn, __fdiv_rn), so nothing
// is contracted into an FMA, in the plain version's order.
//
// The plain pass compacts its lanes after the first `split` carts of each
// stage >= 1 (split > 0) and after each stage but the last.  Lanes are
// independent, so the kernel needs no compaction: it counts the lanes alive at
// each such point (one atomic per lane and point) and records how many points
// each lane passed alive (`reach`).  The caller keeps the lanes that passed
// them all, which are the plain pass's final lanes, in the same order.  Each
// lane banks its visits beyond the dense filter's into its image's count.
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
// What bounds it.  The regressions' weight rows: a VGA call of 16 has about
// 13.5 k stage-0 survivors and about 20 k lane-stages that end in a
// regression, each reading K rows of 2L floats (540 x 216 B) from L2: about
// 2.3 GB of L2 traffic, roughly 0.2-0.4 ms at the H100's L2 bandwidth.  Next
// come the chain's dependent divides and the descents' dependent loads; the
// tail's ~1.7 M cart visits a call at 16 operations each are negligible
// arithmetic.  The measured time stands beside this bound in PERF.md.

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
  const uint8_t* img;       // [B, H, W]
  long long plane;          // H * W
  int W;
  int n;                    // windows per image
  const int* xywin;         // [n, 3]: x, y, win
  const long long* sel;     // [N]: flat window id b*n + w of each lane
  int N;
  const float* score0;      // [B * n]: the dense filter's score
  const int* nvis0;         // [B * n]: its cart visits
  const int* lbf;           // [B * n, nw] stage-0 leaf words, or null: descend stage 0
  const int4* nodes_i;      // [T, K, node_n]: lmk1, lmk2, th, 0
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
  int* nvis_img;            // [B]: visits beyond the dense filter's are added here
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

// One cart's descent on the lane's current shape; returns the leaf index.
__device__ __forceinline__ int descend(const uint8_t* __restrict__ p, int W, int win,
                                       const float* shp, const int4* __restrict__ ni,
                                       const float4* __restrict__ nf, int depth, int node_n,
                                       int rounding) {
  const float winf = (float)win;
  int node = 0;
  for (int d = 0; d < depth - 1; ++d) {
    const int4 e = __ldg(ni + node);
    const float4 o = __ldg(nf + node);
    const int x1 = coord(shp[2 * e.x], o.x, winf, win, rounding);
    const int y1 = coord(shp[2 * e.x + 1], o.y, winf, win, rounding);
    const int x2 = coord(shp[2 * e.y], o.z, winf, win, rounding);
    const int y2 = coord(shp[2 * e.y + 1], o.w, winf, win, rounding);
    const int v = (int)__ldg(p + (long long)y1 * W + x1) - (int)__ldg(p + (long long)y2 * W + x2);
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
    const long long g = a.sel[ticket];
    const int b = (int)(g / a.n);
    const int w = (int)(g - (long long)b * a.n);
    const int win = __ldg(a.xywin + 3 * w + 2);
    const uint8_t* p =
        a.img + b * a.plane + (long long)__ldg(a.xywin + 3 * w + 1) * a.W + __ldg(a.xywin + 3 * w);
    for (int c = lane; c < a.L2; c += 32) shp[c] = __ldg(a.mean_shape + c);
    __syncwarp();

    // stage 0: leaves from the dense filter's words (or a descent), regression
    for (int k = lane; k < a.K; k += 32) {
      leaves[k] = a.lbf
          ? (uint8_t)(((unsigned)__ldg(a.lbf + g * nw + k / kLbfPerWord) >>
                       (kLbfBits * (k % kLbfPerWord))) & ((1u << kLbfBits) - 1))
          : (uint8_t)descend(p, a.W, win, shp, a.nodes_i + (long long)k * node_n,
                             a.nodes_f + (long long)k * node_n, a.depth, node_n, a.rounding);
    }
    __syncwarp();
    regress(a, 0, leaf_n, shp, leaves, lane);

    float sc = a.score0[g];
    int nv = a.nvis0[g];
    const int nv0 = nv;
    bool al = true;  // the same on every lane of the warp
    int reach = 0;
    for (int t = 1; t < a.T && al; ++t) {
      for (int c0 = 0; c0 < a.K && al; c0 += 32) {
        const int k = c0 + lane;
        float4 f = make_float4(0.f, 0.f, 1.f, 0.f);
        if (k < a.K) {
          const long long ck = (long long)t * a.K + k;
          const int leaf = descend(p, a.W, win, shp, a.nodes_i + ck * node_n,
                                   a.nodes_f + ck * node_n, a.depth, node_n, a.rounding);
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
        if (c0 + 32 == a.split && al) {  // the split's compaction point
          if (lane == 0) atomicAdd(a.counters + 1 + reach, 1);
          ++reach;
        }
      }
      if (!al) break;
      regress(a, t, leaf_n, shp, leaves, lane);
      if (t < a.T - 1) {  // the compaction point after the stage
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
      atomicAdd(a.nvis_img + b, nv - nv0);
    }
    __syncwarp();
  }
}

}  // namespace tail

// All pointers are device pointers; lbf may be null.  counters must be zero
// at entry.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take, and the
// kernels launched in *launched.  Launches on `stream`, does not synchronise.
extern "C" int tail_walk(const void* img, int H, int W, int n, const void* xywin,
                         const void* sel, int N, const void* score0, const void* nvis0,
                         const void* lbf, const void* nodes_i, const void* nodes_f,
                         const void* cartf, const void* wts, const void* mean_shape, int T,
                         int K, int depth, int L2, int split, int rounding, void* score,
                         void* nvis, void* alive, void* shape, void* reach, void* nvis_img,
                         void* counters, void* stream, int* launched) {
  using namespace tail;
  if (launched) *launched = 0;
  if (T < 1 || K < 1 || L2 < 2 || N < 0 || depth < 2 || depth > kLbfBits + 1 ||
      (split && (split % 32 || split >= K)))
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
  walk_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (launched) *launched = 1;
  return 0;
}
