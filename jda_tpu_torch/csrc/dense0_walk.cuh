// The stage-0 walk of the JDA cascade over a ladder of scan scales, for Hopper
// (sm_90a): the device code shared by dense0_filter (csrc/dense0.cu, a batch
// of images, optional leaf words) and dense0_image (csrc/dense0_image.cu, one
// image).  Together they replace the four TPU kernels of
// jda_tpu/ops/dense0.py (_scale_filter_pallas :592, _resident :833, _rolled
// :1063, _tiled :1253), which compute this function one scan scale at a time.
//
// What it computes.  The ladder has S scan scales; scale s has an ny x nx grid
// of windows of one size, origins at (iy*step, ix*step), and its windows take
// the indices [first, first + ny*nx) of the reference's enumeration order (win
// outer, y middle, x inner; jda.c:331-339).  For every window of every image
// of the [B, H, W] batch the K stage-0 carts run from the mean shape: each
// visited node compares
//   img[b, iy*step + yr1, ix*step + xr1] - img[b, iy*step + yr2, ix*step + xr2]
// (int32) against its threshold; (yr, xr) depend on (scale, cart, node, point)
// only, so the host passes them as flat offsets yr*W + xr.  The path picks a
// leaf, then
//   score = (score + leaf - mean) / std;  nvis += 1;  alive = score >= cart_th
// in float32, rounded to nearest at each op, in that order (jda.c:395-399).  A
// window stops at the cart that rejects it, so its score is frozen there.
// Outputs are flat [B, n]: entry (b, i) is window i of the enumeration.  With
// lbf != nullptr the leaf indices of a window that stays alive are packed 4
// bits per cart, cart k at nibble k%8 of word k/8 of its [nw] words.
//
// What bounds it.  Neither bytes (the images once, 9 B per window and 4*nw B
// per survivor: ~32 MB and ~10 us for a VGA batch of 16) nor operations
// (sixteen per visited cart: ~12 us for its 52 M visits at the fp32 rate).  A
// window's walk is a chain of dependent loads (per cart three node steps, each
// a table entry and then two pixels addressed by it) and of three dependent
// float32 ops, and windows live very unequally long: 19 carts on average, one
// window in 500 all K.  One thread per window for the whole walk makes every
// launch last one thread's K-cart chain, with all but a few lanes dead.
//
// Design: two phases, two launches, no host synchronisation between them.
//   Head: one thread per window, carts [0, C) only.  A block's windows are of
//   one scale (each scale's B*ny*nx windows are padded to whole blocks), and
//   the block first copies that scale's C*node_n node entries and the C rows
//   of float tables into shared memory, so every table read of the head has
//   shared-memory latency.  Pixels come from global memory through L1/L2.
//   Every window's state at the end of the head (score, alive, nvis) goes to
//   the outputs; a window that is still alive and has work left appends its
//   index to a queue in global memory (one atomicAdd per warp).
//   Survivors: one warp per queued window, fetched from the queue by an atomic
//   ticket, 32 carts per round.  A cart's leaf depends on the pixels only, not
//   on the score, so lane j descends cart c0 + j and loads its leaf score,
//   mean, std and threshold: the three dependent load steps are paid once per
//   32 carts.  The lanes stage those four floats in shared memory and the warp
//   then runs the float chain in cart order, four carts between two looks at
//   the reject, and stops at the first reject; leaves past it are thrown away.
//   Leaf words come from the same leaves, 8 lanes to a word by shuffles; with
//   leaf words wanted the rounds start at cart 0 (the head keeps none), the
//   chain still at cart C.  The queue's order is free: results go to the
//   window's own index, so outputs are deterministic.
// What bounds the new design: per round of a survivor the latency of three
// dependent loads, and per cart three dependent float ops (the IEEE divide
// being most of it); in the head, the instruction rate of a warp that runs
// as long as its longest-living lane, up to C carts.  C = 32 is the optimum
// on an H100 for the bench model (10 % of the windows reach cart 32): a
// shorter head queues too many windows that die within their first round, a
// longer one keeps warps running for one or two live lanes.
// Tried on the card and dropped, each bit-equal and none faster: 8 or 16 lanes
// to a window (a warp walking 4 or 2 windows in lockstep); a head that
// compacts its block's live windows in shared memory after 8, 16, 32, ...
// carts; tickets and queue entries fetched a window ahead; leaf words by a
// second descent of the windows that stay alive only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_step.cuh"

namespace dense0 {

constexpr int kThreads = 256;  // per block, both phases; also the most scales
constexpr int kWarps = kThreads / 32;
constexpr int kLbfBits = 4;
constexpr int kLbfPerWord = 32 / kLbfBits;
constexpr unsigned kFull = 0xffffffffu;

struct Walk {
  const uint8_t* img;  // [B, H, W]
  int B;
  long long plane;     // H * W
  int W;
  const int4* recs;    // [S]: first, nx, step, ny
  int S;
  const int4* nodes;   // [S, K, node_n]: off1, off2, th, 0
  const float* tabf;   // [K, leaf_n + 3]: leaf scores, mean, std, cart_th
  int K;
  int depth;
  int n;               // windows per image
  int head;            // C: carts of the head phase, >= 1
  float* score;        // [B, n]
  bool* alive;         // [B, n]
  int* nvis;           // [B, n]
  int* lbf;            // [B, n, nw] or null
  int* queue;          // [B * n] scratch: flat index b*n + i of each survivor
  int* counters;       // [2], zero at entry: queue length, next ticket
};

// One cart's descent from the window origin p; returns the leaf index.
__device__ __forceinline__ int descend(const uint8_t* __restrict__ p,
                                       const int4* __restrict__ cart, int depth,
                                       int node_n) {
  int node = 0;
  for (int d = 0; d < depth - 1; ++d) {
    const int4 e = cart[node];
    const int v = (int)__ldg(p + e.x) - (int)__ldg(p + e.y);
    node = 2 * node + 1 + (v > e.z ? 1 : 0);
  }
  return node - node_n;
}

using jda::score_step;

__global__ void __launch_bounds__(kThreads) head_kernel(const Walk a) {
  extern __shared__ int4 sm_nodes[];  // [C, node_n], then the float rows [C, nf]
  __shared__ int sm_blocks[kThreads];
  const int tid = threadIdx.x;
  const int node_n = (1 << (a.depth - 1)) - 1;
  const int nf = node_n + 4;
  const int C = min(a.head, a.K);
  float* sm_f = reinterpret_cast<float*>(sm_nodes + C * node_n);

  // which scale this block serves: every scale's windows fill whole blocks
  int mine = 0;
  if (tid < a.S) {
    const int4 r = __ldg(a.recs + tid);
    mine = (a.B * r.y * r.w + kThreads - 1) / kThreads;
  }
  sm_blocks[tid] = mine;
  __syncthreads();
  int s = 0, block0 = 0;
  while (s + 1 < a.S && (int)blockIdx.x >= block0 + sm_blocks[s]) block0 += sm_blocks[s++];
  const int4 rec = __ldg(a.recs + s);

  const int4* sn = a.nodes + (long long)s * a.K * node_n;
  for (int t = tid; t < C * node_n; t += kThreads) sm_nodes[t] = __ldg(sn + t);
  for (int t = tid; t < C * nf; t += kThreads) sm_f[t] = __ldg(a.tabf + t);
  __syncthreads();

  const int cnt = rec.y * rec.w;
  const int j = ((int)blockIdx.x - block0) * kThreads + tid;
  bool enqueue = false;
  int widx = 0;
  if (j < a.B * cnt) {
    const int b = j / cnt;
    const int local = j - b * cnt;
    const int iy = local / rec.y;
    const int ix = local - iy * rec.y;
    const uint8_t* p = a.img + b * a.plane + ((long long)iy * a.W + ix) * rec.z;
    float sc = 0.f;
    int k = 0;
    bool al = true;
    for (; k < C && al; ++k) {
      const int leaf = descend(p, sm_nodes + k * node_n, a.depth, node_n);
      const float* cf = sm_f + k * nf;
      sc = score_step(sc, cf[leaf], cf[node_n + 1], cf[node_n + 2]);
      al = sc >= cf[node_n + 3];
    }
    widx = b * a.n + rec.x + local;
    a.score[widx] = sc;
    a.alive[widx] = al;
    a.nvis[widx] = k;
    enqueue = al && (C < a.K || a.lbf != nullptr);
  }
  // one atomicAdd per warp for its survivors' queue slots
  const unsigned m = __ballot_sync(kFull, enqueue);
  if (m) {
    const int lane = tid & 31;
    int base = 0;
    if (lane == __ffs(m) - 1) base = atomicAdd(a.counters, __popc(m));
    base = __shfl_sync(kFull, base, __ffs(m) - 1);
    if (enqueue) a.queue[base + __popc(m & ((1u << lane) - 1))] = widx;
  }
}

__global__ void __launch_bounds__(kThreads) survivor_kernel(const Walk a) {
  __shared__ float4 sm_cart[kWarps][32];  // leaf score, mean, std, cart_th per lane's cart
  const int lane = threadIdx.x & 31;
  float4* mine = sm_cart[threadIdx.x >> 5];
  const int node_n = (1 << (a.depth - 1)) - 1;
  const int nf = node_n + 4;
  const int C = min(a.head, a.K);
  const int nw = (a.K + kLbfPerWord - 1) / kLbfPerWord;
  const int qlen = a.counters[0];
  for (;;) {
    int ticket = 0;
    if (lane == 0) ticket = atomicAdd(a.counters + 1, 1);
    ticket = __shfl_sync(kFull, ticket, 0);
    if (ticket >= qlen) break;
    const int widx = a.queue[ticket];
    const int b = widx / a.n;
    const int i = widx - b * a.n;
    // the window's scale: the last record whose first index is <= i
    int s = -1;
    for (int s0 = 0; s0 < a.S; s0 += 32) {
      const bool below = s0 + lane < a.S && __ldg(a.recs + s0 + lane).x <= i;
      s += __popc(__ballot_sync(kFull, below));
    }
    const int4 rec = __ldg(a.recs + s);
    const int local = i - rec.x;
    const int iy = local / rec.y;
    const int ix = local - iy * rec.y;
    const uint8_t* p = a.img + b * a.plane + ((long long)iy * a.W + ix) * rec.z;
    const int4* sn = a.nodes + (long long)s * a.K * node_n;
    int* words = a.lbf ? a.lbf + (long long)widx * nw : nullptr;

    float sc = a.score[widx];  // the head's state at cart C
    int nv = C;
    bool al = true;
    for (int c0 = words ? 0 : C; c0 < a.K && al; c0 += 32) {
      const int k = c0 + lane;
      int leaf = 0;
      float4 f = make_float4(0.f, 0.f, 1.f, 0.f);
      if (k < a.K) {
        leaf = descend(p, sn + (long long)k * node_n, a.depth, node_n);
        const float* cf = a.tabf + (long long)k * nf;
        f = make_float4(__ldg(cf + leaf), __ldg(cf + node_n + 1), __ldg(cf + node_n + 2),
                        __ldg(cf + node_n + 3));
      }
      if (words) {  // c0 is a multiple of 32 here: 8 lanes make one word
        unsigned w = (unsigned)leaf << (kLbfBits * (lane % kLbfPerWord));
        w |= __shfl_xor_sync(kFull, w, 1);
        w |= __shfl_xor_sync(kFull, w, 2);
        w |= __shfl_xor_sync(kFull, w, 4);
        if (lane % kLbfPerWord == 0 && k < a.K) words[k / kLbfPerWord] = (int)w;
      }
      mine[lane] = f;
      __syncwarp();
      // the chain over carts [jbeg, jend) of this round, four carts between two
      // looks at the reject: no branch and no load stands inside the chain of
      // dependent float ops, and what a divide does to its divisor alone runs ahead
      const int jbeg = max(C - c0, 0);
      const int jend = min(32, a.K - c0);
      for (int j0 = jbeg & ~3; j0 < jend && al; j0 += 4) {
        float4 g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = mine[j0 + i];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool v = al && j0 + i >= jbeg && j0 + i < jend;
          const float t = score_step(sc, g[i].x, g[i].y, g[i].z);
          sc = v ? t : sc;
          nv += v;
          al = v ? t >= g[i].w : al;
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      a.score[widx] = sc;
      a.alive[widx] = al;
      a.nvis[widx] = nv;
    }
  }
}

enum Phase { kHead = 1, kSurvivors = 2 };

// Launch the phases named in `phases` on `stream`; recs_host is the host's
// copy of the S records.  Returns cudaGetLastError() (0 on success) and does
// not synchronise.  `launched`, where not null, receives the kernels launched.
inline int launch(const Walk& a, const int* recs_host, int phases, cudaStream_t stream,
                  int* launched) {
  int count = 0;
  if (launched) *launched = 0;
  if (a.S < 1 || a.S > kThreads || a.head < 1 || a.depth < 2 || a.depth > kLbfBits + 1)
    return (int)cudaErrorInvalidValue;
  const int node_n = (1 << (a.depth - 1)) - 1;
  const int C = a.head < a.K ? a.head : a.K;
  if (phases & kHead) {
    long long blocks = 0;
    for (int s = 0; s < a.S; ++s) {
      const long long cnt = (long long)a.B * recs_host[4 * s + 1] * recs_host[4 * s + 3];
      blocks += (cnt + kThreads - 1) / kThreads;
    }
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)C * (node_n * sizeof(int4) + (node_n + 4) * sizeof(float));
    if (smem > 47 * 1024) return (int)cudaErrorInvalidValue;  // beside 1 KB of static
    if (blocks > 0) {
      head_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
      ++count;
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (phases & kSurvivors) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
    // enough warps to fill the card; a warp takes windows until the queue is empty
    const long long total = (long long)a.B * a.n;
    long long blocks = (total + kWarps - 1) / kWarps;
    if (blocks > 8LL * sms) blocks = 8LL * sms;
    if (blocks > 0) {
      survivor_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(a);
      ++count;
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (launched) *launched = count;
  return 0;
}

}  // namespace dense0
