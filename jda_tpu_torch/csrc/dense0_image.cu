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
// What it computes is the shared walk (csrc/dense0_walk.cuh) at B = 1 without
// leaf words (the TPU kernel has none): flat score, alive and nvis [n], index
// i being window i of the enumeration.  Only the node offsets depend on the
// scale (they hold step and W); leaf scores, mean, std and cart_th are shared,
// so there is one tabf and a [S, K, node_n] node table.
//
// What bounds it.  By bytes: the image once (0.3 MB for VGA), the tables
// (S*K*node_n*16 B, 0.85 MB for the VGA ladder) and 9 B per window (1.5 MB for
// VGA's 169,706 windows): under a microsecond at 3.35 TB/s.  By operations:
// sixteen per visited cart, a few million visits: the same order.  In practice
// neither.  The first version lasted as long as one thread's serial walk
// through the K carts, a chain of dependent table and pixel loads.  With the
// shared walk the head phase (every window, the first C carts, tables in
// shared memory) is short, and the image's few hundred long-lived windows go
// one to a warp: a call lasts about as long as one warp's walk, ceil((K-C)/32)
// rounds of three dependent loads plus K-C float chain steps.

#include "dense0_walk.cuh"

// All pointers but recs_host are device pointers.  `phases` is 1 (head), 2
// (survivors, from the queue, counters and scores it is given) or 3 (both), as
// for dense0_filter.  counters must be zero at entry of the head phase.  Returns
// cudaGetLastError() after the launches (0 on success) and the number of kernels
// launched in *launched.  Launches on `stream`, does not synchronise.
extern "C" int dense0_image(const void* img, int H, int W, const void* recs,
                            const int* recs_host, int S, const void* nodes,
                            const void* tabf, int K, int depth, int n, int head,
                            void* score, void* alive, void* nvis, void* queue,
                            void* counters, int phases, void* stream,
                            int* launched) {
  dense0::Walk a;
  a.img = (const uint8_t*)img;
  a.B = 1;
  a.plane = (long long)H * W;
  a.W = W;
  a.recs = (const int4*)recs;
  a.S = S;
  a.nodes = (const int4*)nodes;
  a.tabf = (const float*)tabf;
  a.K = K;
  a.depth = depth;
  a.n = n;
  a.head = head;
  a.score = (float*)score;
  a.alive = (bool*)alive;
  a.nvis = (int*)nvis;
  a.lbf = nullptr;
  a.queue = (int*)queue;
  a.counters = (int*)counters;
  return dense0::launch(a, recs_host, phases, (cudaStream_t)stream, launched);
}
