// Dense stage-0 filter of the JDA cascade over a batch of images, for Hopper
// (sm_90a): the whole window ladder, or one scan scale, in two launches.
//
// Replaces the three TPU kernels of jda_tpu/ops/dense0.py that compute this
// function on the fused detection path, one scan scale per call:
//   _scale_filter_pallas_resident  (dense0.py:833)
//   _scale_filter_pallas_rolled    (dense0.py:1063)
//   _scale_filter_pallas_tiled     (dense0.py:1253)
// They differ only in how the image's phase planes fit the TPU's VMEM; on the
// card they are one function, and one call serves every scale of the ladder.
//
// What it computes, what bounds it and the design are those of the shared walk
// (csrc/dense0_walk.cuh): for every window of the [B, n] ladder score, alive
// and nvis of the K stage-0 carts and, with lbf != nullptr, the packed leaf
// words of the windows that stay alive (the fused tail reads survivors' words
// only, so the other rows of the [B, n, nw] tensor are never written: 272 B
// per survivor at K=540, where writing every row of a VGA batch of 16 would be
// 0.74 GB).  This file is the batch entry: B images, S scales (S = 1 serves
// the per-scale wrapper), optional leaf words.
//
// What bounds it on this card: no longer one thread's serial walk through all
// K carts per launch (the first version paid that once per scale, 14 times per
// VGA batch).  The head phase is bound by the instruction rate of warps that
// run as long as their longest-living lane, up to C carts, with tables in shared
// memory; the survivor phase by three dependent loads per 32 carts and three
// dependent float ops per cart, one warp per window, warps taking windows from
// a queue until it is empty.

#include "dense0_walk.cuh"

// All pointers but recs_host are device pointers; lbf may be null.  `phases`
// is 1 (head), 2 (survivors, from the queue, counters and scores it is given)
// or 3 (both).  counters must be zero at entry of the head phase.  Returns
// cudaGetLastError() after the launches (0 on success) and the number of
// kernels launched in *launched.  Launches on `stream`, does not synchronise.
extern "C" int dense0_filter(const void* img, int B, int H, int W, const void* recs,
                             const int* recs_host, int S, const void* nodes,
                             const void* tabf, int K, int depth, int n, int head,
                             void* score, void* alive, void* nvis, void* lbf,
                             void* queue, void* counters, int phases, void* stream,
                             int* launched) {
  dense0::Walk a;
  a.img = (const uint8_t*)img;
  a.B = B;
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
  a.lbf = (int*)lbf;
  a.queue = (int*)queue;
  a.counters = (int*)counters;
  return dense0::launch(a, recs_host, phases, (cudaStream_t)stream, launched);
}
