"""The joint-cascade trainer: RealBoost + joint classification/regression.

PyTorch counterpart of the JAX package's train/boost.py, after the
reference's JoinCascador::Train / BoostCart::Train / Cart::Train
(cascador.cpp:33-55, btcart.cpp:120-317, cart.cpp:41-162).  The
orchestration (stage and cart loops, the node DFS, restarts, thresholds,
snapshots) runs on the host over numpy state; every hot operation runs on
the trainer's device:

  * feature matrices: train/features.py (gathers from the resident corpus)
  * split search:     train/split.py (scatter-add histograms, reductions)
  * corpus forward:   ops/cascade.py (the detection tail: corpora ARE
                      window batches)
  * global regression: train/regression.py (normal equations, Cholesky)
  * hard-negative validation: the partial cascade over mined windows
    (train/mining.py screens them on the device)

Determinism: one np.random.Generator drives pool sampling, coin flips,
percentiles and mining shifts, drawn in the JAX package's order and sizes,
so that both packages train the same model from the same seed.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from jda_tpu_torch.config import Config
from jda_tpu_torch.data import DataSet, NegGenerator, st_apply, st_identity
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.params import CascadeParams, save_model
from jda_tpu_torch.train import features as FT
from jda_tpu_torch.train import regression as RG
from jda_tpu_torch.train import split as SP
from jda_tpu_torch.utils import calc_mean_error, draw_density_graph, log, resolve_device

Tensor = torch.Tensor


def empty_model(c: Config) -> CascadeParams:
    """All-zero cascade with training cursor at (0, -1)."""
    T, K, L = c.T, c.K, c.landmark_n
    node_n, leaf_n = c.node_n, c.leaf_n
    return CascadeParams(
        T=T,
        K=K,
        landmark_n=L,
        tree_depth=c.tree_depth,
        stage_idx=0,
        cart_idx=-1,
        mean_shape=np.zeros(2 * L),
        scale=np.zeros((T, K, node_n), np.int32),
        lmk1=np.zeros((T, K, node_n), np.int32),
        lmk2=np.zeros((T, K, node_n), np.int32),
        off1=np.zeros((T, K, node_n, 2)),
        off2=np.zeros((T, K, node_n, 2)),
        feat_th=np.full((T, K, node_n), -256, np.int32),
        leaf_scores=np.zeros((T, K, leaf_n)),
        cart_th=np.full((T, K), -1e30),
        mean=np.zeros((T, K)),
        std=np.ones((T, K)),
        W=np.zeros((T, K * leaf_n, 2 * L)),
    )


class Trainer:
    """Joint cascade trainer (the `jda train` / `jda resume` workloads).
    Runs on CUDA unless given `device`; `mesh=` (multi-device training) is
    not ported yet."""

    def __init__(
        self,
        c: Config,
        model: Optional[CascadeParams] = None,
        mesh=None,
        device: Union[str, torch.device, None] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device training) is not ported yet (ROADMAP A.12)"
            )
        self.device = resolve_device(device)
        self.c = c
        self.model = model if model is not None else empty_model(c)
        self.rng = np.random.default_rng(c.seed)
        self.pos = DataSet(c, is_pos=True, device=self.device)
        self.neg = DataSet(c, is_pos=False, device=self.device)
        self.neg_gen = NegGenerator(c)
        self.single_scale = not c.multi_scale
        self.mining_max_batches = 2000
        self.mining_batch = 2048  # windows per validation batch
        # mining-exhaustion economics: a mining event that nets fewer than
        # dry_yield_frac * want negatives counts as "dry" (0.0 = only a
        # fully-empty event does, the reference-like behaviour); two
        # consecutive dry events finish the stage with pass-through carts
        # (data.cpp:913-925 would spin forever instead)
        self.dry_yield_frac = 0.0
        self._last_want = 0
        self._miner = None  # lazy DeviceMiner (train/mining.py)
        self.verbose = False  # per-cart score-density graphs (btcart.cpp:19-102)
        self.snapshot_dir: Optional[str] = None
        # per-stage summaries, per-cart seconds, per-node split seconds and
        # per-mining-event statistics (read by chip_smoke.py)
        self.stats: Dict = {"stages": [], "carts": [], "nodes": [], "mining": []}

    # -- data plumbing --------------------------------------------------------

    def load_data(self) -> None:
        """train() data path (src/train.cpp:26-36 without the cache)."""
        self.pos.load_positive(self.c.face_txt, self.rng)
        self.neg_gen.load(self.c.bg_txts, self.rng)
        self.model.mean_shape = self.pos.mean_shape.copy()

    def set_synthetic_data(
        self,
        pos_rows: np.ndarray,  # [N, D] uint8 corpus rows
        gt_shapes: np.ndarray,  # [N, 2L]
        neg_images: List[np.ndarray],
        shape_mask: Optional[np.ndarray] = None,
        neg_factory: Optional[Callable[[int], np.ndarray]] = None,
    ) -> None:
        """Inject an in-memory corpus (tests, embedding)."""
        p = self.pos
        n = len(pos_rows)
        p.imgs = pos_rows.astype(np.uint8)
        p.gt_shapes = gt_shapes.astype(np.float64)
        p.shape_mask = (
            shape_mask.astype(np.int32)
            if shape_mask is not None
            else np.ones(n, np.int32)
        )
        p.scores = np.zeros(n)
        p.last_scores = np.zeros(n)
        p.weights = np.zeros(n)
        p.calc_mean_shape()
        p.current_shapes = p.random_shapes(self.rng)
        p.stp_mc = st_identity(n)
        p.stp_cm = st_identity(n)
        p.live = np.ones(n, bool)
        p.invalidate()
        if neg_factory is not None:
            self.neg_gen.load_factory(neg_factory, self.rng)
        else:
            self.neg_gen.load_images(neg_images, self.rng)
        self.model.mean_shape = p.mean_shape.copy()

    # -- device helpers -------------------------------------------------------

    def _tensor(self, a: np.ndarray, dtype=None) -> Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=self.device)

    def _model_chunk(self, t: int, k0: int, k1: int) -> Dict[str, Tensor]:
        """Carts [k0, k1) of stage t on the device, float fields rounded
        through float32 as the JAX package's chunks are."""
        m = self.model
        ints = ("scale", "lmk1", "lmk2", "feat_th")
        floats = ("off1", "off2", "leaf_scores", "cart_th", "mean", "std")
        out = {f: self._tensor(getattr(m, f)[t, k0:k1], np.int32) for f in ints}
        out.update(
            {f: self._tensor(getattr(m, f)[t, k0:k1], np.float32) for f in floats}
        )
        return out

    def _geometry(self, ds: DataSet, idx: Tensor) -> Dict[str, Tensor]:
        """(base, stride, pw, ph) [m, 3] of corpus rows `idx` in ds.flat_dev()."""
        g = FT.corpus_geometry(1, ds.dims)
        dims = self._tensor(g["stride"][0], np.int32)[None, :].expand(len(idx), 3)
        base = idx[:, None] * ds.D + self._tensor(g["base"][0], np.int64)[None, :]
        return {"base": base, "stride": dims, "pw": dims, "ph": dims}

    def _values(self, ds: DataSet, idx: Tensor, pool: Dict[str, Tensor]) -> Tensor:
        """[m, F] feature values of pool on corpus rows idx."""
        shapes = ds.shapes_dev()[idx]
        stp = ds.stp_dev()
        stp = stp[idx] if stp is not None else None
        if self.single_scale:
            return FT.feature_values_mxu(ds.canvas_dev()[idx], shapes, pool, stp)
        return FT.feature_values(ds.flat_dev(), self._geometry(ds, idx), shapes, pool, stp)

    def _descend(self, ds: DataSet, idx: np.ndarray, t: int, k0: int, k1: int):
        """Host (leaves [m, C], leaf scores [m, C]) of carts [k0, k1) on
        corpus rows idx: the detection tail's descent, C++ rounding."""
        it = self._tensor(idx, np.int64)
        state = {"shape": ds.shapes_dev()[it], **self._geometry(ds, it)}
        stp = ds.stp_dev()
        leaves, b = C.carts_descend(
            self._model_chunk(t, k0, k1),
            ds.flat_dev(),
            state,
            depth=self.c.tree_depth,
            rounding=True,  # C++ training semantics (data.cpp:48-51)
            single_scale=self.single_scale,
            stp=stp[it] if stp is not None else None,
        )
        return leaves.cpu().numpy(), b.cpu().numpy()

    # -- cart training (Cart::Train + SplitNode DFS, cart.cpp:41-162) ----------

    def _draw_cart_params(self, t: int):
        """Per-node random draws for one cart, in heap order (node 1..7):
        feature pool, split-type coin, regression percentile vector.  The
        reference draws these lazily during its DFS (cart.cpp:60-77); the
        JAX package draws them up front, and so does this port, so that
        both consume the generator identically."""
        c = self.c
        node_n = (1 << (c.tree_depth - 1)) - 1
        pools = []
        clsflags = np.zeros(node_n, bool)
        us = np.zeros((node_n, c.feats[t]), np.float32)
        for ni in range(node_n):
            pools.append(
                FT.gen_feature_pool(
                    self.rng, c.feats[t], c.landmark_n, c.radius[t], c.multi_scale
                )
            )
            clsflags[ni] = self.rng.uniform() < c.probs[t]
            if not clsflags[ni]:
                us[ni] = self.rng.uniform(0.1, 0.9, c.feats[t]).astype(np.float32)
        return pools, clsflags, us

    def train_cart(self, t: int, k: int) -> None:
        """One cart: the node DFS over the live rows, each node's rows an
        index list on the device.  Every sum feeding a split is exact
        (split.py), so the subsets give the JAX package's decisions on both
        of its paths (the whole-corpus masks of _cart_fused_jit and the
        recursion over index subsets).  Leaf scores are computed on the host
        in float64 from the leaf assignments (cart.cpp:164-174)."""
        c = self.c
        landmark_id = k % c.landmark_n
        leaf_base = 1 << (c.tree_depth - 1)
        pos, neg = self.pos, self.neg
        pools, clsflags, us = self._draw_cart_params(t)
        wp = self._tensor(pos.weights, np.float32)
        wn = self._tensor(neg.weights, np.float32)
        resid = self._tensor(
            pos.shape_residual(np.arange(len(pos.imgs)), landmark_id), np.float32
        )
        has_gt = self._tensor(pos.shape_mask == 1)
        rows_p = {1: self._tensor(pos.live_idx(), np.int64)}
        rows_n = {1: self._tensor(neg.live_idx(), np.int64)}
        m = self.model
        for node in range(1, leaf_base):
            t0 = time.perf_counter()
            ip, ineg = rows_p.pop(node), rows_n.pop(node)
            pool = pools[node - 1]
            pool_dev = pool.device(self.device)
            vp = self._values(pos, ip, pool_dev)
            vn = self._values(neg, ineg, pool_dev)
            if len(ip) == 0 and len(ineg) == 0:
                f_idx, th = 0, -256
            else:
                ones_p = torch.ones(len(ip), dtype=torch.bool, device=self.device)
                if clsflags[node - 1]:
                    ones_n = torch.ones(len(ineg), dtype=torch.bool, device=self.device)
                    f, thd, _ = SP.classification_split(
                        vp, wp[ip], ones_p, vn, wn[ineg], ones_n
                    )
                else:
                    f, thd, _ = SP.regression_split(
                        vp, resid[ip], has_gt[ip], ones_p, self._tensor(us[node - 1])
                    )
                f_idx, th = int(f), int(thd)
            ni = node - 1  # heap index 1..7 -> storage 0..6
            sc, l1, l2, o1, o2 = pool.select(f_idx)
            m.scale[t, k, ni] = sc
            m.lmk1[t, k, ni] = l1
            m.lmk2[t, k, ni] = l2
            m.off1[t, k, ni] = o1
            m.off2[t, k, ni] = o2
            m.feat_th[t, k, ni] = th
            left_p = vp[:, f_idx] <= th
            left_n = vn[:, f_idx] <= th
            rows_p[2 * node], rows_p[2 * node + 1] = ip[left_p], ip[~left_p]
            rows_n[2 * node], rows_n[2 * node + 1] = ineg[left_n], ineg[~left_n]
            self.stats["nodes"].append(time.perf_counter() - t0)
        # exact f64 leaf scores from the leaf assignments (cart.cpp:164-174)
        for li in range(leaf_base):
            ip = rows_p[leaf_base + li].cpu().numpy()
            ineg = rows_n[leaf_base + li].cpu().numpy()
            pw = c.esp + pos.weights[ip].sum()
            nw = c.esp + neg.weights[ineg].sum()
            m.leaf_scores[t, k, li] = 0.5 * (np.log(pw) - np.log(nw))

    # -- incremental scoring / LBF ---------------------------------------------

    def update_scores(self, ds: DataSet, t: int, k: int) -> None:
        """DataSet::UpdateScores (data.cpp:305-317), live rows only."""
        ds.last_scores = ds.scores.copy()
        if ds.size == 0:
            return
        idx = ds.live_idx()
        _, b = self._descend(ds, idx, t, k, k + 1)
        ds.scores[idx] += b[:, 0].astype(np.float64)

    def gen_lbf(self, ds: DataSet, t: int) -> np.ndarray:
        """BoostCart::GenLBF over live rows: [size, K] global leaf ids."""
        leaves, _ = self._descend(ds, ds.live_idx(), t, 0, self.c.K)
        return leaves + np.arange(self.c.K, dtype=np.int32)[None, :] * self.c.leaf_n

    # -- mining validation (JoinCascador::Validate, cascador.cpp:166-211) ------

    def make_validator(self, stage: int, cart: int) -> Callable:
        """Partial-cascade batch validator for hard-negative mining.
        `stage` full stages are complete; carts [0..cart] of stage `stage`
        are trained (cart == -1 -> none yet).  The JAX package pads the
        partial stage with no-op carts to a bucketed count so that XLA does
        not recompile; the port runs the true count (the padding changes
        only the visit counts of windows that survive, which mining never
        reads)."""
        c = self.c
        dims = (c.img_o_size, c.img_h_size, c.img_q_size)
        ms = self.model.mean_shape.astype(np.float32)
        ms_dev = self._tensor(ms)
        full_chunks = [self._model_chunk(tt, 0, c.K) for tt in range(stage)]
        w_devs = [self._tensor(self.model.W[tt], np.float32) for tt in range(stage)]
        part_chunk = self._model_chunk(stage, 0, cart + 1) if cart >= 0 else None
        geom_cache: Dict[int, Dict[str, Tensor]] = {}

        def validate_dev(flat_dev: Tensor, shapes_dev: Tensor, valid_dev: Tensor, b: int):
            """Device core: flat corpus rows, initial shapes and validity
            already on the device; returns the device state.  The device
            miner calls it directly on windows it synthesized there."""
            if b not in geom_cache:
                g = FT.corpus_geometry(b, dims)
                geom_cache[b] = {k: self._tensor(v) for k, v in g.items()}
            geom = geom_cache[b]
            state = C.init_state(
                b, ms_dev, geom["base"], geom["stride"], geom["pw"], geom["ph"], valid_dev
            )
            state["shape"] = shapes_dev
            with_stp = c.with_similarity_transform
            kw = dict(depth=c.tree_depth, rounding=True, single_scale=self.single_scale)
            for tt in range(stage):
                # per-stage similarity transform from the CURRENT shapes
                # (cascador.cpp:180, applied at :184 and :196)
                stp = C.st_calc_dev(state["shape"], ms_dev) if with_stp else None
                state, leaves = C.run_cart_chunk(full_chunks[tt], flat_dev, state, stp=stp, **kw)
                state = C.apply_regression(
                    w_devs[tt], leaves, state, leaf_n=c.leaf_n, exact=True, stp=stp
                )
            if part_chunk is not None:
                stp = C.st_calc_dev(state["shape"], ms_dev) if with_stp else None
                state, _ = C.run_cart_chunk(part_chunk, flat_dev, state, stp=stp, **kw)
            return state

        def validate(rows: np.ndarray, shift: Optional[np.ndarray] = None):
            m = len(rows)
            flat_dev = self._tensor(rows, np.uint8).view(-1)
            if shift is None:
                shift = self.rng.uniform(-c.shift_size, c.shift_size, (m, 2))
            shapes = np.tile(ms, (m, 1)).astype(np.float32)
            shapes[:, 0::2] += shift[:, 0:1].astype(np.float32)
            shapes[:, 1::2] += shift[:, 1:2].astype(np.float32)
            state = validate_dev(
                flat_dev,
                self._tensor(shapes),
                torch.ones(m, dtype=torch.bool, device=self.device),
                m,
            )
            return (
                state["alive"].cpu().numpy(),
                state["score"].cpu().numpy().astype(np.float64),
                state["shape"].cpu().numpy().astype(np.float64),
                state["nvis"].cpu().numpy(),
            )

        validate.validate_dev = validate_dev
        validate.ms_dev = ms_dev
        return validate

    def more_neg_samples(self, t: int, k: int) -> int:
        """DataSet::MoreNegSamples (data.cpp:479-532).  Returns the number
        of negatives actually mined (-1 when none were needed)."""
        c = self.c
        want = int(c.nps[t] * self.pos.size) - self.neg.size
        if want <= 0:
            return -1
        self._last_want = want
        log(f"mining {want} hard negatives (stage {t}, cart {k})")
        t0 = time.time()
        validator = self.make_validator(t, k - 1)
        # read at call time, as the JAX package does; the miner screens
        # only once the hard pool is drained (DeviceMiner.applicable)
        use_dev = os.environ.get("JDA_TPU_DEVICE_MINER", "1") != "0"
        if use_dev:
            if self._miner is None:
                from jda_tpu_torch.train.mining import DeviceMiner

                self._miner = DeviceMiner(
                    self.neg_gen,
                    c,
                    per_state=max(self.mining_batch // self.neg_gen.n_states, 64),
                    device=self.device,
                )
            use_dev = self._miner.applicable
        if use_dev:
            rows, scores, shapes, stats = self._miner.generate(
                validator, want, max_batches=self.mining_max_batches, rng=self.rng
            )
        else:
            rows, scores, shapes, stats = self.neg_gen.generate(
                validator,
                want,
                batch=self.mining_batch,
                max_batches=self.mining_max_batches,
            )
        if len(rows):
            self.neg.append_negatives(rows, scores, shapes, self.model.mean_shape)
        stats = dict(stats, stage=t, cart=k, want=want, mined=len(rows),
                     seconds=time.time() - t0, device_miner=use_dev)
        self.stats["mining"].append(stats)
        log(
            f"mined {len(rows)} in {stats['seconds']:.1f}s; "
            f"FP={stats['fp_rate']:.6f}, avg reject carts="
            f"{stats['avg_reject_carts']:.2f}"
            + (" [background pool exhausted]" if stats["exhausted"] else "")
        )
        return len(rows)

    # -- stage training (BoostCart::Train, btcart.cpp:120-317) -----------------

    def _normalize(self, t: int, k: int, kk: int, normalization_step: int) -> None:
        pos, neg = self.pos, self.neg
        if kk % normalization_step == 0:
            mean, std = DataSet.calc_mean_std(pos, neg)
            self.model.mean[t, k] = mean
            self.model.std[t, k] = std
            pos.apply_mean_std(mean, std)
            neg.apply_mean_std(mean, std)
        else:
            self.model.mean[t, k] = 0.0
            self.model.std[t, k] = 1.0

    def train_stage(self, t: int) -> None:
        c = self.c
        pos, neg = self.pos, self.neg
        pos_original = pos.size
        neg_original = int(pos_original * c.nps[t])
        neg_rejected = 0
        normalization_step = c.landmark_n * c.score_normalization_steps[t]
        drop_n = c.drops[t]
        neg_th = int(pos.size * c.nps[t] * c.mining_th[t])

        start_cart = self.model.cart_idx + 1
        restarts = 0
        best_drop_rate = 0.0
        best_cart_snapshot = None
        dry_minings = 0  # consecutive minings that produced nothing

        k = start_cart
        while k < c.K:
            kk = k + 1
            # max(neg_th, 1): once the pool empties neg_th decays to 0 and
            # `0 < 0` would never re-attempt mining, so the exhaustion
            # early-stop below could never trigger either
            if neg.size < max(neg_th, 1):
                mined = self.more_neg_samples(t, k)
                neg_th = int(neg.size * c.mining_th[t])
                dry = (mined == 0 and neg.size == 0) or (
                    self.dry_yield_frac > 0.0
                    and 0 <= mined < self.dry_yield_frac * self._last_want
                )
                dry_minings = dry_minings + 1 if dry else 0
                if dry_minings >= 2:
                    # no hard negatives left: the reference would spin
                    # forever (data.cpp:913-925); finish the stage with
                    # pass-through carts instead
                    log(
                        f"stage {t+1}: hard-negative supply exhausted at "
                        f"cart {kk}/{c.K}; remaining carts are pass-through"
                    )
                    for kr in range(k, c.K):
                        self.model.leaf_scores[t, kr] = 0.0
                        self.model.mean[t, kr] = 0.0
                        self.model.std[t, kr] = 1.0
                        self.model.cart_th[t, kr] = -np.inf
                    self.model.cart_idx = c.K - 1
                    break
            if self.verbose and neg.size:
                print(
                    draw_density_graph(pos.scores[pos.live], neg.scores[neg.live]),
                    flush=True,
                )
            DataSet.update_weights(pos, neg)

            t0 = time.time()
            self.train_cart(t, k)
            self.model.cart_idx = k
            self.update_scores(pos, t, k)
            self.update_scores(neg, t, k)
            self._normalize(t, k, kk, normalization_step)

            th = pos.calc_threshold_by_number(drop_n)
            self.model.cart_th[t, k] = th
            pos_n, neg_n = pos.size, neg.size
            will_remove = neg.pre_remove(th)
            tmp_drop = will_remove / max(neg_n, 1)
            n_carts = t * c.K + k
            if c.restart_on and tmp_drop < c.restart_th[t] and n_carts > 10:
                restarts += 1
                log(
                    f"cart {kk}: drop rate {tmp_drop*100:.3f}% below "
                    f"restart threshold; restart {restarts}"
                )
                if tmp_drop > best_drop_rate:
                    best_drop_rate = tmp_drop
                    best_cart_snapshot = self._cart_params(t, k)
                if restarts >= c.restart_times:
                    # None when every restart had drop rate 0: keep the
                    # last trained cart (the reference would install its
                    # stale pre-loop cart copy, btcart.cpp:134-137)
                    if best_cart_snapshot is not None:
                        self._restore_cart(t, k, best_cart_snapshot)
                    best_drop_rate = 0.0
                    pos.reset_scores()
                    neg.reset_scores()
                    self.update_scores(pos, t, k)
                    self.update_scores(neg, t, k)
                    self._normalize(t, k, kk, normalization_step)
                    # recompute the restored cart's threshold in the new
                    # score distribution so removal drops exactly drop_n
                    # (the reference keeps the stale value; its disabled
                    # assert at btcart.cpp:225 documents the mismatch)
                    self.model.cart_th[t, k] = pos.calc_threshold_by_number(drop_n)
                else:
                    pos.reset_scores()
                    neg.reset_scores()
                    continue  # retrain cart k

            best_drop_rate = 0.0
            restarts = 0
            # clear the kept-cart memory, or a later cart whose restarts all
            # score 0.0% drop would install THIS cart's snapshot (the
            # reference leaks its best_cart that way, btcart.cpp:138,201-208)
            best_cart_snapshot = None
            pos.remove(self.model.cart_th[t, k])
            neg.remove(self.model.cart_th[t, k])
            neg_rejected += neg_n - neg.size
            secs = time.time() - t0
            self.stats["carts"].append({"stage": t, "cart": k, "seconds": secs})
            log(
                f"stage {t+1} cart {kk}/{c.K}: {secs:.2f}s, "
                f"pos {pos.size}, neg {neg.size}, "
                f"neg drop {(neg_n-neg.size)/max(neg_n,1)*100:.2f}%"
            )
            if kk != c.K and kk % c.snapshot_iter == 0:
                self.snapshot()
            k += 1

        # global regression over LBF (btcart.cpp:255-292)
        log(f"stage {t+1}: global shape regression")
        t0 = time.perf_counter()
        pos_live = pos.live_idx()
        neg_live = neg.live_idx()
        pos_lbf = self.gen_lbf(pos, t)
        neg_lbf = self.gen_lbf(neg, t) if neg.size else np.zeros((0, c.K), np.int32)
        lbf_s = time.perf_counter() - t0
        has_gt = pos.shape_mask[pos_live] == 1
        valid = pos_live[has_gt]
        err0 = calc_mean_error(
            pos.gt_shapes[valid], pos.current_shapes[valid], c.left_pupils, c.right_pupils
        )
        resid = pos.shape_residual(valid).astype(np.float32)
        t0 = time.perf_counter()
        W = RG.ridge_lbf(pos_lbf[has_gt], resid, c.lbf_dim, device=self.device)
        ridge_s = time.perf_counter() - t0
        self.model.W[t] = W

        for ds, lbf, lidx in ((pos, pos_lbf, pos_live), (neg, neg_lbf, neg_live)):
            if ds.size == 0:
                continue
            delta = W[lbf].sum(axis=1)  # [size, 2L]
            ds.current_shapes[lidx] += st_apply(ds.stp_mc[lidx], delta)
            ds.invalidate_shapes()  # the device mirror is now stale

        err = calc_mean_error(
            pos.gt_shapes[valid], pos.current_shapes[valid], c.left_pupils, c.right_pupils
        )
        accept = pos.size / max(pos_original, 1)
        reject = neg_rejected / max(neg_rejected + neg_original, 1)
        log(
            f"stage {t+1} done: mean error {err:.4f}, "
            f"accept {accept*100:.2f}%, reject {reject*100:.2f}%"
        )
        self.stats["stages"].append(
            {
                "stage": t,
                "mean_error": float(err),
                "mean_error_before": float(err0),
                "accept": float(accept),
                "gen_lbf_s": lbf_s,
                "ridge_s": ridge_s,
            }
        )

    _CART_FIELDS = (
        "scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores", "cart_th",
    )

    def _cart_params(self, t, k):
        return tuple(getattr(self.model, f)[t, k].copy() for f in self._CART_FIELDS)

    def _restore_cart(self, t, k, snap):
        for f, v in zip(self._CART_FIELDS, snap):
            getattr(self.model, f)[t, k] = v

    # -- top level (JoinCascador::Train, cascador.cpp:33-55) -------------------

    def train(self) -> CascadeParams:
        c = self.c
        for t in range(self.model.stage_idx, c.T):
            self.model.stage_idx = t
            log(f"========== train stage {t+1}/{c.T} ==========")
            self.pos.calc_st_parameters(self.model.mean_shape)
            self.neg.calc_st_parameters(self.model.mean_shape)
            self.train_stage(t)
            # cursor semantics (cascador.hpp:125-139): a completed stage is
            # persisted as (t+1, -1) so resume re-enters at the NEXT stage
            self.model.stage_idx = t + 1
            self.model.cart_idx = -1
            self.snapshot(stage_done=True)
        return self.model

    def snapshot(self, stage_done: bool = False) -> None:
        if not self.snapshot_dir:
            return
        os.makedirs(self.snapshot_dir, exist_ok=True)
        tag = time.strftime("%Y%m%d-%H%M%S")
        t, k = self.model.stage_idx, self.model.cart_idx
        mpath = os.path.join(
            self.snapshot_dir, f"jda_tmp_{tag}_stage_{t+1}_cart_{k+1}.model"
        )
        save_model(self.model, mpath, dtype="double")
        dpath = os.path.join(
            self.snapshot_dir, f"jda_data_{tag}_stage_{t+1}_cart_{k+1}.data"
        )
        DataSet.snapshot(self.pos, self.neg, dpath)
        log(f"snapshot -> {mpath}")
