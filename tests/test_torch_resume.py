"""Two-stage training with a checkpoint between the stages, through the
port and jda_tpu on the CPU (the `jda resume` workload, src/train.cpp:54-79,
cursor semantics cascador.hpp:125-139): stage 1 trained and snapshotted by
each package, stage 2 resumed from the JAX package's files by both, and
from its own files by the port."""

import numpy as np
import pytest

import jda_tpu.data as JD
import jda_tpu.params as JP
from jda_tpu.train.boost import Trainer as JaxTrainer
import jda_tpu_torch.data as PD
import jda_tpu_torch.params as PP
from jda_tpu_torch.train.boost import Trainer
from jda_tpu_torch.utils import calc_mean_error

from test_training import _tiny_config, build_synthetic
from torch_train_util import (  # noqa: F401 (one_torch_thread: a fixture)
    MINING_BATCH, model_diffs, one_torch_thread, port_config, split_share,
)


def _stage_one(tr, c, rows, gts, bgs, mpath, dpath, save_model, snapshot):
    """Train stage 1 only and snapshot it; returns the initial mean error."""
    tr.mining_max_batches = 30
    tr.mining_batch = MINING_BATCH
    tr.set_synthetic_data(rows, gts, bgs)
    e0 = calc_mean_error(tr.pos.gt_shapes, tr.pos.current_shapes,
                         c.left_pupils, c.right_pupils)
    tr.model.stage_idx = 0
    tr.pos.calc_st_parameters(tr.model.mean_shape)
    tr.neg.calc_st_parameters(tr.model.mean_shape)
    tr.train_stage(0)
    tr.model.stage_idx, tr.model.cart_idx = 1, -1
    save_model(tr.model, mpath)
    snapshot(tr.pos, tr.neg, dpath)
    return e0


def _resume(make, load_model, resume, mpath, dpath, bgs):
    tr = make(load_model(mpath))
    assert (tr.model.stage_idx, tr.model.cart_idx) == (1, -1)
    tr.mining_max_batches = 30
    tr.mining_batch = MINING_BATCH
    resume(dpath, tr.pos, tr.neg)
    tr.neg_gen.load_images(bgs, tr.rng)
    tr.train()
    return tr


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume")
    c = _tiny_config()
    pc = port_config(c)
    rows, gts, bgs = build_synthetic(c, n_pos=150)
    mpath, dpath = str(d / "snap.model"), str(d / "snap.data")
    jax_first = JaxTrainer(c)
    _stage_one(jax_first, c, rows, gts, bgs, mpath, dpath, JP.save_model, JD.DataSet.snapshot)
    jax_tr = _resume(lambda m: JaxTrainer(c, model=m), JP.load_model, JD.DataSet.resume,
                     mpath, dpath, bgs)
    # the port resumes from the JAX package's model and corpus files
    tr = _resume(lambda m: Trainer(pc, model=m, device="cpu"), PP.load_model,
                 PD.DataSet.resume, mpath, dpath, bgs)
    # and from its own, written after its own first stage
    pm, pd = str(d / "port.model"), str(d / "port.data")
    e0 = _stage_one(Trainer(pc, device="cpu"), pc, rows, gts, bgs, pm, pd,
                    PP.save_model, PD.DataSet.snapshot)
    own = _resume(lambda m: Trainer(pc, model=m, device="cpu"), PP.load_model,
                  PD.DataSet.resume, pm, pd, bgs)
    return jax_first, jax_tr, tr, own, e0


def test_resume_from_jax_snapshot_matches_jax(resumed):
    """Resumed from the same files, the second stage is every field but W
    bit-equal, W within tolerance; the first stage is untouched."""
    jax_first, jax_tr, tr, _, _ = resumed
    assert model_diffs(jax_tr.model, tr.model) == []
    np.testing.assert_array_equal(tr.model.cart_th[0], jax_first.model.cart_th[0])
    np.testing.assert_array_equal(tr.model.W[0], jax_first.model.W[0])


@pytest.mark.parametrize("which", ["from-jax-files", "from-port-files"])
def test_resume_after_stage(resumed, which):
    """tests/test_resume.py's assertions on the port's resumed runs."""
    jax_first, _, tr, own, _ = resumed
    tr = tr if which == "from-jax-files" else own
    c = tr.c
    if which == "from-jax-files":
        np.testing.assert_allclose(tr.model.W[0], jax_first.model.W[0])
    th1 = tr.model.cart_th[1]
    finite = th1 > -1e29
    assert finite[0]
    n_trained = int(finite.sum())
    assert finite[:n_trained].all() and not finite[n_trained:].any()
    assert np.abs(tr.model.W[1]).sum() > 0
    assert tr.model.stage_idx == c.T
    assert tr.pos.size > 0


def test_own_snapshot_resume_matches_jax(resumed):
    """The port's own first stage and resume: every field but W equal to
    the JAX package's; W of the first stage within W_REL_TOL, of the second
    (whose shapes moved by the first W) within W_LATER_REL_TOL."""
    _, jax_tr, _, own, _ = resumed
    assert model_diffs(jax_tr.model, own.model, later_from=1) == []
    share = split_share(jax_tr.model, own.model)
    print(f"two stages: share of equal splits {share}")
    assert share == 1.0


def test_two_stage_run_learns(resumed):
    """tests/test_training.py's assertions on a two-stage run, for the
    port's own two stages."""
    *_, own, e0 = resumed
    pl = own.pos.live_idx()
    assert own.pos.size > 0.5 * 150
    assert own.pos.scores[pl].mean() > 1.0
    e1 = calc_mean_error(own.pos.gt_shapes[pl], own.pos.current_shapes[pl],
                         own.c.left_pupils, own.c.right_pupils)
    assert e1 < e0 * 0.9, (e0, e1)

