"""Training variants through the port and jda_tpu on the CPU: the
similarity-transform and multi-scale paths and the restart path of
tests/test_training.py, each with the JAX tests' own assertions and the
share of equal splits.  Two-stage runs are in tests/test_torch_resume.py."""

import numpy as np
import pytest

from jda_tpu_torch.utils import calc_mean_error

from test_training import _tiny_config, build_synthetic
from torch_train_util import model_diffs, split_share, train_both, w_close, one_torch_thread  # noqa: F401 (fixture)

ONE_STAGE = dict(T=1, K=8, feats=(40,), radius=(0.3,), probs=(0.8,),
                 recall=(0.99,), drops=(1,), nps=(1.0,),
                 score_normalization_steps=(2,), mining_th=(0.5,),
                 restart_th=(0.001,))

VARIANTS = {
    "similarity-transform": (dict(ONE_STAGE, with_similarity_transform=True), 120, 20),
    "multi-scale": (dict(ONE_STAGE, multi_scale=True), 120, 20),
    "restart": (
        dict(T=1, K=14, feats=(30,), radius=(0.3,), probs=(0.9,), recall=(0.99,),
             drops=(1,), nps=(1.0,), score_normalization_steps=(2,),
             mining_th=(0.5,), restart_on=True, restart_th=(0.9,), restart_times=2),
        100, 15,
    ),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    kw, n_pos, mb = VARIANTS[request.param]
    c = _tiny_config(**kw)
    rows, gts, bgs = build_synthetic(c, n_pos=n_pos)
    e0 = []

    def initial_error(tr):
        e0.append(calc_mean_error(tr.pos.gt_shapes, tr.pos.current_shapes,
                                  c.left_pupils, c.right_pupils))

    jax_tr, tr = train_both(c, rows, gts, bgs, mb, setup=initial_error)
    assert e0[0] == e0[1]  # the same initial shapes from the same seed
    return request.param, c, jax_tr, tr, e0[1]


def test_variant_first_stage_equal(variant):
    """The stage of every variant: every field but W bit-equal, W within
    tolerance."""
    name, c, a, b, _ = variant
    first = {f: getattr(a.model, f)[:1] for f in ("scale", "lmk1", "lmk2", "feat_th")}
    for f, v in first.items():
        np.testing.assert_array_equal(getattr(b.model, f)[:1], v, err_msg=f"{name}: {f}")
    for f in ("off1", "off2", "leaf_scores", "cart_th", "mean", "std"):
        np.testing.assert_array_equal(getattr(b.model, f)[:1], getattr(a.model, f)[:1],
                                      err_msg=f"{name}: {f}")
    assert w_close(a.model.W[0], b.model.W[0])


def test_variant_split_share(variant):
    """Every split against jda_tpu: the share of equal splits is 1.0 on
    these fixtures, and the cursor and every field but W are equal."""
    name, _, a, b, _ = variant
    share = split_share(a.model, b.model)
    print(f"{name}: share of equal splits {share}")
    assert share == 1.0, share
    assert model_diffs(a.model, b.model) == []


def test_variant_learns(variant):
    """The JAX tests' own assertions (tests/test_training.py)."""
    name, c, _, tr, e0 = variant
    assert tr.model.stage_idx == c.T
    pl = tr.pos.live_idx()
    e1 = calc_mean_error(tr.pos.gt_shapes[pl], tr.pos.current_shapes[pl],
                         c.left_pupils, c.right_pupils)
    if name == "restart":
        return  # completes despite constant restarts (best-cart fallback)
    assert tr.pos.size > 60
    assert e1 < e0, (e0, e1)
    if name == "multi-scale":
        assert (tr.model.scale > 0).any()  # pool sampled h/q features
