"""Training stack: the boosted classification-regression cascade on the card.

PyTorch counterpart of the JAX package's train/ package, after the
reference's OpenMP training loop (btcart.cpp, cart.cpp, data.cpp): feature
matrices are batched two-pixel gathers, the split search is a scatter-add
histogram and a masked reduction, the global regression is a closed-form
ridge solve, and hard-negative mining screens windows on the device.
Multi-device training shards the samples over a torch.distributed
DeviceMesh (train/sharded.py; its dry runs in train/dryrun.py).
"""

from jda_tpu_torch.train.features import (
    FeaturePool,
    gen_feature_pool,
    feature_values,
    corpus_geometry,
)
from jda_tpu_torch.train.split import (
    classification_split,
    classification_split_from_hists,
    regression_split,
    leaf_scores,
)
from jda_tpu_torch.train.dryrun import sharded_train_step_dryrun

__all__ = [
    "FeaturePool",
    "gen_feature_pool",
    "feature_values",
    "corpus_geometry",
    "classification_split",
    "classification_split_from_hists",
    "regression_split",
    "leaf_scores",
    "sharded_train_step_dryrun",
]
