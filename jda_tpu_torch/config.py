"""Configuration system.

The port's own copy of the JAX package's config.py, field for field.  It is
compatible with the reference JSON schema (config.template.json:1-72,
parsed by src/jda/common.cpp:116-239).  Unlike the reference's
filesystem-singleton (`Config::GetInstance` reading ../config.json at first
use), this is an explicit immutable dataclass that is passed around; a JSON
file with the same schema loads into it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


def _as_list(v, n, cast):
    out = [cast(x) for x in v]
    if len(out) < n:
        raise ValueError(f"stage array too short: {out} for T={n}")
    return out[:n]


@dataclasses.dataclass(frozen=True)
class Config:
    """All knobs of the framework. Defaults follow config.template.json."""

    # model meta (config.template.json:2-6)
    T: int = 5
    K: int = 540
    landmark_n: int = 27
    tree_depth: int = 4
    shift_size: float = 0.02  # "random_shift"

    # image sizes (config.template.json:7-12)
    multi_scale: bool = False
    img_o_size: int = 48
    img_h_size: int = 36
    img_q_size: int = 24

    # hard negative mining (config.template.json:13-18)
    mining_th: Tuple[float, ...] = (0.2, 0.2, 0.2, 0.2, 0.2)
    mining_min_size: int = 32
    mining_factor: float = 1.3
    mining_step_ratio: float = 0.5

    # per-stage arrays (config.template.json:19-27)
    feats: Tuple[int, ...] = (2000, 2000, 2000, 2000, 2000)
    radius: Tuple[float, ...] = (0.3, 0.2, 0.15, 0.12, 0.1)
    probs: Tuple[float, ...] = (0.9, 0.8, 0.7, 0.6, 0.5)
    recall: Tuple[float, ...] = (0.99, 0.99, 0.99, 0.99, 0.99)  # parsed, unused (as in ref)
    drops: Tuple[int, ...] = (1, 1, 1, 1, 1)
    nps: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    score_normalization_steps: Tuple[int, ...] = (10, 10, 10, 10, 10)

    # data (config.template.json:28-33)
    use_hard: bool = False
    face_txt: str = "../data/face.txt"
    bg_txts: Tuple[str, ...] = ("../data/hd.txt", "../data/background.txt")
    test_txt: str = "../data/test.txt"

    # fddb / detection (config.template.json:34-45)
    fddb_dir: str = "../data/fddb"
    fddb_result: bool = True
    fddb_nms: bool = True
    fddb_draw_score: bool = True
    fddb_draw_shape: bool = True
    fddb_minimum_size: int = 20
    fddb_step: int = 5
    fddb_scale_factor: float = 1.3
    fddb_overlap: float = 0.3
    fddb_detect_method: int = 0

    # cart restart (config.template.json:46-52)
    restart_on: bool = False
    restart_th: Tuple[float, ...] = (0.001, 0.001, 0.001, 0.001, 0.001)
    restart_times: int = 5

    # face augment (config.template.json:53-65)
    face_augment_on: bool = False
    symmetric_landmarks: Tuple[Tuple[int, ...], Tuple[int, ...]] = (
        (0, 1, 4, 5, 6, 7, 8, 18, 21),
        (3, 2, 11, 10, 9, 12, 13, 20, 22),
    )
    left_pupils: Tuple[int, ...] = (8,)
    right_pupils: Tuple[int, ...] = (13,)
    with_similarity_transform: bool = False
    landmark_offset: int = 1

    # resume / snapshot (config.template.json:67-71)
    resume_model: str = ""
    resume_data: str = ""
    snapshot_iter: int = 600

    # numerics (hardcoded in common.cpp:143)
    esp: float = 2.2e-16

    # framework-only knobs (no reference equivalent)
    seed: int = 0
    # windows evaluated per device batch during detection/mining
    detect_batch: int = 8192
    # carts evaluated between alive-set compactions
    compact_every: int = 32

    @property
    def leaf_n(self) -> int:
        return 1 << (self.tree_depth - 1)

    @property
    def node_n(self) -> int:
        return self.leaf_n - 1

    @property
    def lbf_dim(self) -> int:
        return self.K * self.leaf_n

    @property
    def landmark_dim(self) -> int:
        return 2 * self.landmark_n

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path, "r") as f:
            j = json.load(f)
        T = int(j["T"])
        img = j["image_size"]
        mining = j["hard_negative_mining"]
        stages = j["stages"]
        data = j["data"]
        fddb = j["fddb"]
        cart = j["cart"]["restart"]
        face = j["face"]
        sym = face["symmetric_landmarks"]
        sym_off = int(sym["offset"])
        pupils = face["pupils"]
        pupils_off = int(pupils["offset"])
        resume = j.get("resume", {})
        return Config(
            T=T,
            K=int(j["K"]),
            landmark_n=int(j["landmark_n"]),
            tree_depth=int(j["tree_depth"]),
            shift_size=float(j["random_shift"]),
            multi_scale=bool(img["multi_scale"]),
            img_o_size=int(img["origin_size"]),
            img_h_size=int(img["half_size"]),
            img_q_size=int(img["quarter_size"]),
            mining_th=tuple(_as_list(mining["mining_th"], T, float)),
            mining_min_size=int(mining["min_size"]),
            mining_factor=float(mining["factor"]),
            mining_step_ratio=float(mining["step_ratio"]),
            feats=tuple(_as_list(stages["feature_pool_size"], T, int)),
            radius=tuple(_as_list(stages["random_sample_radius"], T, float)),
            probs=tuple(_as_list(stages["classification_p"], T, float)),
            recall=tuple(_as_list(stages["recall"], T, float)),
            drops=tuple(_as_list(stages["drop_n"], T, int)),
            nps=tuple(_as_list(stages["neg_pos_ratio"], T, float)),
            score_normalization_steps=tuple(
                _as_list(stages["score_normalization_step"], T, int)
            ),
            use_hard=bool(data["use_hard"]),
            face_txt=str(data["face"]),
            bg_txts=tuple(str(x) for x in data["background"]),
            test_txt=str(data["test"]),
            fddb_dir=str(fddb["dir"]),
            fddb_result=bool(fddb["out"]),
            fddb_nms=bool(fddb["nms"]),
            fddb_draw_score=bool(fddb["draw_score"]),
            fddb_draw_shape=bool(fddb["draw_shape"]),
            fddb_minimum_size=int(fddb["minimum_size"]),
            fddb_step=int(fddb["step"]),
            fddb_scale_factor=float(fddb["scale"]),
            fddb_overlap=float(fddb["overlap"]),
            fddb_detect_method=int(fddb["method"]),
            restart_on=bool(cart["on"]),
            restart_th=tuple(_as_list(cart["th"], T, float)),
            restart_times=int(cart["times"]),
            face_augment_on=bool(face["online_augment"]),
            symmetric_landmarks=(
                tuple(int(x) - sym_off for x in sym["left"]),
                tuple(int(x) - sym_off for x in sym["right"]),
            ),
            left_pupils=tuple(int(x) - pupils_off for x in pupils["left"]),
            right_pupils=tuple(int(x) - pupils_off for x in pupils["right"]),
            with_similarity_transform=bool(face["similarity_transform"]),
            resume_model=str(resume.get("model", "")),
            resume_data=str(resume.get("data", "")),
            snapshot_iter=int(j["snapshot_iter"]),
        )
