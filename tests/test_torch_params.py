"""jda_tpu_torch.params against jda_tpu.params: the same model fields, the
same bytes on disk in both binary formats, the same tensors on device."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu_torch import params as TP

FLAGSHIP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models",
    "flagship_synth.model",
)


def _assert_same_fields(a, b):
    for f in dataclasses.fields(JP.CascadeParams):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_from_arrays_reproduces_every_field():
    m = JP.synthetic_model(
        T=3, K=40, landmark_n=9, seed=3,
        drop_profile=JP.realistic_drop_profile(3, 40),
    )
    _assert_same_fields(m, TP.from_arrays(dataclasses.asdict(m)))


def test_synthetic_model_matches_jax_package():
    kw = dict(T=2, K=24, landmark_n=9, seed=8)
    _assert_same_fields(
        JP.synthetic_model(**kw, reject_rate=0.2),
        TP.synthetic_model(**kw, reject_rate=0.2),
    )
    _assert_same_fields(
        JP.synthetic_model(**kw, multi_scale=True,
                           drop_profile=JP.realistic_drop_profile(2, 24)),
        TP.synthetic_model(**kw, multi_scale=True,
                           drop_profile=TP.realistic_drop_profile(2, 24)),
    )


@pytest.mark.parametrize("fmt", ["double", "float"])
def test_save_model_byte_identical(tmp_path, fmt):
    m = JP.synthetic_model(T=3, K=20, landmark_n=9, seed=12, reject_rate=0.1)
    pj = str(tmp_path / "jax.model")
    pt = str(tmp_path / "torch.model")
    JP.save_model(m, pj, dtype=fmt)
    TP.save_model(TP.from_arrays(dataclasses.asdict(m)), pt, dtype=fmt)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    # and both packages load the file to the same arrays
    _assert_same_fields(JP.load_model(pj, dtype=fmt), TP.load_model(pt, dtype=fmt))


def test_flagship_model_loads_identically():
    _assert_same_fields(JP.load_model(FLAGSHIP), TP.load_model(FLAGSHIP))


def test_save_refuses_regressionless_stage(tmp_path):
    m = TP.synthetic_model(T=2, K=8, landmark_n=9, seed=1)
    m = dataclasses.replace(m, W=np.zeros_like(m.W), stage_idx=1, cart_idx=-1)
    with pytest.raises(ValueError, match="regression"):
        TP.save_model(m, str(tmp_path / "bad.model"))


def test_device_tensors_match_device_arrays():
    m = JP.synthetic_model(T=2, K=12, landmark_n=9, seed=2, reject_rate=0.1)
    ja = m.device_arrays(np.float32)
    tt = TP.from_arrays(dataclasses.asdict(m)).device_tensors("cpu")
    assert set(ja) == set(tt)
    for k in ja:
        a = np.asarray(ja[k])
        b = tt[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert tt["W"].dtype == torch.float32
