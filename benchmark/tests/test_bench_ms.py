"""The multi-scale configuration (jda_t5k540_ms_synth) through the
harness: its modules pass the import check and a copy that imports the
program does not, a sound run is correct, each fault planted under the
timed path is not, and the reference's bfloat16 control is not either."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark import reference_ms as RM

SPEC = H.load_spec()
CELL = "ms_vga_stream_b16"
SPEC_TRAFFIC = H.resolve(SPEC, CELL)["traffic"]


def tiny():
    """The cell at T=2, K=24 (thresholds calibrated, not read) on a pool of
    four 96 x 128 textures, two a call."""
    c = H.resolve(SPEC, CELL)
    model = {k: v for k, v in c["config"]["model"].items() if k != "cart_th_file"}
    c["config"] = dict(c["config"], T=2, K=24, model=model)
    c["traffic"] = dict(c["traffic"], height=96, width=128, pool=4, batch=2)
    return c


def test_modules_resolve():
    c = H.resolve(SPEC, CELL)
    assert c["config"]["model"]["kind"] == "module" and c["config"]["reduced"] == []
    assert os.path.samefile(H.reference_module(c["config"]).__file__, RM.__file__)
    for key in ("reference", "model"):
        path = c["config"][key] if key == "reference" else c["config"]["model"]["path"]
        names = H.imported_names(f"{H.ROOT}/{path}")
        assert "benchmark" in names and not names & set(H.REFEREE_FORBIDDEN)


@pytest.mark.parametrize("module", ["reference", "model"])
def test_copy_that_imports_the_program_is_refused(module, tmp_path):
    config = H.resolve(SPEC, CELL)["config"]
    src = config["reference"] if module == "reference" else config["model"]["path"]
    copy = tmp_path / "copy.py"
    shutil.copy(f"{H.ROOT}/{src}", copy)
    copy.write_text(copy.read_text() + "\nimport jda_tpu_torch  # noqa\n")
    if module == "reference":
        config = dict(config, reference=str(copy))
    else:
        config = dict(config, model=dict(config["model"], path=str(copy)))
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    spec = dict(SPEC, configs=[dict(SPEC["configs"][-1], file=str(path))])
    with pytest.raises(ValueError, match="imports"):
        H.resolve(spec, CELL)


def level_changed(monkeypatch):
    """The program's model with the level of one node changed: stage 0,
    cart 0, the root, which every window reads."""
    init = H.Program.__init__

    def changed(self, config, traffic, fields, device):
        scale = fields["scale"].copy()
        scale[0, 0, 0] = (scale[0, 0, 0] + 1) % 3
        init(self, config, traffic, dict(fields, scale=scale), device)

    monkeypatch.setattr(H.Program, "__init__", changed)


def fill_dropped(monkeypatch):
    """Reads past the pyramid's end take its last pixel, not the int32
    minimum."""
    from jda_tpu_torch.ops import cascade as C

    monkeypatch.setattr(C, "take_fill", lambda flat, idx: flat[idx.clamp(max=flat.shape[0] - 1)]
                        .to(torch.int32))


@pytest.mark.parametrize("fault", [None, level_changed, fill_dropped])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    torch.set_num_threads(4)
    if fault is not None:
        fault(monkeypatch)
    line, nums, _, _ = H.run_cell(tiny(), 2**31 + 11, 0.5, False, "cpu", time.perf_counter(),
                                  log=lambda *a: None)
    assert line["attempted"] > 0
    assert line["correct"] is (fault is None), nums
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}


def test_control_fails():
    """The multi-scale reference in bfloat16 in the program's place is not
    correct under the cell's limits, on three seeds."""
    torch.set_num_threads(4)
    c = tiny()
    fields = H.model_fields(c["config"])
    for seed in (1, 2, 3):
        pool = H.make_pool(c["traffic"], seed)
        want, _, _ = H.reference(c["config"], c["traffic"], fields, pool, "cpu")
        got, _, _ = H.reference(c["config"], c["traffic"], fields, pool, "cpu",
                                dtype=torch.bfloat16)
        assert sum(len(a[0]) for a in want) > 0, "degenerate fixture"
        assert not H.judge(H.compare(got, want), c["limits"])


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_pyramid_is_the_c_librarys(device):
    """The reference's o/h/q levels of a VGA image equal the port's
    C-exact host pyramid (ops/resize.pyramid_c, held to the native
    library by the port's tests), on the CPU and on the card."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from jda_tpu_torch.ops import resize

    img = H.make_pool(dict(SPEC_TRAFFIC, pool=1), 5)
    flat, offsets, strides = RM.pyramid(torch.as_tensor(img).to(device), torch.float32)
    want, want_offsets, want_strides = resize.stack_pyramid(resize.pyramid_c(img[0]))
    assert np.array_equal(flat[0].cpu().numpy(), want)
    assert list(offsets) == list(want_offsets) and list(strides) == list(want_strides)
