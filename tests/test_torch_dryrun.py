"""``repro_torch.launch.dryrun``: the one-card dry run at full size on the
meta device (nothing allocated, no kernel launched), every cell ``ok`` or
the reference's ``SKIP`` with finite positive counts and terms."""
import json
import math

import pytest

from repro.configs import ASSIGNED
from repro.configs import get as jget
from repro.launch.shapes import SKIP as J_SKIP
from repro.launch.shapes import cell_status as j_cell_status
from repro_torch.kernels import _build
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.shapes import SHAPES


def check(rec, arch, shape, path):
    assert rec["chips"] == 1
    assert (rec["arch"], rec["shape"], rec["path"]) == (arch, shape, path)
    want = j_cell_status(jget(arch), shape)
    assert rec["status"] == want
    if want == J_SKIP:
        assert rec["reason"]
        return
    for key in ("hlo_flops", "hlo_bytes", "compute_s", "memory_s",
                "step_s_lower_bound", "roofline_fraction",
                "model_flops_global", "useful_flops_ratio"):
        assert math.isfinite(rec[key]) and rec[key] > 0, (key, rec[key])
    assert rec["memory"]["total_bytes"] >= rec["memory"]["argument_bytes"] \
        > 0
    assert rec["fits"] == (rec["memory"]["total_bytes"] <= op_cost.HBM_BYTES)
    assert rec["dominant"] in ("compute_s", "memory_s")
    assert rec["device"] == op_cost.DEVICE
    spec = SHAPES[shape]
    tokens = spec.global_batch * (1 if spec.kind == "decode"
                                  else spec.seq_len)
    assert rec["tokens_per_step"] == tokens
    if spec.kind == "decode":
        assert rec["route"] == ("shortcut" if jget(arch).ssm_state
                                else path)
        # the reference's ideal: parameters + the whole cache (a windowed
        # layer's kernel reads less than that)
        assert rec["ideal_bytes_per_device"] > 0
        if jget(arch).sliding_window is None:
            assert rec["ideal_bytes_per_device"] <= rec["hlo_bytes"]
    else:
        assert rec["useful_flops_ratio"] <= 1.0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_arch_decode_and_train(arch):
    _build.reset_launches()
    for path in ("shortcut", "paged"):
        check(dryrun.lower_cell(arch, "decode_32k", path=path), arch,
              "decode_32k", path)
    check(dryrun.lower_cell(arch, "train_4k"), arch, "train_4k", "shortcut")
    assert _build.launches() == {}


def test_qwen3_4b_every_shape_paged():
    for shape in SHAPES:
        rec = dryrun.lower_cell("qwen3_4b", shape, path="paged")
        check(rec, "qwen3_4b", shape, "paged")
    # the prefill's attention is the flash kernel's recorded cost
    rec = dryrun.lower_cell("qwen3_4b", "prefill_32k", path="paged")
    rows = {r[2]: r for r in rec["breakdown"]["flops"]}
    assert rows["kernel:flash_attention"][1] == 36


def test_main_writes_one_json_per_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3_4b", "--shape", "all", "--out",
                        str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"qwen3_4b__{s}__1-card__shortcut.json"
                           for s in SHAPES)
    for shape in SHAPES:
        with open(tmp_path / f"qwen3_4b__{shape}__1-card__shortcut.json") \
                as f:
            check(json.load(f), "qwen3_4b", shape, "shortcut")
    out = capsys.readouterr().out
    assert out.count("[ OK ]") == 3 and out.count("[SKIP]") == 1


def test_opt_overrides():
    rec = dryrun.lower_cell("qwen3_4b", "decode_32k", path="paged",
                            opt={"block_size": "32", "num_layers": "2"})
    base = dryrun.lower_cell("qwen3_4b", "decode_32k", path="paged")
    assert rec["hlo_flops"] < base["hlo_flops"] / 10
