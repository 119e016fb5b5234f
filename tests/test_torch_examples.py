"""The PyTorch port's example twins (``examples/*_torch.py``), each run
through its ``main()`` with ``--device cpu`` (the kernels' plain versions):
they finish, print their reference's lines, the serving twin checks its
two access paths token for token, and the training twin resumes from its
checkpoint."""
import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin(capsys):
    load("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    # the mapper thread races the prints of the first versions and of the
    # burst's sync flag; the lines after a wait are fixed
    for line in ("inserted 4000; versions (trad, shortcut) = (1, ",
                 "lookup wave 1 ok", "mapper caught up; versions = (1, 1)",
                 "lookup wave 2 ok; routed shortcut? True", "after burst: ",
                 "resynced: (2, 2)"):
        assert line in out, out


def test_mixed_workload_twin(capsys):
    load("mixed_workload_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("bulk-loaded 20000 in ")
    for wave in range(4):
        assert f"wave {wave}: burst of 400 -> versions" in out, out
    assert out.count("lookup x20k via ") == 12
    assert out.count("  resynced: ") == 4


@pytest.mark.parametrize("arch", ["qwen3_4b", "paligemma_3b"])
def test_serve_paged_twin(capsys, arch):
    load("serve_paged_torch").main(["--device", "cpu", "--arch", arch,
                                    "--batch", "2", "--prompt-len", "32",
                                    "--gen", "8"])
    out = capsys.readouterr().out
    assert f"arch={arch} B=2 prompt=32 gen=8" in out
    assert "outputs identical across paths ✓" in out, out


def test_serve_paged_twin_fails_on_different_paths(monkeypatch):
    """A paged route that decodes other tokens makes the twin fail instead
    of printing the identical line."""
    mod = load("serve_paged_torch")
    real = mod.make_paged_serve_step

    def off_by_one(cfg):
        step = real(cfg)

        def wrong(params, cache, tok, ids):
            nxt, cache = step(params, cache, tok, ids)
            return (nxt + 1) % cfg.vocab_size, cache
        return wrong
    monkeypatch.setattr(mod, "make_paged_serve_step", off_by_one)
    with pytest.raises(AssertionError, match="access paths must agree"):
        mod.main(["--device", "cpu", "--batch", "2", "--prompt-len", "16",
                  "--gen", "4"])


def test_train_small_twin(capsys, tmp_path):
    """The training twin on the CPU: three steps of qwen3_100m at the
    example's widths, its final checkpoint, and a second call on the same
    directory that resumes from it."""
    mod = load("train_small_torch")
    argv = ["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)]
    mod.main(argv)
    out = capsys.readouterr().out
    assert "[train] step     0 loss " in out and "[train] step     2 " in out
    assert "[train] final checkpoint at step 3" in out, out
    mod.main(argv)
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out, out
    assert "[train] step" not in out


def test_train_launcher_takes_one_device_mesh_only():
    from repro_torch.launch.train import main as train_main
    with pytest.raises(ValueError, match="takes only --mesh 1x1"):
        train_main(["--arch", "qwen3_4b", "--reduced", "--mesh", "2x4",
                    "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
@pytest.mark.parametrize("name", ["quickstart_torch", "mixed_workload_torch",
                                  "serve_paged_torch", "train_small_torch"])
def test_twins_default_to_cuda(name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(name).main([])
