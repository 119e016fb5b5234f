"""The port's synthetic data pipeline (``repro_torch.data.pipeline``): the
twins of tests/test_data.py.  It keeps the reference's contract (a pure
function of (seed, step, shard), Zipf over a 4096-symbol active set, copies
from 8 back, labels as next tokens, the modality stubs, the batch specs)
but not jax.random's stream: its draws are numpy's."""
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.data.pipeline import make_batch_specs as j_make_batch_specs
from repro_torch.configs import get
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch_specs


def pipe(arch="internlm2_1_8b", **kw):
    return SyntheticLM(get(arch).reduced(), DataConfig(**kw), device="cpu")


def test_batches_deterministic():
    p = pipe(seq_len=32, global_batch=8, seed=7)
    a = p.batch(step=3, shard=1, num_shards=4)
    b = pipe(seq_len=32, global_batch=8, seed=7).batch(3, 1, 4)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    assert a["tokens"].dtype == torch.int32


def test_steps_shards_and_seeds_differ():
    p = pipe(seq_len=32, global_batch=8)
    s0 = p.batch(0, 0, 4)["tokens"]
    assert not torch.equal(s0, p.batch(1, 0, 4)["tokens"])
    assert not torch.equal(s0, p.batch(0, 1, 4)["tokens"])
    assert not torch.equal(
        s0, pipe(seq_len=32, global_batch=8, seed=1).batch(0, 0, 4)["tokens"])


def test_labels_are_next_tokens():
    b = pipe(seq_len=32, global_batch=4).batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_reshard_preserves_global_batch():
    p = pipe(seq_len=16, global_batch=8)
    two = [p.batch(0, s, 2)["tokens"].shape[0] for s in range(2)]
    four = [p.batch(0, s, 4)["tokens"].shape[0] for s in range(4)]
    assert sum(two) == sum(four) == 8
    with pytest.raises(ValueError, match="not divisible"):
        p.batch(0, 0, 3)


def test_stream_statistics_match_jax():
    """The reference's law, held against its own stream at qwen3_4b's
    vocabulary: tokens in the 4096-symbol active set, Zipf(1.2) ranks
    (symbol 0 the most frequent, at its probability), and the share of
    positions equal to the token 8 back: a copy (probability 0.35) of a
    base draw (the token 8 back is one unless it was itself a copy) or a
    chance match c of two draws, 0.35 (0.65 + 0.35 c) + 0.65 c."""
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    cfg = get("qwen3_4b")
    data = dict(seq_len=2048, global_batch=8)
    ranks = np.arange(1, 4097, dtype=np.float64) ** -1.2
    probs = ranks / ranks.sum()
    c = (probs ** 2).sum()
    want_same = 0.35 * (0.65 + 0.35 * c) + 0.65 * c
    streams = {
        "port": SyntheticLM(cfg, DataConfig(**data), device="cpu").batch(0)[
            "tokens"].numpy(),
        "jax": np.asarray(JSyntheticLM(jget("qwen3_4b"), JDataConfig(
            **data)).batch(0)["tokens"])}
    for name, toks in streams.items():
        assert toks.min() >= 0 and toks.max() < 4096, name
        counts = np.bincount(toks.ravel(), minlength=4096)
        assert counts.argmax() == 0, name
        # a copy of symbol 0 moves its share by at most 0.35 c
        assert abs(counts[0] / toks.size - probs[0]) < 0.02, name
        same = (toks[:, 8:] == toks[:, :-8]).mean()
        assert abs(same - want_same) < 0.02, (name, same, want_same)


def test_modality_stubs():
    mg = get("musicgen_medium").reduced()
    b = SyntheticLM(mg, DataConfig(seq_len=16, global_batch=2),
                    device="cpu").batch(0)
    assert b["embeddings"].shape == (2, 16, mg.d_model)
    assert b["embeddings"].dtype == torch.float32
    assert abs(float(b["embeddings"].std()) - 0.02) < 0.005
    pg = get("paligemma_3b").reduced()
    b = SyntheticLM(pg, DataConfig(seq_len=16, global_batch=2),
                    device="cpu").batch(0)
    assert b["prefix_embeddings"].shape == (2, pg.prefix_len, pg.d_model)
    assert b["tokens"].shape == (2, 16 - pg.prefix_len)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "musicgen_medium",
                                  "paligemma_3b"])
def test_specs_match_real_batches_and_jax(arch):
    cfg = get(arch).reduced()
    specs = make_batch_specs(cfg, 32, 4)
    jspecs = j_make_batch_specs(jget(arch).reduced(), 32, 4)
    real = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4),
                       device="cpu").batch(0)
    assert set(specs) == set(real) == set(jspecs)
    for k, (shape, dtype) in specs.items():
        assert tuple(real[k].shape) == shape == tuple(jspecs[k].shape), k
        assert real[k].dtype == dtype
        assert str(dtype).split(".")[-1] == str(jspecs[k].dtype), k


def test_loss_decreases_on_synthetic_stream():
    """The stream is learnable: a few training steps reduce the loss by
    more than 0.5 nats."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.train import make_train_step
    cfg = get("internlm2_1_8b").reduced()
    p = SyntheticLM(cfg, DataConfig(seq_len=64, global_batch=8),
                    device="cpu")
    params = M.init_params(cfg, 0, torch.float32, device="cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, lr_fn=lambda s: torch.tensor(1e-2),
                           remat=False, weight_decay=0.0,
                           clip_norm=None).fn
    losses = []
    for i in range(30):
        params, opt, m = step(params, opt, p.batch(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert min(losses[-5:]) < losses[0] - 0.5, losses[:3] + losses[-3:]
