"""The files the port's retrieval trainer writes (train/retrieval.py)
against a run of atq_tpu's trainer with the same config on the CPU: one
epoch on the synthetic corpus (20 images) at the JAX package's small test
widths. The same files, the same keys in every ``.npz`` and the same JSON
structure; ``checkpoint_epoch_N.npz`` holds the optimizer state under
optax's tree paths, as JAX writes it; both write the training state under
``orbax/step_1``."""

import json
import os

import numpy as np
import pytest

from atq_tpu.data import flickr8k as jax_f8k
from atq_tpu.train import retrieval as jtrain
from atq_tpu_torch.data import flickr8k as pf8k
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils.jax_interop import load_checkpoint

EMBED, HIDDEN, SIZE, SEQ = 32, 64, 32, 12


@pytest.fixture(autouse=True)
def _vendored_tokenizer(monkeypatch):
    """The JAX side takes NLTK's punkt path when its data is installed;
    pin it to the vendored tokenizer, which the port copies."""
    monkeypatch.setattr(jax_f8k, "_USE_NLTK", False)
    monkeypatch.delenv("ATQ_SPLIT_TOKENIZER", raising=False)


def _npz_keys(path):
    with np.load(path) as f:
        return sorted(f.files)


def test_artifacts_have_the_jax_keys(tmp_path):
    """Then the best checkpoint loads into a fresh model, as serving
    does."""
    kw = dict(batch_size=8, image_size=SIZE, embed_dim=EMBED,
              hidden_dim=HIDDEN, max_seq_length=SEQ, use_residual=True,
              synthetic_images=20, epochs=1, use_ema=True, reinit_model=True,
              gradual_quant=True, warmup_epochs=0, contrastive_reg=0.05)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jtrain.train_retrieval(jtrain.RetrievalConfig(
        **kw, output_dir=str(jdir), data_dir=str(tmp_path / "d"),
        device="cpu"), verbose=False)
    _, history, report = ptrain.train_retrieval(ptrain.RetrievalConfig(
        **kw, output_dir=str(pdir), data_dir=str(tmp_path / "d"),
        device="cpu"), verbose=False)
    jfiles = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == jfiles
    assert "best_model.npz" in jfiles and "checkpoint_epoch_1.npz" in jfiles
    # The training state: an Orbax directory in JAX, a torch.save file in
    # the port (train/checkpoint.py), each under orbax/step_1.
    assert "step_1" in os.listdir(jdir / "orbax")
    assert os.listdir(pdir / "orbax") == ["step_1"]
    for f in jfiles:
        if f.endswith(".npz"):
            assert _npz_keys(pdir / f) == _npz_keys(jdir / f), f
    assert (pdir / "vocab.json").read_text() == \
        (jdir / "vocab.json").read_text()

    def shape(x):
        if isinstance(x, dict):
            return {k: shape(v) for k, v in x.items()}
        if isinstance(x, list):
            return [shape(v) for v in x]
        return type(x).__name__ if x is not None else None

    for f in ("final_report.json", "training_history.json"):
        got = json.loads((pdir / f).read_text())
        want = json.loads((jdir / f).read_text())
        got["training_args"] = sorted(got.get("training_args", {}))
        want["training_args"] = sorted(want.get("training_args", {}))
        assert shape(got) == shape(want), f
    jlines = (jdir / "metrics.jsonl").read_text().splitlines()
    plines = (pdir / "metrics.jsonl").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in plines] == \
        [sorted(json.loads(x)) for x in jlines]
    assert history == json.loads((pdir / "training_history.json")
                                 .read_text())
    assert np.isfinite(report["test_metrics"]["mean_R@1"])
    # The best checkpoint serves: it loads into a fresh model.
    fresh = ATQMultimodalRetrieval(
        vocab_size=len(pf8k.load_vocab_file(str(pdir / "vocab.json"))),
        embed_dim=EMBED, hidden_dim=HIDDEN, use_residual=True,
        max_seq_length=SEQ, device="cpu")
    fresh.load_jax_variables(load_checkpoint(str(pdir / "best_model.npz")))
