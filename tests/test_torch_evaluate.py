"""``python -m atq_tpu_torch.evaluate`` against the JAX package's
``evaluate.py`` on the CPU, on the same checkpoints and the same data.

- Classification: the full-width RPB classifier (a JAX init, trained-size
  alphas) on a small Fashion-MNIST in the IDX format (40 train, 48 test
  images), dense and ``--packed``: accuracy equal, mean loss within rtol
  1e-5 (float32 sums in another order).
- Retrieval: a seeded model (embed 32, FFN 64, 4 text layers, sequence
  12, images 32x32) on the Flickr8k-format fixture (tests/data, 30 images:
  3 test images, 15 caption rows), ``--packed --int8_trunk``: R@K equal,
  and the ``--save_index`` file's ids in the same order with embeddings
  within 1e-4 (tests/test_torch_retrieval.py's tolerance); a scanned
  (``--scan_layers``) copy of the checkpoint gives the same metrics and
  index bit for bit.
- The ``--output`` keys, and the grad-mode, tokenizer-stamp and
  ``--moe_experts`` exits.
"""

import gzip
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from data.flickr8k_fixture import make_fixture  # noqa: E402

import evaluate as jax_evaluate  # noqa: E402
from atq_tpu.models.image_classifier import (  # noqa: E402
    ATQImageClassifier as JaxClassifier,
)
from atq_tpu.nn.transformer import stack_layer_params  # noqa: E402
from atq_tpu.train.classifier import _save_checkpoint  # noqa: E402
from atq_tpu_torch import evaluate  # noqa: E402
from atq_tpu_torch.data.flickr8k import (  # noqa: E402
    VOCAB_TOKENIZER_KEY,
    prepare_flickr8k_dataloaders,
    save_vocab_file,
)
from atq_tpu_torch.data.mnist import _make, _templates  # noqa: E402
from atq_tpu_torch.models.retrieval import (  # noqa: E402
    ATQMultimodalRetrieval,
)
from atq_tpu_torch.utils.jax_interop import save_checkpoint  # noqa: E402

LOSS_RTOL = 1e-5
EMB_TOL = 1e-4
RET_WIDTHS = ["--embed_dim", "32", "--hidden_dim", "64",
              "--max_seq_length", "12", "--image_size", "32",
              "--batch_size", "8"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_idx(path, array):
    dims = array.shape
    header = bytes([0, 0, 8, len(dims)]) + b"".join(
        d.to_bytes(4, "big") for d in dims)
    with gzip.open(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    root = tmp_path_factory.mktemp("clf")
    raw = root / "data" / "FashionMNIST" / "raw"
    raw.mkdir(parents=True)
    templates = _templates("fashion_mnist")
    for split, n, seed in (("train", 40, 100), ("t10k", 48, 200)):
        imgs, labels = _make(templates, n, seed)
        _write_idx(raw / f"{split}-images-idx3-ubyte.gz", imgs)
        _write_idx(raw / f"{split}-labels-idx1-ubyte.gz", labels)
    model = JaxClassifier(use_rpb=True, hidden_size=128)
    v = jax.tree_util.tree_map(np.array, model.init(
        jax.random.PRNGKey(0), np.zeros((1, 28, 28, 1), np.float32)))
    for layer in ("classifier_0", "classifier_3"):  # a trained-size alpha
        v["params"][layer]["alpha"] = np.full((1,), 0.02, np.float32)
    path = str(root / "atq_model_fashion_mnist.npz")
    _save_checkpoint(v, path)
    return path, str(root / "data"), v


def _metrics(tmp_path, run, main, argv):
    out = str(tmp_path / f"{run}.json")
    main(argv + ["--output", out])
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_classification_matches_jax(classifier, tmp_path, packed):
    path, data_dir, _ = classifier
    argv = ["--task", "classification", "--checkpoint", path, "--use-rpb",
            "--data_dir", data_dir, "--batch_size", "32"] + \
        ["--packed"] * packed
    got = _metrics(tmp_path, "port", evaluate.main, argv + ["--device",
                                                            "cpu"])
    want = _metrics(tmp_path, "jax", jax_evaluate.main, argv)
    assert set(got) == set(want) == {"accuracy", "loss"}
    assert got["accuracy"] == want["accuracy"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)


def test_grad_mode_and_moe_exits(classifier, tmp_path):
    path, data_dir, v = classifier
    base = ["--task", "classification", "--use-rpb", "--data_dir",
            data_dir, "--device", "cpu"]
    with pytest.raises(SystemExit, match="no wp/wn"):
        evaluate.main(base + ["--checkpoint", path, "--grad-mode", "ttq"])
    ttq = str(tmp_path / "ttq.npz")
    params = {**v["params"], "classifier_0": {
        **v["params"]["classifier_0"], "wp": np.ones((1,), np.float32),
        "wn": np.ones((1,), np.float32)}}
    _save_checkpoint({**v, "params": params}, ttq)
    with pytest.raises(SystemExit, match="untrained alpha"):
        evaluate.main(base + ["--checkpoint", ttq, "--grad-mode", "parity"])
    with pytest.raises(NotImplementedError, match="moe_experts"):
        evaluate.main(base + ["--checkpoint", path, "--moe_experts", "2"])


@pytest.fixture(scope="module")
def retrieval(tmp_path_factory):
    root = tmp_path_factory.mktemp("retrieval")
    data = make_fixture(str(root / "flickr8k"), n_images=30, size=40)
    _, _, _, vocab_size, word_to_idx = prepare_flickr8k_dataloaders(
        batch_size=8, image_size=32, max_length=12, root_dir=data)
    model = ATQMultimodalRetrieval(
        vocab_size=vocab_size, embed_dim=32, hidden_dim=64,
        max_seq_length=12, use_residual=True, device="cpu",
        generator=torch.Generator().manual_seed(0))
    ckpt_dir = root / "run"
    ckpt_dir.mkdir()
    v = model.jax_variables()
    path = str(ckpt_dir / "best_model.npz")
    save_checkpoint(v, path)
    save_vocab_file(word_to_idx, str(ckpt_dir / "vocab.json"))
    scanned_dir = root / "scanned"
    scanned_dir.mkdir()
    te = "text_encoder"
    scanned = {**v, "params": {**v["params"], te: stack_layer_params(
        v["params"][te], 4)}, "quant": {**v["quant"], te: stack_layer_params(
            v["quant"][te], 4)}}
    scanned_path = str(scanned_dir / "best_model.npz")
    save_checkpoint(jax.tree_util.tree_map(np.asarray, scanned),
                    scanned_path)
    save_vocab_file(word_to_idx, str(scanned_dir / "vocab.json"))
    return path, scanned_path, data


def _index(path):
    with np.load(path, allow_pickle=True) as f:
        return list(f["ids"]), np.asarray(f["embeddings"])


def test_retrieval_matches_jax(retrieval, tmp_path):
    path, scanned_path, data = retrieval

    def argv(ckpt, run):
        return (["--task", "retrieval", "--checkpoint", ckpt,
                 "--use_residual", "--packed", "--int8_trunk",
                 "--data_dir", data, "--save_index",
                 str(tmp_path / f"{run}.npz")] + RET_WIDTHS)

    port_argv = ["--device", "cpu"]
    got = _metrics(tmp_path, "port", evaluate.main,
                   argv(path, "port") + port_argv)
    want = _metrics(tmp_path, "jax", jax_evaluate.main, argv(path, "jax"))
    assert set(got) == set(want)
    assert {"image_to_text_R@1", "text_to_image_R@10"} <= set(got)
    assert got == want
    ids, embs = _index(tmp_path / "port.npz")
    jax_ids, jax_embs = _index(tmp_path / "jax.npz")
    assert ids == jax_ids and len(ids) == 3
    np.testing.assert_allclose(embs, jax_embs, rtol=0, atol=EMB_TOL)

    scanned = _metrics(tmp_path, "scanned", evaluate.main,
                       argv(scanned_path, "scanned") + port_argv)
    assert scanned == got
    s_ids, s_embs = _index(tmp_path / "scanned.npz")
    assert s_ids == ids
    np.testing.assert_array_equal(s_embs, embs)


def test_tokenizer_stamp_exit(retrieval, tmp_path):
    path, _, data = retrieval
    vocab = json.load(open(os.path.join(os.path.dirname(path),
                                        "vocab.json")))
    other = "split" if vocab[VOCAB_TOKENIZER_KEY] != "split" else \
        "vendored-ptb"
    vocab[VOCAB_TOKENIZER_KEY] = other
    stamped = tmp_path / "vocab.json"
    stamped.write_text(json.dumps(vocab))
    with pytest.raises(SystemExit, match="tokenizer"):
        evaluate.main(["--task", "retrieval", "--checkpoint", path,
                       "--use_residual", "--data_dir", data, "--vocab_file",
                       str(stamped), "--device", "cpu"] + RET_WIDTHS)
