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
- ``--moe_experts 2``: an MoE checkpoint of the same widths, ``--packed``
  (the expert planes stay dense): R@K equal.
- The ``--output`` keys, and the grad-mode and tokenizer-stamp exits.
- A trained text tower (the port's trainer, one epoch at those widths
  and learning rate 1e-3, whose attention scores reach ~100), dense and
  ``--packed``, module by module against JAX's on the test split's
  captions: each module of the port run on the inputs JAX gave its own
  (flax's captured intermediates) within TOWER_RTOL of that output's
  largest |value|, and the text embeddings within TOWER_ATOL. The card
  against the CPU is read the same way by chip_smoke.py (phase
  evaluate's text_modules).
"""

import gzip
import json
import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from data.flickr8k_fixture import make_fixture  # noqa: E402

import evaluate as jax_evaluate  # noqa: E402
from atq_tpu.models.image_classifier import (  # noqa: E402
    ATQImageClassifier as JaxClassifier,
)
from atq_tpu.models.retrieval import (  # noqa: E402
    ATQMultimodalRetrieval as JaxRetrieval,
)
from atq_tpu.serve.packed_model import (  # noqa: E402
    export_packed_collection as jax_export_packed_collection,
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
from atq_tpu_torch.nn.attention import lengths_to_padding_mask  # noqa: E402
from atq_tpu_torch.serve.packed_model import (  # noqa: E402
    attach_packed_collection,
    export_packed_collection,
)
from atq_tpu_torch.train.retrieval import main as train_main  # noqa: E402
from atq_tpu_torch.utils.jax_interop import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)

LOSS_RTOL = 1e-5
EMB_TOL = 1e-4
# The trained tower (readings at one thread: the embeddings 9.4e-7 dense,
# 1.9e-6 packed; the worst module, the whole tower from the token ids,
# 2.3e-6 and 4.3e-6 of its scale).
TOWER_RTOL, TOWER_ATOL = 1e-5, 1e-5
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
    moe_dir = root / "moe"
    moe_dir.mkdir()
    moe = ATQMultimodalRetrieval(
        vocab_size=vocab_size, embed_dim=32, hidden_dim=64,
        max_seq_length=12, use_residual=True, text_moe_experts=2,
        device="cpu", generator=torch.Generator().manual_seed(1))
    save_checkpoint(moe.jax_variables(), str(moe_dir / "best_model.npz"))
    save_vocab_file(word_to_idx, str(moe_dir / "vocab.json"))
    return path, scanned_path, data


def test_retrieval_moe_matches_jax(retrieval, tmp_path):
    """A port-written MoE checkpoint evaluates on both packages alike."""
    path, _, data = retrieval
    ckpt = os.path.join(os.path.dirname(os.path.dirname(path)), "moe",
                        "best_model.npz")
    argv = ["--task", "retrieval", "--checkpoint", ckpt, "--use_residual",
            "--packed", "--moe_experts", "2", "--data_dir",
            data] + RET_WIDTHS
    got = _metrics(tmp_path, "port", evaluate.main, argv + ["--device",
                                                            "cpu"])
    want = _metrics(tmp_path, "jax", jax_evaluate.main, argv)
    assert {"image_to_text_R@1", "text_to_image_R@10"} <= set(got)
    assert got == want


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


@pytest.fixture(scope="module")
def trained(retrieval, tmp_path_factory):
    """The port's trainer, one epoch on the fixture at RET_WIDTHS' widths;
    its best_model.npz, read back, and the test split's first batch."""
    _, _, data = retrieval
    out = str(tmp_path_factory.mktemp("trained"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # The latency reading and the curves' plot come after the training and
    # read nothing back into it: left out, they save ~5 s.
    try:
        with mock.patch("atq_tpu_torch.train.retrieval._latency_ms",
                        return_value=1.0), \
                mock.patch("atq_tpu_torch.train.retrieval."
                           "_plot_training_curves"):
            train_main(["--device", "cpu", "--data_dir", data, "--epochs",
                        "1", "--use_residual", "--learning_rate", "1e-3",
                        "--output_dir", out] + RET_WIDTHS)
    finally:
        torch.set_num_threads(threads)
    _, _, loader, vocab_size, _ = prepare_flickr8k_dataloaders(
        batch_size=64, image_size=32, max_length=12, root_dir=data,
        vocab_file=os.path.join(out, "vocab.json"))
    batch = next(iter(loader))
    return (load_checkpoint(os.path.join(out, "best_model.npz")),
            vocab_size, np.asarray(batch[1]), np.asarray(batch[2]))


def _jax_text_outputs(ckpt, vocab_size, ids, lengths, packed):
    """JAX's text embeddings and every module's output on the way, by
    dotted module path (flax's captured intermediates)."""
    model = JaxRetrieval(vocab_size=vocab_size, embed_dim=32, hidden_dim=64,
                         use_residual=True)
    variables = {k: v for k, v in ckpt.items() if isinstance(v, dict)}
    if packed:
        variables["packed"] = jax_export_packed_collection(
            ckpt["params"], ckpt["quant"])
    emb, state = jax.jit(lambda v, i, n: model.apply(
        v, i, n, method=JaxRetrieval.encode_text,
        capture_intermediates=True, mutable=["intermediates"]))(
            variables, ids, lengths)
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                flat[".".join(path)] = np.asarray(v[0])
            elif isinstance(v, dict):
                walk(v, path + [k])

    walk(jax.device_get(state["intermediates"]), [])
    return np.asarray(emb), flat


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_trained_text_tower_matches_jax_module_by_module(trained, packed):
    ckpt, vocab_size, ids, lengths = trained
    model = ATQMultimodalRetrieval(vocab_size=vocab_size, embed_dim=32,
                                   hidden_dim=64, max_seq_length=12,
                                   use_residual=True, device="cpu")
    model.load_jax_variables(ckpt)
    if packed:
        attach_packed_collection(model, export_packed_collection(
            ckpt["params"], ckpt["quant"], device="cpu"))
    want, jx = _jax_text_outputs(ckpt, vocab_size, ids, lengths, packed)
    te = model.text_encoder
    mask = lengths_to_padding_mask(torch.as_tensor(lengths), ids.shape[1])

    def t(name):
        return torch.from_numpy(jx[name].copy())

    # (port module, its inputs from JAX's outputs, JAX's output of it)
    cases = [(te.embed_norm, (t("text_encoder.embedding"),), {},
              "text_encoder.embed_norm")]
    h = t("text_encoder.embed_norm") + te.positional_encoding[
        :, :ids.shape[1]]
    for i in range(te.num_layers):
        name = f"text_encoder.layers_{i}"
        layer = getattr(te, f"layers_{i}")
        n1 = t(f"{name}.norm1")
        cases += [
            (layer.norm1, (h,), {}, f"{name}.norm1"),
            (layer.self_attn, (n1, n1, n1), {"key_padding_mask": mask},
             f"{name}.self_attn"),
            (layer.linear1, (t(f"{name}.norm2"),), {}, f"{name}.linear1"),
            (layer.linear2, (F.gelu(t(f"{name}.linear1")),), {},
             f"{name}.linear2"),
            (layer, (h,), {"src_key_padding_mask": mask}, name)]
        h = t(name)
    cases += [
        (te.norm, (h,), {}, "text_encoder.norm"),
        (te.attention_pool_0, (t("text_encoder.norm"),), {},
         "text_encoder.attention_pool_0"),
        (te.attention_pool_2, (torch.tanh(t(
            "text_encoder.attention_pool_0")),), {},
         "text_encoder.attention_pool_2"),
        (te, (torch.as_tensor(ids), torch.as_tensor(lengths)), {},
         "text_encoder"),
        (model.text_projector, (t("text_encoder"),), {}, "text_projector"),
        (model.text_norm, (t("text_projector"),), {}, "text_norm")]
    assert {name for *_, name in cases} <= set(jx)
    with torch.inference_mode():
        for module, args, kwargs, name in cases:
            got = module(*args, **kwargs).numpy()
            ref = jx[name]
            assert got.shape == ref.shape, name
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=TOWER_RTOL * np.abs(ref).max(),
                                       err_msg=name)
        got = model.encode_text(torch.as_tensor(ids),
                                torch.as_tensor(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOWER_ATOL)
    # Trained: the attention scores are far from the seeded model's.
    q = t("text_encoder.layers_0.self_attn.q_proj").reshape(
        *ids.shape, 8, 4)
    k = t("text_encoder.layers_0.self_attn.k_proj").reshape(
        *ids.shape, 8, 4)
    assert torch.einsum("bqhd,bkhd->bhqk", q, k).abs().max() / 2 > 20
