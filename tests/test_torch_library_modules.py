"""The library modules that no command-line tool calls, against atq_tpu on
the CPU:

- data/text_utils.py: ``build_vocabulary``, ``clean_text``,
  ``tokenize_texts`` equal to JAX's on the offline fallback (NLTK here has
  no data) and on the NLTK branch (its tokenizer and stopword corpus
  monkeypatched in, the same for both packages); ``create_embedding_matrix``
  on a GloVe-format file the test writes, equal;
- data/multimodal_dataset.py: items from a JSON file and images the test
  writes, equal to JAX's;
- models/legacy.py: ``ATQMultimodalClassifier`` (and its alias) from one
  flax init carried across, eval logits within 1e-5, every drop mode;
- nn/mixed_precision.py: ``PrecisionControlledLinear`` (RPB and ternary)
  and ``EnhancedATQTransformerLayer`` from one flax init, eval outputs
  within 1e-5 (the layer with a mask, 5e-5 of its largest |value|), and
  the importance-derived precision and sparsity equal;
- ``apply_reference_text_init``: its random draws come from a torch
  generator, so the rule is compared: which leaves change (unrolled and
  scanned), the xavier bounds, the embedding's N(0, 0.02), the clobbered
  positional table;
- utils/metrics.py: ``estimate_flops`` equal on the classifier and the
  retrieval model, ``accuracy`` (no ties) and ``confusion_matrix`` equal.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.data import multimodal_dataset as jds
from atq_tpu.data import text_utils as jtu
from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
)
from atq_tpu.models.legacy import ATQMultimodalClassifier as JaxLegacy
from atq_tpu.models.text_encoder import (
    ATQTextEncoder as JaxTextEncoder,
    apply_reference_text_init as jax_reference_init,
)
from atq_tpu.nn import mixed_precision as jmp
from atq_tpu.utils import metrics as jmetrics
from atq_tpu_torch.data import multimodal_dataset as tds
from atq_tpu_torch.data import text_utils as ttu
from atq_tpu_torch.models.image_classifier import ATQImageClassifier
from atq_tpu_torch.models.legacy import ATQMultimodalClassifier, MultimodalATQ
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.models.text_encoder import (
    ATQTextEncoder,
    apply_reference_text_init,
)
from atq_tpu_torch.nn import mixed_precision as tmp
from atq_tpu_torch.utils import metrics as tmetrics
from atq_tpu_torch.utils.jax_interop import from_jax_variables

TEXTS = ["A dog runs on the grass.", "Two dogs run; the grass is green!",
         "a cat sleeps 3 times", "the dog and the cat"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(from_jax_variables(
        {k: _np(v) for k, v in variables.items()}), strict=True)
    return module


@pytest.fixture(params=["fallback", "nltk"])
def nltk_branch(request, monkeypatch):
    """The offline fallback as this machine has it, or the NLTK branch
    with NLTK's data stood in for: a tokenizer that splits off trailing
    punctuation and a four-word stopword list."""
    if request.param == "nltk":
        import nltk
        import nltk.corpus

        monkeypatch.setattr(nltk.data, "find", lambda name: name)
        monkeypatch.setattr(nltk.tokenize, "word_tokenize",
                            lambda t: t.replace(".", " .").split())
        monkeypatch.setattr(nltk.corpus, "stopwords", type(
            "Stop", (), {"words": staticmethod(
                lambda lang: ["the", "a", "on", "is"])}))
    return request.param


def test_text_utils_match_jax(nltk_branch):
    assert ttu._word_tokenize(TEXTS[0]) == jtu._word_tokenize(TEXTS[0])
    assert ttu._stopwords() == jtu._stopwords()
    if nltk_branch == "nltk":
        assert ttu._stopwords() == {"the", "a", "on", "is"}
    else:
        assert "dog" not in ttu._stopwords() and "the" in ttu._stopwords()
    vocab = ttu.build_vocabulary(TEXTS, min_freq=1, max_size=50)
    assert vocab == jtu.build_vocabulary(TEXTS, min_freq=1, max_size=50)
    assert [ttu.clean_text(t) for t in TEXTS] == [jtu.clean_text(t)
                                                  for t in TEXTS]
    ids, lengths = ttu.tokenize_texts(TEXTS, vocab, max_length=6)
    jids, jlengths = jtu.tokenize_texts(TEXTS, vocab, max_length=6)
    np.testing.assert_array_equal(ids, jids)
    assert lengths == jlengths


def test_create_embedding_matrix_reads_glove(tmp_path):
    vocab = ttu.build_vocabulary(TEXTS, min_freq=1)
    glove = tmp_path / "glove.txt"
    glove.write_text("dog 0.5 -1.0 2.0\ncat 1 2 3\nbad 1 2\n"
                     "grass 0.25 0.5 0.75\n")
    got = ttu.create_embedding_matrix(vocab, 3, str(glove), seed=3)
    np.testing.assert_array_equal(
        got, jtu.create_embedding_matrix(vocab, 3, str(glove), seed=3))
    np.testing.assert_array_equal(got[vocab["dog"]], [0.5, -1.0, 2.0])
    assert not got[vocab["<PAD>"]].any()
    assert got.dtype == np.float32 and got.shape == (len(vocab), 3)


def test_multimodal_dataset_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    items = []
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (6, 5, 3), np.uint8)).save(
            tmp_path / f"im{i}.png")
        items.append({"image": f"im{i}.png", "text": TEXTS[i].lower()})
    items[0]["label"] = 4
    (tmp_path / "items.json").write_text(json.dumps(items))
    vocab = ttu.build_vocabulary(TEXTS, min_freq=1)
    for v in (vocab, None):
        got = tds.MultimodalDataset(str(tmp_path),
                                    str(tmp_path / "items.json"), vocab=v,
                                    max_length=4)
        want = jds.MultimodalDataset(str(tmp_path),
                                     str(tmp_path / "items.json"), vocab=v,
                                     max_length=4)
        assert len(got) == len(want) == 3
        for i in range(3):
            g, w = got[i], want[i]
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g["image"], w["image"])
            assert g["image"].shape == (6, 5, 3)
            np.testing.assert_array_equal(g["text"], w["text"])
            assert (g["text_length"], g["label"]) == (w["text_length"],
                                                      w["label"])


@pytest.fixture(scope="module")
def legacy():
    jm = JaxLegacy(vocab_size=30, embed_dim=16, hidden_dim=32)
    rng = np.random.RandomState(1)
    image = rng.randn(3, 28, 28, 1).astype(np.float32)
    text = rng.randint(4, 30, (3, 7)).astype(np.int32)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(image),
                             jnp.asarray(text)))
    port = _load(ATQMultimodalClassifier(vocab_size=30, embed_dim=16,
                                         hidden_dim=32, device="cpu"), v)
    return jm, v, port, image, text


@pytest.mark.parametrize("drop", ["none", "image", "text"])
def test_legacy_classifier_matches_jax(legacy, drop):
    jm, v, port, image, text = legacy
    kw = {"drop_image": drop == "image", "drop_text": drop == "text"}
    pad = np.arange(7)[None, :] >= np.asarray([7, 4, 2])[:, None]
    want = np.asarray(jax.jit(lambda var, *a: jm.apply(var, *a, **kw))(
        v, jnp.asarray(image), jnp.asarray(text), jnp.asarray(pad)))
    with torch.no_grad():
        got = port(torch.from_numpy(image), torch.from_numpy(text).long(),
                   torch.from_numpy(pad), **kw).numpy()
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert MultimodalATQ is ATQMultimodalClassifier


@pytest.mark.parametrize("use_rpb", [True, False])
def test_precision_controlled_linear_matches_jax(use_rpb):
    x = np.random.RandomState(2).randn(4, 24).astype(np.float32)
    jl = jmp.PrecisionControlledLinear(features=12, importance=1.6,
                                       use_rpb=use_rpb)
    v = _np(jl.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tl = _load(tmp.PrecisionControlledLinear(24, 12, importance=1.6,
                                             use_rpb=use_rpb, device="cpu"),
               v)
    if use_rpb:
        assert tl.linear.precision_ratio == pytest.approx(0.05 * 1.6)
        assert float(tl.linear.sparsity_target) == pytest.approx(
            float(v["quant"]["linear"]["sparsity_target"]))
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.apply(v, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_enhanced_transformer_layer_matches_jax():
    x = np.random.RandomState(3).randn(2, 6, 16).astype(np.float32)
    mask = np.ones((2, 1, 6, 6), np.float32)
    mask[1, :, :, 4:] = 0.0
    jl = jmp.EnhancedATQTransformerLayer(embed_dim=16, num_heads=4,
                                         dim_feedforward=32, layer_idx=2)
    v = _np(jax.jit(jl.init)(jax.random.PRNGKey(2), jnp.asarray(x)))
    tl = _load(tmp.EnhancedATQTransformerLayer(16, 4, 32, layer_idx=2,
                                               device="cpu"), v)
    want = np.asarray(jax.jit(jl.apply)(v, jnp.asarray(x),
                                        jnp.asarray(mask)))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-5 * np.abs(want).max())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("scanned", [False, True], ids=["unrolled",
                                                        "scanned"])
def test_reference_text_init_follows_the_jax_rule(scanned):
    enc = ATQTextEncoder(vocab_size=50, embed_dim=32, num_heads=4,
                         num_layers=2, dim_feedforward=64,
                         scan_layers=scanned, device="cpu")
    from atq_tpu_torch.utils.jax_interop import to_jax_variables

    v = to_jax_variables(enc.state_dict())
    got = apply_reference_text_init(v, torch.Generator().manual_seed(0))
    want = jax_reference_init(v, jax.random.PRNGKey(0))
    before = dict(_leaves(v["params"]))
    g, w = dict(_leaves(got["params"])), dict(_leaves(_np(want["params"])))
    assert g.keys() == w.keys() == before.keys()
    changed = {k for k in w if not np.array_equal(w[k], before[k])}
    assert changed == {k for k in g if not np.array_equal(g[k], before[k])}
    assert any("scan" in k for k in changed) == scanned
    for k in changed:
        assert g[k].shape == before[k].shape and g[k].dtype == np.float32
        if k[-1] == "embedding":
            assert g[k].std() == pytest.approx(0.02, rel=0.05)
            continue
        bound = 0.8 * math.sqrt(6.0 / (g[k].shape[-1] + g[k].shape[-2]))
        assert np.abs(g[k]).max() <= bound
        assert np.abs(g[k]).max() > 0.9 * bound
    pe = got["constants"]["positional_encoding"]
    bound = 0.8 * math.sqrt(6.0 / (pe.shape[-1] + pe.shape[-2]))
    assert not np.array_equal(pe, v["constants"]["positional_encoding"])
    assert np.abs(pe).max() <= bound
    assert np.abs(np.asarray(
        want["constants"]["positional_encoding"])).max() <= bound


def test_estimate_flops_matches_jax():
    clf = ATQImageClassifier(device="cpu")
    jv = JaxClassifier().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 28, 28, 1)))
    for size in ((1, 28, 28), (784,)):
        assert tmetrics.estimate_flops(clf, size) == \
            jmetrics.estimate_flops(jv["params"], size) > 0
    ret = ATQMultimodalRetrieval(vocab_size=40, embed_dim=32, hidden_dim=64,
                                 max_seq_length=8, text_moe_experts=2,
                                 device="cpu")
    params = ret.jax_variables()["params"]
    assert tmetrics.estimate_flops(ret, (3, 32, 32)) == \
        jmetrics.estimate_flops(params, (3, 32, 32))


def test_accuracy_and_confusion_matrix_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(50, 10).astype(np.float32)  # no ties
    target = rng.randint(0, 10, 50)
    assert tmetrics.accuracy(torch.from_numpy(logits),
                             torch.from_numpy(target), (1, 3, 5)) == \
        jmetrics.accuracy(logits, target, (1, 3, 5))
    preds = logits.argmax(1)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(preds, target),
                                  jmetrics.confusion_matrix(preds, target))
    np.testing.assert_array_equal(
        tmetrics.confusion_matrix(preds, target, num_classes=12),
        jmetrics.confusion_matrix(preds, target, num_classes=12))
