"""Reference ``.pth`` interop in the port (utils/torch_interop.py,
models/resnet.py's torchvision importer, the retrieval trainer's
``--imagenet_weights``) against atq_tpu's on the CPU. Every state dict is
made here from a numpy seed, in the reference's (or torchvision's) names
and shapes; nothing is downloaded.

- ``import_classifier_state_dict``, ``import_text_encoder_state_dict``,
  ``import_fusion_state_dict`` and ``import_retrieval_state_dict`` give
  JAX's trees bit for bit (keys, dtypes, values), and the ``export_*``
  functions give JAX's state dicts bit for bit, a scanned text tower
  included; the imported trees load into the port's models through
  ``from_jax_variables`` and embed there as on JAX;
- ``load_torch_state_dict`` (torchvision ResNet-18 names, with the ``fc``
  head and ``num_batches_tracked`` that it skips) and
  ``load_imagenet_weights`` give JAX's ``(params, batch_stats)`` bit for
  bit; a file whose sha256 misses the manifest prefix raises the same
  ValueError on both sides;
- ``--imagenet_weights`` with ``--reinit_model``, the manifest prefix set
  to the test file's digest on both sides: each trainer grafts the file's
  backbone before its re-init (the tree the re-init is given holds the
  file's weights, the same on both sides) and prints JAX's warning.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.data import flickr8k as jax_f8k
from atq_tpu.models import image_classifier as jax_classifier_mod
from atq_tpu.models import resnet as jax_resnet
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.train import retrieval as jtrain
from atq_tpu.utils import torch_interop as jinterop
from atq_tpu_torch.models import resnet as port_resnet
from atq_tpu_torch.models.image_classifier import ATQImageClassifier
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils import torch_interop as pinterop
from atq_tpu_torch.utils.jax_interop import (
    from_jax_variables,
    to_jax_variables,
)

EMBED, HIDDEN, SEQ, VOCAB = 32, 64, 8, 40


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setattr(jax_f8k, "_USE_NLTK", False)
    monkeypatch.delenv("ATQ_SPLIT_TOKENIZER", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


def _assert_same_sd(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype, k
        assert np.array_equal(g, np.asarray(w)), k


def _seeded(sd, seed):
    """The same names and shapes, new float32 values from a numpy seed:
    N(0, 0.1²), masks 0/1, running variances in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(sd.items()):
        shape = np.shape(v)
        if k.endswith("precision_mask"):
            out[k] = np.asarray(rng.rand(*shape) < 0.3, np.float32)
        elif k.endswith("running_var"):
            out[k] = np.asarray(0.5 + rng.rand(*shape), np.float32)
        else:
            out[k] = np.asarray(0.1 * rng.randn(*shape), np.float32)
    return out


def _retrieval_sd(seed, scanned=False):
    """A reference-format retrieval state dict: the port model's JAX trees
    through JAX's exporter (for the names and shapes), values seeded."""
    model = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
        use_residual=True, max_seq_length=SEQ, text_scan_layers=scanned,
        device="cpu")
    v = model.jax_variables()
    sd = jinterop.export_retrieval_params(v["params"], v["quant"],
                                          v["constants"], v["batch_stats"])
    return _seeded(sd, seed), v


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_classifier_import_and_export_equal_jax():
    model = ATQImageClassifier(use_rpb=True, hidden_size=128, device="cpu")
    v = to_jax_variables(model.state_dict())
    sd = _seeded(jinterop.export_classifier_params(
        v["params"], v["quant"], v["batch_stats"]), 1)
    want = _tree_np(jinterop.import_classifier_state_dict(sd))
    got = pinterop.import_classifier_state_dict(sd)
    for g, w in zip(got, want):
        _assert_same_tree(g, w)
    _assert_same_sd(pinterop.export_classifier_params(*got),
                    jinterop.export_classifier_params(*want))
    # Into the port's model, and the same logits as JAX's model.
    params, quant, stats = got
    model.load_state_dict(from_jax_variables(
        {"params": params, "quant": quant, "batch_stats": stats}))
    x = np.random.RandomState(3).randn(2, 28, 28, 1).astype(np.float32)
    jmodel = jax_classifier_mod.ATQImageClassifier(use_rpb=True,
                                                   hidden_size=128)
    wl = np.asarray(jmodel.apply({"params": want[0], "quant": want[1],
                                  "batch_stats": want[2]}, jnp.asarray(x),
                                 train=False))
    with torch.no_grad():
        gl = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scanned", [False, True],
                         ids=["unrolled", "scanned"])
def test_retrieval_import_and_export_equal_jax(scanned):
    sd, _ = _retrieval_sd(2)
    want = _tree_np(jinterop.import_retrieval_state_dict(sd))
    got = pinterop.import_retrieval_state_dict(sd)
    for g, w in zip(got, want):
        _assert_same_tree(g, w)
    for name, g, w in (
            ("text", pinterop.import_text_encoder_state_dict(
                sd, prefix="text_encoder."),
             jinterop.import_text_encoder_state_dict(
                 sd, prefix="text_encoder.")),
            ("fusion", pinterop.import_fusion_state_dict(
                sd, prefix="fusion."),
             jinterop.import_fusion_state_dict(sd, prefix="fusion."))):
        for a, b in zip(g, _tree_np(w)):
            _assert_same_tree(a, b)
    if scanned:  # the exporters take a scanned text tower too
        _, v = _retrieval_sd(2, scanned=True)
        trees = (v["params"], v["quant"], v["constants"], v["batch_stats"])
    else:
        trees = got
    _assert_same_sd(pinterop.export_retrieval_params(*trees),
                    jinterop.export_retrieval_params(*trees))
    p, q, c = (trees[0]["text_encoder"], trees[1]["text_encoder"],
               trees[2]["text_encoder"])
    _assert_same_sd(pinterop.export_text_encoder_params(p, q, c),
                    jinterop.export_text_encoder_params(p, q, c))
    _assert_same_sd(
        pinterop.export_fusion_params(trees[0]["fusion"],
                                      trees[1]["fusion"]),
        jinterop.export_fusion_params(trees[0]["fusion"],
                                      trees[1]["fusion"]))


def test_imported_retrieval_embeds_as_on_jax():
    sd, _ = _retrieval_sd(4)
    params, quant, constants, stats = pinterop.import_retrieval_state_dict(
        sd)
    variables = {"params": params, "quant": quant, "constants": constants,
                 "batch_stats": stats}
    port = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
        use_residual=True, max_seq_length=SEQ, device="cpu")
    port.load_jax_variables(variables)
    rng = np.random.RandomState(5)
    batch = (rng.randn(2, 32, 32, 3).astype(np.float32),
             rng.randint(1, VOCAB, (2, SEQ)).astype(np.int32),
             np.asarray([SEQ, 3], np.int32))
    jmodel = JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED,
                          hidden_dim=HIDDEN, use_residual=True,
                          max_seq_length=SEQ)
    want = jmodel.apply(variables, *(jnp.asarray(a) for a in batch),
                        return_embeddings=True, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(batch[0]),
                   torch.from_numpy(batch[1]).long(),
                   torch.from_numpy(batch[2]).long(),
                   return_embeddings=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def _torchvision_resnet18(seed):
    """A torchvision ResNet-18 state dict: the backbone in its names (via
    JAX's exporter of a port ResNet's trees), the ``fc`` head and every
    BatchNorm's ``num_batches_tracked``, values seeded."""
    v = to_jax_variables(port_resnet.ResNetFeatures(device="cpu")
                         .state_dict())
    sd = _seeded(jinterop.export_resnet_params(v["params"],
                                               v["batch_stats"]), seed)
    rng = np.random.RandomState(seed + 1)
    sd["fc.weight"] = rng.randn(1000, 512).astype(np.float32)
    sd["fc.bias"] = rng.randn(1000).astype(np.float32)
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k[:-len("running_mean")] + "num_batches_tracked"] = np.asarray(
            7, np.int64)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def test_load_torch_state_dict_equals_jax():
    sd = _torchvision_resnet18(6)
    want = _tree_np(jax_resnet.load_torch_state_dict(sd))
    got = port_resnet.load_torch_state_dict(sd)
    for g, w in zip(got, want):
        _assert_same_tree(g, w)
    net = port_resnet.ResNetFeatures(device="cpu")
    net.load_state_dict({**from_jax_variables(
        {"params": got[0], "batch_stats": got[1]})}, strict=False)
    assert torch.equal(net.conv1.weight, sd["conv1.weight"])
    assert torch.equal(net.layer4_1.bn2.running_var,
                       sd["layer4.1.bn2.running_var"])


@pytest.fixture
def imagenet_file(tmp_path, monkeypatch):
    """A torchvision-layout ``.pth`` and the manifest prefix set to its
    digest on both sides."""
    path = tmp_path / "resnet18-test.pth"
    torch.save(_torchvision_resnet18(8), path)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    for mod in (jax_resnet, port_resnet):
        monkeypatch.setitem(mod.IMAGENET_MANIFEST, "resnet18", {
            **mod.IMAGENET_MANIFEST["resnet18"],
            "sha256_prefix": digest[:8]})
    return str(path)


def test_load_imagenet_weights_equals_jax(imagenet_file):
    want = _tree_np(jax_resnet.load_imagenet_weights(imagenet_file))
    got = port_resnet.load_imagenet_weights(imagenet_file)
    for g, w in zip(got, want):
        _assert_same_tree(g, w)


def test_a_wrong_digest_raises_the_jax_error(tmp_path):
    path = tmp_path / "resnet18.pth"
    torch.save(_torchvision_resnet18(9), path)
    errors = []
    for mod in (jax_resnet, port_resnet):
        with pytest.raises(ValueError, match="manifest prefix") as e:
            mod.load_imagenet_weights(str(path))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "f37072fd" in errors[1]


class _Stop(Exception):
    pass


def test_imagenet_weights_graft_before_reinit(imagenet_file, tmp_path,
                                              monkeypatch, capsys):
    """Each trainer's re-init is handed the grafted backbone: the file's
    weights, the same on both sides."""
    seen = {}

    def recorder(side):
        def reinit(params, _rng):
            seen[side] = _tree_np(params)["image_encoder"]["base_model"]
            raise _Stop
        return reinit

    monkeypatch.setattr(jtrain, "reinit_params", recorder("jax"))
    monkeypatch.setattr(ptrain, "reinit_params", recorder("port"))
    kw = dict(batch_size=4, image_size=32, embed_dim=EMBED,
              hidden_dim=HIDDEN, max_seq_length=SEQ, use_residual=True,
              synthetic_images=20, epochs=1, reinit_model=True,
              imagenet_weights=imagenet_file,
              data_dir=str(tmp_path / "none"), device="cpu")
    for side, trainer, cfg in (
            ("jax", jtrain.train_retrieval, jtrain.RetrievalConfig),
            ("port", ptrain.train_retrieval, ptrain.RetrievalConfig)):
        with pytest.raises(_Stop):
            trainer(cfg(**kw, output_dir=str(tmp_path / side)))
        out = capsys.readouterr().out
        assert f"Loaded IMAGENET1K backbone from {imagenet_file}" in out
        assert "WARNING: --reinit_model re-initializes the pretrained " \
            "backbone too" in out
    params, _ = port_resnet.load_imagenet_weights(imagenet_file)
    _assert_same_tree(seen["port"], params)
    _assert_same_tree(seen["jax"], params)


def test_graft_carries_the_batchnorm_statistics(imagenet_file):
    model = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
        use_residual=True, max_seq_length=SEQ, device="cpu")
    ptrain.graft_imagenet_backbone_(model, imagenet_file)
    params, stats = jax_resnet.load_imagenet_weights(imagenet_file)
    v = model.jax_variables()
    _assert_same_tree(v["params"]["image_encoder"]["base_model"],
                      _tree_np(params))
    _assert_same_tree(v["batch_stats"]["image_encoder"]["base_model"],
                      _tree_np(stats))
