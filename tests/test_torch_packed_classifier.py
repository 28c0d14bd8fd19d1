"""The port's last public names against the JAX package's on the CPU.

- ``serve.PackedClassifier`` (the classifier's conv features dense, its
  head from 2-bit planes) against ``atq_tpu``'s on one seeded checkpoint
  carried over by utils/jax_interop.py: logits within rtol/atol 1e-5 (the
  tolerance tests/test_torch_serve.py holds the packed port to), and
  ``memory_footprint_bytes`` equal field for field; RPB, ternary and
  ``ATQ_PACK32`` heads.
- ``train.classifier.build_eval_step`` against JAX's on one batch, dense
  and packed: ``correct`` and ``count`` equal, ``loss`` within 1e-5
  relative, and the model left dense after a packed step; ``load_checkpoint`` with and without a template (an optax
  state's named tuples among it) against JAX's reader.
- ``nn.transformer.normalize_text_encoder_layout`` against JAX's on a
  scanned subtree, bit for bit; ``resnet18_features``/``resnet50_features``,
  ``modality_dropout_flags``, ``xavier_uniform_gain_`` and
  ``peak_flops_per_chip`` against their JAX counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
)
from atq_tpu.models.resnet import (
    resnet18_features as jax_resnet18,
    resnet50_features as jax_resnet50,
)
from atq_tpu.nn.initializers import xavier_uniform_gain
from atq_tpu.nn.transformer import (
    normalize_text_encoder_layout as jax_normalize,
    stack_layer_params,
)
from atq_tpu.serve.packed_model import (
    PackedClassifier as JaxPackedClassifier,
    export_packed_collection as jax_export,
)
from atq_tpu.train.classifier import (
    _save_checkpoint,
    build_eval_step as jax_build_eval_step,
    load_checkpoint as jax_load_checkpoint,
)
from atq_tpu.utils.flops import peak_flops_per_chip as jax_peak
from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
from atq_tpu_torch.models.image_classifier import ATQImageClassifier
from atq_tpu_torch.models.resnet import resnet18_features, resnet50_features
from atq_tpu_torch.models.retrieval import modality_dropout_flags
from atq_tpu_torch.models.text_encoder import ATQTextEncoder
from atq_tpu_torch.nn.initializers import xavier_uniform_gain_
from atq_tpu_torch.nn.transformer import normalize_text_encoder_layout
from atq_tpu_torch.serve import PackedClassifier, pack_quantized_params
from atq_tpu_torch.serve.packed_model import export_packed_collection
from atq_tpu_torch.train.classifier import build_eval_step, load_checkpoint
from atq_tpu_torch.utils.flops import peak_flops_per_chip
from atq_tpu_torch.utils.jax_interop import (
    from_jax_variables,
    to_jax_variables,
)

TOL = 1e-5
BATCH = 16


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded(use_rpb, seed=0):
    """A seeded classifier as JAX-layout variables: BatchNorm statistics
    drawn and each head layer at its optimal alpha, as a trained
    checkpoint holds them (chip_smoke.py's checkpoint)."""
    gen = torch.Generator().manual_seed(seed)
    model = ATQImageClassifier(use_rpb=use_rpb, hidden_size=128,
                               device="cpu", generator=gen)
    with torch.no_grad():
        for bn in (model.features.bn1, model.features.bn2):
            bn.running_mean.normal_(0.0, 0.1, generator=gen)
            bn.running_var.uniform_(0.5, 1.5, generator=gen)
        for layer in (model.classifier_0, model.classifier_3):
            _, a = adaptive_ternary_quantization(
                layer.weight, sparsity_target=getattr(
                    layer, "sparsity_target", 0.3))
            layer.alpha.fill_(float(a))
    return model, to_jax_variables(model.state_dict())


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((BATCH, 28, 28, 1)).astype(np.float32)
    return images, rng.integers(0, 10, BATCH).astype(np.int32)


@pytest.mark.parametrize("use_rpb,pack32", [(True, False), (False, False),
                                            (True, True)],
                         ids=["rpb", "ternary", "rpb_pack32"])
def test_packed_classifier_matches_jax(monkeypatch, use_rpb, pack32):
    monkeypatch.setenv("ATQ_PACK32", "1" if pack32 else "0")
    _, v = _seeded(use_rpb)
    images, _ = _batch()
    port = PackedClassifier(v["params"], v.get("quant", {}),
                            v["batch_stats"], use_rpb=use_rpb,
                            hidden_size=128, device="cpu")
    ref = JaxPackedClassifier(v["params"], v.get("quant", {}),
                              v["batch_stats"], use_rpb=use_rpb,
                              hidden_size=128)
    got = port(images)
    assert got.device.type == "cpu" and got.shape == (BATCH, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(images)),
                               rtol=TOL, atol=TOL)
    footprint = port.memory_footprint_bytes()
    assert footprint == ref.memory_footprint_bytes()
    assert footprint["packed_bytes"] < footprint["dense_fp32_bytes"]
    assert set(port.packed) == {"classifier_0", "classifier_3"}
    fields = {k for e in port.packed.values() for k in e}
    assert ("corr_idx" in fields) == use_rpb
    assert (port.packed["classifier_0"]["packed"].dtype == torch.int32) \
        == pack32


def test_packed_classifier_checks_the_head():
    _, v = _seeded(True)
    with pytest.raises(ValueError, match="hidden_size=256"):
        PackedClassifier(v["params"], v["quant"], v["batch_stats"],
                         hidden_size=256, device="cpu")
    with pytest.raises(ValueError, match="use_rpb=False"):
        PackedClassifier(v["params"], v["quant"], v["batch_stats"],
                         use_rpb=False, device="cpu")
    packed = pack_quantized_params(v["params"], v["quant"],
                                   ["classifier_3"], device="cpu")
    assert list(packed) == ["classifier_3"]
    assert packed["classifier_3"]["shape"] == (10, 128)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_build_eval_step_matches_jax(packed):
    model, v = _seeded(True)
    images, labels = _batch(1)
    jax_model = JaxClassifier(use_rpb=True, hidden_size=128)
    state = {"atq_params": v["params"], "quant": v["quant"],
             "atq_batch_stats": v["batch_stats"]}
    want = jax.device_get(jax_build_eval_step(
        jax_model, "atq_params", "atq_batch_stats",
        packed=jax_export(v["params"], v["quant"]) if packed else None)(
            state, (jnp.asarray(images), jnp.asarray(labels))))
    step = build_eval_step(model, packed=export_packed_collection(
        v["params"], v["quant"], device="cpu") if packed else None)
    got = step((torch.from_numpy(images), torch.from_numpy(labels).long()))
    assert set(got) == set(want) == {"loss", "correct", "count"}
    assert int(got["correct"]) == int(want["correct"])
    assert int(got["count"]) == int(want["count"]) == BATCH
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=TOL)
    assert all(t.device.type == "cpu" for t in got.values())
    assert model.classifier_0.packed_entry is None  # left as it was


def test_build_eval_step_packed_then_dense():
    """A packed step leaves the model dense, as JAX's leaves its apply: a
    dense step built after it on the same model gives the dense sums."""
    model, v = _seeded(True)
    images, labels = _batch(2)
    batch = (torch.from_numpy(images), torch.from_numpy(labels).long())
    dense_first = build_eval_step(model)(batch)
    packed = build_eval_step(model, packed=export_packed_collection(
        v["params"], v["quant"], device="cpu"))(batch)
    dense_after = build_eval_step(model)(batch)
    for k in dense_first:
        assert torch.equal(dense_after[k], dense_first[k]), k
    assert not torch.equal(packed["loss"], dense_first["loss"])


def _leaves_equal(got, want):
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) > 0
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_checkpoint_matches_jax(tmp_path):
    _, v = _seeded(True)
    params = v["params"]["classifier_3"]
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(1e-3)).init(params)
    _, opt = optax.chain(optax.clip_by_global_norm(1.0),
                               optax.adam(1e-3)).update(
        jax.tree_util.tree_map(jnp.ones_like, params), opt, params)
    tree = {"params": v["params"], "opt": jax.device_get(opt)}
    path = str(tmp_path / "ckpt.npz")
    _save_checkpoint(tree, path)

    plain = load_checkpoint(path)
    _leaves_equal(plain, jax_load_checkpoint(path))
    assert isinstance(plain["params"]["classifier_3"]["weight"],
                      torch.Tensor)

    # A template of the state's structure, with a leaf the file lacks.
    template = {"params": v["params"],
                "opt": jax.tree_util.tree_map(np.zeros_like, tree["opt"]),
                "extra": np.full((2,), 7.0, np.float32)}
    got = load_checkpoint(path, template=template)
    want = jax_load_checkpoint(path, template=template)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    _leaves_equal(got, want)
    adam = got["opt"][1][0]  # chain(clip, chain(scale_by_adam, ...))
    assert type(adam) is type(want["opt"][1][0]) and int(adam.count) == 1
    np.testing.assert_array_equal(got["extra"], template["extra"])
    on_tensors = load_checkpoint(path, template={
        "params": {"classifier_3": {"alpha": torch.zeros(1)}}})
    assert isinstance(on_tensors["params"]["classifier_3"]["alpha"],
                      torch.Tensor)
    np.testing.assert_array_equal(
        on_tensors["params"]["classifier_3"]["alpha"],
        v["params"]["classifier_3"]["alpha"])


def test_normalize_text_encoder_layout_matches_jax():
    te = ATQTextEncoder(vocab_size=40, embed_dim=32, num_heads=8,
                        num_layers=3, dim_feedforward=64, max_seq_length=12,
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    variables = to_jax_variables(te.state_dict())
    params, quant = variables["params"], variables["quant"]
    scanned_p = jax.device_get(stack_layer_params(params, 3))
    scanned_q = jax.device_get(stack_layer_params(quant, 3))
    got = normalize_text_encoder_layout(scanned_p, scanned_q)
    want = jax_normalize(scanned_p, scanned_q)
    assert got[2] is want[2] is True
    for g, w in zip(got[:2], want[:2]):
        assert jax.tree_util.tree_structure(g) == \
            jax.tree_util.tree_structure(w)
        _leaves_equal(g, w)
    _leaves_equal(got[0], params)
    # An unrolled subtree comes back as it is; a wrong count raises.
    same = normalize_text_encoder_layout(params, quant, num_layers=3)
    assert same[0] is params and same[1] is quant and same[2] is False
    with pytest.raises(ValueError, match="3 layers"):
        normalize_text_encoder_layout(scanned_p, scanned_q, num_layers=4)
    with pytest.raises(ValueError, match="3 layers"):
        jax_normalize(scanned_p, scanned_q, num_layers=4)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_features_match_jax_layout(arch):
    port = {"resnet18": resnet18_features,
            "resnet50": resnet50_features}[arch](device="cpu")
    jax_model = {"resnet18": jax_resnet18, "resnet50": jax_resnet50}[arch]()
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), train=False))
    want = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))
    got = from_jax_variables(want)
    sd = port.state_dict()
    assert set(got) == set(sd)
    assert all(tuple(sd[k].shape) == tuple(got[k].shape) for k in got)
    x = torch.zeros((2, 32, 32, 3))
    assert port(x).shape == (2, {"resnet18": 512, "resnet50": 2048}[arch])


def test_modality_dropout_flags():
    gen = torch.Generator().manual_seed(0)
    assert modality_dropout_flags(gen, 0.0) == (False, False)
    assert modality_dropout_flags(gen, 1.0) == (True, True)
    flags = [modality_dropout_flags(torch.Generator().manual_seed(s), 0.3)
             for s in range(400)]
    assert all(isinstance(f, bool) for pair in flags for f in pair)
    share = np.mean(flags, axis=0)
    assert np.all(np.abs(share - 0.3) < 0.08), share
    again = [modality_dropout_flags(torch.Generator().manual_seed(s), 0.3)
             for s in range(400)]
    assert again == flags


@pytest.mark.parametrize("shape", [(64, 32), (3, 48, 16)])
def test_xavier_uniform_gain_matches_jax_bound(shape):
    got = xavier_uniform_gain_(torch.empty(shape), 0.8,
                               generator=torch.Generator().manual_seed(0))
    want = np.asarray(xavier_uniform_gain(0.8)(jax.random.PRNGKey(0),
                                               shape))
    bound = 0.8 * np.sqrt(6.0 / (shape[-1] + shape[-2]))
    for a in (got.numpy(), want):
        assert np.abs(a).max() <= bound
        assert np.abs(a).max() > 0.9 * bound
    assert abs(float(got.std()) - float(want.std())) < 0.1 * bound


def test_peak_flops_per_chip():
    assert peak_flops_per_chip("cpu") is None
    assert jax_peak(jax.devices("cpu")[0]) is None
    if not torch.cuda.is_available():
        assert peak_flops_per_chip() is None
