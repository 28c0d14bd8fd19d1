"""utils/visualization.py in the port against atq_tpu's on the CPU: the
same weights given as the port's module, its state dict, or the JAX
layout's tree print the same ternary counts as JAX's function (the classic
``0.05·mean|w|`` threshold, a reference quirk both keep), find the same
layers (no BatchNorm, no LayerNorm scale, no embedding table), draw their
figures, and report the same parameter counts and memory."""

import numpy as np
import pytest
import torch

from atq_tpu.utils import visualization as jviz
from atq_tpu_torch.models.image_classifier import ATQImageClassifier
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.utils import visualization as pviz
from atq_tpu_torch.utils.jax_interop import to_jax_variables


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _classifier():
    model = ATQImageClassifier(use_rpb=True, hidden_size=128, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # a trained head is far from uniform
        w = model.classifier_0.weight
        w.copy_(w * torch.linspace(0.01, 2.0, w.shape[1]))
    return model


@pytest.mark.parametrize("layer", ["classifier_0", "classifier_3", "conv2",
                                   "no_such_layer"])
def test_ternary_counts_print_as_on_jax(layer, capsys, tmp_path):
    model = _classifier()
    params = to_jax_variables(model.state_dict())["params"]
    jviz.visualize_ternary_weights(params, layer,
                                   str(tmp_path / "jax.png"))
    want = capsys.readouterr().out
    assert want.startswith(f"Layer {layer} not found." if layer ==
                           "no_such_layer" else f"Layer: {layer}")
    for i, given in enumerate((model, model.state_dict(), params)):
        out = tmp_path / f"port{i}.png"
        pviz.visualize_ternary_weights(given, layer, str(out))
        assert capsys.readouterr().out == want
        assert out.exists() == (layer != "no_such_layer")


def test_the_same_layers_as_jax():
    model = ATQMultimodalRetrieval(vocab_size=30, embed_dim=32,
                                   hidden_dim=64, use_residual=True,
                                   max_seq_length=8, device="cpu")
    params = model.jax_variables()["params"]
    want = [(n, w) for n, w in jviz._named_weights(params)]
    got = list(pviz._named_weights(model))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert not any("norm" in n or "embedding" in n or "bn" in n
                   for n, _ in got)
    for (_, g), (_, w) in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_weight_distribution_figures(capsys, tmp_path):
    model = _classifier()
    out = tmp_path / "hist.png"
    pviz.plot_weight_distribution(model, "classifier", str(out))
    assert out.exists() and out.stat().st_size > 0
    pviz.plot_weight_distribution(model, "absent", str(tmp_path / "x.png"))
    jviz.plot_weight_distribution(
        to_jax_variables(model.state_dict())["params"], "absent")
    port_out, jax_out = capsys.readouterr().out.split("\n", 1)
    assert port_out + "\n" == jax_out == \
        "No weights found with the specified layer name.\n"


def test_compare_model_efficiency(capsys, tmp_path):
    from atq_tpu.utils.metrics import count_parameters, measure_model_memory

    models = {"atq": {"model": _classifier(),
                      "inputs": torch.zeros(1, 28, 28, 1)},
              "dense": {"model": ATQImageClassifier(use_rpb=False,
                                                    device="cpu"),
                        "inputs": torch.zeros(1, 28, 28, 1)}}
    out = tmp_path / "cmp.png"
    results = pviz.compare_model_efficiency(models, (1, 28, 28, 1),
                                            str(out))
    assert out.exists()
    printed = capsys.readouterr().out
    for name, entry in models.items():
        params = to_jax_variables(entry["model"].state_dict())["params"]
        assert results[name]["Parameters (M)"] == \
            count_parameters(params) / 1e6
        assert results[name]["Memory (MB)"] == measure_model_memory(params)
        assert results[name]["Inference Time (ms)"] > 0
        assert name.ljust(20) + " | " in printed
