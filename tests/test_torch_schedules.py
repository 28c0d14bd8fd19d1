"""The port's quantization schedules (core/schedules.py) and the retrieval
trainer's sparsity plan against atq_tpu's on the CPU.

The JAX functions map a 'quant' collection to a new one; the port writes
the same values into a model's ``sparsity_target`` buffers. Each case
starts both from one collection (the port model's own, in the JAX layout
through utils/jax_interop.py, the fusion's layers included), runs the
schedule, and requires every ``sparsity_target`` leaf to be equal bit for
bit (both write float32), with the precision masks untouched.
"""

import numpy as np
import pytest
import torch

from atq_tpu.core import schedules as js
from atq_tpu.train.retrieval import (
    RetrievalConfig as JaxConfig,
    retrieval_sparsity_plan as jax_plan,
)
from atq_tpu_torch.core import schedules as ps
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.train.retrieval import (
    RetrievalConfig,
    retrieval_sparsity_plan,
)


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "scanned"])
def model(request):
    return ATQMultimodalRetrieval(
        vocab_size=40, embed_dim=32, hidden_dim=64, use_residual=True,
        max_seq_length=8, text_scan_layers=request.param, device="cpu",
        generator=torch.Generator().manual_seed(0))


def _quant(model):
    return model.jax_variables()["quant"]


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v)
    return out


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("epochs,warmup", [(10, 2), (25, 5), (6, 2), (2, 2),
                                           (3, 0)])
def test_schedule_tables_match_jax(epochs, warmup):
    j = js.GradualQuantizationScheduler(epochs, vision_sparsity=0.3,
                                        text_sparsity=0.2,
                                        warmup_epochs=warmup)
    p = ps.GradualQuantizationScheduler(epochs, vision_sparsity=0.3,
                                        text_sparsity=0.2,
                                        warmup_epochs=warmup)
    assert p.vision_sparsity_schedule == j.vision_sparsity_schedule
    assert p.text_sparsity_schedule == j.text_sparsity_schedule
    for epoch in range(epochs + 2):
        assert p.scheduled_values(epoch) == j.scheduled_values(epoch)


def test_layer_importance_and_params_match_jax(model):
    paths = [path for path, _ in ps.sparsity_buffers(model)]
    assert any(p.startswith("fusion/") for p in paths)
    assert len(paths) == len([k for k in _flat(_quant(model))
                              if k.endswith("sparsity_target")])
    for path in paths + ["intermediate_ffn", "conv1", "other"]:
        assert ps.MixedPrecisionATQ.get_layer_importance(path) == \
            js.MixedPrecisionATQ.get_layer_importance(path)
        for epoch in (0, 3, 9):
            assert ps.MixedPrecisionATQ.calculate_quantization_params(
                path, epoch, 10, 0.3) == \
                js.MixedPrecisionATQ.calculate_quantization_params(
                    path, epoch, 10, 0.3)


@pytest.mark.parametrize("epoch", [0, 1, 4, 9])
def test_gradual_scheduler_step_matches_jax(model, epoch):
    """The recipe's schedule (10 epochs, warmup 2) with the trainer's plan:
    the cascade on the two projectors, then the importance walk over every
    RPB layer, the fusion's included."""
    cfg = RetrievalConfig(gradual_quant=True)
    plan = retrieval_sparsity_plan(cfg)
    assert plan == jax_plan(JaxConfig(gradual_quant=True))
    want = js.GradualQuantizationScheduler(10, warmup_epochs=2).step(
        _quant(model), epoch, plan)
    ps.GradualQuantizationScheduler(10, warmup_epochs=2).step(
        model, epoch, plan)
    _assert_same(_quant(model), want)


@pytest.mark.parametrize("epoch", [0, 3, 8, 12])
def test_set_quant_sparsity_matches_jax(model, epoch):
    """The cascade alone (no --gradual_quant): only the planned layers
    move."""
    plan = retrieval_sparsity_plan(RetrievalConfig(vision_sparsity=0.35,
                                                   text_sparsity=0.25))
    before = _quant(model)
    progress = ps.epoch_progress(epoch, 10)
    assert progress == js.epoch_progress(epoch, 10)
    want = js.set_quant_sparsity(before, plan, progress)
    ps.set_quant_sparsity(model, plan, progress)
    _assert_same(_quant(model), want)


def test_update_model_quantization_classifies_vision_by_image(model):
    want = js.MixedPrecisionATQ.update_model_quantization(
        _quant(model), 5, 10, vision_threshold=0.4, text_threshold=0.15)
    ps.MixedPrecisionATQ.update_model_quantization(
        model, 5, 10, vision_threshold=0.4, text_threshold=0.15)
    _assert_same(_quant(model), want)
    flat = _flat(_quant(model))
    img = flat["fusion/modality_projections_image/projection/"
               "sparsity_target"]
    txt = flat["fusion/modality_projections_text/projection/"
               "sparsity_target"]
    assert img != txt  # 'image' in the path picks the vision threshold
