"""The port stands alone: importing every ``atq_tpu_torch`` module (the
training slices' ``train``, ``data`` and fused-op modules and the retrieval
serving slice's models, int8 trunk, index and tokenizer included) pulls in
neither JAX nor the JAX package, and its entry points refuse to fall back
to the CPU when no device is requested and no GPU is present."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "atq_tpu_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
import atq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(atq_tpu_torch.__path__,
                                                "atq_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "atq_tpu"))
print(len(names), "modules;", "leaked:", bad)
assert not bad, bad
"""


def test_importing_every_module_leaves_jax_out():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|atq_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files
                 if pattern.search(f.read_text())]
    assert not offenders, offenders


def _entry_points():
    from atq_tpu_torch.models.image_classifier import (
        ATQImageClassifier,
        BaselineCNNClassifier,
    )
    from atq_tpu_torch.serve.packed_model import pack_quantized_layer
    from atq_tpu_torch.train.classifier import (
        ClassifierConfig,
        train_classifier,
    )
    from atq_tpu_torch.utils.platform import resolve_device

    from atq_tpu_torch.models.resnet import ResNetFeatures
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.models.text_encoder import ATQTextEncoder
    from atq_tpu_torch.serve.index import EmbeddingIndex
    from atq_tpu_torch.serve.int8_trunk import export_int8_collection

    return [
        lambda: resolve_device(),
        lambda: ATQImageClassifier(),
        lambda: pack_quantized_layer({"weight": torch.zeros(8, 8).numpy(),
                                      "alpha": torch.ones(1).numpy()}),
        lambda: BaselineCNNClassifier(),
        lambda: train_classifier(ClassifierConfig(), loaders=(None,) * 3),
        lambda: ATQMultimodalRetrieval(vocab_size=8, embed_dim=16,
                                       hidden_dim=16),
        lambda: ATQTextEncoder(8, embed_dim=16, num_layers=1,
                               dim_feedforward=16),
        lambda: ResNetFeatures(),
        lambda: EmbeddingIndex(4),
        lambda: export_int8_collection({}, {}),
    ]


def test_expected_modules_exist():
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    for name in ("train/classifier.py", "train/__main__.py",
                 "train/schedules_lr.py", "ops/fused_linear.py",
                 "data/augment.py", "data/prefetch.py", "utils/metrics.py",
                 "ops/fused_attention.py", "nn/attention.py",
                 "nn/transformer.py", "nn/hoist.py", "utils/flops.py",
                 "utils/timing.py", "train/scale.py", "core/packing.py",
                 "models/resnet.py", "models/text_encoder.py",
                 "models/retrieval.py", "serve/int8_trunk.py",
                 "serve/index.py", "data/flickr8k.py", "data/treebank.py"):
        assert name in names, name
    for name in ("fused_linear.cu", "fused_attention.cu", "order_stat.cu"):
        assert (PKG / "csrc" / name).exists(), name


@pytest.mark.parametrize("which", range(10))
def test_entry_points_without_device_raise_on_a_cpu_only_host(which):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no GPU"):
        _entry_points()[which]()


def _serving_cli_defaults_to_cuda(tmp_path, task):
    from atq_tpu_torch.serve.__main__ import build_parser, build_server

    assert build_parser().parse_args(
        ["--task", task, "--checkpoint", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        build_server(["--task", task, "--checkpoint",
                      str(tmp_path / "missing.npz")])


def test_serving_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _serving_cli_defaults_to_cuda(tmp_path, "classification")


def test_retrieval_serving_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _serving_cli_defaults_to_cuda(tmp_path, "retrieval")


def test_training_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from atq_tpu_torch.train.__main__ import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--checkpoint-dir", str(tmp_path), "--subset-fraction",
              "0.01", "--data-dir", str(tmp_path / "data")])
    assert not (tmp_path / "data").exists()  # raised before any data


def test_scale_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from atq_tpu_torch.train.scale import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    out = tmp_path / "rows.json"
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--configs", "bert-base", "--attn", "fused", "--hoist",
              "--out", str(out)])
    assert not out.exists()  # raised before any row


def test_encoder_modules_without_device_raise_on_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from atq_tpu_torch.nn.transformer import ScannedTernaryStack

    with pytest.raises(RuntimeError, match="no GPU"):
        ScannedTernaryStack(1, 8, 2, 16)
