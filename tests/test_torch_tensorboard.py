"""``--tensorboard-dir`` / ``--tensorboard_dir`` and utils/tb.py's
``MetricsWriter`` in the port, read back from the event files on the CPU.

- The classifier CLI writes, at steps 1 and 2, the tags that atq_tpu's
  classifier trainer writes (its ``classifier/`` dict,
  atq_tpu/train/classifier.py:655-661, read from a JAX run with the same
  flags), with the values of the run's own results.
- The retrieval CLI writes ``retrieval/`` plus every ``metrics.jsonl`` key
  at steps 1 and 2, with the values of ``metrics.jsonl``: the events that
  atq_tpu's writer makes of those rows as its trainer passes them
  (atq_tpu/train/retrieval.py:940-941; the backend turns ``@`` into
  ``_``). The ``metrics.jsonl`` keys are held to JAX's in
  tests/test_torch_retrieval_artifacts.py.
- With both backends unimportable the writer warns once and every call is
  a no-op (no file written); without a logdir it is silent.

Event files are read with tensorboardX's protos (no TensorFlow import).
"""

import glob
import json
import os
import struct
import sys
import warnings

import numpy as np
import pytest
import torch

from atq_tpu.data import flickr8k as jax_f8k
from atq_tpu.data import mnist as jax_mnist
from atq_tpu.train import classifier as jclassifier
from atq_tpu.utils.tb import MetricsWriter as JaxMetricsWriter
from atq_tpu_torch.train import retrieval as pretrieval
from atq_tpu_torch.train.__main__ import main as classifier_main
from atq_tpu_torch.utils.tb import MetricsWriter

SUBSET = "0.004"  # 240 training images: 3 steps of 64 an epoch


@pytest.fixture(autouse=True)
def _one_thread_no_download(monkeypatch):
    monkeypatch.setenv("ATQ_NO_DOWNLOAD", "1")
    monkeypatch.setattr(jax_f8k, "_USE_NLTK", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scalars(logdir):
    """``{tag: [(step, value), ...]}`` from the event files under
    ``logdir`` (TFRecord frames of ``Event`` protos)."""
    from tensorboardX.proto import event_pb2

    out = {}
    files = sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*")))
    assert files, f"no event file under {logdir}"
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event()
            event.ParseFromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step,
                                                  v.simple_value))
    return out


def test_classifier_writes_the_jax_scalars(tmp_path):
    jtb, ptb = str(tmp_path / "jax_tb"), str(tmp_path / "port_tb")
    loaders = jax_mnist.get_fashion_mnist_data(
        64, str(tmp_path / "data"), subset_fraction=float(SUBSET))
    jclassifier.train_classifier(jclassifier.ClassifierConfig(
        use_rpb=True, epochs=2, batch_size=64, tensorboard_dir=jtb,
        checkpoint_dir=str(tmp_path / "jax_ck")), loaders=loaders,
        verbose=False)
    _, results = classifier_main([
        "--use-rpb", "--epochs", "2", "--batch-size", "64",
        "--subset-fraction", SUBSET, "--tensorboard-dir", ptb,
        "--checkpoint-dir", str(tmp_path / "port_ck"), "--plots-dir",
        str(tmp_path / "plots"), "--data-dir", str(tmp_path / "data"),
        "--device", "cpu"])
    want, got = _scalars(jtb), _scalars(ptb)
    assert sorted(got) == sorted(want) == sorted(
        f"classifier/{k}" for k in ("train_acc", "base_acc", "val_acc",
                                    "loss", "sparsity", "imgs_per_sec"))
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] \
            == [1, 2], tag
    # The port's values are its run's own (float32 in the event file).
    for tag, key in (("val_acc", "val_accuracies"),
                     ("train_acc", "train_accuracies"),
                     ("loss", "epoch_losses"),
                     ("sparsity", "sparsity_schedule"),
                     ("imgs_per_sec", "imgs_per_sec")):
        np.testing.assert_allclose([v for _, v in got[f"classifier/{tag}"]],
                                   results[key], rtol=1e-6, err_msg=tag)
    # Both packages write the same sparsity schedule.
    np.testing.assert_array_equal(
        [v for _, v in got["classifier/sparsity"]],
        [v for _, v in want["classifier/sparsity"]])


def test_retrieval_writes_the_metrics_jsonl(tmp_path):
    out, tb = tmp_path / "out", str(tmp_path / "tb")
    pretrieval.main([
        "--device", "cpu", "--batch_size", "4", "--embed_dim", "32",
        "--hidden_dim", "64", "--image_size", "32", "--max_seq_length", "8",
        "--synthetic_images", "20", "--epochs", "2", "--use_residual",
        "--output_dir", str(out), "--data_dir", str(tmp_path / "none"),
        "--tensorboard_dir", tb])
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert "train_loss" in rows[0] and "mean_R@1" in rows[0]
    jtb = str(tmp_path / "jax_tb")
    writer = JaxMetricsWriter(jtb)
    for row in rows:
        writer.scalars(row["epoch"], {k: v for k, v in row.items()
                                      if k != "epoch"}, prefix="retrieval/")
    writer.close()
    want, got = _scalars(jtb), _scalars(tb)
    assert len(want) == len(rows[0]) - 1
    assert got == want


def test_writer_is_a_noop_with_a_warning_without_backends(tmp_path,
                                                          monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logdir = tmp_path / "tb"
    with pytest.warns(UserWarning, match="no working tensorboardX"):
        writer = MetricsWriter(str(logdir))
    assert not writer.active
    writer.scalars(1, {"loss": 1.0})
    writer.flush()
    writer.close()
    assert not logdir.exists()


def test_writer_without_a_logdir_is_silent(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        writer = MetricsWriter(None)
        writer.scalars(1, {"loss": 1.0})
        writer.close()
    assert not writer.active
    logdir = str(tmp_path / "tb")
    writer = MetricsWriter(logdir)
    assert writer.active
    writer.scalars(3, {"a": 2.5, "skipped": "not a number"}, prefix="p/")
    writer.close()
    assert _scalars(logdir) == {"p/a": [(3, 2.5)]}
