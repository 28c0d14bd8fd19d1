"""The port's resumable training state (train/checkpoint.py, ``--resume``
in both trainers) on the CPU.

- ``save_train_state`` / ``restore_train_state`` round-trip every kind of
  leaf bit for bit; ``keep`` prunes to the newest steps; ``latest_step``
  ignores a torn temporary file (a write killed before its rename), which
  the next save removes; a missing directory raises ``FileNotFoundError``
  (the trainers then start fresh); a JAX Orbax ``step_N`` (a directory)
  makes both calls raise ``ValueError`` and leaves it untouched;
- an optimizer chain's ``state_dict`` taken mid-run and loaded into a
  fresh chain continues the same updates bit for bit;
- each trainer, 2 epochs writing its state every epoch, against the same
  run resumed after its ``step_2`` state is deleted: the resumed run says
  "Resumed from ... at epoch 1", trains epoch 2 only, and writes a
  ``step_2`` equal to the uninterrupted run's bit for bit (parameters,
  buffers, optimizer moments and counts, EMA, baseline, generators). The
  retrieval run trains with GradCache (``--grad_accum_steps 2``), EMA,
  the co-trained baseline and dropout on uint8 images; the classifier with
  ``--grad-accum-steps 2`` and device augmentation. (``--use_amp`` with
  GradCache and resume runs in the README's CLI example on the CPU and in
  ``chip_smoke.py``; bf16 on the CPU is slow.)
"""

import os

import numpy as np
import pytest
import torch

from atq_tpu_torch.data import flickr8k as pf8k
from atq_tpu_torch.data import mnist as port_mnist
from atq_tpu_torch.train import checkpoint as ckpt
from atq_tpu_torch.train import classifier as pclassifier
from atq_tpu_torch.train import retrieval as pretrieval


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"weight": torch.randn(4, 3, generator=g),
                      "mask": torch.rand(4, 3, generator=g) > 0.5,
                      "scalar": torch.tensor(0.3),
                      "half": torch.randn(5, generator=g).bfloat16()},
            "optimizer": {"count": seed, "mu": [torch.randn(2, generator=g),
                                                torch.zeros(3)]},
            "epoch": seed, "best": 1.5 * seed, "generators": {
                "step": g.get_state()}, "numpy_rng": ckpt.numpy_rng_state(),
            "loader_epoch": None}


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_round_trip(tmp_path):
    state = _state(3)
    path = ckpt.save_train_state(str(tmp_path), 3, state)
    assert path == str(tmp_path / "step_3")
    restored, step = ckpt.restore_train_state(str(tmp_path))
    assert step == 3
    _assert_equal(restored, state)
    assert ckpt.state_digest(restored) == ckpt.state_digest(state)
    assert ckpt.state_digest(_state(4)) != ckpt.state_digest(state)
    np.random.seed(5)
    saved = ckpt.numpy_rng_state()
    want = np.random.rand(3)
    ckpt.set_numpy_rng_state(saved)
    assert np.array_equal(np.random.rand(3), want)


def test_keep_prunes_to_the_newest_steps(tmp_path):
    for step in range(1, 6):
        ckpt.save_train_state(str(tmp_path), step, _state(step), keep=3)
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4", "step_5"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, step = ckpt.restore_train_state(str(tmp_path))
    assert step == 5 and restored["epoch"] == 5
    restored, step = ckpt.restore_train_state(str(tmp_path), step=4)
    assert step == 4 and restored["epoch"] == 4


def test_torn_temporary_is_ignored(tmp_path):
    ckpt.save_train_state(str(tmp_path), 1, _state(1))
    torn = tmp_path / ".tmp_step_2_999"
    torn.write_bytes(b"\x80\x02half a pickle")
    (tmp_path / "step_2.partial").write_bytes(b"")
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored, step = ckpt.restore_train_state(str(tmp_path))
    assert step == 1 and restored["epoch"] == 1
    ckpt.save_train_state(str(tmp_path), 2, _state(2))
    assert not torn.exists()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_missing_directory_raises(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path), step=7)


@pytest.mark.parametrize("call", ["restore", "save"])
def test_a_jax_orbax_step_is_refused(tmp_path, call):
    """Both packages keep their state under ``step_N``; a JAX Orbax step is
    a directory. Either call raises a ValueError naming both formats and
    the way weights cross over, and leaves the directory as it was."""
    from atq_tpu.train import checkpoint as jax_ckpt

    jax_ckpt.save_train_state(str(tmp_path), 2, {
        "params": {"w": np.ones(3, np.float32)}, "epoch": np.asarray(2)})
    jax_ckpt.wait_for_checkpoints()
    assert (tmp_path / "step_2").is_dir()
    listing = sorted(str(p.relative_to(tmp_path))
                     for p in tmp_path.rglob("*"))
    with pytest.raises(ValueError, match=r"(?s)JAX Orbax.*torch\.save.*"
                       r"checkpoint_epoch_N\.npz.*utils/jax_interop\.py"):
        if call == "restore":
            ckpt.restore_train_state(str(tmp_path))
        else:
            ckpt.save_train_state(str(tmp_path), 3, _state(3))
    assert sorted(str(p.relative_to(tmp_path))
                  for p in tmp_path.rglob("*")) == listing


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_state_round_trips(name):
    def chain():
        params = [("a", torch.nn.Parameter(torch.ones(3, 2))),
                  ("b", torch.nn.Parameter(torch.zeros(4)))]
        cfg = pretrieval.RetrievalConfig(optimizer=name, epochs=2,
                                         clip_grad=True)
        return params, pretrieval.make_retrieval_optimizer(cfg, params, 3)

    grads = [[torch.randn(3, 2, generator=torch.Generator().manual_seed(i)),
              torch.randn(4, generator=torch.Generator().manual_seed(i + 9))]
             for i in range(4)]

    def run(params, opt, steps):
        for g in steps:
            for (_, p), gi in zip(params, g):
                p.grad = gi.clone()
            opt.step()

    params, opt = chain()
    run(params, opt, grads[:2])
    saved = ckpt.to_host(opt.state_dict())
    saved_params = [p.detach().clone() for _, p in params]
    run(params, opt, grads[2:])
    params2, opt2 = chain()
    opt2.load_state_dict(saved)
    with torch.no_grad():
        for (_, p), v in zip(params2, saved_params):
            p.copy_(v)
    run(params2, opt2, grads[2:])
    assert opt2.count == opt.count == 4
    for (_, p), (_, q) in zip(params, params2):
        assert torch.equal(p, q)


def _resume_drill(tmp_path, capsys, run, orbax):
    """``run(resume)`` twice: uninterrupted, then resumed after step_2 is
    deleted; returns both step_2 states and the second run's output."""
    run(False)
    first, _ = ckpt.restore_train_state(orbax, 2)
    os.remove(os.path.join(orbax, "step_2"))
    capsys.readouterr()
    result = run(True)
    out = capsys.readouterr().out
    second, _ = ckpt.restore_train_state(orbax, 2)
    return first, second, out, result


def test_retrieval_resume_equals_uninterrupted(tmp_path, capsys):
    cfg = pretrieval.RetrievalConfig(
        device="cpu", batch_size=16, embed_dim=32, hidden_dim=64,
        image_size=32, max_seq_length=12, synthetic_images=20, epochs=2,
        use_residual=True, reinit_model=True, gradual_quant=True,
        warmup_epochs=0, checkpoint_freq=1, use_ema=True,
        train_baseline=True, distill=True, grad_accum_steps=2,
        output_dir=str(tmp_path / "out"),
        data_dir=str(tmp_path / "absent"))

    def run(resume):
        cfg.resume = resume
        return pretrieval.train_retrieval(cfg)

    first, second, out, (state, history, _) = _resume_drill(
        tmp_path, capsys, run, str(tmp_path / "out" / "orbax"))
    assert f"Resumed from {tmp_path / 'out' / 'orbax'} at epoch 1" in out
    assert "Epoch 1/2" not in out and "Epoch 2/2" in out
    assert len(history["train_losses"]) == 1
    assert {"model", "optimizer", "ema_params", "baseline",
            "baseline_optimizer", "generators"} <= set(first)
    assert sorted(first["generators"]) == ["baseline", "step"]
    assert first["optimizer"]["count"] > 0
    _assert_equal(second, first)
    digests = [line.rsplit("sha256 ", 1)[1].rstrip(")") for line in
               out.splitlines() if "sha256" in line]
    step1, _ = ckpt.restore_train_state(str(tmp_path / "out" / "orbax"), 1)
    assert digests == [ckpt.state_digest(step1), ckpt.state_digest(first)]


def test_retrieval_without_state_starts_fresh(tmp_path, capsys):
    cfg = pretrieval.RetrievalConfig(
        device="cpu", batch_size=8, embed_dim=32, hidden_dim=64,
        image_size=32, max_seq_length=12, synthetic_images=20, epochs=1,
        resume=True, output_dir=str(tmp_path / "out"),
        data_dir=str(tmp_path / "absent"))
    pretrieval.train_retrieval(cfg)
    out = capsys.readouterr().out
    assert "No checkpoint to resume from; starting fresh" in out
    assert "Epoch 1/1" in out
    assert os.listdir(tmp_path / "out" / "orbax") == ["step_1"]


def _tiny_loaders():
    imgs, labels, timgs, tlabels = port_mnist._synthetic("fashion_mnist",
                                                         160, 32)
    stats = port_mnist.FASHION_STATS
    return (port_mnist.ArrayLoader(imgs[:128], labels[:128], 32, stats,
                                   shuffle=True, augment=True, flip=True,
                                   drop_remainder=True),
            port_mnist.ArrayLoader(imgs[128:], labels[128:], 32, stats),
            port_mnist.ArrayLoader(timgs, tlabels, 32, stats))


def test_classifier_resume_equals_uninterrupted(tmp_path, capsys):
    cfg = pclassifier.ClassifierConfig(
        use_rpb=True, distill=True, use_l1=True, clip_grad=True, epochs=2,
        orbax_freq=1, grad_accum_steps=2, device="cpu",
        checkpoint_dir=str(tmp_path / "ckpt"))

    def run(resume):
        cfg.resume = resume
        return pclassifier.train_classifier(cfg, loaders=_tiny_loaders())

    orbax = str(tmp_path / "ckpt" / "orbax_fashion_mnist")
    first, second, out, (_, results) = _resume_drill(tmp_path, capsys, run,
                                                     orbax)
    assert f"Resumed from {orbax} at epoch 1" in out
    assert "Epoch 1/2" not in out and "Epoch 2/2" in out
    assert len(results["train_accuracies"]) == 1
    assert first["atq_optimizer"]["count"] == 8  # 4 steps an epoch
    assert first["loader_epoch"] == 2
    _assert_equal(second, first)


def test_loaders_count_their_epochs(tmp_path):
    ds = pf8k.Flickr8kDataset(str(tmp_path / "absent"), "train",
                              image_size=16, max_length=8,
                              synthetic_images=20)
    loader = pf8k.Flickr8kLoader(ds, 4, shuffle=True, drop_remainder=True)
    first = [b[1] for b in loader]
    again = pf8k.Flickr8kLoader(ds, 4, shuffle=True, drop_remainder=True)
    second = [b[1] for b in loader]
    assert loader.epoch == 2
    assert not all(np.array_equal(a, b) for a, b in zip(first, second))
    for epoch, want in ((1, second), (0, first)):
        again.epoch = epoch  # as a resumed run sets it
        assert all(np.array_equal(a, b[1]) for a, b in zip(want, again))
