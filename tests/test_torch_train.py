"""Classification training in the port (atq_tpu_torch.train) against the
JAX trainer (atq_tpu.train.classifier) on the CPU.

- The loaders give the same batches from the same seed (IDX files written
  to a temporary directory, so nothing is downloaded).
- Step 0 of the co-trained step (KD + L1 + RPB, dropout 0, no
  augmentation), dense and fused (ATQ_FUSED=1 on both sides), from one
  init carried across with ``from_jax_train_state``: losses within 1e-5
  relative, every gradient within rtol 1e-4 and an atol of 1e-5 times the
  model's largest |gradient| (the ATQ loss is ~1e3 at init, a saturated
  CE, and the conv biases before a train-mode BatchNorm have a true
  gradient of 0 that both sides compute as cancellation noise at that
  scale); ternary patterns bit-exact.
- A 20-step trajectory with the real optimizers: the teacher's loss within
  2e-3 relative at every step; the ATQ loss within 10x the JAX package's
  own sensitivity envelope (JAX rerun from a 1e-6-perturbed init), the
  bound tests/test_trajectory_parity.py uses against the reference.
- The optimizer (clip, masked decay, Adam, schedules) step for step
  against optax.
- A checkpoint the port's trainer writes loads into the JAX model and gives
  the same logits.
Small size: 16x16 inputs (a 1024-wide head input) and a 32-unit hidden
layer (32,768 weights, on the order-statistic path).
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atq_tpu.core.quantize import ternary_threshold as jax_threshold
from atq_tpu.data import mnist as jax_mnist
from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
    BaselineCNNClassifier as JaxBaseline,
)
from atq_tpu.train import classifier as jtrain
from atq_tpu_torch.core.quantize import ternary_threshold
from atq_tpu_torch.data import mnist as port_mnist
from atq_tpu_torch.models.image_classifier import (
    ATQImageClassifier,
    BaselineCNNClassifier,
)
from atq_tpu_torch.train import classifier as ptrain
from atq_tpu_torch.utils.jax_interop import (
    from_jax_train_state,
    from_jax_variables,
    load_checkpoint,
    to_jax_train_state,
    to_jax_variables,
)

IMAGE, HIDDEN, BATCH = 16, 32, 16
SPARSITY_EPOCH0, L1 = 0.05, 2e-5


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# --- data -----------------------------------------------------------------

def _write_idx(path, array):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | array.ndim))
        f.write(struct.pack(f">{array.ndim}I", *array.shape))
        f.write(array.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def idx_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fashion")
    rng = np.random.RandomState(0)
    files = {"train-images-idx3-ubyte.gz": rng.randint(0, 256, (500, 28, 28)),
             "train-labels-idx1-ubyte.gz": rng.randint(0, 10, 500),
             "t10k-images-idx3-ubyte.gz": rng.randint(0, 256, (90, 28, 28)),
             "t10k-labels-idx1-ubyte.gz": rng.randint(0, 10, 90)}
    for name, a in files.items():
        _write_idx(str(d / name), a)
    return str(d)


@pytest.mark.parametrize("raw", [True, False])
def test_loaders_give_the_jax_batches(idx_dir, raw):
    want = jax_mnist.get_fashion_mnist_data(32, idx_dir, subset_fraction=0.5)
    got = port_mnist.get_fashion_mnist_data(32, idx_dir, subset_fraction=0.5)
    for lw, lg in zip(want, got):
        lw.raw = lg.raw = raw
        assert len(lw) == len(lg)
        for _ in range(2):  # two epochs: reshuffled, re-augmented
            n = 0
            for (xw, yw), (xg, yg) in zip(lw, lg):
                np.testing.assert_array_equal(xg, xw)
                np.testing.assert_array_equal(yg, yw)
                n += 1
            assert n == len(lw)


def test_synthetic_stand_in_matches_jax(monkeypatch):
    for mod in (jax_mnist, port_mnist):  # a small set, quickly
        monkeypatch.setattr(mod, "_synthetic",
                            lambda d, f=mod._synthetic: f(d, 300, 50))
    want = jax_mnist._load_arrays("fashion_mnist", "/nonexistent")
    got = port_mnist._load_arrays("fashion_mnist", "/nonexistent")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- one init for both trainers -----------------------------------------

@pytest.fixture(scope="module")
def init():
    """JAX variables for both models, with BatchNorm statistics, alpha and
    the teacher moved off their init values, sparsity at epoch 0."""
    x = jnp.zeros((2, IMAGE, IMAGE, 1))
    atq = _tree(JaxClassifier(use_rpb=True, hidden_size=HIDDEN).init(
        jax.random.PRNGKey(0), x))
    base = _tree(JaxBaseline(hidden_size=HIDDEN).init(
        jax.random.PRNGKey(1), x))
    rng = np.random.RandomState(1)
    for v in (atq, base):
        for bn in ("bn1", "bn2"):
            s = v["batch_stats"]["features"][bn]
            s["mean"] = (rng.randn(*s["mean"].shape) * 0.1).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, s["var"].shape).astype(
                np.float32)
    for layer in ("classifier_0", "classifier_3"):
        atq["params"][layer]["alpha"] = np.full((1,), 0.05, np.float32)
        atq["quant"][layer]["sparsity_target"] = np.float32(SPARSITY_EPOCH0)
    return {"atq_params": atq["params"], "quant": atq["quant"],
            "atq_batch_stats": atq["batch_stats"],
            "base_params": base["params"],
            "base_batch_stats": base["batch_stats"]}


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, IMAGE, IMAGE, 1).astype(np.float32),
             rng.randint(0, 10, BATCH).astype(np.int32)) for _ in range(n)]


def _port_models(state):
    atq_sd, base_sd = from_jax_train_state(state)
    atq = ATQImageClassifier(use_rpb=True, hidden_size=HIDDEN,
                             dropout_rate=0.0, image_size=IMAGE,
                             device="cpu")
    base = BaselineCNNClassifier(hidden_size=HIDDEN, dropout_rate=0.0,
                                 image_size=IMAGE, device="cpu")
    atq.load_state_dict(atq_sd)
    base.load_state_dict(base_sd)
    atq.train()
    base.train()
    return atq, base


def _jax_models():
    return (JaxClassifier(use_rpb=True, hidden_size=HIDDEN, dropout_rate=0.0),
            JaxBaseline(hidden_size=HIDDEN, dropout_rate=0.0))


CFG = dict(use_rpb=True, distill=True, use_l1=True, clip_grad=True,
           epochs=20, device_augment=False)


def _capture():
    """An optax transformation that leaves the params alone and keeps the
    gradients in its state."""
    def update(u, s, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}

    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}, update)


class _NoUpdate:
    def step(self):
        pass


def test_train_state_round_trips(init):
    back = to_jax_train_state(*from_jax_train_state(init))
    flat = {str(k): a for k, a in jax.tree_util.tree_leaves_with_path(back)}
    for k, a in jax.tree_util.tree_leaves_with_path(init):
        np.testing.assert_array_equal(flat[str(k)], np.asarray(a))
    assert len(flat) == len(jax.tree_util.tree_leaves(init))


@pytest.mark.parametrize("fused", [False, True])
def test_step0_matches_jax(init, monkeypatch, fused):
    monkeypatch.setenv("ATQ_FUSED", "1" if fused else "0")
    images, labels = _batches(1)[0]
    jatq, jbase = _jax_models()
    step = jax.jit(jtrain.build_train_step(
        jatq, jbase, _capture(), _capture(), jtrain.ClassifierConfig(**CFG)))
    state = {**init, "step": jnp.asarray(0, jnp.int32),
             "atq_opt_state": _capture().init(init["atq_params"]),
             "base_opt_state": _capture().init(init["base_params"])}
    new, m = step(state, (jnp.asarray(images), jnp.asarray(labels)),
                  jnp.float32(SPARSITY_EPOCH0), jnp.float32(L1),
                  jax.random.PRNGKey(0))
    want = {"atq": _tree(new["atq_opt_state"]["g"]),
            "base": _tree(new["base_opt_state"]["g"])}

    atq, base = _port_models(init)
    for layer in ("classifier_0", "classifier_3"):  # patterns bit-exact
        w = getattr(atq, layer).weight.detach()
        thr = ternary_threshold(w, sparsity_target=SPARSITY_EPOCH0)
        jthr = jax_threshold(jnp.asarray(w.numpy()),
                             sparsity_target=SPARSITY_EPOCH0)
        assert thr.numpy().tobytes() == np.asarray(jthr).tobytes()
    pstep = ptrain.build_train_step(atq, base, _NoUpdate(), _NoUpdate(),
                                    ptrain.ClassifierConfig(**CFG))
    pm = pstep(torch.from_numpy(images), torch.from_numpy(labels).long(), L1)
    for key in ("loss", "base_loss"):
        np.testing.assert_allclose(float(pm[key]), float(m[key]), rtol=1e-5,
                                   err_msg=key)
    for key in ("atq_correct", "base_correct"):
        assert int(pm[key]) == int(m[key])
    for name, model in (("atq", atq), ("base", base)):
        sd = {**model.state_dict(),  # the buffers mark the BatchNorms
              **{k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in model.named_parameters()}}
        got = to_jax_variables(sd)["params"]
        flat_w = jax.tree_util.tree_leaves_with_path(want[name])
        scale = max(1.0, max(np.abs(a).max() for _, a in flat_w))
        flat_g = {str(k): a for k, a in
                  jax.tree_util.tree_leaves_with_path(got)}
        assert len(flat_g) == len(flat_w)
        for k, a in flat_w:
            np.testing.assert_allclose(flat_g[str(k)], a, rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=str(k))


# --- trajectory ---------------------------------------------------------

def _jax_trajectory(state0, batches, perturb=None):
    jatq, jbase = _jax_models()
    cfg = jtrain.ClassifierConfig(**CFG)
    params = state0["atq_params"]
    if perturb is not None:
        rng = np.random.RandomState(perturb)
        params = jax.tree_util.tree_map(
            lambda p: p + 1e-6 * np.abs(p) * rng.choice([-1.0, 1.0], p.shape
                                                        ).astype(np.float32),
            params)
    atq_tx = jtrain.make_optimizer(
        cfg, 10, weight_decay=1e-4,
        decay_mask=jtrain.ternary_latent_decay_mask(params, state0["quant"],
                                                    "parity"))
    base_tx = jtrain.make_optimizer(cfg, 10, clip=False)
    state = {**state0, "atq_params": params,
             "atq_opt_state": atq_tx.init(params),
             "base_opt_state": base_tx.init(state0["base_params"]),
             "step": jnp.asarray(0, jnp.int32)}
    step = jax.jit(jtrain.build_train_step(jatq, jbase, atq_tx, base_tx, cfg))
    losses, base_losses = [], []
    for images, labels in batches:
        state, m = step(state, (jnp.asarray(images), jnp.asarray(labels)),
                        jnp.float32(SPARSITY_EPOCH0), jnp.float32(L1),
                        jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        base_losses.append(float(m["base_loss"]))
    return np.asarray(losses), np.asarray(base_losses)


def test_trajectory_tracks_jax(init):
    """From the init's alpha = 1 (the JAX models' own, at which the head's
    CE is saturated), as tests/test_trajectory_parity.py runs it. With a
    trained model's alpha the loss is O(1) and float noise that Adam
    amplifies (conv biases before a train-mode BatchNorm have a true
    gradient of 0, so their updates are ±lr of noise) flips ternary
    patterns after a few steps on either side; the envelope of one
    perturbed init does not bound that."""
    init = {**init, "atq_params": {
        k: ({**v, "alpha": np.ones((1,), np.float32)} if "alpha" in v else v)
        for k, v in init["atq_params"].items()}}
    batches = _batches(20, seed=3)
    j_loss, j_base = _jax_trajectory(init, batches)
    p_loss, _ = _jax_trajectory(init, batches, perturb=123)

    cfg = ptrain.ClassifierConfig(**CFG)
    atq, base = _port_models(init)
    atq_opt = ptrain.make_optimizer(
        cfg, atq.named_parameters(), 10, weight_decay=1e-4,
        decay_mask=ptrain.ternary_latent_decay_mask(atq, "parity"))
    base_opt = ptrain.make_optimizer(cfg, base.named_parameters(), 10,
                                     clip=False)
    step = ptrain.build_train_step(atq, base, atq_opt, base_opt, cfg)
    t_loss, t_base = [], []
    for images, labels in batches:
        m = step(torch.from_numpy(images), torch.from_numpy(labels).long(),
                 L1)
        t_loss.append(float(m["loss"]))
        t_base.append(float(m["base_loss"]))
    t_loss, t_base = np.asarray(t_loss), np.asarray(t_base)

    rel_base = np.abs(t_base - j_base) / np.maximum(np.abs(j_base), 1.0)
    assert rel_base.max() < 2e-3, rel_base
    scale = np.maximum(np.abs(j_loss), 1.0)
    delta = np.abs(t_loss - j_loss)
    assert delta[0] / scale[0] < 1e-5, (t_loss[0], j_loss[0])
    envelope = np.maximum.accumulate(np.abs(p_loss - j_loss))
    budget = 10.0 * np.maximum(envelope, 1e-6 * scale) + 1e-3 * scale
    assert (delta <= budget).all(), (delta, budget)
    assert j_loss[-1] != j_loss[0]  # the run moved


# --- optimizer ----------------------------------------------------------

@pytest.mark.parametrize("clip,cosine,grad_scale", [
    (True, True, 1.0),     # global norm above 1: clipped
    (True, False, 1e-3),   # below 1: untouched
    (False, True, 1.0),
])
def test_optimizer_matches_optax(clip, cosine, grad_scale):
    rng = np.random.RandomState(4)
    shapes = {"a": (6, 5), "b": (7,), "frozen": (3, 4), "nograd": (2,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    decay = {"a": True, "b": True, "frozen": False, "nograd": True}
    cfg = jtrain.ClassifierConfig(clip_grad=clip, use_cosine_lr=cosine,
                                  epochs=4)
    tx = jtrain.make_optimizer(cfg, 3, weight_decay=1e-4, decay_mask=decay)
    jp, js = dict(params), tx.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = ptrain.make_optimizer(
        ptrain.ClassifierConfig(clip_grad=clip, use_cosine_lr=cosine,
                                epochs=4),
        tp.items(), 3, weight_decay=1e-4, decay_mask=decay)
    for step in range(8):
        grads = {k: (rng.randn(*s) * grad_scale).astype(np.float32)
                 for k, s in shapes.items()}
        grads["nograd"] = np.zeros(shapes["nograd"], np.float32)
        updates, js = tx.update(grads, js, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = None if k == "nograd" else torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} step {step}")


def _jax_leaf_name(name):
    """A port parameter name as its JAX param path, dot-joined."""
    mod, leaf = name.rsplit(".", 1)
    if leaf == "weight" and ".conv" in mod:
        leaf = "kernel"
    elif leaf == "weight" and ".bn" in mod:
        leaf = "scale"
    return f"{mod}.{leaf}"


def test_decay_mask_matches_jax():
    for use_rpb in (True, False):
        for grad_mode in ("parity", "ste"):
            jm = JaxClassifier(use_rpb=use_rpb, hidden_size=HIDDEN,
                               grad_mode=grad_mode)
            v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)))
            want = {".".join(str(p.key) for p in path): m for path, m in
                    jax.tree_util.tree_leaves_with_path(
                        jtrain.ternary_latent_decay_mask(
                            v["params"], v.get("quant", {}), grad_mode))}
            pm = ATQImageClassifier(use_rpb=use_rpb, hidden_size=HIDDEN,
                                    grad_mode=grad_mode, image_size=8,
                                    device="cpu")
            got = {_jax_leaf_name(k): m for k, m in
                   ptrain.ternary_latent_decay_mask(pm, grad_mode).items()}
            assert got == want, (use_rpb, grad_mode)


def test_l1_penalty_matches_jax(init):
    atq, _ = _port_models(init)
    want = float(jtrain._l1_penalty(init["atq_params"]))
    np.testing.assert_allclose(ptrain._l1_penalty(atq).item(), want,
                               rtol=1e-6)


# --- the trainer end to end -------------------------------------------

def _tiny_loaders():
    from atq_tpu_torch.data.mnist import FASHION_STATS, ArrayLoader

    imgs, labels, timgs, tlabels = port_mnist._synthetic("fashion_mnist",
                                                         96, 32)
    return (ArrayLoader(imgs[:64], labels[:64], 32, FASHION_STATS,
                        shuffle=True, augment=True, flip=True,
                        drop_remainder=True),
            ArrayLoader(imgs[64:], labels[64:], 32, FASHION_STATS),
            ArrayLoader(timgs, tlabels, 32, FASHION_STATS))


def test_trainer_checkpoint_serves_on_jax(tmp_path):
    cfg = ptrain.ClassifierConfig(use_rpb=True, distill=True, use_l1=True,
                                  clip_grad=True, epochs=1, device="cpu",
                                  checkpoint_dir=str(tmp_path))
    state, results = ptrain.train_classifier(cfg, loaders=_tiny_loaders(),
                                             verbose=False)
    assert results["launches_per_step"] == [{
        "order_stat": 0.0, "batched_order_stat": 0.0,
        "fused_attention_fwd": 0.0, "fused_attention_bwd": 0.0,
        "ternary_matmul": 0.0, "ternary_matmul32": 0.0,
        "ternary_matmul_rpb": 0.0, "fused_forward": 0.0, "fused_dx": 0.0,
        "fused_dwda": 0.0}]  # CPU: plain versions only
    assert len(results["step_losses"][0]) == 2
    assert np.isfinite(results["step_losses"][0]).all()
    tree = jtrain.load_checkpoint(results["checkpoint"])
    x = np.random.RandomState(5).randn(4, 28, 28, 1).astype(np.float32)
    want = np.asarray(JaxClassifier(use_rpb=True, hidden_size=128).apply(
        tree, jnp.asarray(x), train=False))
    model = ATQImageClassifier(use_rpb=True, hidden_size=128, device="cpu")
    model.load_state_dict(from_jax_variables(load_checkpoint(
        results["checkpoint"])))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        live = state["atq_model"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, live)


@pytest.mark.parametrize("field,value", [("dp", 2), ("tp", 2),
                                         ("fsdp", True)])
def test_parallel_options_in_one_process(tmp_path, field, value):
    """Without torchrun a mesh of more than one rank raises, naming it; a
    one-rank ``fsdp`` shards nothing and trains as the plain trainer (the
    multi-rank steps: tests/test_torch_dp_classifier.py)."""
    cfg = ptrain.ClassifierConfig(device="cpu", epochs=1, use_rpb=True,
                                  checkpoint_dir=str(tmp_path),
                                  **{field: value})
    if field == "fsdp":
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # a test that trains: one thread a worker
        try:
            _, results = ptrain.train_classifier(
                cfg, loaders=_tiny_loaders(), verbose=False)
        finally:
            torch.set_num_threads(threads)
        assert np.isfinite(results["epoch_losses"]).all()
        return
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        ptrain.train_classifier(cfg, loaders=_tiny_loaders(), verbose=False)


def test_cli_matches_train_py_flags():
    """Every train.py flag, and ``--device`` (default cuda) besides. The
    flags are read from train.py's source: importing it would set up the
    JAX package's platform and compilation cache."""
    import pathlib
    import re

    from atq_tpu_torch.train.__main__ import build_parser

    src = (pathlib.Path(__file__).resolve().parent.parent
           / "train.py").read_text()
    want = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src))
    got = {opt for a in build_parser()._actions for opt in a.option_strings
           if opt.startswith("--") and opt != "--help"}
    assert len(want) > 20
    assert got == want | {"--device"}
    assert build_parser().parse_args([]).device == "cuda"
