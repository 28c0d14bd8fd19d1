"""The classifier trainer's ``--dp``/``--tp``/``--fsdp`` step
(train/classifier.py over parallel/) in gloo worlds on the CPU, against
JAX's jitted step on a dp=2 mesh of the conftest's virtual CPU devices and
against the port's one-process step on the same global batch.

From one init (tests/test_torch_train.py's: KD + L1 + RPB, dropout 0, no
augmentation, 16x16 inputs, a 32-unit hidden layer, global batch 16), each
config's losses, accuracies, every gradient leaf of both models (rtol 1e-4
and an atol of 1e-5 times the model's largest |gradient|, the one-process
test's limits) and the BatchNorm statistics (rtol 1e-5): dp=2, dp=2 with
``--fsdp`` (whose student state at rest is the JAX fsdp rule's bytes, the
large leaves halved), tp=2 (``classifier_0``/``classifier_3``'s
out-features over the 'model' ranks), and dp=2 with ``--grad-accum-steps
2`` (against JAX's ``accum_train_step`` on the mesh). With dropout 0.3 the
dp=2 step draws the global batch's masks: it equals the one-process step.
dp=2 × tp=2 with ``--fsdp`` runs in a world of 4 and matches too. The CLI
runs on two ranks with ``--tp 2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_dist as td
from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
    BaselineCNNClassifier as JaxBaseline,
)
from atq_tpu.parallel.mesh import fsdp_spec, make_mesh, replicate, shard_batch
from atq_tpu.train import classifier as jtrain

IMAGE, HIDDEN, BATCH = 16, 32, 16
SPARSITY, L1 = 0.05, 2e-5
CFG = dict(use_rpb=True, distill=True, use_l1=True, clip_grad=True,
           epochs=20, device_augment=False)
SPECS = {"dp2": dict(dp=2), "fsdp": dict(dp=2, fsdp=True),
         "tp2": dict(dp=1, tp=2), "accum2": dict(dp=2, grad_accum_steps=2)}


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def init():
    """tests/test_torch_train.py's init: BatchNorm statistics, alpha and
    the sparsity moved off their init values."""
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
        atq["quant"][layer]["sparsity_target"] = np.float32(SPARSITY)
    return {"atq_params": atq["params"], "quant": atq["quant"],
            "atq_batch_stats": atq["batch_stats"],
            "base_params": base["params"],
            "base_batch_stats": base["batch_stats"]}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.randn(BATCH, IMAGE, IMAGE, 1).astype(np.float32),
            rng.randint(0, 10, BATCH).astype(np.int32))


def _capture():
    """An optax transformation that keeps the gradients in its state."""
    def update(u, s, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}

    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}, update)


def _jax_mesh_step(init, batch, accum):
    """JAX's step on a dp=2 mesh: the state replicated, the batch sharded
    over 'data'."""
    jatq = JaxClassifier(use_rpb=True, hidden_size=HIDDEN, dropout_rate=0.0)
    jbase = JaxBaseline(hidden_size=HIDDEN, dropout_rate=0.0)
    cfg = jtrain.ClassifierConfig(**CFG, grad_accum_steps=accum)
    step = jax.jit(jtrain.build_train_step(jatq, jbase, _capture(),
                                           _capture(), cfg))
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    state = replicate({**init, "step": jnp.asarray(0, jnp.int32),
                       "atq_opt_state": _capture().init(init["atq_params"]),
                       "base_opt_state": _capture().init(
                           init["base_params"])}, mesh)
    new, m = step(state, shard_batch(tuple(jnp.asarray(a) for a in batch),
                                     mesh),
                  jnp.float32(SPARSITY), jnp.float32(L1),
                  jax.random.PRNGKey(0))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "atq": _tree(new["atq_opt_state"]["g"]),
            "base": _tree(new["base_opt_state"]["g"]),
            "atq_stats": _tree(new["atq_batch_stats"]),
            "base_stats": _tree(new["base_batch_stats"])}


@pytest.fixture(scope="module")
def runs(init, batch):
    port1 = td.launch(1, td.classifier_steps, init, batch, CFG,
                      [dict(hidden=HIDDEN),
                       dict(hidden=HIDDEN, grad_accum_steps=2),
                       dict(hidden=HIDDEN, dropout=0.3, seed=3)])[0]
    ranks = td.launch(2, td.classifier_steps, init, batch, CFG,
                      [dict(SPECS[k], hidden=HIDDEN) for k in SPECS]
                      + [dict(dp=2, hidden=HIDDEN, dropout=0.3, seed=3)])
    four = td.launch(4, td.classifier_steps, init, batch, CFG,
                     [dict(dp=2, tp=2, fsdp=True, hidden=HIDDEN)])[0][0]
    return {"jax": _jax_mesh_step(init, batch, 1),
            "jax_accum": _jax_mesh_step(init, batch, 2),
            "port1": port1[0], "port1_accum": port1[1],
            **dict(zip(SPECS, ranks[0])), "dropout": ranks[0][-1],
            "dropout1": port1[2], "rank1": ranks[1], "dp2_tp2_fsdp": four}


def _leaves(tree):
    return {str(k): np.asarray(a) for k, a in
            jax.tree_util.tree_leaves_with_path(tree)}


def _assert_like(got, want, what):
    for name in ("atq", "base"):
        g, w = _leaves(got[name]), _leaves(want[name])
        assert sorted(g) == sorted(w), what
        scale = max(1.0, max(np.abs(a).max() for a in w.values()))
        for k, a in w.items():
            np.testing.assert_allclose(g[k], a, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f"{what} {name} {k}")
        gs, ws = _leaves(got[name + "_stats"]), _leaves(want[name + "_stats"])
        for k, a in ws.items():
            np.testing.assert_allclose(gs[k], a, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} {name} stats {k}")
    for key in ("loss", "base_loss"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=1e-5, err_msg=f"{what} {key}")
    for key in ("atq_correct", "base_correct"):
        assert int(got["metrics"][key]) == int(want["metrics"][key]), what


@pytest.mark.parametrize("config", ["dp2", "fsdp", "tp2", "dp2_tp2_fsdp"])
def test_sharded_step_matches_jax_mesh_and_one_process(runs, config):
    _assert_like(runs[config], runs["jax"], f"{config} vs jax dp2")
    _assert_like(runs[config], runs["port1"], f"{config} vs port dp1")


def test_grad_accum_matches_jax_mesh_and_one_process(runs):
    """JAX splits the global batch into the microbatches and shards each,
    so a rank holds its rows of every microbatch."""
    _assert_like(runs["accum2"], runs["jax_accum"], "accum2 vs jax dp2")
    _assert_like(runs["accum2"], runs["port1_accum"], "accum2 vs port dp1")


def test_ranks_agree_and_dropout_draws_are_the_global_batchs(runs):
    for name in ("atq", "base"):
        for k, a in _leaves(runs["rank1"][0][name]).items():
            np.testing.assert_array_equal(a, _leaves(runs["dp2"][name])[k])
    _assert_like(runs["dropout"], runs["dropout1"], "dropout dp2 vs dp1")


def test_fsdp_state_bytes_follow_the_jax_rule(runs, init):
    """The student's state at rest under --fsdp: each leaf JAX's fsdp_spec
    shards over 'data' is halved, the others whole."""
    atq = {k: init[k] for k in ("atq_params", "quant", "atq_batch_stats")}
    whole = half = 0
    for leaf in jax.tree_util.tree_leaves(atq):
        nbytes = np.asarray(leaf).nbytes
        whole += nbytes
        half += nbytes // 2 if fsdp_spec(leaf, 2) != () else nbytes
    # The port's state dict adds BatchNorm's num_batches_tracked (int64).
    extra = runs["dp2"]["state_bytes"] - whole
    assert 0 <= extra <= 64
    assert runs["fsdp"]["state_bytes"] == half + extra
    assert half < 0.6 * whole


def test_main_on_two_ranks(tmp_path):
    """The trainer from ``--tp 2 --fsdp`` flags on two ranks, as torchrun
    starts it (128 synthetic training images): the ranks report the same
    losses and rank 0 writes the whole checkpoint."""
    from atq_tpu.train.classifier import load_checkpoint as jax_load

    ck = tmp_path / "classifier"
    ranks = td.launch(2, td.trainer_main, "classifier", [
        "--use-rpb", "--distill", "--use-l1", "--clip-grad", "--epochs",
        "1", "--batch-size", "32", "--device", "cpu", "--tp", "2",
        "--fsdp", "--checkpoint-dir", str(ck)])
    assert ranks[0] == ranks[1] and np.isfinite(ranks[0]).all()
    weight = jax_load(str(ck / "atq_model_fashion_mnist.npz"))["params"][
        "classifier_0"]["weight"]
    assert weight.shape == (128, 3136)
