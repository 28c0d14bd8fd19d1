"""Hoisted quantization under tensor parallelism:
``ScannedTernaryStack(hoist_quant=True)`` whose stacked (L, out, in)
projections hold out-features shards (parallel/sharded_model.py at tp = 2,
nn/hoist.py ``whole_layers``), in a gloo world of 2 on the CPU
(tests/_torch_dist.py), against the same stack in one process and against
JAX's ``ScannedTernaryStack(hoist_quant=True)`` (atq_tpu/nn/transformer.py,
whose hoist takes the batched order statistic on the whole stacked weight
whatever its placement), for grad_mode parity, STE and TTQ.

Both packages start from one JAX init carried into the port by
utils/jax_interop.py: 2 layers at d_model 64, FFN 128, 4 heads, a batch of
2 sequences of 12 with padding; the loss is ``sum(y · c)`` with fixed
random cotangents c.

Limits:
- each call of the batched threshold in the port's forward (6 a forward:
  q, k, v, out, linear1, linear2) takes the whole stacked weight on every
  rank, equal bit for bit to the one-process call's, and returns the same
  thresholds bit for bit; JAX's ``ternary_threshold_batched`` on that
  weight (its order statistic as the JAX tests run it on the CPU) returns
  them bit for bit too, and both packages' batched quantizers give the
  same ternary pattern;
- the loss within rtol 1e-5 and every gradient leaf within 5e-3 of its own
  L2 norm (tests/_dp_reference.py's LOSS_RTOL and GRAD_RTOL, which
  tests/test_torch_dp_scan.py holds the unhoisted scanned stack to under
  --tp 2; no perturbation envelope is added here); the output likewise
  within 5e-3 of its L2 norm. A leaf whose gradient is zero to rounding
  (at most 1e-6 of the largest) is not held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dp_reference as ref
import _torch_dist as td
from atq_tpu.core import quantize as jq
from atq_tpu.nn import transformer as jtr
from atq_tpu_torch.core import quantize as tq
from atq_tpu_torch.utils.jax_interop import from_jax_variables

LAYERS, B, S, E, H, F = 2, 2, 12, 64, 4, 128
GRAD_MODES = ("parity", "ste", "ttq")
KINDS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
         "self_attn.out_proj", "linear1", "linear2")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, E).astype(np.float32)
    pad = np.arange(S)[None, :] >= np.asarray([7, S])[:, None]
    return x, pad, rng.randn(B, S, E).astype(np.float32)


def _jax_run(grad_mode, x, pad, cot):
    """JAX's hoisted stack: its variables, loss, output and gradients
    (port names)."""
    js = jtr.ScannedTernaryStack(
        num_layers=LAYERS, embed_dim=E, num_heads=H, dim_feedforward=F,
        dropout=0.0, grad_mode=grad_mode, hoist_quant=True)
    v = js.init(jax.random.PRNGKey(0), x)

    def loss(p):
        y = js.apply({**v, "params": p}, x,
                     src_key_padding_mask=jnp.asarray(pad))
        return jnp.sum(y * cot), y

    (l, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    grads = from_jax_variables({"params": _np(g)})
    return v, {"loss": float(l), "y": np.asarray(y),
               "grads": {k: t.numpy() for k, t in grads.items()}}


@pytest.fixture(scope="module")
def runs():
    x, pad, cot = _inputs()
    config = dict(num_layers=LAYERS, embed_dim=E, num_heads=H,
                  dim_feedforward=F, dropout=0.0)
    specs, jax_runs = [], {}
    for mode in GRAD_MODES:
        v, jax_runs[mode] = _jax_run(mode, x, pad, cot)
        state = from_jax_variables({"params": _np(v["params"]),
                                    "quant": _np(v["quant"])})
        specs.append({"config": {**config, "grad_mode": mode},
                      "state": {k: t.numpy() for k, t in state.items()},
                      "x": x, "pad": pad, "cot": cot, "tp": 1})
    one = td.launch(1, td.hoisted_stacks, specs)[0]
    tp2 = td.launch(2, td.hoisted_stacks,
                    [{**s, "tp": 2} for s in specs])
    return {mode: {"spec": spec, "jax": jax_runs[mode], "one": one[i],
                   "tp2": [r[i] for r in tp2]}
            for i, (mode, spec) in enumerate(zip(GRAD_MODES, specs))}


def _kind(spec, weights):
    """The projection whose stacked weight ``weights`` is, whole."""
    found = [k for k in KINDS
             if np.array_equal(spec["state"][f"scan.layer.{k}.weight"],
                               weights)]
    assert len(found) == 1, f"a threshold call on {weights.shape}"
    return found[0]


def _assert_close(got, want, what):
    np.testing.assert_allclose(got["loss"], want["loss"],
                               rtol=ref.LOSS_RTOL, err_msg=what)
    y_err = np.linalg.norm(got["y"] - want["y"]) / np.linalg.norm(want["y"])
    assert y_err <= ref.GRAD_RTOL, f"{what}: output {y_err}"
    errors = ref.grad_errors(got["grads"], want["grads"])
    worst = max(errors.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1.0, f"{what}: gradient {worst} (error / limit)"


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_tp2_thresholds_take_the_whole_stacked_weight(runs, mode):
    """Every rank's 6 calls of the batched threshold take the whole
    (L, out, in) weight, bit for bit the one-process call's, and return
    the one-process thresholds bit for bit; no layer quantizes on its own
    (the hoisted pass runs every layer pre-quantized)."""
    r = runs[mode]
    want = r["one"]["thresholds"]
    assert len(want) == len(KINDS)
    assert sorted(_kind(r["spec"], w) for w, _ in want) == sorted(KINDS)
    for rank, got in enumerate(r["tp2"] + [r["one"]]):
        assert got["single_thresholds"] == 0, rank
        assert len(got["thresholds"]) == len(KINDS), rank
        for (gw, gt), (ww, wt) in zip(got["thresholds"], want):
            np.testing.assert_array_equal(gw, ww, err_msg=f"rank {rank}")
            np.testing.assert_array_equal(gt, wt, err_msg=f"rank {rank}")


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_thresholds_and_patterns_match_jax_bit_for_bit(runs, mode):
    r = runs[mode]
    for weights, thr in r["one"]["thresholds"]:
        kind = _kind(r["spec"], weights)
        sparsity = r["spec"]["state"][f"scan.layer.{kind}.sparsity_target"]
        want = np.asarray(jq.ternary_threshold_batched(
            jnp.asarray(weights), sparsity_target=jnp.asarray(sparsity)))
        np.testing.assert_array_equal(thr, want, err_msg=kind)
        j_pattern = np.asarray(jq.adaptive_ternary_quantization_batched(
            jnp.asarray(weights), sparsity_target=jnp.asarray(sparsity))[0])
        t_pattern = tq.adaptive_ternary_quantization_batched(
            torch.from_numpy(weights),
            sparsity_target=torch.from_numpy(sparsity))[0].numpy()
        np.testing.assert_array_equal(t_pattern, j_pattern, err_msg=kind)
        b = thr.reshape(-1, 1, 1)
        np.testing.assert_array_equal(
            t_pattern, (weights > b).astype(np.float32)
            - (weights < -b).astype(np.float32), err_msg=kind)


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_tp2_step_matches_one_process(runs, mode):
    r = runs[mode]
    for rank, got in enumerate(r["tp2"]):
        _assert_close(got, r["one"], f"{mode} tp2 rank {rank}")
    a, b = r["tp2"]
    assert a["loss"] == b["loss"]
    np.testing.assert_array_equal(a["y"], b["y"])


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_hoisted_stack_matches_jax(runs, mode):
    r = runs[mode]
    _assert_close(r["one"], r["jax"], f"{mode} one process")
    _assert_close(r["tp2"][0], r["jax"], f"{mode} tp2")
