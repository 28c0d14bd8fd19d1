"""The port's production-shape QAT step (atq_tpu_torch.train.scale) against
the JAX harness it ports (benchmarks/scale_mfu.py:build_step), at a tiny
config: embed 32, FFN 64, 4 heads, 2 layers, sequence 16, batch 4, remat,
scanned.

Both start from the JAX init (carried in through utils/jax_interop.py) and
see the same tokens and labels (``np.random.RandomState(0)`` in the same
order). Step 0's gradients are read off the first Adam moment
(``mu = (1 − b1)·g`` after one update) on both sides. Tolerances, float32:
loss within rtol 1e-6 at step 0 and 1e-5 over 5 steps, gradients within
rtol 1e-4 and 1e-4 of the largest |gradient| (sums in another order,
through two layers and the embedding; measured worst 5e-5). AMP
(bf16 matmuls): a bf16 product may round one step apart, and the ternary
thresholds then move with the updated weights, so step 0 is held to 1e-4
(loss) and 2e-2 (gradients, of the largest), and the 5-step losses to
rtol 1e-2 and a falling trajectory (measured worst: 2.7e-3).
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "benchmarks"))

import scale_mfu  # noqa: E402

from atq_tpu_torch.train import scale  # noqa: E402
from atq_tpu_torch.utils.jax_interop import from_jax_variables  # noqa: E402

TINY = (32, 64, 4, 2, 16, 4, True, True)
PATHS = {"einsum": dict(), "fused_hoist": dict(attn_impl="fused",
                                               hoist_quant=True)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(use_amp, path):
    jstep, _, jstate, jn = scale_mfu.build_step(*TINY, use_amp=use_amp,
                                                **PATHS[path])
    (params, _), quant = jstate
    step, _, state, n = scale.build_step(*TINY, use_amp=use_amp,
                                         device="cpu", **PATHS[path])
    state[0].load_state_dict(from_jax_variables(
        {"params": _np(params), "quant": _np(quant)}))
    assert n == jn
    return jstep, jstate, step, state


def _grads_from_moments(jstate, state):
    (_, opt_state), _ = jstate
    want = from_jax_variables({"params": _np(opt_state[0].mu)})
    model, opt = state
    got = {name: mu for (name, _), mu in zip(model.named_parameters(),
                                             opt.mu)}
    return got, want


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("use_amp", [False, True])
def test_step0_and_five_step_trajectory_match_jax(use_amp, path):
    jstep, jstate, step, state = _both(use_amp, path)
    jl, tl = [], []
    for i in range(5):
        jstate, loss_j = jstep(jstate)
        state, loss_t = step(state)
        jl.append(float(loss_j))
        tl.append(float(loss_t))
        if i == 0:
            got, want = _grads_from_moments(jstate, state)
            assert set(got) == set(want)
            top = max(float(np.abs(g.numpy()).max()) for g in want.values())
            rtol, atol = (2e-2, 2e-2) if use_amp else (1e-4, 1e-4)
            for name, g in want.items():
                np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                           rtol=rtol, atol=atol * top,
                                           err_msg=name)
            np.testing.assert_allclose(tl[0], jl[0],
                                       rtol=1e-4 if use_amp else 1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-2 if use_amp else 1e-5)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]


def test_measure_row_has_the_harness_keys_on_cpu(tmp_path):
    row = scale.measure("tiny", TINY, use_amp=True, iters=2,
                        attn_impl="fused", hoist_quant=True, device="cpu")
    assert row["params_millions"] > 0.5  # the embedding table dominates
    assert row["ms_per_step"] > 0 and row["tokens_per_sec"] > 0
    assert row["flops_per_step"] == scale.analytic_step_flops(*TINY[:6])
    assert row["hoist_quant"] and row["attn_impl"] == "fused"
    assert row["device"] == "cpu" and row["mfu_pct"] is None
    assert len(row["losses"]) == 4 and np.isfinite(row["losses"]).all()
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert not any(row["launches_per_step"].values())


def test_main_writes_rows_and_records_a_bad_config(tmp_path):
    out = tmp_path / "rows.json"
    rows = scale.main(["--configs", "no-such-config", "--device", "cpu",
                       "--out", str(out)])
    assert rows[0]["config"] == "no-such-config" and "error" in rows[0]
    assert out.exists()


def test_unrolled_branch_ignores_attn_and_matches_jax():
    """ref-scale's unrolled branch (scan=False): the JAX harness does not
    pass attn_impl to its layers, so neither does the port."""
    spec = (32, 64, 4, 2, 16, 4, True, False)
    jstep, _, jstate, _ = scale_mfu.build_step(*spec, use_amp=False,
                                               attn_impl="fused")
    (params, _), quant = jstate
    step, _, state, _ = scale.build_step(*spec, use_amp=False, device="cpu",
                                         attn_impl="fused")
    state[0].load_state_dict(from_jax_variables(
        {"params": _np(params), "quant": _np(quant)}))
    _, loss_j = jstep(jstate)
    _, loss_t = step(state)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    attn = state[0].layer_0.self_attn
    assert attn.attn_impl == "einsum"
