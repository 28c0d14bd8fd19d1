"""The retrieval trainer's ``--dp``/``--tp``/``--fsdp`` step
(train/retrieval.py over parallel/) in a gloo world of 2 on the CPU,
against JAX's jitted step on a dp=2 mesh and against the port's
one-process step on the same global batch (tests/_dp_reference.py: the
JAX package's test size, global batch 8, dropout 0, float images, the
recipe's AdamW with ``--clip_grad``).

- dp=2, dp=2 ``--fsdp`` and tp=2: the loss within 1e-5, each gradient leaf
  within ``GRAD_RTOL`` of its L2 norm plus ten times its sensitivity to a
  1e-6 change of the images (tests/_dp_reference.py), the BatchNorm
  statistics within 1e-4; the ranks' losses equal. The negative pool is
  the all-gathered global batch and the gradients are summed then divided
  by dp, so the factor of the gather's backward is right or these fail.
- ``--fsdp``: the per-rank state at rest (module and Adam moments) is the
  JAX fsdp rule's bytes, about half.
- With dropout 0.1 and uint8 images (flips drawn), dp=2 equals the
  one-process step: each rank keeps its rows of the global batch's draws,
  and the generator ends in the same state.
"""

import numpy as np
import pytest

import _dp_reference as ref
import _torch_dist as td
from atq_tpu.parallel.mesh import fsdp_spec


@pytest.fixture(scope="module")
def runs():
    model, v = ref.jax_init()
    b = ref.batch()
    want = ref.jax_mesh_step(model, v, b, ref.CFG)
    bd = ref.batch(uint8=True)
    drop = dict(model={"dropout": 0.1}, seed=5)
    one = td.launch(1, td.retrieval_steps,
                    [ref.spec(v, b), ref.spec(v, ref.perturbed(b)),
                     ref.spec(v, bd, **drop)])[0]
    ranks = td.launch(2, td.retrieval_steps, [
        ref.spec(v, b, dp=2), ref.spec(v, b, dp=2, fsdp=True),
        ref.spec(v, b, dp=1, tp=2), ref.spec(v, bd, dp=2, **drop)])
    return {"jax": want, "variables": v, "port1": one[0],
            "envelope": one[:2], "drop1": one[2],
            **dict(zip(("dp2", "fsdp", "tp2", "drop2"), ranks[0])),
            "rank1": ranks[1]}


@pytest.mark.parametrize("config", ["dp2", "fsdp", "tp2"])
def test_sharded_step_matches_jax_mesh_and_one_process(runs, config):
    for want, what in ((runs["jax"], "jax dp2"), (runs["port1"], "port")):
        ref.assert_step_like(runs[config], want, f"{config} vs {what}",
                             runs["envelope"])
    i = ["dp2", "fsdp", "tp2"].index(config)
    assert runs["rank1"][i]["loss"] == runs[config]["loss"]


def test_fsdp_halves_the_large_leaves(runs):
    """Each leaf JAX's fsdp_spec shards over 'data' is halved on a rank,
    in the module and in both Adam moments."""
    params = runs["variables"]["params"]
    whole = half = 0
    for _, leaf in ref.leaves(params):
        whole += leaf.nbytes
        half += leaf.nbytes // 2 if fsdp_spec(leaf, 2) != () else leaf.nbytes
    assert runs["dp2"]["moment_bytes"] == 2 * whole
    assert runs["fsdp"]["moment_bytes"] == 2 * half
    assert runs["fsdp"]["state_bytes"] < 0.55 * runs["dp2"]["state_bytes"]
    assert half < 0.55 * whole


def test_random_draws_are_the_global_batchs(runs):
    ref.assert_step_like(runs["drop2"], runs["drop1"], "dropout dp2 vs dp1",
                         runs["envelope"])
    np.testing.assert_array_equal(runs["drop2"]["generator"],
                                  runs["drop1"]["generator"])
    assert runs["drop2"]["loss"] != runs["dp2"]["loss"]

