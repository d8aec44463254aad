"""``DistributedDataParallel.make_step`` on 2 gloo ranks against the JAX
package's ``make_step`` on 2 of its CPU devices (``tests/test_ddp.py:140``
is the spec).

A [1, 1, 1, 1] Bottleneck ResNet, converted to SyncBatchNorm, under amp O2
+ FusedAdam + DDP, trained 3 steps through the functional step
(``amp.scaled_grad``, ``ddp.allreduce_grads(grads)``,
``optimizer.step(grads)``, the loss averaged over the ranks), from the
JAX package's weights, on a 16-image batch of which each rank takes half.
On the CPU ``make_step`` runs the step eagerly.  The ranks also count
their collectives: the functional step writes no ``.grad``, so the
end-of-backward hook does not fire and the grads are reduced once.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optimizers as joptim
from apex_tpu import parallel as jparallel
from apex_tpu.nn import functional as JF

import torch_dist_worker

LR = 1e-5
STEPS = 3


def _small_jax():
    return jparallel.convert_syncbn_model(jmodels.ResNet(
        jmodels.resnet.Bottleneck, [1, 1, 1, 1], num_classes=10))


@pytest.fixture(scope="module")
def inputs():
    params, state = _small_jax().init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(11)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "state": jax.tree_util.tree_map(np.asarray, state),
            "x": rs.randn(16, 3, 32, 32).astype(np.float32),
            "y": rs.randint(0, 10, 16).astype(np.int32),
            "lr": LR, "steps": STEPS}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return [r for r in torch_dist_worker.run(
        "make_step", inputs, tmp_path_factory.mktemp("make_step"))]


def _train_jax(inp):
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jm, jopt = jamp.initialize(_small_jax(), joptim.FusedAdam(lr=LR),
                               opt_level="O2", verbosity=0)
    ddp = jparallel.DistributedDataParallel(jm)
    params = jm.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                   inp["params"]))
    state = jax.tree_util.tree_map(jnp.asarray, inp["state"])

    def step(st, batch):
        params, bn, ost = st
        xb, yb = batch

        def loss_fn(p):
            out, new_bn = jm.apply(p, xb, state=bn, train=True)
            return JF.cross_entropy(out, yb), new_bn

        loss, new_bn, grads = jamp.scaled_grad(loss_fn, params, ost,
                                               has_aux=True)
        grads = ddp.allreduce_grads(grads)
        params, ost, _ = jopt.step(params, ost, grads)
        return (params, new_bn, ost), lax.pmean(loss, "data")

    train = ddp.make_step(step, mesh=mesh, donate_state=False)
    st, losses = (params, state, jopt.init(params)), []
    for _ in range(STEPS):
        st, loss = train(st, (jnp.asarray(inp["x"]), jnp.asarray(inp["y"])))
        losses.append(float(loss))
    return losses, st


# the tolerances of the O2 training slice (tests/test_torch_resnet.py): the
# convolutions run in bf16 through oneDNN here and XLA there and round on
# each side (losses up to 8.8e-3 apart over three steps there); FusedAdam
# moves a weight by about lr a step, so a near-zero grad whose sign flips
# costs up to 2*lr a step; the running statistics from bf16 activations,
# 5e-2 in relative norm
def test_make_step_two_ranks_matches_jax_make_step(ranks, inputs):
    jl, (jparams, jstate, jost) = _train_jax(inputs)
    r0, r1 = ranks
    for k in ("masters", "half", "m", "v"):     # the ranks stay in step
        np.testing.assert_array_equal(r0[k], r1[k], k)
    for k in r0["buffers"]:
        np.testing.assert_array_equal(r0["buffers"][k], r1["buffers"][k], k)
    assert r0["losses"] == r1["losses"]         # averaged over the ranks
    tl = np.asarray(r0["losses"])
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    jm = np.asarray(jost.masters.buf)
    atol = 2 * LR * STEPS + 4 * float(np.spacing(np.abs(jm).max()))
    np.testing.assert_allclose(r0["masters"], jm, rtol=0, atol=atol)
    assert r0["steps"] == int(jost.inner.step) == STEPS
    worst = 0.0
    for path, leaves in jstate.items():
        assert int(r0["buffers"][f"{path}.num_batches_tracked"]) == STEPS
        for k in ("running_mean", "running_var"):
            t, j = r0["buffers"][f"{path}.{k}"], np.asarray(leaves[k])
            worst = max(worst, np.linalg.norm(t - j) / np.linalg.norm(j))
    assert worst <= 5e-2, worst


def test_functional_step_reduces_once_and_leaves_grad_alone(ranks):
    """No ``.grad`` written, the end-of-backward hook never fired, and each
    step made exactly the collectives of its comm plan's buckets, two a
    SyncBatchNorm (the statistics forward, their cotangent backward) and
    the loss's mean."""
    for r in ranks:
        assert r["grads_none"] and r["hooked"] == 0 and not r["queued"]
        chunks = sum(b["chunks"] for b in r["plan"])
        assert r["all_reduce_calls"] == [2 * r["n_sync"] + chunks + 1] * \
            STEPS, (r["all_reduce_calls"], r["n_sync"], chunks)
        # the runtime's accounting is the plan's, key for key
        keys = ("dtype", "comm_dtype", "leaves", "elements", "chunks",
                "cause", "topology", "wire_elements", "padded_elements",
                "dcn_comm_dtype")
        assert [{k: s[k] for k in keys} for s in r["stats"]] == \
            [{k: b[k] for k in keys} for b in r["plan"]]
        assert [s["bytes"] for s in r["stats"]] == \
            [b["wire_bytes"] for b in r["plan"]]
