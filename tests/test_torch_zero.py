"""ZeRO in the port's amp optimizer on 4 gloo ranks, against the JAX
package's ZeRO on 4 of its CPU devices under ``shard_map``
(``tests/test_zero.py`` is the spec).

Two workloads, the ranks started once for the file
(``tests/torch_dist_worker.py``, suite ``zero``):

- a toy parameter tree of 73 elements (so the windows pad: 19 a rank over
  4, 37 over the 2 ranks of a "node"), fp16 under O2 with a dynamic loss
  scale and fp32 BatchNorm-like leaves, FusedAdam; each step's grads are
  given (the loss is ``sum(p * g)``), different on every rank, with an inf
  in one rank's grads at step 1.  Stages 1, 2 (and compressed) and 3
  against the JAX package's run on the same grads: masters within 4 ulps
  (the JAX package's Adam divides where the port multiplies by the
  reciprocal: ``tests/test_torch_checkpoint.py``'s bound), the moments
  within 2e-6 of their largest, the step and the scalers exact, the skip
  on every rank; and a JAX ZeRO-1 state after K steps continued on the
  ranks to the JAX package's K + M, and the ranks' state after K
  continued in the JAX package;
- tests/test_zero.py's conv net at batch 16 (4 a rank), within the port:
  ZeRO-1 after one step against DDP (atol 1e-6) and over four (losses
  rtol 1e-2), hierarchical DDP likewise, stages 2 and 3 against stage 1,
  and ZeRO-1 through ``make_step``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch

from apex_tpu import amp as jamp
from apex_tpu import optimizers as joptim
from apex_tpu import parallel as jparallel

from apex_tpu_torch import amp, nn, optimizers, parallel
from apex_tpu_torch.utils.jax_interop import zero_state_to_jax

import torch_dist_worker

WORLD = 4
K, M = 4, 2
HP = dict(lr=1e-3, weight_decay=0.01)
# leaf names whose JAX order differs from their registration order; 73
# elements in all
TOY = {"fc": {"weight": (5, 7), "bias": (5,)},
       "bn1": {"weight": (7,), "bias": (7,)},
       "layer": {"2": {"weight": (3, 4)}, "10": {"weight": (7,)}}}


def _names(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_names(v, name) if isinstance(v, dict) else {name: v})
    return out


def _toy(rs):
    def draw(t):
        return {k: draw(v) if isinstance(v, dict)
                else (rs.randn(*v) * 0.5).astype(np.float32)
                for k, v in t.items()}
    return draw(TOY)


def _grads(rs):
    """K + M steps of 4 ranks' grads; an inf in rank 2's at step 1."""
    shapes = _names(TOY)
    steps = []
    for i in range(K + M):
        per = [{n: (rs.randn(*s) * 1e-2).astype(np.float32)
                for n, s in shapes.items()} for _ in range(WORLD)]
        if i == 1:
            per[2]["layer.2.weight"][1, 1] = np.inf
        steps.append(per)
    return steps


def _jax_params(arrays):
    def cast(t, pinned=False):
        return {k: cast(v, pinned or k.startswith("bn"))
                if isinstance(v, dict) else
                jnp.asarray(v, jnp.float32 if pinned else jnp.float16)
                for k, v in t.items()}
    return cast(arrays)


def _jax_loss(params, g):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return sum(jnp.sum(leaf.astype(jnp.float32) * g[
        ".".join(str(k.key) for k in path)]) for path, leaf in leaves)


class _Jax:
    """The JAX package's ZeRO run on the toy grads, 4 devices."""

    def __init__(self, arrays, stage=1, ici=None, compress=False):
        self.mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
        self.opt = jamp.AmpOptimizer(joptim.FusedAdam(**HP),
                                     jamp.LossScaler("dynamic"),
                                     master_weights=True)
        self.params = _jax_params(arrays)
        self.stage = stage
        knobs = dict(zero_stage=stage, zero_ici_size=ici,
                     zero_compress_bf16=compress)
        self.specs = jamp.zero_optimizer_specs(self.opt, self.params,
                                               "data", **knobs)
        self.state = jax.jit(jax.shard_map(
            lambda p: self.opt.init(p, zero_axis="data", **knobs),
            mesh=self.mesh, in_specs=(P(),), out_specs=self.specs,
            check_vma=False))(self.params)
        self._step = jax.jit(jax.shard_map(
            self._body, mesh=self.mesh,
            in_specs=(P(), self.specs, P("data")),
            out_specs=(P(), self.specs, P()), check_vma=False))

    def _body(self, p, os, g):
        g = {k: v[0] for k, v in g.items()}
        if self.stage == 3:
            _, grads = jamp.scaled_grad(
                lambda m: _jax_loss(jamp.zero_gather_params(m, "data"), g),
                os.masters, os)
            _, os, info = self.opt.step((), os, grads)
            return p, os, info
        grads = jax.grad(lambda pp: _jax_loss(pp, g)
                         * os.scalers[0].loss_scale)(p)
        return self.opt.step(p, os, grads)

    def run(self, steps):
        infos = []
        for per in steps:
            g = {n: jnp.asarray(np.stack([r[n] for r in per]))
                 for n in per[0]}
            self.params, self.state, info = self._step(self.params,
                                                       self.state, g)
            infos.append({k: float(v) for k, v in info.items()})
        return infos

    def numpy_state(self):
        st = self.state
        return {"masters": np.asarray(st.masters.buf),
                "m": np.asarray(st.inner.m), "v": np.asarray(st.inner.v),
                "step": int(st.inner.step),
                "scalers": {k: np.asarray(getattr(st.scalers[0], k))
                            for k in ("loss_scale", "unskipped",
                                      "steps_skipped")}}


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(20)
    arrays = _toy(rs)
    grads = _grads(rs)
    j = _Jax(arrays)
    j.run(grads[:K])
    rn = np.random.RandomState(0)
    return {"toy": arrays, "toy_grads": grads, "K": K,
            "jax_at_k": j.state,
            "net_x": rn.randn(16, 3, 8, 8).astype(np.float32),
            "net_y": rn.randint(0, 10, 16).astype(np.int32)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    inp = dict(inputs, jax_at_k=jax.tree_util.tree_map(
        np.asarray, inputs["jax_at_k"]))
    return torch_dist_worker.run("zero", inp,
                                 tmp_path_factory.mktemp("zero"), WORLD)


def _gathered(ranks, key, part="end"):
    return {k: np.concatenate([r["toy"][key][part][k] for r in ranks])
            for k in ("masters", "m", "v")}


def _assert_state(got, want, where):
    d = np.abs(got["masters"].view(np.int32).astype(np.int64)
               - want["masters"].view(np.int32).astype(np.int64))
    assert d.max() <= 4, (where, d.max())
    for k in ("m", "v"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=np.float32(2e-6)
                                   * np.abs(want[k]).max(),
                                   err_msg=f"{where} {k}")


@pytest.mark.parametrize("key,stage,ici,compress", [
    ("z1", 1, None, False), ("z2", 2, 2, False), ("z2c", 2, 2, True),
    ("z3", 3, 2, False)])
def test_zero_stages_match_jax(ranks, inputs, key, stage, ici, compress):
    j = _Jax(inputs["toy"], stage, ici, compress)
    jinfo = j.run(inputs["toy_grads"])
    want = j.numpy_state()
    _assert_state(_gathered(ranks, key), want, key)
    for r in ranks:
        end = r["toy"][key]["end"]
        assert end["step"] == want["step"] == K + M - 1
        for k, v in want["scalers"].items():
            assert end["scalers"][k].tobytes() == v.tobytes(), k
        # the skip was every rank's, and the scale halved once
        assert [i["found_inf"] for i in r["toy"][key]["info"]] == \
            [i["found_inf"] for i in jinfo] == [0, 1, 0, 0, 0, 0]
        np.testing.assert_allclose(
            [i["grad_norm"] for i in r["toy"][key]["info"]],
            [i["grad_norm"] for i in jinfo], rtol=1e-5)
    if stage >= 2:
        # the two nodes hold the same windows, bitwise
        for a, b in ((0, 2), (1, 3)):
            for k in ("masters", "m", "v"):
                np.testing.assert_array_equal(
                    ranks[a]["toy"][key]["end"][k],
                    ranks[b]["toy"][key]["end"][k])


def test_zero1_params_are_every_ranks_and_match_ddp(ranks):
    """The gathered half and fp32 params agree on every rank, and ZeRO-1
    lands on the unsharded DDP step's masters (another reduction order of
    the same sums; tests/test_zero.py's atol 1e-6)."""
    for r in ranks[1:]:
        for n, v in r["toy"]["z1"]["params"].items():
            np.testing.assert_array_equal(
                v, ranks[0]["toy"]["z1"]["params"][n])
    ddp = ranks[0]["toy"]["ddp"]
    z1 = _gathered(ranks, "z1")["masters"]
    np.testing.assert_allclose(z1[:ddp["masters"].size], ddp["masters"],
                               rtol=0, atol=1e-6)
    assert [i["found_inf"] for i in ddp["info"]] == [0, 1, 0, 0, 0, 0]


def test_jax_zero1_state_continues_on_the_ranks(ranks, inputs):
    j = _Jax(inputs["toy"])
    j.run(inputs["toy_grads"])
    got = {k: np.concatenate([r["toy"]["from_jax"]["end"][k]
                              for r in ranks]) for k in ("masters", "m", "v")}
    _assert_state(got, j.numpy_state(), "from_jax")


def test_port_zero1_state_continues_in_jax(ranks, inputs):
    sds = []
    for r in ranks:
        st = r["toy"]["z1"]["at_k"]
        sds.append({"scalers": [{k: torch.from_numpy(v)
                                 for k, v in st["scalers"].items()}],
                    "inner": {"step": torch.tensor(st["step"],
                                                   dtype=torch.int32),
                              "m": torch.from_numpy(st["m"]),
                              "v": torch.from_numpy(st["v"])},
                    "masters": torch.from_numpy(st["masters"])})
    out = zero_state_to_jax(sds)
    j = _Jax(inputs["toy"])
    st = j.state
    j.state = st._replace(
        inner=type(st.inner)(**{k: jnp.asarray(v)
                                for k, v in out["inner"].items()}),
        masters=type(st.masters)(jnp.asarray(out["masters"]),
                                 st.masters.layout),
        scalers=tuple(jamp.ScalerState(**{k: jnp.asarray(v)
                                          for k, v in s.items()})
                      for s in out["scalers"]))
    j.run(inputs["toy_grads"][K:])
    _assert_state(_gathered(ranks, "z1"), j.numpy_state(), "to_jax")


def test_zero_on_the_net(ranks):
    """tests/test_zero.py's pins on its conv net, within the port."""
    net = [r["net"] for r in ranks]
    total = net[0]["ddp_1"].size
    for key, atol in (("z1_1", 1e-6), ("z2_1", 1e-6), ("z2c_1", 2e-2),
                      ("z3_1", 1e-6)):
        np.testing.assert_allclose(net[0][key][:total], net[0]["ddp_1"],
                                   rtol=0, atol=atol, err_msg=key)
    for key in ("hier_4", "z1_4"):
        np.testing.assert_allclose(net[0][key], net[0]["ddp_4"], rtol=1e-2,
                                   err_msg=key)
    assert np.isfinite(net[0]["z3_loss"]).all()
    flat, hier = net[0]["grads"]
    for a, b in zip(flat, hier):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-3)
    first, second = net[0]["make_step"]
    assert first.shape == (2,) and np.isfinite(first).all()
    assert second[-1] < first[0]


def test_zero_errors(ranks):
    e = ranks[0]["errors"]
    assert "flat grad shard" in e["tree_grads"]
    assert "all_gather" in e["as_list"]
    assert "ZeRO-sharded" in e["write"]
    assert "functional step" in e["scale_loss"]
    assert "already" in e["again"]
    assert "ZeRO-3" in e["gather_stage1"]
    assert "ZeRO-sharded" in e["outside"]


def _net_opt(inner=None):
    net = torch.nn.Sequential(
        nn.Conv2d(3, 4, 3, padding=1, device="cpu",
                  generator=torch.Generator().manual_seed(0)),
        nn.BatchNorm2d(4, device="cpu"))
    return amp.initialize(net, inner or optimizers.FusedAdam(),
                          opt_level="O2", verbosity=0)


def test_zero_knob_validation():
    _, opt = _net_opt()
    for bad in (dict(zero_stage=4, zero_ici_size=2), dict(zero_stage=0),
                dict(zero_stage=2), dict(zero_stage=3),
                dict(zero_stage=1, zero_compress_bf16=True)):
        with pytest.raises(ValueError):
            amp.zero_optimizer_specs(opt, **bad)
        with pytest.raises(ValueError):
            opt.zero_shard(**bad)
    # one rank here: the whole buffer, padded to nothing
    assert amp.zero_optimizer_specs(opt) == [(0, opt.masters.layout.total)]
    _, lamb = _net_opt(optimizers.FusedLAMB())
    with pytest.raises(ValueError, match="elementwise"):
        lamb.zero_shard()
    with pytest.raises(ValueError, match="elementwise"):
        amp.zero_optimizer_specs(lamb)


@pytest.mark.parametrize("stage,ici,compress", [
    (1, None, False), (2, 4, False), (2, 4, True), (3, 4, False),
    (3, 2, False)])
def test_zero_update_comm_plan_equals_the_jax_packages(stage, ici,
                                                       compress):
    from apex_tpu import nn as jnn
    jm, jopt = jamp.initialize(
        jnn.Sequential([jnn.Conv2d(3, 4, 3, padding=1), jnn.BatchNorm2d(4),
                        jnn.ReLU(), jnn.Flatten(), jnn.Linear(4 * 8 * 8,
                                                              10)]),
        joptim.FusedAdam(), opt_level="O2", verbosity=0, hard_override=True)
    params, _ = jm.init(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    ptree = {".".join(str(k.key) for k in path): torch.empty(
        leaf.shape, dtype=getattr(torch, str(leaf.dtype)), device="meta")
        for path, leaf in flat}
    kw = dict(zero_stage=stage, world=8, ici_size=ici,
              zero_compress_bf16=compress)
    want = jparallel.zero_update_comm_plan(params, **kw)
    # the JAX package names a jnp scalar type by its class
    # ("<class 'jax.numpy.float32'>"); the port by the dtype's name
    for b in want:
        for k in ("dtype", "comm_dtype", "dcn_comm_dtype"):
            b[k] = b[k].replace("<class 'jax.numpy.", "").replace("'>", "")
    assert parallel.zero_update_comm_plan(ptree, **kw) == want


@pytest.fixture
def one_rank_group(tmp_path, monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME",
                       os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    parallel.init_process_group(init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_zero3_policy_drops_the_gathered_saves_and_only_them(one_rank_group):
    """The ZeRO-3 checkpoint policy on one gloo rank: it drops exactly the
    saves that view the gathered parameters (the weights of the second and
    third layers, which their input grads need; the first layer's input
    needs no grad, so its weight is not saved), and keeps a tensor the
    loss head makes at the size of the gathered buffer after it is freed
    (the allocator may give it the freed address).  The grads of the
    regathered backward bitwise the kept backward's."""
    torch.manual_seed(0)
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(8, 16).astype(np.float32)).bfloat16()
    y = torch.from_numpy(rs.randint(0, 16, 8))

    def grads(policy):
        model = torch.nn.Sequential(
            *[m for _ in range(3) for m in (
                nn.Linear(16, 16, device="cpu",
                          generator=torch.Generator().manual_seed(1)),
                torch.nn.Tanh())])
        model, opt = amp.initialize(model, optimizers.FusedAdam(),
                                    opt_level="O2", verbosity=0)
        opt.zero_shard(zero_stage=3, zero_ici_size=1)
        size = opt.masters.zero.padded

        def loss_fn():
            out = torch.func.functional_call(
                model, amp.zero_gather_params(opt), (x,))
            # the gathered buffers are freed by now: a zero tensor of
            # their size, saved by the product, adds nothing to the grads
            same = torch.zeros(size, dtype=torch.bfloat16)
            extra = (out.float().mean().bfloat16() * same).float().sum()
            return torch.nn.functional.cross_entropy(out.float(), y) + extra

        if policy:
            with amp.zero_gather_checkpoint_policy(opt):
                loss, g = amp.scaled_grad(loss_fn, opt)
        else:
            loss, g = amp.scaled_grad(loss_fn, opt)
        return loss, g.clone(), opt.zero_dropped_saves

    kept = grads(False)
    dropped = grads(True)
    assert kept[2] == 0 and dropped[2] == 2
    assert torch.equal(kept[0], dropped[0])
    assert torch.equal(kept[1], dropped[1])
