"""examples/imagenet/main_amp_torch.py ``--zero`` (ZeRO-1) on the CPU
against the JAX package's examples/imagenet/main_amp.py ``--zero``.

ResNet-18 at batch 4, 32 x 32, O2 + FusedAdam at lr 1e-5, three
iterations after the warm-up step.  The JAX example runs as a user runs
it, in a subprocess on one CPU device; the port's runs in process on a
group of one rank (the example makes it) from the same weights (the JAX
model's ``init`` at the example's seed) and the same synthetic batch:
losses within rtol 2e-2, tests/test_torch_make_step_ddp.py's bound at its
learning rate: the bf16 convolutions run through oneDNN here and XLA
there (the first forward alone differs by 0.6 % at lr 0), and Adam's
first steps move every weight by about lr in the sign of its grad, which
small grads do not share.  The sharded step itself is held to 4 ulps of
the JAX package's in tests/test_torch_zero.py.  On one rank the
sharded step's collectives move nothing, so ``--zero`` prints the very
losses of the unsharded run.  On two gloo ranks at a learning rate that
moves the loss, ``--zero`` follows the same ranks' DDP run.

``--zero --checkpoint-dir`` on the two gloo ranks: an uninterrupted run
of three epochs, and a run resumed from its epoch-2 checkpoint, whose
third epoch prints the same losses and whose epoch-3 checkpoint holds the
same bits, every array (the whole optimizer state each rank gathered, the
model); and that two-rank checkpoint given back at world 1 (one window
of the whole buffer), bitwise.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from apex_tpu import models as jmodels

import torch

from apex_tpu_torch import amp, models, optimizers, parallel
from apex_tpu_torch.utils import checkpoint as ckpt
from apex_tpu_torch.utils.jax_interop import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "imagenet", "main_amp_torch.py")
JAX_EXAMPLE = os.path.join(REPO, "examples", "imagenet", "main_amp.py")
sys.path.insert(0, os.path.dirname(EXAMPLE))
import main_amp_torch as example  # noqa: E402

ARGS = ["--arch", "resnet18", "-b", "4", "--image-size", "32", "--iters",
        "3", "--print-freq", "1", "--fused-adam", "--lr", "1e-5", "--zero"]


def _losses(text, tag=""):
    return [float(m) for m in re.findall(
        re.escape(tag) + r"Epoch: \[\d+\]\[\d+/\d+\].*?Loss ([0-9.]+) ",
        text)]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **extra)
    for k in ("APEX_TPU_TORCH_INIT_METHOD", "MASTER_ADDR", "RANK",
              "WORLD_SIZE"):
        env.pop(k, None)
    return env


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's resnet18 built with the JAX model's init weights."""
    params, state = jmodels.resnet18().init(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    build = models.resnet18

    def resnet18(**kw):
        m = build(**kw)
        m.load_state_dict(sd)
        return m

    monkeypatch.setattr(models, "resnet18", resnet18)


def _port(capsys, argv):
    assert example.main(["--device", "cpu"] + argv) > 0
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 3 and np.all(np.isfinite(losses)), out
    return losses, out


def test_zero_follows_the_jax_examples_trajectory(capsys, jax_weights):
    jax_run = subprocess.run(
        [sys.executable, JAX_EXAMPLE] + ARGS, capture_output=True,
        text=True, timeout=600, cwd=REPO,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=1"))
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    assert "ZeRO-1" in jax_run.stdout
    jl = _losses(jax_run.stdout)
    assert len(jl) == 3, jax_run.stdout
    got, out = _port(capsys, ARGS)
    assert "ZeRO-1 optimizer-state sharding" in out, out
    np.testing.assert_allclose(got, jl, rtol=2e-2)
    # one rank: the sharded step is the unsharded one, loss for loss
    plain, _ = _port(capsys, [a for a in ARGS if a != "--zero"])
    assert got == plain


def _two_ranks(store, argv, epochs=1):
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", "2", "--init-method", f"file://{store}", EXAMPLE,
         "--device", "cpu"] + argv,
        capture_output=True, text=True, timeout=600, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "=> 2 rank(s) on cpu" in proc.stdout
    l0 = _losses(proc.stdout, "[rank 0] ")
    l1 = _losses(proc.stdout, "[rank 1] ")
    # each rank prints the loss averaged over the ranks
    assert len(l0) == 3 * epochs and l0 == l1 and np.all(np.isfinite(l0)), \
        proc.stdout
    return np.array(l0)


def test_zero_on_two_gloo_ranks(tmp_path):
    """Two gloo ranks with ``--zero`` against the same two ranks without
    it (DDP's all-reduce), at lr 1e-3, where three steps take the loss
    from about 5 to about 0.1.  The two reduce differently (DDP sums the
    bf16 grads on a bf16 wire, ZeRO-1 reduce-scatters them in fp32), so
    the losses agree within rtol 1e-2 and atol 5e-3 (measured: 0.14 % at
    step 1, 1.6e-3 at step 2), while a step that used only a rank's own
    grads for its window, or left a window unstepped, moves them by far
    more."""
    argv = ARGS[:ARGS.index("--lr")] + ["--lr", "1e-3", "--zero"]
    zero = _two_ranks(tmp_path / "zero_store", argv)
    ddp = _two_ranks(tmp_path / "ddp_store",
                     [a for a in argv if a != "--zero"])
    assert ddp[0] - ddp[-1] > 1.0
    np.testing.assert_allclose(zero, ddp, rtol=1e-2, atol=5e-3)


CK_ARGS = ARGS[:ARGS.index("--lr")] + ["--lr", "1e-3", "--zero"]


def _arrays(path):
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def zero_run(tmp_path_factory):
    """Three epochs on two gloo ranks under ``--zero``, a checkpoint an
    epoch."""
    tmp = tmp_path_factory.mktemp("zero_ck")
    ck = str(tmp / "ck")
    whole = _two_ranks(tmp / "s1", CK_ARGS + [
        "--epochs", "3", "--checkpoint-dir", ck], epochs=3)
    assert ckpt.available_steps(ck) == [1, 2, 3]
    return whole, ck


def test_zero_checkpoint_resumes_bitwise_on_two_gloo_ranks(tmp_path,
                                                           zero_run):
    whole, ck = zero_run
    ck2 = str(tmp_path / "ck2")
    # the epoch-2 checkpoint alone, resumed for the third epoch
    os.makedirs(ck2)
    name = os.path.basename(ckpt._path(ck, 2))
    shutil.copy(os.path.join(ck, name), os.path.join(ck2, name))
    third = _two_ranks(tmp_path / "s2", CK_ARGS + [
        "--epochs", "3", "--checkpoint-dir", ck2, "--resume"])
    np.testing.assert_array_equal(third, whole[6:])
    a, b = _arrays(ckpt._path(ck, 3)), _arrays(ckpt._path(ck2, 3))
    assert a.keys() == b.keys()
    assert any("['m']" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_rank_zero_checkpoint_resumes_at_world_one(tmp_path,
                                                       monkeypatch,
                                                       zero_run):
    _, ck = zero_run
    monkeypatch.setenv("GLOO_SOCKET_IFNAME",
                       os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    parallel.init_process_group(init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
    try:
        model, opt = amp.initialize(
            models.resnet18(device="cpu",
                            generator=torch.Generator().manual_seed(9)),
            optimizers.FusedAdam(lr=1e-3), opt_level="O2", verbosity=0)
        opt.zero_shard()
        assert example.resume_state(ck, model, opt, "conv7") == 3
        assert opt.masters.buf.numel() == opt.masters.layout.total
        got = ckpt._leaf_dict(example.train_state(model, opt))
    finally:
        torch.distributed.destroy_process_group()
        amp.set_policy(amp.NoPolicy())
    stored = _arrays(ckpt._path(ck, 3))
    stored.pop("__checksum__")
    assert got.keys() == stored.keys()
    for k in stored:
        np.testing.assert_array_equal(got[k], stored[k], err_msg=k)
