"""examples/imagenet/main_amp_torch.py on the CPU, in process, and the
profiler utilities it uses.

ResNet-18 at batch 4, 32 x 32, three iterations: NCHW; channels-last with
the space-to-depth stem and FusedAdam; a uint8 NHWC ``--data`` blob with a
val split through the DataLoader and the convergence gate; a checkpoint
then a resume into the space-to-depth stem, whose first logits are the
saved conv7 model's; ``--zero`` with a checkpoint refused; and two gloo
ranks through the port's launcher, which print the same (rank-averaged)
loss.  Then
``utils.profiler`` against ``apex_tpu.utils.profiler``: ``AverageMeter``
the same numbers, range nesting, and profiler windows that nest and write
a trace into a directory of their own.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from apex_tpu.utils import profiler as jprofiler

from apex_tpu_torch import amp, models, optimizers
from apex_tpu_torch.utils import checkpoint as ckpt
from apex_tpu_torch.utils import profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "imagenet", "main_amp_torch.py")
sys.path.insert(0, os.path.dirname(EXAMPLE))
import main_amp_torch as example  # noqa: E402

BASE = ["--device", "cpu", "--arch", "resnet18", "-b", "4",
        "--image-size", "32", "--iters", "3", "--print-freq", "1"]


def _losses(text, tag=""):
    return [float(m) for m in re.findall(
        re.escape(tag) + r"Epoch: \[\d+\]\[\d+/\d+\].*?Loss ([0-9.]+) ",
        text)]


def _run(capsys, argv):
    ips = example.main(BASE + argv)
    out = capsys.readouterr().out
    assert ips > 0 and "=> done. avg" in out, out
    losses = _losses(out)
    assert losses and all(np.isfinite(losses)), out
    return out


def test_nchw(capsys):
    out = _run(capsys, [])
    assert "=> 1 rank(s) on cpu" in out
    assert amp.policy.current_policy().__class__.__name__ == "NoPolicy"


def test_channels_last_space_to_depth_fused_adam(capsys):
    _run(capsys, ["--channels-last", "--stem", "space_to_depth",
                  "--fused-adam"])


def test_o1_leaves_no_cast_policy(capsys):
    _run(capsys, ["--opt-level", "O1", "--channels-last"])
    assert amp.policy.current_policy().__class__.__name__ == "NoPolicy"


def test_uint8_data_with_val_split_and_gate(capsys, tmp_path):
    rs = np.random.RandomState(0)
    blob = tmp_path / "blob.npz"
    np.savez(blob,
             images=rs.randint(0, 256, (16, 32, 32, 3)).astype(np.uint8),
             labels=rs.randint(0, 1000, 16),
             val_images=rs.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
             val_labels=rs.randint(0, 1000, 8))
    for extra in ([], ["--channels-last"]):
        out = _run(capsys, ["--data", str(blob), "--target-acc", "0"]
                   + extra)
        assert "=> native data loader: True (4 batches/epoch)" in out, out
        assert "=> convergence gate PASSED" in out, out
        assert re.search(r"\* Prec@1 [0-9.]+ +\(epoch 0, 8 val images\)",
                         out), out


def test_float_data_blob_is_nchw(capsys, tmp_path):
    rs = np.random.RandomState(1)
    blob = tmp_path / "f.npz"
    np.savez(blob, images=rs.randn(8, 3, 32, 32).astype(np.float32),
             labels=rs.randint(0, 1000, 8))
    _run(capsys, ["--data", str(blob), "--channels-last"])


def test_checkpoint_then_resume_into_space_to_depth(capsys, tmp_path):
    ck = str(tmp_path / "ck")
    _run(capsys, ["--checkpoint-dir", ck, "--epochs", "2"])
    from apex_tpu_torch.utils import checkpoint
    assert checkpoint.available_steps(ck) == [1, 2]
    # the conversion keeps the conv7 model's function: the checkpoint's
    # model in fp32, and the space-to-depth model the example's resume
    # converts from it, give the same first logits to fp32 rounding (1e-5
    # in norm; measured 1e-7)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 32, 32)
                         .astype(np.float32))
    m7 = models.resnet18(device="cpu")
    m7.load_state_dict(checkpoint.restore_checkpoint(
        ck, {"model": m7.state_dict()})["model"])
    ms, opt = amp.initialize(models.resnet18(stem="space_to_depth",
                                             device="cpu"),
                             optimizers.SGD(lr=0.1), opt_level="O0",
                             verbosity=0)
    assert example.resume_state(ck, ms, opt, "space_to_depth") == 2
    with torch.no_grad():
        want, got = m7.train()(x), ms.train()(x)
    capsys.readouterr()
    err = float((got - want).norm() / want.norm())
    assert err <= 1e-5, err
    out = _run(capsys, ["--checkpoint-dir", ck, "--epochs", "3", "--resume",
                        "--stem", "space_to_depth"])
    assert "converting" in out and "resumed from epoch 2" in out, out
    assert checkpoint.available_steps(ck) == [1, 2, 3]
    out = _run(capsys, ["--checkpoint-dir", ck, "--epochs", "4", "--resume",
                        "--stem", "space_to_depth"])
    assert "converting" not in out and "resumed from epoch 3" in out, out


def test_zero_and_missing_gpu_raise(tmp_path):
    # --zero runs (tests/test_torch_imagenet_zero.py) and, with
    # --checkpoint-dir, saves its gathered state (resumed bitwise there)
    example.main(BASE + ["--zero", "--checkpoint-dir", str(tmp_path)])
    assert ckpt.available_steps(str(tmp_path)) == [1]
    if not torch.cuda.is_available():
        argv = [a for a in BASE if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="CUDA"):
            example.main(argv)


def test_two_gloo_ranks_print_the_same_loss(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("APEX_TPU_TORCH_INIT_METHOD", "MASTER_ADDR", "RANK",
              "WORLD_SIZE"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", "2", "--init-method", f"file://{tmp_path}/store",
         EXAMPLE] + BASE + ["--channels-last"],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    l0 = _losses(proc.stdout, "[rank 0] ")
    l1 = _losses(proc.stdout, "[rank 1] ")
    assert len(l0) == 3 and l0 == l1, proc.stdout
    assert "=> 2 rank(s) on cpu" in proc.stdout


# -- utils.profiler -----------------------------------------------------------

def test_average_meter_matches_jax():
    a, b = profiler.AverageMeter(), jprofiler.AverageMeter()
    for val, n in ((3.0, 1), (1.5, 4), (0.25, 2)):
        a.update(val, n)
        b.update(val, n)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)
    a.reset()
    assert (a.val, a.avg, a.sum, a.count) == (0.0, 0.0, 0.0, 0)


def test_ranges_nest_as_jax():
    assert profiler.range_push("outer") == 1
    assert profiler.range_push("inner") == 2
    assert profiler.range_pop() == 1
    assert profiler.range_pop() == 0
    with pytest.raises(RuntimeError):
        profiler.range_pop()

    @profiler.annotate("named")
    def f(x):
        return x + 1

    assert f(1) == 2


def test_profile_windows_nest_and_write_their_own_trace(tmp_path):
    assert not profiler.profiling_active()
    with profiler.profile(str(tmp_path)) as cap:
        assert profiler.current_capture_dir() == cap
        assert profiler.start_profile(str(tmp_path / "ignored")) == cap
        with profiler.nvtx_range("apex_range"):
            torch.ones(4).sum()
        assert profiler.stop_profile() is None       # the inner window
        assert profiler.profiling_active()
    assert not profiler.profiling_active()
    assert profiler.current_capture_dir() is None
    assert profiler.last_capture_dir() == cap
    trace = os.path.join(cap, "trace.json")
    assert os.path.exists(trace) and "apex_range" in open(trace).read()
    with profiler.profile(str(tmp_path)) as cap2:
        pass
    assert cap2 != cap and os.path.dirname(cap2) == str(tmp_path)
    assert profiler.stop_profile() is None
