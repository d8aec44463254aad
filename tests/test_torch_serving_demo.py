"""The serving demo of the port (examples/serving/demo_torch.py) run in
process on the CPU at a tiny size: all seven modes run, the five decode
modes print their tokens and times, speculative decoding equals greedy,
and the engine modes (continuous batching with a shared-prefix pool, T5
continuous batching) serve every request."""

import argparse
import importlib.util
import os

import numpy as np

import pytest
import torch

_PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "serving",
                     "demo_torch.py")


def _demo():
    spec = importlib.util.spec_from_file_location("demo_torch", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_five_modes_run(capsys):
    demo = _demo()
    out = demo.main(["--device", "cpu", "--batch", "2", "--prompt", "6",
                     "--new", "8", "--layers", "2", "--width", "32",
                     "--vocab", "64", "--beams", "3", "--gamma", "3"])
    text = capsys.readouterr().out
    assert set(out) == set(demo.MODES + demo.ENGINE_MODES)
    for mode in demo.MODES:
        ids = out[mode]
        assert ids.shape == (2, 14) and ids.device.type == "cpu"
        assert bool(((ids >= 0) & (ids < 64)).all())
        assert f"{mode:8s} row 0:" in text
    assert torch.equal(out["spec"], out["greedy"])
    assert torch.equal(out["greedy"][:, :6], out["beam"][:, :6])
    assert "speculative == greedy: True" in text and "done" in text
    for mode in demo.ENGINE_MODES:
        stats, n = out[mode]
        assert stats["finished"] == 4 and n == 4 * 8
        assert f"{mode:8s}" in text
    assert out["engine"][0]["prefix_hits"] == 2


@pytest.mark.parametrize("mode", ["engine", "seq2seq"])
def test_engine_modes_wait_for_item_5(mode):
    """The engine modes, which waited for the serving engines (ROADMAP
    queue 1, item 5), run on their own: every request finishes with its
    tokens."""
    demo = _demo()
    args = argparse.Namespace(batch=2, prompt=6, new=5, vocab=64, layers=2,
                              width=32)
    rng = np.random.RandomState(0)
    if mode == "engine":
        target = demo.build(2, 32, 0, 64, 11, torch.device("cpu"))
        stats, n = demo.run_engine(target, args, 11, rng)
        assert stats["prefix_hits"] == 2
    else:
        stats, n = demo.run_seq2seq(args, rng, torch.device("cpu"))
    assert stats["finished"] == 4 and n == 4 * 5
