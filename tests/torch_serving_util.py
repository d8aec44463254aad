"""Shared helpers of the serving parity tests (tests/test_torch_serving*.py):
tiny models of both packages with one set of weights, and a function that
plays one script of requests and steps on a JAX engine and a port engine
alike."""

import numpy as np
import torch

import jax

from apex_tpu import models as jmodels

from apex_tpu_torch import models
from apex_tpu_torch.utils.jax_interop import params_from_jax

VOCAB = 64
BUF = 24


def carry(jm, seed, tm, scale_table=None):
    """The JAX model's ``init`` weights from ``seed``, into ``tm`` too;
    ``scale_table`` names an embedding table divided by 0.02 (sharp,
    tie-free argmax margins, as the JAX serving tests do)."""
    params, _ = jm.init(jax.random.PRNGKey(seed))
    if scale_table is not None:
        params = dict(params)
        params[scale_table] = {
            "weight": params[scale_table]["weight"] / 0.02}
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return params


def gpt(seed=0, n_layer=2, n_head=4, n_embd=32, n_kv_head=2, block=BUF,
        scale=False):
    """The JAX serving tests' GPT (vocab 64, block 24, 2 layers, 4 heads,
    width 32, 2 KV heads): (jax model, params, port model)."""
    kw = dict(vocab_size=VOCAB, block_size=block, n_layer=n_layer,
              n_head=n_head, n_embd=n_embd, dropout=0.0,
              n_kv_head=n_kv_head)
    jm = jmodels.GPT(jmodels.GPTConfig(**kw))
    tm = models.GPT(models.GPTConfig(**kw), device="cpu")
    return jm, carry(jm, seed, tm, "wte" if scale else None), tm


def mistral(seed, window=5, vocab=97, max_pos=32):
    """A tiny Llama with Mistral's sliding window (the JAX rolling
    tests'), sharp argmax margins."""
    kw = dict(vocab_size=vocab, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=max_pos,
              sliding_window=window, tie_word_embeddings=True)
    jm = jmodels.Llama(jmodels.LlamaConfig(**kw))
    tm = models.Llama(models.LlamaConfig(**kw), device="cpu")
    return jm, carry(jm, seed, tm, "embed_tokens"), tm


def t5(seed, layers=2):
    """A tiny T5 (the JAX seq2seq tests')."""
    kw = dict(vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=64,
              num_layers=layers, num_heads=4, dropout_rate=0.0,
              relative_attention_num_buckets=8,
              relative_attention_max_distance=16)
    jm = jmodels.T5(jmodels.T5Config(**kw))
    tm = models.T5(models.T5Config(**kw), device="cpu")
    return jm, carry(jm, seed, tm), tm


def prompts(seed, lengths, vocab=VOCAB, low=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(low, vocab, n)] for n in lengths]


def play(eng, script):
    """Run ``script`` on ``eng``: ``("add"|"submit", prompt, n, kw)``
    admits (its rid appended to the returned list), ``("step",)`` steps
    once, ``("drain",)`` steps until nothing is live or queued,
    ``("cancel", i)`` / ``("preempt", i)`` the i-th request.  Returns
    (rids, the tokens of every step in order)."""
    rids, outs = [], []
    for op in script:
        if op[0] in ("add", "submit"):
            _, prompt, n, kw = op
            fn = eng.add_request if op[0] == "add" else eng.submit
            rids.append(fn(prompt, n, **kw))
        elif op[0] == "step":
            outs.append(_plain(eng.step()))
        elif op[0] == "drain":
            steps = 0
            while eng.live() or eng.queue_depth():
                outs.append(_plain(eng.step()))
                steps += 1
                assert steps < 200
        else:
            assert getattr(eng, op[0])(rids[op[1]])
    return rids, outs


def _plain(out):
    return {int(k): [int(t) for t in v] for k, v in out.items()}


def results(eng, rids):
    return [[int(t) for t in eng.result(r)] if eng.is_finished(r) else None
            for r in rids]


def same_traffic(jeng, teng, script):
    """The script on both engines: the same rids, the same tokens at every
    step, the same results."""
    jr, jo = play(jeng, script)
    tr, to = play(teng, script)
    assert jr == tr
    assert to == jo
    got = results(teng, tr)
    assert got == results(jeng, jr)
    return got


def kv_numpy(tree):
    """A cache tree (of either package) as numpy leaves."""
    if isinstance(tree, dict):
        return {k: kv_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_tree_close(port_tree, jax_tree, path=""):
    """Leaf by leaf, a port tree against a JAX one (numpy): integer leaves
    equal (int8 KV entries within one quantization step: the two
    packages' fp32 matmuls differ in the last bits), float leaves within
    rtol 1e-5, atol 1e-6."""
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(jax_tree), path
        for k in port_tree:
            assert_tree_close(port_tree[k], jax_tree[k], f"{path}/{k}")
        return
    want = tensor(jax_tree)
    got = port_tree.detach()
    assert got.shape == want.shape, path
    if want.dtype == torch.int8:
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        assert int(diff.max()) <= 1, path
    elif want.dtype.is_floating_point:
        torch.testing.assert_close(got.to(want.dtype), want, rtol=1e-5,
                                   atol=1e-6, msg=path)
    else:
        assert torch.equal(got.to(want.dtype), want), path
