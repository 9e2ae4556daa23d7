"""Lookahead decoding in the port against the JAX package on the CPU.

The tiny llama fixture decodes greedily with ``generate_lookahead`` in both
packages: the port's tokens are the JAX function's, token for token, and
its greedy decode's. Its round and acceptance counts follow the argmaxes
of the Jacobi window's rows, which on random weights sit at near-ties that
the JAX runtime's jitted probe and the port's eager one round apart (a
0.42% gap at the first probe, whose logits agree to 0.83%), so the counts
are held to the JAX function's on a scripted target instead: a bigram
model whose every row's next token is fixed, through which both packages'
walks, window shifts and n-gram pools run on the same logits. The probe's
layout and mask are the JAX layout's, entry for entry, for each (W, N,
G)."""
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu.runtime import lookahead as JLA
from ik_llama_cpp_tpu_torch.runtime import generate as TG
from ik_llama_cpp_tpu_torch.runtime import lookahead as TLA

N_NEW = 24
# a prompt that repeats itself, so that the n-gram pool has grams to verify
PROMPT = [int(x) for x in np.tile(np.random.default_rng(8).integers(3, 250, 6), 3)]


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    path = F.make_tiny_llama_gguf(tmp_path_factory.mktemp("la") / "l.gguf", seed=6)
    return JG.Runtime.from_gguf(path), TG.Runtime.from_gguf(path, device="cpu")


@pytest.mark.parametrize("wng", [(4, 3, 4), (3, 2, 2), (5, 4, 3)])
def test_layout_is_jax_layout(wng):
    a, b = TLA._Layout(*wng), JLA._Layout(*wng)
    assert a.T == b.T
    np.testing.assert_array_equal(a.rel_pos, b.rel_pos)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert [a.level_row(j, i) for j in range(wng[1] - 1) for i in range(1, wng[0])] == \
        [b.level_row(j, i) for j in range(wng[1] - 1) for i in range(1, wng[0])]


@pytest.mark.parametrize("wng", [(4, 3, 4), (3, 2, 2)])
def test_tokens_are_jax_and_greedy(runtimes, wng):
    jr, tr = runtimes
    w, n, g = wng
    _, jt, js = JLA.generate_lookahead(jr, PROMPT, N_NEW, W=w, N=n, G=g, capacity=128,
                                       stop_at_eos=False)
    _, tt, ts = TLA.generate_lookahead(tr, PROMPT, N_NEW, W=w, N=n, G=g, capacity=128,
                                       stop_at_eos=False)
    _, greedy = tr.generate_greedy_on_device(PROMPT, N_NEW, stop_at_eos=False)
    assert tt == jt == greedy
    for st in (ts, js):
        assert st.n_predict == N_NEW == 1 + st.n_rounds + st.n_accept


class Bigram:
    """A scripted target: the next token after t is (3 t + 1) % V at every
    position, whatever came before; the logits are one-hot. The port's
    runtime returns torch tensors, the JAX runtime numpy arrays."""
    V = 53

    def __init__(self, torch_out: bool):
        self.torch_out, self.tokenizer, self.eos_id = torch_out, None, -1

    def _rows(self, toks):
        out = np.zeros((len(toks), self.V), np.float32)
        out[np.arange(len(toks)), (3 * np.asarray(toks) + 1) % self.V] = 1.0
        return torch.from_numpy(out) if self.torch_out else out

    def _ids(self, prompt):
        return list(prompt)

    def new_cache(self, batch, capacity):
        return None

    def eval_tokens(self, ids, kv, n_past):
        return self._rows(ids[-1:]), kv, n_past + len(ids)

    def eval_probe(self, toks, positions, block_mask, kv, n_past):
        assert len(toks) == len(positions) == len(block_mask)
        return self._rows(toks)


@pytest.mark.parametrize("wng", [(4, 3, 4), (3, 2, 2), (5, 4, 3)])
def test_walk_and_pool_match_jax_on_a_scripted_target(wng):
    """On the bigram target both packages emit the same tokens with the same
    round, prediction and acceptance counts, and grams are accepted."""
    w, n, g = wng
    _, jt, js = JLA.generate_lookahead(Bigram(False), [7, 9], 40, W=w, N=n, G=g)
    _, tt, ts = TLA.generate_lookahead(Bigram(True), [7, 9], 40, W=w, N=n, G=g)
    assert tt == jt and len(tt) == 40
    assert (ts.n_rounds, ts.n_predict, ts.n_accept) == (js.n_rounds, js.n_predict, js.n_accept)
    assert ts.n_accept > 0
