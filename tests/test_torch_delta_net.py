"""The port's gated delta-net recurrence (``ops/delta_net.py``) against the
JAX package's ``delta_net`` and its float64 oracle ``delta_net_ref`` on the
CPU.

Seeded numpy inputs at small widths (batch 2, head dim 16), GQA ratios 1
and 2 under both repeat types, one token and 33 tokens. Tolerance: 1e-4 of
max|ref| on the outputs and on the state. Both float32 recurrences run the
same per-token operations; what differs is float32 rounding (observed: at
most 3e-7 of max|ref| against the oracle, on outputs and state alike)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu.ops import delta_net as JD
from ik_llama_cpp_tpu_torch.ops import delta_net as TD

TOL = 1e-4


def _inputs(seed, b=2, t=33, hkq=2, h=4, d=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        q=rng.standard_normal((b, t, hkq, d)).astype(f),
        k=rng.standard_normal((b, t, hkq, d)).astype(f),
        v=rng.standard_normal((b, t, h, d)).astype(f),
        g=(-np.abs(rng.standard_normal((b, t, h))) * 0.5).astype(f),
        beta=rng.standard_normal((b, t, h)).astype(f),
        state=(rng.standard_normal((b, h, d, d)) * 0.1).astype(f))


def _port(a, repeat_type):
    out, s = TD.delta_net(*(torch.from_numpy(a[n]) for n in ("q", "k", "v", "g", "beta",
                                                             "state")),
                          repeat_type=repeat_type)
    return out.numpy(), s.numpy()


def _close(x, ref):
    return float(np.abs(x - ref).max()) <= TOL * float(np.abs(ref).max())


@pytest.mark.parametrize("t", [1, 33])
@pytest.mark.parametrize("hkq,h,repeat_type", [(4, 4, 0), (2, 4, 0), (2, 4, 1)])
def test_matches_jax_and_reference(t, hkq, h, repeat_type):
    a = _inputs(t * 10 + h + repeat_type, t=t, hkq=hkq, h=h)
    ref_out, ref_s = JD.delta_net_ref(**a, repeat_type=repeat_type)
    j_out, j_s = JD.delta_net(**{n: jnp.asarray(x) for n, x in a.items()},
                              repeat_type=repeat_type)
    out, s = _port(a, repeat_type)
    assert out.shape == ref_out.shape and s.shape == ref_s.shape
    assert out.dtype == np.float32 and s.dtype == np.float32
    assert _close(out, ref_out) and _close(s, ref_s)
    assert _close(out, np.asarray(j_out)) and _close(s, np.asarray(j_s))


def test_repeat_types_differ():
    """The two GQA maps pair v-heads with other k-heads: at ratio 2 they
    give different outputs, each the oracle's for its own map."""
    a = _inputs(5, t=4)
    o0, _ = _port(a, 0)
    o1, _ = _port(a, 1)
    assert not np.allclose(o0, o1)
    assert _close(o1, JD.delta_net_ref(**a, repeat_type=1)[0])


@pytest.mark.parametrize("repeat_type", [0, 1])
def test_state_carries_over_two_calls(repeat_type):
    """Tokens [0, 20) then [20, 33) from the first call's state give the
    one-call outputs and state."""
    a = _inputs(7)
    out, s = _port(a, repeat_type)
    first = {n: (x[:, :20] if n != "state" else x) for n, x in a.items()}
    o1, s1 = _port(first, repeat_type)
    second = {n: (x[:, 20:] if n != "state" else s1) for n, x in a.items()}
    o2, s2 = _port(second, repeat_type)
    assert _close(np.concatenate([o1, o2], axis=1), out) and _close(s2, s)


def test_clip_saturates_like_the_reference():
    """A decay above 1 (g = 1) grows the state into the +-1e6 clip within
    the 33 tokens; the port clips as the oracle does (a share of the
    state sits at the clip)."""
    a = _inputs(9, t=33)
    a["g"][:] = 1.0
    ref_out, ref_s = JD.delta_net_ref(**a)
    out, s = _port(a, 0)
    assert (np.abs(ref_s) >= TD.CLIP).mean() > 0.05
    assert float(np.abs(s).max()) == TD.CLIP
    assert _close(out, ref_out) and _close(s, ref_s)


def test_input_state_is_not_written():
    a = _inputs(11, t=3)
    st = torch.from_numpy(a["state"].copy())
    TD.delta_net(*(torch.from_numpy(a[n]) for n in ("q", "k", "v", "g", "beta")), st)
    assert torch.equal(st, torch.from_numpy(a["state"]))


def test_masked_tokens_leave_the_state_bit_for_bit():
    """beta -> -1e30 and g -> 0 (what the model's forward sets past
    n_valid) keep the state exactly as it was."""
    a = _inputs(13, t=6)
    a["beta"][:, 3:] = -1e30
    a["g"][:, 3:] = 0.0
    _, s = _port(a, 0)
    head = {n: (x[:, :3] if n != "state" else x) for n, x in a.items()}
    _, s3 = _port(head, 0)
    assert np.array_equal(s, s3)
