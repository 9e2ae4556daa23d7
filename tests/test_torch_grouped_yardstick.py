"""The library yardstick of kernels 10 and 14 in chip_smoke.py phase 3
(``grouped_library``: one bf16 ``torch._grouped_mm`` over the live experts)
computes the function of ``ragged_qmatmul_ref`` and
``ragged_qmatmul_i8_ref`` on the dequantized operands, within bf16 output
rounding: with empty groups, and with no live row at all."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu_torch.ops import moe_decode as MD
from ik_llama_cpp_tpu_torch.ops import moe_qmm as MQ

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

G, M = 6, 40
SIZE_SETS = {"uneven": [7, 0, 13, 1, 0, 19], "one expert": [0, 0, 40, 0, 0, 0],
             "short": [3, 5, 0, 0, 2, 0]}


def _sizes(name):
    return torch.tensor(SIZE_SETS[name], dtype=torch.int32)


def _per_group(xf, wf, sizes):
    """float32 x[rows of g] @ w[g] per group, in order: the products the
    references form, on the operands given."""
    out, start = [], 0
    for g, n in enumerate(sizes.tolist()):
        out.append(xf[start:start + n] @ wf[g])
        start += n
    return torch.cat(out)


def _check(lib, ref, absdot, k):
    """bf16 output rounding (half an ulp: at most 2^-8 of the value) on top
    of two float32 sums of the same K products in different orders."""
    tol = 2.0 ** -8 * ref.abs() + 16 * k ** 0.5 * 2.0 ** -24 * absdot.max()
    assert lib.dtype == torch.bfloat16
    assert bool(((lib.float() - ref).abs() <= tol).all())


@pytest.mark.parametrize("name", list(SIZE_SETS))
def test_grouped_library_is_kernel_14s_function(name):
    k, n = 128, 48
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(-8, 8, (G, n, k), dtype=np.int8)).transpose(1, 2)
    sc = torch.from_numpy(rng.uniform(0.01, 0.03, (G, k // 32, n)).astype(np.float32)) \
        .to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((M, k)).astype(np.float32)).to(torch.bfloat16)
    gs = _sizes(name)
    total = int(gs.sum())
    w = chip_smoke.k_major(MD.dequant_experts(codes, sc, 32))
    assert w.shape == (G, k, n) and w.transpose(1, 2).is_contiguous()
    lib = chip_smoke.grouped_library(x, w, gs)
    assert lib.shape == (M, n)
    ref = MQ.ragged_qmatmul_ref(x, codes, sc, gs, group=32)[:total]
    absdot = _per_group(x.float().abs(), w.float().abs(), gs)
    _check(lib[:total], ref, absdot, k)


@pytest.mark.parametrize("name", list(SIZE_SETS))
def test_grouped_library_is_kernel_10s_function(name):
    """On the dequantized rows and experts (x_q x_s and codes x sw, rounded
    to bf16), the grouped product is the per-group float32 product within
    bf16 output rounding; against ragged_qmatmul_i8_ref itself the two bf16
    roundings of its operands add 2^-8 of the sum of |x w|."""
    k, n = 512, 32
    rng = np.random.default_rng(2)
    codes = torch.from_numpy(rng.integers(-127, 128, (G, n, k), dtype=np.int8)).transpose(1, 2)
    sw = torch.from_numpy(rng.uniform(1e-4, 2e-3, (G, k // 256, n)).astype(np.float32))
    xq = torch.from_numpy(rng.integers(-127, 128, (M, k), dtype=np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-2, (M, k // 256)).astype(np.float32))
    gs = _sizes(name)
    total = int(gs.sum())
    xd = (xq.float() * torch.repeat_interleave(xs, 256, dim=1)).to(torch.bfloat16)
    wd = chip_smoke.k_major((codes.float() * torch.repeat_interleave(sw, 256, dim=1))
                            .to(torch.bfloat16))
    lib = chip_smoke.grouped_library(xd, wd, gs)[:total]
    absdot = _per_group(xd.float().abs(), wd.float().abs(), gs)
    _check(lib, _per_group(xd.float(), wd.float(), gs), absdot, k)
    ref = MQ.ragged_qmatmul_i8_ref(xq, xs, codes, sw, gs)[:total]
    assert bool(((lib.float() - ref).abs() <= 2.0 ** -8 * ref.abs() + 2.0 ** -8 * absdot
                 + 1e-6).all())


def test_grouped_library_with_no_live_row():
    """All groups empty: the call runs and its rows are undefined (the
    kernels leave them unwritten too)."""
    x = torch.zeros((M, 64), dtype=torch.bfloat16)
    w = chip_smoke.k_major(torch.ones((G, 64, 16), dtype=torch.bfloat16))
    out = chip_smoke.grouped_library(x, w, torch.zeros(G, dtype=torch.int32))
    assert out.shape == (M, 16) and out.dtype == torch.bfloat16
