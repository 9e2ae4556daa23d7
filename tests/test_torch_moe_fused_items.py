"""The work items of the port's two single-launch MoE kernels: the fused
decode (kernel 11, ``csrc/moe_decode_fused_i8.cu``) and the fused prefill
(kernel 9, ``csrc/moe_qmm_i8.cu``).

Both kernels deal work items from a ticket counter on the device, every
phase-1 item before any phase-2 item, so that an item that waits (phase 2
waits for h) only waits on items already taken by blocks that never wait.
These CPU tests hold the host-side plans, the item decoders the kernels
mirror, the shape rules (which may only widen), and a model of each
kernel's split of the work, which must give the plain version's bits: the
items change who computes what, never the order of a sum."""
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu_torch.ops import _cuda
from ik_llama_cpp_tpu_torch.ops import moe_decode as TD
from ik_llama_cpp_tpu_torch.ops import moe_qmm as TQ
from ik_llama_cpp_tpu_torch.ops.moe_decode import SUPERGROUP, sg_accumulate
from ik_llama_cpp_tpu_torch.ops.qmatmul import quantize_activations as t_quant

from test_torch_moe_decode import experts_np, to_torch
from test_torch_moe_qmm import _buckets

# ---------------------------------------------------------------- kernel 11 --
DECODE_SHAPES = [(1, 8, 768, 2048), (8, 8, 768, 2048), (3, 8, 768, 2048),
                 (1, 4, 1536, 2048), (2, 2, 256, 512), (1, 1, 512, 256)]


@pytest.mark.parametrize("t,top_k,ff,e", DECODE_SHAPES)
def test_fused_decode_items_dealt_once_phase1_first(t, top_k, ff, e):
    """Every (pair, 16 FF columns) and every (token, column tile of E) item
    is dealt exactly once, in the kernel's order, every phase-1 ticket
    before every phase-2 ticket."""
    plan = TD.fused_decode_plan(t, top_k, ff, e)
    items = [TD.fused_decode_item(plan, k) for k in range(plan["blocks"])]
    p1 = [(p, f0) for kind, p, f0 in items if kind == 1]
    p2 = [(tt, n0) for kind, tt, n0 in items if kind == 2]
    assert sorted(p1) == [(p, f0) for p in range(t * top_k)
                          for f0 in range(0, ff, TD.FUSED_COLS)]
    assert sorted(p2) == [(tt, n0) for tt in range(t) for n0 in range(0, e, plan["cols"])]
    kinds = [kind for kind, _, _ in items]
    assert kinds == sorted(kinds)
    # pair-major, then token-major: a token's phase-1 items are dealt
    # together, so its phase-2 items find it ready early
    assert items[:plan["n_ft"]] == [(1, 0, f0) for f0 in range(0, ff, TD.FUSED_COLS)]
    assert items[plan["items1"]:plan["items1"] + 2] == [(2, 0, 0), (2, 0, plan["cols"])]
    assert plan["counters"] == 2 + t * top_k * (ff // SUPERGROUP) + t


@pytest.mark.parametrize("t,top_k,ff,e", DECODE_SHAPES)
def test_fused_decode_supergroup_counts(t, top_k, ff, e):
    """A (pair, supergroup) is completed by exactly 256 / 16 phase-1 items
    (the count its counter waits for before the last one requantizes), and
    a token's phase-2 items wait for top_k x FF/256 requantized
    supergroups, all of them dealt before the first phase-2 ticket."""
    plan = TD.fused_decode_plan(t, top_k, ff, e)
    counts = {}
    for k in range(plan["items1"]):
        _, p, f0 = TD.fused_decode_item(plan, k)
        counts[(p, f0 // SUPERGROUP)] = counts.get((p, f0 // SUPERGROUP), 0) + 1
    assert set(counts.values()) == {SUPERGROUP // TD.FUSED_COLS}
    per_token = {}
    for p, _ in counts:
        per_token[p // top_k] = per_token.get(p // top_k, 0) + 1
    assert per_token == {tt: top_k * (ff // SUPERGROUP) for tt in range(t)}


def _old_decode_smem(k, ff, top_k):
    """The shared memory of the kernel this one replaced: a token's int8
    rows of h and their scales, or the activation row."""
    return max(k + k // SUPERGROUP * 4, top_k * (ff + ff // SUPERGROUP * 4))


@pytest.mark.parametrize("top_k", [1, 2, 4, 6, 8, 16, 64])
def test_fused_decode_rule_only_widens(top_k):
    """Every shape the replaced kernel took still fits: phase 1 keeps its
    row, and phase 2 reads h from L2 instead of shared memory."""
    for k in range(256, 262144, 256 * 37):
        for ff in list(range(256, 40000, 256 * 11)) + [768, 1536, 2048, 14336]:
            if _old_decode_smem(k, ff, top_k) <= TD.SMEM_LIMIT:
                assert TD.fused_decode_fits(k, ff, top_k), (k, ff, top_k)
                assert TD.fused_decode_smem_bytes(k, ff, top_k) <= _old_decode_smem(k, ff, top_k)


def _decode_items_model(xq, xs, ids, wts, e, top_k, plan):
    """Kernel 11's work split on the CPU: h written a phase-1 item at a time
    (16 columns of a pair, each column's supergroups in order), the
    (pair, supergroup) requantized once, the down sums a phase-2 item at a
    time (each column's pairs, then supergroups, in order)."""
    p, k = xq.shape
    ff = e.gate.shape[2]
    ids_l = ids.long()
    h = torch.empty((p, ff), dtype=torch.bfloat16)
    for kk in range(plan["items1"]):
        _, pp, f0 = TD.fused_decode_item(plan, kk)
        cols = slice(f0, f0 + TD.FUSED_COLS)
        ex = ids_l[pp]
        q, s = xq[pp:pp + 1], xs[pp:pp + 1]
        g = torch.zeros((1, TD.FUSED_COLS))
        u = torch.zeros((1, TD.FUSED_COLS))
        for sg in range(k // SUPERGROUP):
            g = sg_accumulate(g, q, s, e.gate[ex][:, cols], e.gate_s[ex][:, cols], sg)
            u = sg_accumulate(u, q, s, e.up[ex][:, cols], e.up_s[ex][:, cols], sg)
        hb = TD._act(g, u, "silu", 0.0).to(torch.bfloat16)
        h[pp, cols] = (hb.float() * wts[pp]).to(torch.bfloat16)[0]
    hq, hs = TD.requant_by_inverse(h)
    t = p // top_k
    out = torch.empty((t, e.down.shape[2]))
    for kk in range(plan["items1"], plan["blocks"]):
        _, tt, n0 = TD.fused_decode_item(plan, kk)
        cols = slice(n0, n0 + plan["cols"])
        acc = torch.zeros((1, min(plan["cols"], e.down.shape[2] - n0)))
        for j in range(top_k):
            pp = tt * top_k + j
            ex = ids_l[pp]
            for sg in range(ff // SUPERGROUP):
                acc = sg_accumulate(acc, hq[pp:pp + 1], hs[pp:pp + 1], e.down[ex][:, cols],
                                    e.down_s[ex][:, cols], sg)
        out[tt, cols] = acc[0]
    return out


@pytest.mark.parametrize("t", [1, 3])
def test_fused_decode_item_model_equals_plain(t):
    """The items, computed one at a time and put together, give the plain
    version's bits: only who computes a column changes, never its order of
    sums (the int8 dots are exact, the float corrections run in supergroup
    order, the down sums pair by pair)."""
    top_k, k, ff, e_ = 3, 512, 512, 512
    d = experts_np(g=6, k=k, f=ff, seed=20 + t)
    e = to_torch(d)
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((t * top_k, k)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 6, t * top_k).astype(np.int32))
    wts = torch.from_numpy(rng.random(t * top_k).astype(np.float32))
    xq, xs = t_quant(x)
    plan = TD.fused_decode_plan(t, top_k, ff, e_)
    got = _decode_items_model(xq, xs, ids, wts, e, top_k, plan)
    ref = TD.moe_decode_fused_i8_ref(xq, xs.t(), ids, wts, e.gate, e.gate_s, e.up, e.up_s,
                                     e.down, e.down_s, top_k=top_k)
    assert torch.equal(got, ref)


def test_zeroed_counters_kept_per_kernel():
    """One buffer a (device, kernel name), grown when a launch needs more
    and otherwise handed back as it is (the kernels leave it zero)."""
    a = _cuda.zeroed_counters(torch.device("cpu"), "k-a", 10)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert _cuda.zeroed_counters(torch.device("cpu"), "k-a", 200) is a
    b = _cuda.zeroed_counters(torch.device("cpu"), "k-b", 10)
    assert b is not a
    c = _cuda.zeroed_counters(torch.device("cpu"), "k-a", 5000)
    assert c.numel() >= 5000 and c is not a


# ----------------------------------------------------------------- kernel 9 --
@pytest.mark.parametrize("n_live,capacity,ff,e", [
    (128, 40, 768, 2048), (37, 40, 768, 2048), (1, 8, 256, 256), (6, 72, 512, 512),
    (3, 512, 1280, 4096), (0, 40, 768, 2048)])
def test_fused_prefill_items_dealt_once_phase1_first(n_live, capacity, ff, e):
    """Every (slot, row block, 64 FF columns) and (slot, row block, 256
    columns of E) of the live slots is dealt exactly once, every phase-1
    ticket before every phase-2 ticket, slot-major (a slot's items run side
    by side and share its rows in L2); each 256-column group of FF gets
    its four phase-1 items (the last to finish requantizes it)."""
    items = TQ.fused_prefill_items(n_live, capacity, ff, e)
    nrb = -(-capacity // TQ.FUSED_ROWS)
    p1 = [it[1:] for it in items if it[0] == 1]
    p2 = [it[1:] for it in items if it[0] == 2]
    assert p1 == [(s, rb, q) for s in range(n_live) for rb in range(nrb)
                  for q in range(ff // TQ.FUSED_SWEEP)]
    assert p2 == [(s, rb, c) for s in range(n_live) for rb in range(nrb)
                  for c in range(-(-e // TQ.FUSED_COLS))]
    assert [it[0] for it in items] == sorted(it[0] for it in items)
    groups = {}
    for s, rb, q in p1:
        key = (s, rb, q * TQ.FUSED_SWEEP // SUPERGROUP)
        groups[key] = groups.get(key, 0) + 1
    assert set(groups.values()) <= {SUPERGROUP // TQ.FUSED_SWEEP}
    plan = TQ.fused_prefill_plan(capacity, ff, e, max(n_live, 1))
    assert len(items) <= plan["items"] and plan["row_blocks"] == nrb
    assert plan["counters"] == 2 + max(n_live, 1) * nrb * (1 + ff // SUPERGROUP)


@pytest.mark.parametrize("capacity,ff,mi,depth", [
    (40, 768, 3, 4), (8, 256, 1, 4), (64, 768, 4, 4), (512, 1280, 4, 4), (40, 1408, 3, 4),
    (72, 2304, 4, 2)])
def test_fused_prefill_plan(capacity, ff, mi, depth):
    """16-row tiles up to the 64-row block, and the deepest ring that fits
    beside the int8 h rows; the block's shared memory within the limit."""
    plan = TQ.fused_prefill_plan(capacity, ff, 2048, 128)
    assert (plan["mi"], plan["depth"]) == (mi, depth)
    assert plan["smem"] <= TQ.SMEM_LIMIT
    assert plan["blocks"] == 132
    assert plan["counters"] == 2 + 128 * plan["row_blocks"] * (1 + ff // SUPERGROUP)


def _old_prefill_smem(ff):
    """The shared memory of the kernel this one replaced: two stages of
    x / gate / up tiles, a bf16 slab and the int8 h of a 64-row block."""
    return (2 * 3 * 64 * (SUPERGROUP + 16) + 64 * SUPERGROUP * 2 + 64 * (ff + 16)
            + 64 * (ff // SUPERGROUP) * 4)


def test_fused_prefill_rule_only_widens():
    """Every shape the replaced kernel took still fits (it took FF <= 1280);
    FF up to 2304 now fits at every capacity."""
    for ff in range(256, 4096, 256):
        for capacity in list(range(8, 136, 8)) + [256, 512]:
            if _old_prefill_smem(ff) <= TQ.SMEM_LIMIT:
                assert TQ.fused_prefill_fits(capacity, 2048, ff), (capacity, ff)
            if ff <= 2304:
                assert TQ.fused_prefill_fits(capacity, 2048, ff), (capacity, ff)


def _prefill_items_model(xg, xst, eids, n_live, e, capacity):
    """Kernel 9's work split on the CPU: h of each (slot, row block, 64 FF
    columns) computed by itself (each column's supergroups in order) into a
    bf16 buffer, the 256-column group requantized when its fourth item is
    done, then each (slot, row block, 256 E columns) of the down
    projection, its supergroups in order."""
    g_, r, k = xg.shape
    ff, ee = e.gate.shape[2], e.down.shape[2]
    qs = xst.transpose(1, 2)
    hb = torch.zeros((g_, r, ff), dtype=torch.bfloat16)
    hq = torch.zeros((g_, r, ff), dtype=torch.int8)
    hs = torch.zeros((g_, r, ff // SUPERGROUP))
    out = torch.zeros((g_, r, ee))
    done = {}
    for kind, slot, rb, idx in TQ.fused_prefill_items(n_live, capacity, ff, ee):
        ex = int(eids[slot])
        rows = slice(rb * TQ.FUSED_ROWS, min(r, (rb + 1) * TQ.FUSED_ROWS))
        if kind == 1:
            cols = slice(idx * TQ.FUSED_SWEEP, (idx + 1) * TQ.FUSED_SWEEP)
            n = rows.stop - rows.start
            gg = torch.zeros((n, TQ.FUSED_SWEEP))
            uu = torch.zeros((n, TQ.FUSED_SWEEP))
            for sg in range(k // SUPERGROUP):
                gg = sg_accumulate(gg, xg[ex, rows], qs[ex, rows], e.gate[ex][:, cols],
                                   e.gate_s[ex][:, cols], sg)
                uu = sg_accumulate(uu, xg[ex, rows], qs[ex, rows], e.up[ex][:, cols],
                                   e.up_s[ex][:, cols], sg)
            hb[ex, rows, cols] = TD._act(gg, uu, "silu", 0.0).to(torch.bfloat16)
            fs = idx * TQ.FUSED_SWEEP // SUPERGROUP
            done[(slot, rb, fs)] = done.get((slot, rb, fs), 0) + 1
            if done[(slot, rb, fs)] == SUPERGROUP // TQ.FUSED_SWEEP:
                grp = slice(fs * SUPERGROUP, (fs + 1) * SUPERGROUP)
                q, s = TD.requant_by_inverse(hb[ex, rows, grp])
                hq[ex, rows, grp] = q
                hs[ex, rows, fs] = s[:, 0]
        else:
            cols = slice(idx * TQ.FUSED_COLS, (idx + 1) * TQ.FUSED_COLS)
            acc = torch.zeros((rows.stop - rows.start, min(TQ.FUSED_COLS, ee - cols.start)))
            for sg in range(ff // SUPERGROUP):
                acc = sg_accumulate(acc, hq[ex, rows], hs[ex, rows], e.down[ex][:, cols],
                                    e.down_s[ex][:, cols], sg)
            out[ex, rows, cols] = acc
    return out


@pytest.mark.parametrize("sizes,capacity", [([5, 0, 9, 2, 0, 8], 16), ([72, 3, 0, 0], 72)])
def test_fused_prefill_item_model_equals_plain(sizes, capacity):
    """The items, computed one at a time and put together, give the plain
    version's bits on every live slot's rows (two row blocks in the second
    case): a row's 256 h values are requantized together, whichever items
    computed them."""
    k, ff, ee = 512, 512, 512
    d = experts_np(g=len(sizes), k=k, f=ff, seed=40 + capacity)
    xq, xst, eids, n_live = _buckets(sizes, k, capacity, seed=capacity)
    e = to_torch(d)
    xg, xs = torch.from_numpy(xq), torch.from_numpy(xst)
    got = _prefill_items_model(xg, xs, eids, int(n_live), e, capacity)
    ref = TQ.fused_moe_prefill_i8_ref(xg, xs, torch.from_numpy(eids), torch.tensor(n_live),
                                      e.gate, e.gate_s, e.up, e.up_s, e.down, e.down_s,
                                      capacity=capacity)
    live = torch.from_numpy(eids[:n_live]).long()
    assert torch.equal(got[live], ref[live])
