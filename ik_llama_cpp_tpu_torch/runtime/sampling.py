"""Sampler chain (host-side, numpy) — analogue of llama-sampling.cpp.

Implements the reference's configurable chain (common/sampling.h:133-141):
``dry;top_k;tfs_z;typical_p;top_p;min_p;xtc;top_n_sigma;temperature`` followed
by distribution sampling, plus the out-of-chain final samplers mirostat v1/v2
(src/llama-sampling.cpp) and adaptive-p (llama-sampling.h:68-107,
llama-sampling.cpp:1096-1240).  Each stage matches the reference's semantics
(e.g. min_p relative to max probability, typical via entropy distance, DRY
suffix-repeat penalties with sequence breakers, adaptive-p's EMA-adapted
target with the quadratic/linear logit reshaping).

Stateless stages work on a (logits, order) candidate view; stateful samplers
(mirostat mu, adaptive-p history) live in :class:`SamplerState`, the analogue
of `llama_sampling`/`llama_sampler_adaptive_p` contexts.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DEFAULT_ORDER = ("dry", "top_k", "tfs_z", "typical_p", "top_p", "min_p",
                 "xtc", "top_n_sigma", "temperature")

DEFAULT_DRY_BREAKERS = ("\n", ":", '"', "*")


@dataclass
class SamplerParams:
    temp: float = 0.8
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 1.0
    typical_p: float = 1.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    top_n_sigma: float = 0.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    # DRY (don't-repeat-yourself) repetition penalty
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = -1   # -1 = penalty_last_n window of -1 → ctx
    dry_sequence_breaker_ids: tuple = ()   # token ids that reset matching
    # mirostat: 0 = off, 1 = v1, 2 = v2
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    # adaptive-p final sampler (ik-specific): negative target = disabled
    adaptive_target: float = -1.0
    adaptive_decay: float = 0.9
    logit_bias: dict = field(default_factory=dict)
    samplers: tuple = DEFAULT_ORDER
    n_vocab_hint: int = 0
    min_keep: int = 1        # floor on surviving candidates per stage
    penalize_nl: bool = True  # False: newline logit restored after penalties
    nl_token_id: int = -1     # the newline token (set by the server layer)


@dataclass
class SamplerState:
    """Cross-token sampler state (mirostat mu, adaptive-p EMA history)."""
    mu: float | None = None
    adaptive_weighted_sum: float = 0.0
    adaptive_total_weight: float = 0.0


def _softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max()
    e = np.exp(logits - m)
    return e / e.sum()


def _top_sorted(logits: np.ndarray, k: int):
    """Indices of the top-k logits, sorted descending — argpartition +
    small sort instead of a full-vocab argsort (llama.cpp's top-k uses a
    partial sort for exactly this reason, llama-sampling.cpp)."""
    part = np.argpartition(-logits, k - 1)[:k]
    return part[np.argsort(-logits[part])]


def _initial_candidates(logits: np.ndarray, p: SamplerParams):
    """Build the (order, lg, probs) candidate view the stage loop consumes.

    A full argsort of a 100k+ vocab costs ~3 ms/token — more than half the
    host-side sampling budget at production decode rates. When the FIRST
    enabled truncating stage is top-k (the default chain order), only the
    top-k entries can ever survive, so a partial selection is exact. When
    it is top-p, one top-2048 partial selection almost always covers the
    requested mass on real (peaked) LLM distributions; full-softmax
    probabilities (log-sum-exp over the whole vocab) make the cumulative
    mass identical to the full-sort path, and a distribution flat enough
    to miss falls through to the full argsort.
    min_p may precede either: its keep rule (prob >= min_p * max prob) is a
    ratio, independent of the candidate set. Anything else enabled before
    the truncator (dry, tfs, typical, xtc, top-n-sigma, temperature with
    dynatemp) needs the full distribution: fall back to the full argsort.
    """
    n = len(logits)
    first = None   # first enabled stage that shapes the candidate set
    for stage in p.samplers:
        enabled = (
            (stage == "dry" and p.dry_multiplier > 0.0)
            or (stage == "top_k" and p.top_k > 0)
            or (stage == "tfs_z" and p.tfs_z < 1.0)
            or (stage == "typical_p" and p.typical_p < 1.0)
            or (stage == "top_p" and p.top_p < 1.0)
            or (stage == "xtc" and p.xtc_probability > 0.0)
            or (stage == "top_n_sigma" and p.top_n_sigma > 0.0)
            or (stage == "temperature" and p.dynatemp_range > 0.0))
        if stage == "min_p":
            continue     # set-size invariant (pure ratio vs max)
        if enabled:
            first = stage
            break
    if first == "top_k" and max(p.top_k, p.min_keep) < n:
        order = _top_sorted(logits, max(p.top_k, p.min_keep))
        lg = logits[order]
        return order, lg, _softmax(lg)
    if first == "top_p" and n > 2048:
        # one partial attempt: real LLM distributions concentrate top_p mass
        # in far fewer than 2048 tokens; a flat distribution (mass not
        # reached) falls through to the full sort without iterating
        m = np.max(logits)
        z = m + np.log(np.sum(np.exp(logits - m)))   # log-sum-exp, full vocab
        order = _top_sorted(logits, 2048)
        lg = logits[order]
        probs = np.exp(lg - z)                       # full-softmax masses
        if probs.sum() >= min(p.top_p + 1e-6, 1.0):
            return order, lg, probs
    order = np.argsort(-logits)
    lg = logits[order]
    return order, lg, _softmax(lg)


def apply_penalties(logits, history, p: SamplerParams):
    if not history or (p.penalty_repeat == 1.0 and p.penalty_freq == 0.0
                       and p.penalty_present == 0.0):
        return logits
    nl_logit = (float(logits[p.nl_token_id])
                if not p.penalize_nl and 0 <= p.nl_token_id < len(logits)
                else None)
    logits = logits.copy()
    recent = history[-p.penalty_last_n:] if p.penalty_last_n > 0 else history
    uniq, counts = np.unique(np.asarray(recent), return_counts=True)
    l = logits[uniq]
    if p.penalty_repeat != 1.0:
        l = np.where(l > 0, l / p.penalty_repeat, l * p.penalty_repeat)
    logits[uniq] = l - (counts * p.penalty_freq
                        + (counts > 0) * p.penalty_present)
    if nl_logit is not None:
        # penalize_nl=false restores the newline's pre-penalty logit
        # (llama_sampling_prepare's nl_logit save/restore)
        logits[p.nl_token_id] = nl_logit
    return logits


def apply_dry(logits: np.ndarray, history, p: SamplerParams) -> np.ndarray:
    """DRY repetition penalty (llama-sampling.cpp llama_sampler_dry_apply).

    A candidate token that would extend a repeated suffix of length ``m >=
    allowed_length`` is penalized by ``multiplier * base**(m -
    allowed_length)``.  Sequence-breaker tokens reset matching (matches never
    span a breaker)."""
    if p.dry_multiplier <= 0.0 or not history:
        return logits
    # -1 = whole context (the reference maps dry_penalty_last_n=-1 to
    # n_ctx, NOT to the repeat-penalty window — clamping DRY to the
    # 64-token penalty window would gut it); 0 disables
    window = p.dry_penalty_last_n
    if window == 0:
        return logits
    seq = list(history[-window:]) if window > 0 else list(history)
    n = len(seq)
    if n < 2:
        return logits
    breakers = set(p.dry_sequence_breaker_ids)
    # truncate at the last breaker: matches must live in the post-breaker tail
    for i in range(n - 1, -1, -1):
        if seq[i] in breakers:
            seq = seq[i + 1:]
            break
    n = len(seq)
    if n < 2:
        return logits
    arr = np.asarray(seq)
    best: dict[int, int] = {}
    # for each earlier position i, the longest common suffix of seq[:i+1]
    # and seq predicts that seq[i+1] continues the repeat with length m
    last = arr[-1]
    for i in range(n - 2, -1, -1):
        if arr[i] != last:
            continue
        m = 1
        while m <= i and n - 1 - m >= 0 and arr[i - m] == arr[n - 1 - m]:
            m += 1
        cand = int(arr[i + 1])
        if m > best.get(cand, 0):
            best[cand] = m
    out = None
    for tok, m in best.items():
        if m >= p.dry_allowed_length and tok < len(logits):
            if out is None:
                out = logits.copy()
            out[tok] -= p.dry_multiplier * p.dry_base ** (m - p.dry_allowed_length)
    return out if out is not None else logits


# ---------------------------------------------------------------------------
# final samplers


def _sample_mirostat_v2(lg, order, p, rng, state: SamplerState):
    """lg: full-vocab sorted logits, temperature ALREADY applied by the
    caller (llama_sample_temp precedes mirostat in the reference; no second
    division here)."""
    if state.mu is None:
        state.mu = 2.0 * p.mirostat_tau
    probs = _softmax(lg)
    surprise = -np.log2(probs + 1e-30)
    mask = surprise <= state.mu
    if not mask.any():
        mask = np.zeros_like(mask)
        mask[np.argmax(probs)] = True
    order2, probs_kept = order[mask], probs[mask]
    probs2 = probs_kept / probs_kept.sum()
    idx = rng.choice(len(probs2), p=probs2)
    # observed surprise uses the pre-truncation probability of the pick
    observed = float(-np.log2(probs_kept[idx] + 1e-30))
    state.mu -= p.mirostat_eta * (observed - p.mirostat_tau)
    return int(order2[idx])


def _sample_mirostat_v1(lg, order, p, rng, state: SamplerState, n_vocab: int):
    """lg: full-vocab sorted logits with temperature already applied."""
    if state.mu is None:
        state.mu = 2.0 * p.mirostat_tau
    probs = _softmax(lg)
    m = min(100, len(probs) - 1)
    if m < 2:
        return int(order[np.argmax(probs)])
    ti = np.log((np.arange(2, m + 1)) / np.arange(1, m))
    bi = np.log(probs[:m - 1] / (probs[1:m] + 1e-30) + 1e-30)
    s_hat = float(np.sum(ti * bi) / max(np.sum(ti * ti), 1e-12))
    eps = s_hat - 1.0
    den = 1.0 - float(n_vocab) ** (-eps)
    # eps < 0 (sub-Zipfian estimate) makes numerator and denominator both
    # negative; a sign-destroying clamp here used to produce a negative
    # base and a complex fractional power
    base = (eps * (2.0 ** state.mu)) / (den if abs(den) > 1e-12
                                        else np.copysign(1e-12, den or 1.0))
    k = abs(base) ** (1.0 / max(s_hat, 1e-6)) if np.isfinite(base) \
        else float(len(probs))
    k = int(np.clip(k, 1, len(probs)))
    lg2, order2 = lg[:k], order[:k]
    probs2 = _softmax(lg2)
    idx = rng.choice(len(probs2), p=probs2)
    observed = float(-np.log2(probs2[idx] + 1e-30))
    state.mu -= p.mirostat_eta * (observed - p.mirostat_tau)
    return int(order2[idx])


def _sample_adaptive_p(logits_orig, lg, order, p, rng, state: SamplerState):
    """Adaptive-p final sampler (llama-sampling.cpp:1096-1240): reshape
    logits into a quadratic-near/linear-far well around an EMA-adapted target
    probability, then sample from the reshaped distribution; update the EMA
    with the selected token's ORIGINAL probability."""
    cur_probs_un = np.exp(lg - lg.max())
    cum_cur = cur_probs_un.sum()
    orig_un = np.exp(logits_orig - logits_orig.max())
    cum_orig = orig_un.sum()

    target = float(np.clip(p.adaptive_target, 0.0, 1.0))
    if state.adaptive_total_weight == 0.0:
        adapted = target
    else:
        adapted = 2.0 * target - (state.adaptive_weighted_sum /
                                  state.adaptive_total_weight)
    adapted = float(np.clip(adapted, 0.0, 1.0))

    peak, inv_width, sharpness = 5.0, 1.0 / 0.3, 10.0
    dist = np.abs((cur_probs_un / cum_cur) * inv_width - adapted * inv_width)
    xlog = peak - sharpness * dist * dist / (1.0 + dist)
    xprobs = np.exp(xlog - xlog.max())
    xprobs /= xprobs.sum()
    idx = rng.choice(len(xprobs), p=xprobs)
    tok = int(order[idx])
    update_prob = float(orig_un[order[idx]] / cum_orig) if tok < len(orig_un) else 0.0
    # NOTE: orig_un is indexed by token id (full-vocab original logits)
    if update_prob > 0:
        state.adaptive_weighted_sum = (p.adaptive_decay * state.adaptive_weighted_sum
                                       + update_prob)
        state.adaptive_total_weight = (p.adaptive_decay * state.adaptive_total_weight
                                       + 1.0)
    return tok


# ---------------------------------------------------------------------------


def topk_chain_compatible(p: SamplerParams) -> bool:
    """True when the chain can be sampled EXACTLY from a device-side top-K
    prefetch (vals/idx/lse) instead of the full logits row: the effective
    chain is {penalties, top_k-first, top_p, min_p, temperature} with no
    full-distribution stage, no logit bias, and no out-of-chain sampler."""
    if p.logit_bias or p.mirostat != 0 or p.adaptive_target >= 0.0:
        return False
    if not p.penalize_nl:
        return False
    if (p.dry_multiplier > 0.0 or p.tfs_z < 1.0 or p.typical_p < 1.0
            or p.xtc_probability > 0.0 or p.top_n_sigma > 0.0
            or p.dynatemp_range > 0.0):
        return False
    if p.top_k <= 0:
        return False
    for st in p.samplers:
        if st == "top_k":
            return True
        # min_p is a prob ratio vs the max — candidate-set invariant;
        # anything else shaping the set before top_k needs the full row
        if st == "top_p" and p.top_p < 1.0:
            return False
    return False


def _penalize_subset(lg: np.ndarray, order: np.ndarray, history,
                     p: SamplerParams) -> np.ndarray:
    """apply_penalties restricted to the fetched candidate ids (exact:
    penalties only lower a token's logit, so penalized tokens outside the
    top-K fetch can never enter the post-penalty top-k)."""
    if not history or (p.penalty_repeat == 1.0 and p.penalty_freq == 0.0
                       and p.penalty_present == 0.0):
        return lg
    recent = history[-p.penalty_last_n:] if p.penalty_last_n > 0 else history
    uniq, counts = np.unique(np.asarray(recent), return_counts=True)
    pos = np.searchsorted(uniq, order)
    pos = np.clip(pos, 0, len(uniq) - 1)
    hit = uniq[pos] == order
    if not hit.any():
        return lg
    lg = lg.copy()
    cnt = np.where(hit, counts[pos], 0)
    l = lg[hit]
    if p.penalty_repeat != 1.0:
        l = np.where(l > 0, l / p.penalty_repeat, l * p.penalty_repeat)
    lg[hit] = l - (cnt[hit] * p.penalty_freq + p.penalty_present)
    return lg


def sample_topk(vals, idx, lse, p: SamplerParams, rng: np.random.Generator,
                history: list[int] | None = None,
                state: SamplerState | None = None):
    """sample() fed from a device-side top-K prefetch: ``vals``/``idx`` are
    the top-K logits/ids (sorted desc, e.g. from lax.top_k on device) and
    ``lse`` the full-vocab log-sum-exp. Exact for topk_chain_compatible
    chains when K >= top_k + the distinct penalized-token count — the
    caller checks both. Consumes rng identically to sample()."""
    lg = np.asarray(vals, np.float32)
    order = np.asarray(idx)
    lg = _penalize_subset(lg, order, history or [], p)
    srt = np.argsort(-lg, kind="stable")
    lg, order = lg[srt], order[srt]
    if p.temp <= 0.0:
        return int(order[0])
    # mirror _initial_candidates' top-k-first fast path: the working set is
    # max(top_k, min_keep)-sized from the start, so every stage (including
    # a min_p ordered before top_k) sees the same candidates as sample()
    k = max(p.top_k, p.min_keep)
    lg, order = lg[:k], order[:k]
    probs = _softmax(lg)
    for stage in p.samplers:
        if stage == "top_k":
            lg, order = lg[:k], order[:k]
            probs = _softmax(lg)
        elif stage == "top_p" and p.top_p < 1.0:
            cum = np.cumsum(probs)
            keep = max(1, p.min_keep, int(np.searchsorted(cum, p.top_p) + 1))
            lg, order = lg[:keep], order[:keep]
            probs = _softmax(lg)
        elif stage == "min_p" and p.min_p > 0.0:
            mask = probs >= p.min_p * probs.max()
            if mask.sum() < p.min_keep:
                mask[:] = False
                mask[:p.min_keep] = True
            lg, order = lg[mask], order[mask]
            probs = _softmax(lg)
        elif stage == "temperature":
            lg = lg / max(p.temp, 1e-6)
            probs = _softmax(lg)
    probs = _softmax(lg)
    choice = rng.choice(len(probs), p=probs)
    return int(order[choice])


def sample(logits: np.ndarray, p: SamplerParams, rng: np.random.Generator,
           history: list[int] | None = None,
           state: SamplerState | None = None,
           return_probs: bool = False):
    """Run the sampler chain on one logit vector; returns the token id
    (or (id, ids, probs) of the surviving candidate set with
    ``return_probs``)."""
    logits = np.asarray(logits, np.float32).reshape(-1)
    if p.logit_bias:
        logits = logits.copy()
        for tok, b in p.logit_bias.items():
            t = int(tok)
            if 0 <= t < len(logits):
                logits[t] = -np.inf if b <= -100.0 else logits[t] + b
    logits = apply_penalties(logits, history or [], p)
    # adaptive-p's "original" distribution is captured AFTER penalties and
    # before the sampler queue (llama_prep_adaptive_p runs on the
    # penalty-adjusted cur_p, common/sampling.cpp:548)
    logits_orig = logits

    if p.temp <= 0.0 and p.mirostat == 0 and p.adaptive_target < 0.0:
        tok = int(np.argmax(logits))
        if return_probs:
            return tok, np.array([tok]), np.array([1.0], np.float32)
        return tok

    if p.mirostat != 0:
        # the reference BYPASSES the sampler queue for mirostat: only
        # penalties + temperature apply before the mirostat pick
        # (common/sampling.cpp sampler_queue is skipped when
        # mirostat != 0), so no top-k/top-p/etc. truncation here and
        # exactly ONE temperature application
        order = np.argsort(-logits)
        lg = logits[order] / max(p.temp, 1e-6)
        state = state if state is not None else SamplerState()
        if p.mirostat == 2:
            tok = _sample_mirostat_v2(lg, order, p, rng, state)
        else:
            n_vocab = p.n_vocab_hint or len(logits_orig)
            tok = _sample_mirostat_v1(lg, order, p, rng, state, n_vocab)
        if return_probs:
            return tok, order, _softmax(lg)
        return tok

    order, lg, probs = _initial_candidates(logits, p)

    for stage in p.samplers:
        if stage == "dry":
            if p.dry_multiplier > 0.0:
                biased = apply_dry(logits, history or [], p)
                order = np.argsort(-biased)
                lg = biased[order]
                probs = _softmax(lg)
        elif stage == "top_k" and p.top_k > 0:
            k = max(p.top_k, p.min_keep)
            lg, order = lg[:k], order[:k]
            probs = _softmax(lg)
        elif stage == "tfs_z" and p.tfs_z < 1.0 and len(probs) > 2:
            d2 = np.abs(np.diff(probs, 2))
            d2 = d2 / (d2.sum() or 1.0)
            cum = np.cumsum(d2)
            keep = max(int(np.searchsorted(cum, p.tfs_z) + 1), 1)
            keep = max(keep + 2, p.min_keep)
            lg, order = lg[:keep], order[:keep]
            probs = _softmax(lg)
        elif stage == "typical_p" and p.typical_p < 1.0:
            ent = -np.sum(probs * np.log(probs + 1e-12))
            shifted = np.abs(-np.log(probs + 1e-12) - ent)
            srt = np.argsort(shifted)
            n_keep = max(p.min_keep, 1,
                         int(np.searchsorted(np.cumsum(probs[srt]),
                                             p.typical_p) + 1))
            keep = srt[:n_keep]
            keep.sort()
            lg, order = lg[keep], order[keep]
            probs = _softmax(lg)
        elif stage == "top_p" and p.top_p < 1.0:
            cum = np.cumsum(probs)
            keep = max(1, p.min_keep, int(np.searchsorted(cum, p.top_p) + 1))
            lg, order = lg[:keep], order[:keep]
            probs = _softmax(lg)
        elif stage == "min_p" and p.min_p > 0.0:
            mask = probs >= p.min_p * probs.max()
            if mask.sum() < p.min_keep:       # candidates are sorted desc
                mask[:] = False
                mask[:p.min_keep] = True
            lg, order = lg[mask], order[mask]
            probs = _softmax(lg)
        elif stage == "xtc" and p.xtc_probability > 0.0:
            if rng.random() < p.xtc_probability:
                above = probs >= p.xtc_threshold
                if above.sum() > 1:
                    idx = np.where(above)[0]
                    keepmask = np.ones(len(probs), bool)
                    keepmask[idx[:-1]] = False
                    if keepmask.sum() >= max(1, p.min_keep):
                        lg, order = lg[keepmask], order[keepmask]
                        probs = _softmax(lg)
        elif stage == "top_n_sigma" and p.top_n_sigma > 0.0:
            sd = lg.std()
            mask = lg >= (lg.max() - p.top_n_sigma * sd)
            if mask.sum() < p.min_keep:
                mask[:] = False
                mask[:p.min_keep] = True
            lg, order = lg[mask], order[mask]
            probs = _softmax(lg)
        elif stage == "temperature":
            temp = p.temp
            if p.dynatemp_range > 0.0 and len(probs) > 1:
                # dynamic temperature scaled by normalized entropy
                ent = -np.sum(probs * np.log(probs + 1e-12))
                max_ent = np.log(len(probs))
                t_min = max(0.0, p.temp - p.dynatemp_range)
                t_max = p.temp + p.dynatemp_range
                frac = (ent / max_ent) ** p.dynatemp_exponent if max_ent > 0 else 1.0
                temp = t_min + (t_max - t_min) * frac
            lg = lg / max(temp, 1e-6)
            probs = _softmax(lg)

    state = state if state is not None else SamplerState()

    if p.adaptive_target >= 0.0:
        tok = _sample_adaptive_p(logits_orig, lg, order, p, rng, state)
    else:
        probs = _softmax(lg)
        choice = rng.choice(len(probs), p=probs)
        tok = int(order[choice])

    if return_probs:
        return tok, order, _softmax(lg)
    return tok
