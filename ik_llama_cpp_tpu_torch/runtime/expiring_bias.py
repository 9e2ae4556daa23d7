"""Expiring logit bias (ELB) — the reference's ``--expiring-logit-bias-file``
(ikawrakow PR #1731): a rule file of phrase biases with *durations* and a
keyword-driven state machine.

Semantics (common/common.cpp:5456 argparse_expiring_logit_bias,
examples/server/server-context.cpp:1880-1999 state build,
common/sampling.cpp:836-995 apply/accept):

* ``(DURATION : "PHRASE" ... : BIAS[,BIAS...])`` — bias the phrase's token
  ids for DURATION accepted tokens.  Multiple biases map 1:1 onto the
  phrase's tokens (last bias extrapolated); ``LO~HI`` interpolates a range
  across them.  The phrase's FIRST token is biased only while the generated
  text does NOT already end with it ("no bias if seen"); later tokens are
  biased only while the text ends with the phrase's preceding pieces, so
  the bias steers the continuation of a partially emitted phrase.
* ``(DURATION : name ~DELTA, ...)`` — *sampler-parameter* modification:
  DELTA is added to the named sampler field when the state starts and
  subtracted when DURATION expires.  With quoted phrases, each odd-count
  occurrence of the phrase toggles add/subtract instead.
* ``((...))`` — persistent entry, carried into every later state;
  ``(())`` clears the persistent set.  Persistent entries default to an
  effectively infinite duration.
* A non-parenthesised line is an *exitword*: it closes the current state;
  finding that word in the generated text advances the machine to the next
  state.  A trailing ``>>`` marks it as a *jumpword* for all earlier
  states that lack one (a match skips straight to the state after it).
* Negative DURATION applies the bias (quasi-)forever, with per-token
  offsets inverted (duration ``^ 0x7FFFFFFF`` with m = -1).

The torch port's copy of the JAX package's ``runtime/expiring_bias.py``: numpy and the
standard library only, held to the JAX module by
``tests/test_torch_server_extras.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# member names of the reference's X_COMMON_PARAMS_SAMPLING table
# (common/sampling.h:85-112) that exist on our SamplerParams; the addsubs
# vector is indexed by this tuple
ELB_PARAM_NAMES = (
    "min_keep", "top_k", "top_p", "min_p", "tfs_z", "typical_p", "temp",
    "dynatemp_range", "dynatemp_exponent", "penalty_last_n",
    "penalty_repeat", "penalty_freq", "penalty_present", "dry_multiplier",
    "dry_base", "dry_allowed_length", "dry_penalty_last_n", "mirostat",
    "mirostat_tau", "mirostat_eta", "xtc_probability", "xtc_threshold",
    "top_n_sigma", "adaptive_target", "adaptive_decay",
)
_INT_PARAMS = {"min_keep", "top_k", "penalty_last_n", "dry_allowed_length",
               "dry_penalty_last_n", "mirostat"}
_SIZE_T = 1 << 64          # the reference stores durations as size_t


@dataclass
class ElbEntry:
    posi: list = field(default_factory=list)       # per-phrase search pos
    addsubs: list = field(default_factory=list)    # per ELB_PARAM_NAMES
    addflags: list = field(default_factory=list)   # per-phrase toggled?
    max_phrase_len: int = 0
    phrases: list = field(default_factory=list)
    biases: list = field(default_factory=list)     # empty → sampler entry
    duration: int = 1
    is_range: bool = False


@dataclass
class ElbParam:
    entries: list = field(default_factory=list)
    exitword: str = ""
    op: str = ""


@dataclass
class ElbToken:
    id: int
    bias: float
    duration: int
    cond: str


@dataclass
class ElbState:
    first_tokens: list = field(default_factory=list)
    other_tokens: list = field(default_factory=list)
    exitword: str = ""
    countup: int = 0
    delay: int = 0
    max_cond_len: int = 0
    jumpword: str = ""
    jump_idx: int = 0
    search_word_len: int = 0


import re as _re

_FLOAT_RE = _re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _stof(s: str) -> float:
    """std::stof semantics: parse a leading float, ignore the rest;
    raises ValueError when no leading number exists."""
    m = _FLOAT_RE.match(s.strip())
    if not m:
        raise ValueError(s)
    return float(m.group(0))


def _unescape(s: str) -> str:
    """string_process_escapes: \\n \\t \\' \\" \\\\ sequences."""
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            c = s[i + 1]
            out.append({"n": "\n", "t": "\t", "'": "'", '"': '"',
                        "\\": "\\"}.get(c, "\\" + c))
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _extract_quoted(line: str):
    """string_extract(line, '"'): quoted substrings (escape-aware closing
    quotes, contents unescaped) + the quote positions."""
    extracts, posi = [], []
    pos = line.find('"')
    count = 0
    while pos != -1:
        if count % 2 == 0:
            posi.append(pos)
            count += 1
        else:
            n_esc = 0
            j = pos
            while j > 0 and line[j - 1] == "\\":
                n_esc += 1
                j -= 1
            if n_esc % 2 == 0:
                extracts.append(_unescape(line[posi[-1] + 1: pos]))
                posi.append(pos)
                count += 1
        pos = line.find('"', pos + 1)
    return extracts, posi


def parse_elb(content: str) -> list[ElbParam]:
    """Parse an expiring-logit-bias rule file into ElbParam states
    (argparse_expiring_logit_bias, common/common.cpp:5456)."""
    elb_params = [ElbParam()]
    persistent: list[ElbEntry] = []

    for raw in content.split("\n"):
        line = raw.strip()
        if not line or line[0] == "#":
            continue

        extracts, qposi = _extract_quoted(line)
        qq_posi = [0] + qposi + [len(line) + 1]
        # inline comment outside any quoted span truncates the line
        for j in range(0, len(qq_posi) - 1, 2):
            pnd = line.find("#", qq_posi[j])
            if 0 <= pnd < qq_posi[j + 1]:
                line = line[:pnd].strip()
                qq_posi = qq_posi[: j + 2]
                qq_posi[-1] = len(line) + 1
                extracts = extracts[: j // 2]
                break
        last_qq_pos = qq_posi[-2]
        n_char = len(line)
        if not n_char:
            continue

        if line[0] == "(" and line[-1] == ")":
            is_nested = n_char >= 4 and line[1] == "(" and line[-2] == ")"
            if is_nested:
                if n_char == 4:                      # (()) → clear persistent
                    persistent = []
                    continue
                line = line[1: n_char - 1]
                n_char -= 2

            # (DURATION : ...)
            duration = -1 if is_nested else 1
            cln = line.find(":")
            first_q = qq_posi[1] if len(qq_posi) > 2 else len(line) + 1
            if 1 < cln < first_q:
                try:
                    duration = int(line[1:cln].strip())
                except ValueError:
                    continue
            if duration == 0:
                continue

            # sampler-param deltas in the tail after the last quote
            addsubs = [0.0] * len(ELB_PARAM_NAMES)
            is_sb = False
            window = line[min(last_qq_pos + 1, n_char):]
            for j, name in enumerate(ELB_PARAM_NAMES):
                pos = window.find(name)
                if pos == -1:
                    continue
                pos += len(name)
                nxt = window.find(",", pos + 1)
                if nxt == -1:
                    nxt = n_char - 1
                sub = window[pos:nxt].strip()
                if sub.startswith("~"):
                    try:
                        addsubs[j] += _stof(sub[1:])
                        is_sb = True
                    except ValueError:
                        pass

            phrases = list(extracts)
            if not phrases:
                if is_sb:
                    phrases = [""]
                else:
                    continue

            biases: list[float] = []
            is_range = False
            if not is_sb:
                cln_r = line.rfind(":")
                sub = line[cln_r + 1: n_char - 1]
                if "~" in sub:
                    lo, _, hi = sub.partition("~")
                    try:
                        biases = [_stof(lo), _stof(hi)]
                    except ValueError:
                        continue
                    is_range = True
                else:
                    for s in sub.split(","):
                        s = s.strip()
                        if s:
                            try:
                                biases.append(_stof(s))
                            except ValueError:
                                pass
                if not biases:
                    continue

            entry = ElbEntry(
                posi=[0] * len(phrases), addsubs=addsubs,
                addflags=[False] * len(phrases),
                max_phrase_len=max(len(p) for p in phrases),
                phrases=phrases, biases=biases, duration=duration,
                is_range=is_range)
            if is_nested:
                persistent.append(entry)
            elb_params[-1].entries.append(entry)
            continue

        # exitword line: closes the current state
        if last_qq_pos > 0:
            elb_params[-1].op = line[last_qq_pos + 1:].strip()
        exitwords = extracts if extracts else [_unescape(line)]
        elb_params[-1].exitword = exitwords[0]
        elb_params.append(ElbParam(
            entries=[ElbEntry(posi=list(e.posi), addsubs=list(e.addsubs),
                              addflags=list(e.addflags),
                              max_phrase_len=e.max_phrase_len,
                              phrases=list(e.phrases), biases=list(e.biases),
                              duration=e.duration, is_range=e.is_range)
                     for e in persistent]))
    return elb_params


def build_elb_states(tokenizer, elb_params: list[ElbParam]) -> list[ElbState]:
    """Tokenize phrases into per-state first/other token bias tables
    (server-context.cpp:1917-1999)."""
    states: list[ElbState] = []
    for i, param in enumerate(elb_params):
        if param.op == ">>":
            for st in states:
                if not st.jumpword:
                    st.jumpword = param.exitword
                    st.jump_idx = i + 1
                    st.search_word_len = max(len(st.exitword),
                                             len(st.jumpword))
        st = ElbState(exitword=param.exitword,
                      search_word_len=len(param.exitword))
        states.append(st)

        for entry in param.entries:
            if not entry.biases:
                continue            # sampler-param entry: handled in apply
            for phrase in entry.phrases:
                duration = entry.duration
                ids = tokenizer.encode(phrase, add_bos=False)
                if not ids:
                    continue
                biases = list(entry.biases)
                if not entry.is_range:
                    biases += [biases[-1]] * (len(ids) - len(biases))
                    biases = biases[: len(ids)]
                elif len(ids) == 1:
                    biases = [biases[-1]]
                else:                # interpolate LO..HI across the tokens
                    lo, hi = biases[0], biases[-1]
                    inc = (hi - lo) / (len(ids) - 1)
                    biases = [lo + inc * j for j in range(len(ids))]

                def piece(tid):
                    return tokenizer.decode_bytes([tid]).decode(
                        "utf-8", errors="replace")

                if biases[0] != 0.0:
                    # size_t(duration): negative → quasi-infinite
                    st.first_tokens.append(ElbToken(
                        ids[0], biases[0], duration % _SIZE_T,
                        piece(ids[0])))
                m = 1
                if duration < 0:
                    # int32 `duration ^= 0x7FFFFFFF` ("smallest infinite
                    # duration"): -1 → INT32_MIN, then the size_t cast
                    # below turns it astronomically large
                    duration = (duration & 0xFFFFFFFF) ^ 0x7FFFFFFF
                    if duration >= 1 << 31:
                        duration -= 1 << 32
                    m = -1
                cond = ""
                for j in range(1, len(ids)):
                    cond += piece(ids[j - 1])
                    if biases[j] == 0.0:
                        continue
                    dur_j = (duration + m * j) % _SIZE_T
                    if biases[j] > 0.0:
                        st.delay = max(dur_j, st.delay)
                    st.other_tokens.append(ElbToken(
                        ids[j], biases[j], dur_j, cond))
                st.max_cond_len = max(len(cond), st.max_cond_len)

        st.first_tokens.sort(key=lambda t: -t.duration)
        st.other_tokens.sort(key=lambda t: -t.duration)
    return states


class ElbRuntime:
    """Per-slot ELB state machine: bias application before sampling and
    the accept step after each emitted token (common/sampling.cpp apply @
    :836 / accept @ :941).  ``sampler`` is the slot's SamplerParams,
    mutated in place by sampler-param entries."""

    def __init__(self, states: list[ElbState], elb_params: list[ElbParam],
                 sampler):
        self.states = states
        self.elb_params = elb_params
        self.sampler = sampler
        self.idx = 0
        self.search_pos = 0

    # -- sampler-param add/subtract (elb_add/elb_sub, sampling.cpp:824) --
    def _param_delta(self, entry: ElbEntry, sign: int) -> None:
        for name, d in zip(ELB_PARAM_NAMES, entry.addsubs):
            if d == 0.0 or not hasattr(self.sampler, name):
                continue
            cur = getattr(self.sampler, name)
            if name in _INT_PARAMS:
                setattr(self.sampler, name, int(cur) + sign * round(d))
            else:
                setattr(self.sampler, name, float(cur) + sign * d)

    def apply(self, logits, generated_text: str,
              drafted_text: str = "") -> None:
        """Add the active state's expiring token biases to ``logits`` (in
        place) and toggle sampler-param entries; call before sampling."""
        if self.idx >= len(self.states):
            return
        elb = self.states[self.idx]

        if drafted_text:
            window = (generated_text[max(0, len(generated_text)
                                         - elb.max_cond_len):]
                      + drafted_text)
        else:
            window = generated_text

        n_vocab = len(logits)
        if window and elb.other_tokens \
                and elb.other_tokens[0].duration > elb.countup:
            for t in elb.other_tokens:
                if t.duration <= elb.countup:
                    break            # sorted desc: rest expired
                if t.cond and window.endswith(t.cond) and t.id < n_vocab:
                    logits[t.id] += t.bias
        if elb.first_tokens and elb.first_tokens[0].duration > elb.countup:
            for t in elb.first_tokens:
                if t.duration <= elb.countup:
                    break
                # "no bias if seen (probably too late)"
                if (not window or not window.endswith(t.cond)) \
                        and t.id < n_vocab:
                    logits[t.id] += t.bias

        # expiring sampler-parameter bias
        if self.idx < len(self.elb_params):
            for entry in self.elb_params[self.idx].entries:
                if entry.biases:
                    continue
                for j, phrase in enumerate(entry.phrases):
                    if not phrase:
                        # duration-bound only
                        if elb.countup == 0 and not entry.addflags[j]:
                            self._param_delta(entry, +1)
                            entry.addflags[j] = True
                        elif elb.countup == entry.duration \
                                and entry.addflags[j]:
                            self._param_delta(entry, -1)
                            entry.addflags[j] = False
                        continue
                    count = 0
                    pos = generated_text.find(phrase, entry.posi[j])
                    while pos != -1:
                        count += 1
                        pos = generated_text.find(phrase, pos + len(phrase))
                    entry.posi[j] = max(
                        0, len(generated_text) - len(phrase) + 1)
                    if count % 2 == 1:
                        # odd occurrence count toggles the deltas
                        self._param_delta(entry,
                                          -1 if entry.addflags[j] else +1)
                        entry.addflags[j] = not entry.addflags[j]

    def accept(self, generated_text: str, last_piece: str) -> None:
        """Advance countup and the exit/jump-word search; call after each
        accepted token, with the text BEFORE the new piece was appended
        (the reference appends to generated_text afterwards)."""
        if self.idx >= len(self.states):
            return
        idx = self.idx
        elb = self.states[idx]
        elb.countup += 1
        if elb.delay > elb.countup or elb.search_word_len == 0:
            return

        window = generated_text[min(len(generated_text),
                                    self.search_pos):] + last_piece
        if elb.jumpword and elb.jumpword in window:
            pos = window.find(elb.jumpword)
            pos += self.search_pos + len(elb.jumpword)
            self.idx = elb.jump_idx
        elif elb.exitword and elb.exitword in window:
            pos = window.find(elb.exitword)
            pos += self.search_pos + len(elb.exitword)
            self.idx += 1
        else:
            self.search_pos += max(0, len(window) - elb.search_word_len + 1)
            return
        # single-character clearance (stop "\n\n" from expiring two
        # states' "\n" exitwords at once)
        self.search_pos = pos + 1

        # undo the OLD state's still-applied sampler deltas
        if idx < len(self.elb_params):
            for entry in self.elb_params[idx].entries:
                for j, flag in enumerate(entry.addflags):
                    if flag:
                        self._param_delta(entry, -1)
                        entry.addflags[j] = False
        # the new state's phrase search starts at the match point
        if self.idx < len(self.elb_params):
            for entry in self.elb_params[self.idx].entries:
                entry.posi = [pos] * len(entry.posi)


def build_elb_runtime(tokenizer, content, sampler) -> ElbRuntime | None:
    """Parse rule text (a string, or the server API's array of lines) and
    construct a fresh per-request runtime; None when no usable rules."""
    if isinstance(content, (list, tuple)):
        content = "\n".join(str(x) for x in content)
    if not content or not str(content).strip():
        return None
    params = parse_elb(str(content))
    if not any(p.entries or p.exitword for p in params):
        return None
    states = build_elb_states(tokenizer, params)
    return ElbRuntime(states, params, sampler)
