"""Timings + profiling — analogue of llama_timings / llama_print_timings
(llama.h:562, :1596) and the IK_PRINT_TIMING stage timers (llama.cpp:41).

``Timings`` aggregates load / prompt-eval / eval wall time and token counts
and prints the reference's familiar summary block. ``trace`` wraps
torch.profiler and writes a Chrome trace (host ops and, on the card, CUDA
kernels) into a directory.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Timings:
    t_load_ms: float = 0.0
    t_prompt_ms: float = 0.0
    n_prompt: int = 0
    t_eval_ms: float = 0.0
    n_eval: int = 0
    t_start: float = field(default_factory=time.perf_counter)

    @contextlib.contextmanager
    def load(self):
        t0 = time.perf_counter()
        yield
        self.t_load_ms += (time.perf_counter() - t0) * 1e3

    @contextlib.contextmanager
    def prompt(self, n_tokens: int):
        t0 = time.perf_counter()
        yield
        self.t_prompt_ms += (time.perf_counter() - t0) * 1e3
        self.n_prompt += n_tokens

    @contextlib.contextmanager
    def eval(self, n_tokens: int = 1):
        t0 = time.perf_counter()
        yield
        self.t_eval_ms += (time.perf_counter() - t0) * 1e3
        self.n_eval += n_tokens

    def print(self, file=sys.stderr):
        """llama_print_timings output format."""
        total = (time.perf_counter() - self.t_start) * 1e3
        p = lambda s: print(s, file=file)
        p(f"load time = {self.t_load_ms:10.2f} ms")
        if self.n_prompt:
            p(f"prompt eval time = {self.t_prompt_ms:10.2f} ms / "
              f"{self.n_prompt:5d} tokens ({self.t_prompt_ms / self.n_prompt:8.2f}"
              f" ms per token, {self.n_prompt / self.t_prompt_ms * 1e3:8.2f}"
              f" tokens per second)")
        if self.n_eval:
            p(f"       eval time = {self.t_eval_ms:10.2f} ms / "
              f"{self.n_eval:5d} runs   ({self.t_eval_ms / max(self.n_eval, 1):8.2f}"
              f" ms per token, {self.n_eval / max(self.t_eval_ms, 1e-9) * 1e3:8.2f}"
              f" tokens per second)")
        p(f"      total time = {total:10.2f} ms")

    def as_dict(self) -> dict:
        return {
            "t_load_ms": round(self.t_load_ms, 2),
            "t_prompt_ms": round(self.t_prompt_ms, 2),
            "n_prompt": self.n_prompt,
            "t_eval_ms": round(self.t_eval_ms, 2),
            "n_eval": self.n_eval,
            "prompt_tps": round(self.n_prompt / self.t_prompt_ms * 1e3, 2)
            if self.t_prompt_ms else 0.0,
            "eval_tps": round(self.n_eval / self.t_eval_ms * 1e3, 2)
            if self.t_eval_ms else 0.0,
        }


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace around a block and write it as
    ``trace.json`` (Chrome trace format; open it in chrome://tracing or
    Perfetto) into ``logdir``. CUDA kernels are traced when the card is
    there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


STAGE_TIMING = os.environ.get("IK_PRINT_TIMING", "") not in ("", "0")


@contextlib.contextmanager
def stage(name: str):
    """IK_PRINT_TIMING=1 per-stage microsecond prints (llama.cpp:6192)."""
    if not STAGE_TIMING:
        yield
        return
    t0 = time.perf_counter()
    yield
    print(f"[timing] {name}: {(time.perf_counter() - t0) * 1e6:.0f} us",
          file=sys.stderr)
