"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX package,
and it refuses to run on the CPU unless asked to."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ik_llama_cpp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ik_llama_cpp_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _module_level_imports(path: Path):
    """Imports that run when the module is imported: those outside every
    function body."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module
            yield from walk(child)
    yield from walk(ast.parse(path.read_text(), filename=str(path)))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_imported_at_use(path):
    """The port never imports ``regex`` (the tokenizer's classes come from
    unicodedata), and imports jinja2, aiohttp, triton and PIL only inside
    the functions that need them: the card's machine may lack them."""
    assert "regex" not in {m.split(".")[0] for m in _imported_modules(path)}
    top = {m.split(".")[0] for m in _module_level_imports(path)}
    assert not top & {"jinja2", "aiohttp", "triton", "PIL"}, f"{path} imports {top}"


def test_port_has_kernel_sources():
    srcs = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert srcs == {"qmatmul_i8", "qmatmul", "qmatmul4", "flash_attention",
                    "flash_attention_decode", "flash_attention_decode_q",
                    "flash_attention_q8", "moe_decode_i8", "moe_qmm_i8", "moe_decode",
                    "moe_decode_fused_i8", "moe_qmm", "flash_attention_mla"}
    from ik_llama_cpp_tpu_torch.ops import _cuda
    assert set(_cuda.SOURCES) == srcs


def test_port_files_cover_every_subpackage():
    """The scan above reaches every sub-package of the port, the tools too."""
    subs = {p.relative_to(PORT).parts[0] for p in _port_files()[:-1]
            if len(p.relative_to(PORT).parts) > 1}
    assert subs == {"gguf", "models", "ops", "quant", "runtime", "server", "tools"}
    assert PORT / "tools" / "perf_dequant.py" in _port_files()
    assert PORT / "server" / "app.py" in _port_files()
    assert PORT / "models" / "qwen3next.py" in _port_files()
    assert PORT / "ops" / "delta_net.py" in _port_files()
    assert PORT / "runtime" / "speculative.py" in _port_files()
    for rel in ("models/mamba.py", "runtime/lora.py", "tools/convert_lora.py",
                "tools/perplexity.py", "models/bert.py", "runtime/lookahead.py",
                "tools/embedding.py", "tools/retrieval.py", "tools/gritlm.py",
                "tools/cvector_generator.py", "tools/lookahead.py", "runtime/state.py",
                "runtime/allowlist.py", "runtime/expiring_bias.py", "runtime/llg.py",
                "runtime/chat_autoparser.py", "server/sessions.py"):
        assert PORT / rel in _port_files(), rel


def test_runtime_defaults_to_cuda(tmp_path):
    """Without ``device`` the runtime asks for CUDA and raises without it;
    it never carries on quietly on the CPU."""
    from ik_llama_cpp_tpu_torch.runtime.generate import Runtime, resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runtime.from_gguf(tmp_path / "never-read.gguf")
    assert resolve_device("cpu").type == "cpu"

