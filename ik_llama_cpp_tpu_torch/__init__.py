"""ik_llama_cpp_tpu_torch — the PyTorch/CUDA port of ik_llama_cpp_tpu.

A second package beside the JAX one: plain tensor code in PyTorch, every
Pallas kernel of the ported paths rewritten by hand in CUDA C++ for Hopper
(``csrc/``, built with nvcc on first use). Entry point:
``runtime.generate.Runtime.from_gguf(path, device=None)``, which runs on
``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
