"""PyTorch/CUDA port of the vector-search system in ``repro``.

The package mirrors ``repro``'s module paths (``repro_torch.core.search`` is
the counterpart of ``repro.core.search``) and imports neither JAX nor
anything of ``repro``. Its four kernels (``repro_torch.kernels``) are CUDA
C++ for Hopper (``sm_90a``), built with ``nvcc`` at first use; beside each
sits a plain PyTorch version that runs when the tensors lie on the CPU.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
