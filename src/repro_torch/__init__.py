"""PyTorch/CUDA port of the Proxima reproduction (``src/repro``).

The package mirrors ``src/repro`` file for file; each module names the
reference module it ports.  It imports ``torch``, numpy and scipy, never
``jax`` or ``repro``.  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``.  On a CUDA device the four hand-written kernels of
``repro_torch.kernels`` carry the search; on the CPU their plain PyTorch
versions do.
"""
