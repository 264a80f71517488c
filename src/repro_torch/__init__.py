"""repro_torch — the PyTorch/CUDA port of ``repro``.

The loader stack (``core``) and the datasets are copies of the reference's
numpy-only modules; the device side (``data.pipeline`` feeds, ``models``,
``serve`` and the ``kernels``) is PyTorch with hand-written CUDA kernels
for Hopper.  The package imports neither JAX nor anything of ``repro``.
"""
