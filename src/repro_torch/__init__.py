"""PyTorch/CUDA port of the LC/DC reproduction (``src/repro/`` is the
JAX reference it is held against).

The package mirrors ``repro``'s module layout — ``core/`` for the
simulator and controller, ``kernels/`` for the hand-written Hopper
kernels and their plain PyTorch versions, ``configs/``, ``models/``,
``serving/`` and ``launch/`` for the model-serving stack — and imports
neither ``jax`` nor anything of ``repro``. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
