"""PyTorch + CUDA port of ``repro`` (P4: private, personalized, peer-to-peer
learning) for NVIDIA Hopper.

Same module layout and names as the JAX package, so each counterpart is easy
to find. This package imports ``torch`` and numpy only: never ``jax`` and
never anything from ``repro``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without CUDA and without an explicit device they
raise instead of falling back to the CPU.
"""
