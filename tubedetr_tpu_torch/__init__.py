"""PyTorch + CUDA port of the TubeDETR spatio-temporal video grounding system.

The package mirrors ``tubedetr_tpu``'s module layout so each counterpart is
easy to find, but imports neither JAX nor the JAX package: it carries its own
copies of the host-side helpers it needs. Hand-written Hopper kernels live
under ``csrc/`` and are built at first use (``ops/_cuda_build.py``).
"""

__version__ = "0.1.0"
