"""PyTorch + CUDA port of ``instant_nsr_pl_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``datasets/``, ``systems/``, ``utils/``) so each counterpart is found by path.
It imports ``torch`` and numpy only: nothing of JAX and nothing of the JAX
package. The kernels the JAX package wrote in Pallas for the TPU are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel op runs its plain PyTorch version instead.
"""
