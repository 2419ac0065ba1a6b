"""Tensor ops of the port: rays, contraction, encodings, MLPs, the fused
kernel ops (``cp_mlp``, ``sh_mlp``), marching and compositing."""
