"""PyTorch/CUDA port of ``contracts_marl_aam_corridors_tpu`` for the NVIDIA H100.

Imports torch and numpy only; see README.md ("PyTorch/CUDA port") and
ROADMAP.md for what is ported so far.
"""
