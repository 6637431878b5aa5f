"""tnerf_torch: the PyTorch + CUDA port of tnerf for one NVIDIA H100.

Serves checkpoints of the reference package (`tnerf/`, JAX) through the
fused frequency-MLP render path: `python -m tnerf_torch.cli eval|render`.
Importing the package builds nothing; the CUDA kernels under `csrc/` are
compiled at their first use on a card (`tnerf_torch.kernels.build`).
"""
