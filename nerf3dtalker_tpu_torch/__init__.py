"""nerf3dtalker_tpu_torch — the PyTorch/CUDA port of nerf3dtalker_tpu.

The JAX package `nerf3dtalker_tpu` is the reference; this package keeps its
module paths and names so each counterpart is easy to find, and runs on an
NVIDIA Hopper GPU. Its hot loop, the fused NeRF point-MLP plus alpha
composite, is a hand-written CUDA kernel (`csrc/fused_render_fwd.cu`)
bound through `ctypes` (`ops/kernels/`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; they
raise when CUDA is absent and the CPU was not asked for. On a CPU tensor
every kernel wrapper takes the kernel's plain PyTorch version.

The package never imports JAX or the JAX package: what it needs from the
JAX-free modules there (config, camera, mel) is kept as its own copy.
"""

__version__ = "0.1.0"
