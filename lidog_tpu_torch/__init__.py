"""PyTorch/CUDA port of lidog_tpu (serving path).

Mirrors the JAX package's layout (core/, ops/, models/, serve.py) and its
parameter layout, so a flax variable tree loads unchanged
(utils/from_jax.py).  The hot sparse convs and the fused norm pass are
hand-written Hopper kernels (csrc/, ops/norm.py); everything else is plain
PyTorch.  Imports nothing of JAX or of lidog_tpu.
"""
