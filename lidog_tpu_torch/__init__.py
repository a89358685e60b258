"""PyTorch/CUDA port of lidog_tpu: the serving path, the single-source
training step and LiDOG's training step (MinkUNet34BEV).

Mirrors the JAX package's layout (core/, ops/, models/, losses/, metrics/,
train/, serve.py) and its parameter layout, so a flax variable tree or a
lidog_tpu TrainState loads unchanged (utils/from_jax.py).  The sparse
convs (forward, input and weight gradients), the masked BatchNorm
(eval, train, backward) and the pooled BEV scatter-max (forward and
backward) are hand-written Hopper kernels (csrc/, ops/bn_act_triton.py);
everything else is plain PyTorch.  Imports nothing of JAX or of
lidog_tpu.

On the card: `serve.Predictor(model)`, and `train.train_step.TrainState
.create(model, train.optim.make_optimizer(...))` with `make_train_step`;
LiDOG's step is train.lidog_step.make_lidog_train_step.  Both entry
points take `device="cpu"` for the plain PyTorch path, which the CPU tests
(tests/test_torch_port_*.py) hold against lidog_tpu.  `python3
chip_smoke.py` checks every kernel and the three paths on a card.
"""
