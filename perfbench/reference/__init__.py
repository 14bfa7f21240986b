"""The plain float32 reference that decides ``correct``: DTQN and
DTQN-bag, the DDQN learner, the envs and the replay, in plain PyTorch.  It
imports nothing of ``dtqn_tpu_torch`` nor of the JAX package, and takes
nothing the program made."""
