"""The plain float32 reference that decides ``correct``: the DDQN learner,
the envs, the replay and the products' precision, shared by every
configuration, and each network family's plain model, in the module its
configuration names as its ``"reference"`` (DTQN's: ``model.py``), in
plain PyTorch.  It imports nothing of ``dtqn_tpu_torch`` nor of the JAX
package, and takes nothing the program made."""
