"""The plain reference that decides ``correct``: PyTorch and NumPy only. It
imports neither JAX, nor the JAX package, nor anything of the program,
and takes nothing the program made but the outputs it judges."""
