"""The LM stack of the port, serving half: the JAX package's ``models/``
in plain PyTorch (no file there reaches a Pallas kernel, so none here
launches a kernel of the port's own)."""
