"""The ten assigned LM architectures (one module each, the JAX package's
``configs/*`` with the port's ``ModelConfig``), the shape cells and the
registry."""
