"""The port's ``parallel/api`` (the LM train and serving steps, on one
device or a mesh) and ``parallel/sharded`` (sharded leaves)."""
