"""The port's ``parallel/api``: the LM serving steps on one device."""
