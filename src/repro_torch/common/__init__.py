"""What the port shares across layers: the partitioning rules and the
parameter trees with logical axes (``param.py``)."""
