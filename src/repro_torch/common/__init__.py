"""What the port shares across layers: the partitioning rules."""
