"""The device mesh: ranks of a ``torch.distributed`` group laid out as a
named grid, and the collectives of the on-mesh regions (``api``)."""
