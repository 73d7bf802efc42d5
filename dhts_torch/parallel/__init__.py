"""Meshes of the port (counterpart of :mod:`dhts.parallel`): the one-device
``(data, lane)`` mesh of the fused spatial step."""
