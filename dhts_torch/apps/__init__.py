"""Applications built on the port (counterpart of :mod:`dhts.apps`)."""
