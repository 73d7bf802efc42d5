"""Utilities (counterpart of :mod:`dhts.utils`)."""
