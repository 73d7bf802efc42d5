"""Signal control: the ITSCP environment and the MLP controller."""
