"""Tools run by hand on the card: the knee sweep and the output check's readings."""
