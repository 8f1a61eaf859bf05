"""Tools that drive the port's CLI end to end."""
