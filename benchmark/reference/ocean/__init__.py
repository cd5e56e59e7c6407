"""A frozen copy of the port's plain path, serial, in its own namespace."""
