"""Core utilities: typed MCA parameters and concurrent containers."""
