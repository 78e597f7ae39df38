"""Data collections: the distribution vtable and tiled matrices."""
