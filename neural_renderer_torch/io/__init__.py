"""Asset I/O: Wavefront OBJ/MTL parsing and texture loading (host numpy)."""
