"""Scene / pipeline API: the reference's L3 layer (renderer.py)."""
