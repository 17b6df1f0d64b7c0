"""Rasterizer defaults and static settings.

Defaults mirror the reference (``rasterize.py:7-12``):
IMAGE_SIZE=256, ANTI_ALIASING=True, NEAR=0.1, FAR=100, EPS=1e-4,
BACKGROUND_COLOR=(0,0,0).
"""

import dataclasses

DEFAULT_IMAGE_SIZE = 256
DEFAULT_ANTI_ALIASING = True
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100.0
DEFAULT_EPS = 1e-4
DEFAULT_BACKGROUND_COLOR = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Static rasterizer configuration: the reference ``Rasterize.__init__``
    arguments (``rasterize.py:19-37``).  The background color is a tensor
    operand of ``rasterize_core`` ([3] or per-batch [bs, 3], reference
    rasterize.py:462-465), not static config."""
    image_size: int = DEFAULT_IMAGE_SIZE
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    eps: float = DEFAULT_EPS
    return_rgb: bool = True
    return_alpha: bool = True
    return_depth: bool = True

    def validate(self):
        if not (self.return_rgb or self.return_alpha or self.return_depth):
            raise ValueError('nothing to draw '
                             '(reference rasterize.py:25-27 raises too)')
        return self
