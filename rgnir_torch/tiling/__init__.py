"""Spatial tiling for orthomosaics: pad to a tile multiple, reshape into
a tile grid and back, and the mask of real pixels. Counterpart:
``rgnir_tpu/tiling/``."""

from rgnir_torch.tiling.tiles import (
    pad_to_multiple,
    tile_image,
    untile_image,
    valid_mask,
)

__all__ = ["pad_to_multiple", "tile_image", "untile_image", "valid_mask"]
