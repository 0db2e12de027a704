"""Configuration of the analysis path: index kinds, registry, contracts.

A copy of the parts of ``rgnir_tpu/config.py`` that the analysis path
reads, kept here so this package never imports the JAX one (whose
``__init__`` imports JAX). ``tests/test_torch_ops.py`` holds the two
equal. Reference citations are the JAX module's.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union


class IndexKind(str, enum.Enum):
    """Normalized-difference indices of the reference.

    Band layout: channel 0 = Red, 1 = Green, 2 = NIR.
    """

    NDVI = "NDVI"    # (NIR - R) / (NIR + R + eps)
    GNDVI = "GNDVI"  # (NIR - G) / (NIR + G + eps)
    NDWI = "NDWI"    # (G - NIR) / (G + NIR + eps)

    @classmethod
    def parse(cls, value: "IndexLike | str") -> "IndexLike":
        """A builtin member, a registered :class:`CustomIndex` by name,
        or an already-resolved kind (returned as is)."""
        if isinstance(value, (IndexKind, CustomIndex)):
            return value
        key = str(value).upper()
        try:
            return cls(key)
        except ValueError:
            custom = _CUSTOM_INDICES.get(key)
            if custom is not None:
                return custom
            raise ValueError(f"Unknown index type: {value}") from None

    @property
    def feature_name(self) -> str:
        return "Water" if self is IndexKind.NDWI else "Vegetation"

    @property
    def coverage_threshold(self) -> float:
        return 0.0 if self is IndexKind.NDWI else 0.2

    @property
    def cmap_name(self) -> str:
        return "RdYlBu" if self is IndexKind.NDWI else "RdYlGn"


ALL_INDICES: Tuple[IndexKind, ...] = (IndexKind.NDVI, IndexKind.GNDVI, IndexKind.NDWI)


@dataclasses.dataclass(frozen=True)
class CustomIndex:
    """A user-defined normalized-difference index:
    ``clip((bands[0] - bands[1]) / (bands[0] + bands[1] + eps), -1, 1)``,
    with the builtins' eps/clip contract."""

    name: str
    bands: Tuple[int, int]          # (positive, negative) channel index
    coverage_threshold: float = 0.2
    cmap_name: str = "RdYlGn"
    feature_name: str = "Vegetation"

    @property
    def value(self) -> str:
        return self.name


# Registry of CustomIndex by upper-cased name. Append-only: a name is
# never rebound to another spec (idempotent re-registration is fine).
_CUSTOM_INDICES: Dict[str, CustomIndex] = {}

# Index names double as output path components.
_INDEX_NAME_RE = re.compile(r"[A-Za-z0-9_-]+")


def register_index(
    name: str,
    bands: Tuple[int, int],
    *,
    coverage_threshold: float = 0.2,
    cmap_name: str = "RdYlGn",
    feature_name: str = "Vegetation",
) -> CustomIndex:
    """Register a custom normalized-difference index under ``name``.

    Raises ``ValueError`` on a builtin-name collision, a malformed name
    or band pair, or an attempt to rebind a name to another spec.
    """
    key = str(name).upper()
    if key in IndexKind.__members__:
        raise ValueError(
            f"Index name {name!r} collides with builtin IndexKind.{key}"
        )
    if not _INDEX_NAME_RE.fullmatch(key):
        raise ValueError(
            f"Bad index name {name!r}: must match [A-Za-z0-9_-]+ "
            f"(it is used as an output path component)"
        )
    ia, ib = int(bands[0]), int(bands[1])
    if not (0 <= ia <= 2 and 0 <= ib <= 2) or ia == ib:
        raise ValueError(
            f"bands must be two DISTINCT channels in 0..2, got {bands!r}"
        )
    idx = CustomIndex(
        name=str(name),
        bands=(ia, ib),
        coverage_threshold=float(coverage_threshold),
        cmap_name=str(cmap_name),
        feature_name=str(feature_name),
    )
    existing = _CUSTOM_INDICES.get(key)
    if existing is not None:
        if existing == idx:
            return existing
        raise ValueError(
            f"Index {name!r} is already registered with a different "
            f"spec ({existing}); pick a new name"
        )
    _CUSTOM_INDICES[key] = idx
    return idx


def registered_indices() -> Tuple[CustomIndex, ...]:
    """All custom indices registered in this process."""
    return tuple(_CUSTOM_INDICES.values())


def import_index_specs(specs: Iterable[Mapping]) -> Tuple[CustomIndex, ...]:
    """Register custom indices from plain dicts, e.g.
    ``dataclasses.asdict(c)`` of another process's or package's
    registered indices. The registry is the only state the analysis
    path carries, so this is how it crosses over."""
    out = []
    for spec in specs:
        spec = dict(spec)
        out.append(register_index(
            spec.pop("name"), tuple(spec.pop("bands")), **spec
        ))
    return tuple(out)


IndexLike = Union[IndexKind, CustomIndex]

# Numerical contract constants
EPSILON: float = 1e-10
INDEX_CLIP: Tuple[float, float] = (-1.0, 1.0)
HIST_BINS: int = 50

# Size caps (all LANCZOS in the reference)
MAX_STORE_DIM: int = 2048
MAX_ANALYSIS_DIM: int = 1024
MAX_ALIGN_DIM: int = 1024
THUMBNAIL_SIZE: Tuple[int, int] = (400, 400)
MAX_DOC_MB: float = 16.0        # the document store's size precheck


@dataclasses.dataclass(frozen=True)
class WBConfig:
    """White-balance percentile stretch:
    ``clip((ch - p_low) / (p_high - p_low) * 255, 0, 255)`` per channel."""

    p_low: float = 2.0
    p_high: float = 98.0
    out_scale: float = 255.0


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Index math contract."""

    eps: float = EPSILON
    clip_lo: float = INDEX_CLIP[0]
    clip_hi: float = INDEX_CLIP[1]
    vegetation_threshold: float = 0.2
    water_threshold: float = 0.0
    hist_bins: int = HIST_BINS


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Colormap render contract: vmin/vmax are the imshow limits; change
    maps use bwr with +/-0.5."""

    vmin: float = -1.0
    vmax: float = 1.0
    change_cmap: str = "bwr"
    change_vlim: float = 0.5
    dpi: int = 100


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Spatial tiling of mosaics sharded over a device mesh. The block
    fields are the JAX package's kernel blocks, kept so that a
    configuration reads the same in both packages."""

    tile_h: int = 512
    tile_w: int = 512
    block_h: int = 256
    block_w: int = 256


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    """Host-side decode and encode pools."""

    decode_workers: int = 8
    encode_workers: int = 4
    prefetch_batches: int = 2
    batch_size: int = 32
    # Probe headers first, then decode whole same-shape batches into one
    # contiguous arena with the native decoder.
    arena_decode: bool = True
    # When set, decoded arrays are cached as raw .npy blobs here.
    decode_cache_dir: Optional[str] = None
    decode_cache_max_bytes: int = 2 << 30


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Storage backend settings."""

    mongo_uri: Optional[str] = None
    max_pool_size: int = 3
    max_idle_time_ms: int = 30000
    server_selection_timeout_ms: int = 5000
    connect_timeout_ms: int = 10000
    socket_timeout_ms: int = 30000
    max_doc_mb: float = MAX_DOC_MB
    max_store_dim: int = MAX_STORE_DIM
    images_per_page: int = 12
