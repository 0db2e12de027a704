"""The frames every cell analyses, made from the run's seed.

A frame is an RGNir scene: a field that varies block by block, the way
crop rows, soil and shade change across a survey frame, plus per-pixel
noise. Each channel's field lies in its own range (NIR above red and
green, as over vegetation), so the indices spread over (-1, 1) and no
channel is ever constant. Every seed gives the same sizes and the same
recipe; only the values differ.

The block values come from ``numpy.random.default_rng(seed)``; the
per-pixel noise, hundreds of MB, from a ``torch.Generator`` on the device
seeded from that stream, in one call, so that making a pool takes
milliseconds and not seconds of every run's set-up.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 32            # pixels per side of a block of the field
NOISE = 32            # the noise adds 0..NOISE - 1, less NOISE // 2
# per channel (red, green, NIR): the range of the field's block values
FIELD_RANGE = ((24, 150), (24, 190), (60, 222))


def frame_pool(seed: int, frames: int, height: int, width: int,
               device: torch.device) -> torch.Tensor:
    """``(frames, height, width, 3)`` uint8 on ``device``, the same bytes
    for the same arguments."""
    rng = np.random.default_rng(seed)
    bh, bw = -(-height // BLOCK), -(-width // BLOCK)
    lo = np.array([r[0] for r in FIELD_RANGE], dtype=np.int64)
    hi = np.array([r[1] for r in FIELD_RANGE], dtype=np.int64)
    field = rng.integers(lo, hi + 1, size=(frames, bh, bw, 3)).astype(np.uint8)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**63 - 1)))
    out = torch.randint(0, NOISE, (frames, height, width, 3), dtype=torch.uint8,
                        generator=gen, device=device)
    f = torch.from_numpy(field).to(device)
    full = f[:, :, None, :, None, :].expand(frames, bh, BLOCK, bw, BLOCK, 3)
    full = full.reshape(frames, bh * BLOCK, bw * BLOCK, 3)[:, :height, :width]
    out += full
    out -= NOISE // 2
    return out
