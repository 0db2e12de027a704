"""Registration: phase-correlation alignment on the tensors' device.

Reference: ``align_images`` (process-images.py:515-565): grayscale via
skimage ``rgb2gray``, shift estimate via ``phase_cross_correlation``,
resample via ``scipy.ndimage.shift(order=1, mode='reflect')``. Here: the
FFT cross-power spectrum, a wrap-aware argmax and a bilinear reflect
warp in PyTorch, with a tiled non-rigid refinement.
Counterpart: ``rgnir_tpu/register/``.
"""

from rgnir_torch.register.phase import (
    luminance,
    phase_correlation_shift,
    align_images,
)
from rgnir_torch.register.warp import shift_image, bilinear_shift_2d
from rgnir_torch.register.local import (
    align_images_local,
    local_shift_field,
    warp_with_field,
)

__all__ = [
    "luminance",
    "phase_correlation_shift",
    "align_images",
    "align_images_local",
    "local_shift_field",
    "warp_with_field",
    "shift_image",
    "bilinear_shift_2d",
]
