"""Host C++ of the port, each built with g++ at first use into
``build/rgnir_torch_native/`` (``_build.py``): the shared-memory frame
ring of the streaming session (``framering.cpp``), the image decoder
and encoders of the batch pipeline (``imgio.cpp``, which links libtiff,
libjpeg and libpng and is optional: without them the callers use
Pillow), and the joint-histogram accumulator of the streamed mosaic's
host reduction (``jointhist.cpp``). Counterpart: ``rgnir_tpu/native/``."""

from rgnir_torch.native import imgio, jointhist
from rgnir_torch.native.ring import FrameRing

__all__ = ["FrameRing", "imgio", "jointhist"]
