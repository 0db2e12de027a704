"""Host C++ of the port: the shared-memory frame ring of the streaming
session (``framering.cpp``), built with g++ at first use into
``build/rgnir_torch_native/`` (``_build.py``). Counterpart:
``rgnir_tpu/native/`` (whose decoder and joint histogram are not ported
yet)."""

from rgnir_torch.native.ring import FrameRing

__all__ = ["FrameRing"]
