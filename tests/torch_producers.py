"""Producer processes of the port's ring and streaming tests.

They live apart from the test files so that a spawned producer imports
only the port's ring (numpy, ctypes and, through the package, torch),
not JAX.
"""

import time

import numpy as np

from rgnir_torch.native import FrameRing


def push_random(name, shape, count, finish=False):
    """Pushes ``count`` random frames (``default_rng(0)``) whose first
    byte is their sequence number mod 256, then (with ``finish``) ends
    the stream."""
    ring = FrameRing.open(name, shape)
    for frame in random_frames(shape, count):
        while not ring.try_push(frame):
            time.sleep(0.0005)
    if finish:
        ring.finish()
    ring.close()


def random_frames(shape, count):
    """The frames :func:`push_random` pushes, in order."""
    rng = np.random.default_rng(0)
    frames = []
    for sent in range(count):
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
        frame[0, 0, 0] = sent % 256
        frames.append(frame)
    return frames


def striped_frame(shape, sid, seq):
    """A frame whose first ``3 * sid + seq + 1`` rows have NIR 255 and
    R 0 (NDVI 1 there, 0 elsewhere), so its vegetation coverage encodes
    (stream, sequence number)."""
    frame = np.zeros(shape, dtype=np.uint8)
    frame[:3 * sid + seq + 1, :, 2] = 255
    return frame


def push_striped(name, shape, count, sid, finish=True):
    """Pushes ``count`` striped frames of stream ``sid``, then ends it."""
    ring = FrameRing.open(name, shape)
    sent = 0
    while sent < count:
        if ring.try_push(striped_frame(shape, sid, sent)):
            sent += 1
        else:
            time.sleep(0.0005)
    if finish:
        ring.finish()
    ring.close()
