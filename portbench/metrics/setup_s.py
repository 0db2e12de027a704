"""setup_s (s): process start to the first timed call (host clock): imports,
the frames made from the seed, the kernels built or loaded, the cell's key
warmed (an eager call, then the capture) and its host buffers made."""


def read(r):
    return r.setup_s
