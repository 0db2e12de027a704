"""The port's shared-memory frame ring (rgnir_torch.native.FrameRing),
as tests/test_native.py holds the JAX package's: push and pop in one
process and across spawned processes, end of stream, the refusals, and
one ring shared by the two packages (the C++ copy keeps the layout).

Ring names carry the pid, so concurrent test sessions never share a
/dev/shm segment.
"""

import multiprocessing as mp
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from rgnir_torch.native import FrameRing
from rgnir_torch.native import _build
from torch_producers import push_random

ROOT = Path(__file__).resolve().parents[1]
_PID = os.getpid()
JOIN_S = 60


def test_push_pop_same_process():
    with FrameRing.create(f"/rgnir_torch_ring1_{_PID}", (4, 6, 3), capacity=2) as r:
        a = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
        assert r.try_push(a)
        assert r.try_push(a + 1)
        assert not r.try_push(a)  # full
        assert len(r) == 2
        np.testing.assert_array_equal(r.try_pop(), a)
        out = np.zeros_like(a)
        assert r.try_pop(out=out) is out
        np.testing.assert_array_equal(out, a + 1)
        assert r.try_pop() is None  # empty
        assert r.try_pop(out=out) is None
        assert len(r) == 0 and r.capacity == 2
        assert not r.eof
        r.finish()
        assert r.eof


def test_cross_process_stream_in_order_and_eof():
    shape, count = (8, 8, 3), 50
    name = f"/rgnir_torch_ring2_{_PID}"
    with FrameRing.create(name, shape, capacity=4) as ring:
        proc = mp.get_context("spawn").Process(target=push_random,
                                               args=(name, shape, count, True))
        proc.start()
        seen = []
        eof_seen = False
        deadline = time.time() + JOIN_S
        while time.time() < deadline:
            frame = ring.try_pop()
            if frame is not None:
                seen.append(int(frame[0, 0, 0]))
                continue
            if eof_seen:
                break  # an empty pop after eof: every frame was seen
            eof_seen = ring.eof
            time.sleep(0.0005)
        proc.join(timeout=JOIN_S)
        assert not proc.is_alive() and proc.exitcode == 0
    assert seen == [i % 256 for i in range(count)]  # in order, none lost


def test_non_uint8_push_rejected():
    with FrameRing.create(f"/rgnir_torch_ring_dt_{_PID}", (4, 4, 3), capacity=2) as r:
        with pytest.raises(TypeError, match="uint8"):
            r.try_push(np.zeros((4, 4, 3), np.float32))
        assert len(r) == 0


def test_shape_mismatch():
    name = f"/rgnir_torch_ring3_{_PID}"
    with FrameRing.create(name, (4, 4, 3)) as r:
        with pytest.raises(ValueError):
            r.try_push(np.zeros((2, 2, 3), np.uint8))
        with pytest.raises(ValueError):
            FrameRing.open(name, (8, 8, 3))
        for bad in (np.zeros((4, 4, 3), np.int16), np.zeros((2, 4, 3), np.uint8),
                    np.zeros((4, 4, 6), np.uint8)[..., ::2]):
            with pytest.raises(ValueError):
                r.try_pop(out=bad)


def test_interop_with_the_jax_package_ring():
    """A frame pushed by rgnir_tpu's ring is popped by the port's, and
    the other way round, on one ring of one name and shape."""
    from rgnir_tpu.native import FrameRing as JaxFrameRing
    from rgnir_tpu.native import native_available

    assert native_available()
    shape = (5, 7, 3)
    name = f"/rgnir_torch_interop_{_PID}"
    frames = np.random.default_rng(4).integers(0, 256, (2,) + shape, dtype=np.uint8)
    with JaxFrameRing.create(name, shape, capacity=3) as jax_ring:
        with FrameRing.open(name, shape) as port_ring:
            assert port_ring.capacity == 3
            assert jax_ring.try_push(frames[0])
            np.testing.assert_array_equal(port_ring.try_pop(), frames[0])
            assert port_ring.try_push(frames[1])
            np.testing.assert_array_equal(jax_ring.try_pop(), frames[1])
            jax_ring.finish()
            assert port_ring.eof


def test_open_missing_ring_raises():
    with pytest.raises(OSError):
        FrameRing.open(f"/rgnir_torch_missing_{_PID}", (4, 4, 3))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source g++ rejects raises with g++'s message; nothing is loaded."""
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cpp") as e:
        _build.library("broken", lambda lib: None)
    assert "error" in str(e.value)
    assert "broken" not in _build._LIBS
    assert not list((tmp_path / "build").glob("*.so"))


def test_shared_build_builds_together_and_names_the_failure(tmp_path):
    """The build policy both builders share: sources compile together, a
    good one is built and reused (0.0 s the second time) while a broken
    one raises with the compiler's output and leaves no library."""
    from rgnir_torch import _shlib

    (tmp_path / "good.cpp").write_text('extern "C" int g() { return 7; }\n')
    (tmp_path / "bad.cpp").write_text("int f( { return 0; }\n")
    out = tmp_path / "build"
    targets = {n: (tmp_path / f"{n}.cpp",
                   _shlib.library_path(out, n, _build.GXX_FLAGS, [tmp_path / f"{n}.cpp"]))
               for n in ("good", "bad")}
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build bad.cpp") as e:
        _shlib.build("g++", _build.GXX_FLAGS, out, targets)
    assert "good.cpp" not in str(e.value)
    assert targets["good"][1].exists() and not targets["bad"][1].exists()
    seconds = _shlib.build("g++", _build.GXX_FLAGS, out, {"good": targets["good"]})
    assert seconds == {"good": 0.0}
    cache = {}
    lib = _shlib.load(cache, "good", lambda: targets["good"][1], lambda lib: None)
    assert lib.g() == 7 and cache["good"] is lib


def test_ring_import_initialises_no_cuda():
    """Producer processes import the ring; doing so starts no CUDA."""
    code = ("import rgnir_torch.native.ring, torch\n"
            "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
