"""The joint histograms of channel pairs: the port's host accumulator
(``rgnir_torch.native.jointhist``, a copy of the JAX package's C++) and
the plain version of the ``jointhist`` CUDA kernel
(``rgnir_torch.kernels.jointhist``), against the JAX package's
accumulator and numpy. Counts are integers: every comparison is exact.
The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from rgnir_tpu.native import jointhist as jax_jointhist
from rgnir_torch.kernels import jointhist as kjh
from rgnir_torch.native import _build
from rgnir_torch.native import jointhist


def numpy_joint(flat, pairs):
    out = np.zeros((len(pairs), 256, 256), np.uint32)
    for p, (ia, ib) in enumerate(pairs):
        key = (flat[:, ia].astype(np.uint32) << 8) | flat[:, ib]
        out[p] = np.bincount(key, minlength=65536).reshape(256, 256)
    return out


def plain(flat, pairs):
    out = torch.zeros(len(pairs), 256, 256, dtype=torch.int32)
    return kjh.joint_histograms(torch.from_numpy(flat), pairs, out).numpy()


PAIRS = [((0, 2),), ((0, 2), (1, 2)), ((2, 0), (0, 0)), ((0, 1), (0, 2), (1, 2))]


@pytest.mark.parametrize("pairs", PAIRS)
def test_native_matches_jax_and_numpy(pairs):
    flat = np.random.default_rng(11).integers(0, 256, (10007, 3), dtype=np.uint8)
    got = jointhist.accumulate(flat, pairs)
    np.testing.assert_array_equal(got, numpy_joint(flat, pairs))
    np.testing.assert_array_equal(got, jax_jointhist.accumulate(flat, pairs))
    assert got.sum(axis=(1, 2)).tolist() == [flat.shape[0]] * len(pairs)


@pytest.mark.parametrize("pairs", PAIRS)
@pytest.mark.parametrize("n", [0, 1, 7, 10007])
def test_plain_kernel_version_matches_numpy(pairs, n):
    flat = np.random.default_rng(n).integers(0, 256, (n, 3), dtype=np.uint8)
    np.testing.assert_array_equal(plain(flat, pairs), numpy_joint(flat, pairs))


# 1 and 4 channels, and 4-8 pairs: the kernel's launch rows (up to 4 pairs
# a row, 5-8 in two) with repeated pairs and (a, a) pairs
WIDE = [
    (1, ((0, 0),)),
    (1, ((0, 0),) * 5),
    (4, ((0, 3), (1, 3), (2, 3), (3, 3))),
    (4, ((3, 0), (0, 3), (1, 1), (2, 3), (0, 3))),
    (4, ((0, 3), (1, 3), (2, 3), (3, 3), (0, 1), (1, 0), (2, 2), (0, 3))),
    (3, ((0, 2), (1, 2), (0, 2), (2, 2))),
    (3, ((0, 2), (1, 2), (2, 0), (1, 1), (0, 2))),
    (3, ((0, 1), (1, 2), (2, 0), (0, 0), (1, 1), (2, 2))),
    (3, ((0, 2), (1, 2), (0, 1), (2, 2), (0, 0), (1, 0), (0, 2))),
    (3, ((0, 2), (1, 2), (0, 1), (2, 2), (0, 0), (1, 0), (0, 2), (2, 1))),
]


@pytest.mark.parametrize("c, pairs", WIDE)
@pytest.mark.parametrize("n", [1, 15, 10007])
def test_plain_kernel_version_wide_matches_jax_and_numpy(c, pairs, n):
    """C = 1 and 4, 4-8 pairs: the plain version, the port's accumulator
    and the JAX package's accumulator against numpy, each pair's total n."""
    flat = np.random.default_rng(100 * c + n).integers(0, 256, (n, c), dtype=np.uint8)
    want = numpy_joint(flat, pairs)
    got = plain(flat, pairs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jointhist.accumulate(flat, pairs), want)
    np.testing.assert_array_equal(jax_jointhist.accumulate(flat, pairs), want)
    assert got.sum(axis=(1, 2)).tolist() == [n] * len(pairs)


def test_plain_kernel_version_eight_pairs_accumulates_in_order():
    """out[p] takes pair p's counts and keeps what it held, for all 8."""
    rng = np.random.default_rng(17)
    flat = rng.integers(0, 256, (4099, 4), dtype=np.uint8)
    pairs = WIDE[4][1]
    start = rng.integers(0, 1000, (8, 256, 256), dtype=np.int32)
    out = kjh.joint_histograms(torch.from_numpy(flat), pairs, torch.from_numpy(start.copy()))
    np.testing.assert_array_equal(out.numpy(), start + numpy_joint(flat, pairs).astype(np.int32))


def test_plain_kernel_version_two_channels_and_accumulates():
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (513, 2), dtype=np.uint8)
    b = rng.integers(0, 256, (777, 2), dtype=np.uint8)
    out = torch.zeros(2, 256, 256, dtype=torch.int32)
    for part in (a, b):
        kjh.joint_histograms(torch.from_numpy(part), ((0, 1), (1, 0)), out)
    np.testing.assert_array_equal(out.numpy(), numpy_joint(np.concatenate([a, b]),
                                                           ((0, 1), (1, 0))))


def test_native_accumulates_into_out():
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (513, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (777, 3), dtype=np.uint8)
    out = jointhist.accumulate(a, ((0, 2),))
    jointhist.accumulate(b, ((0, 2),), out=out)
    np.testing.assert_array_equal(out, numpy_joint(np.concatenate([a, b]), ((0, 2),)))


def test_run_heavy_and_constant_data():
    """Runs of equal keys (the native single-pair path merges them; the
    kernel's warps do): long runs, a run over the whole tail, single
    runs, and a constant band."""
    rng = np.random.default_rng(14)
    base = rng.integers(0, 256, 501, dtype=np.uint8).repeat(37)
    flat = np.stack([base, base[::-1], base ^ 85], axis=1).copy()
    for pairs in (((0, 2),), ((0, 2), (1, 2))):
        want = numpy_joint(flat, pairs)
        np.testing.assert_array_equal(jointhist.accumulate(flat, pairs), want)
        np.testing.assert_array_equal(jax_jointhist.accumulate(flat, pairs), want)
        np.testing.assert_array_equal(plain(flat, pairs), want)
    const = np.full((4096, 3), 7, np.uint8)
    got = jointhist.accumulate(const, ((0, 1),))
    assert got[0, 7, 7] == 4096 and got.sum() == 4096
    np.testing.assert_array_equal(plain(const, ((0, 1),)), got)


def test_simd_adaptive_path_matches_numpy():
    """Bands of at least 2^16 pixels probe their content and may take the
    AVX-512 path (built with -march=native on hosts with VBMI): run-heavy,
    a two-bin ripple and uniform noise, both pair orders, at a size that
    is not a multiple of 16."""
    rng = np.random.default_rng(15)
    n = (1 << 17) + 13
    runs = np.repeat(rng.integers(0, 256, (n // 64 + 1, 3), dtype=np.uint8), 64,
                     axis=0)[:n].copy()
    ripple = np.empty((n, 3), np.uint8)
    ripple[0::2] = 37
    ripple[1::2] = 201
    noise = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    for flat in (runs, ripple, noise):
        for pairs in (((0, 2),), ((2, 1),)):
            want = numpy_joint(flat, pairs)
            np.testing.assert_array_equal(jointhist.accumulate(flat, pairs), want)
            np.testing.assert_array_equal(jax_jointhist.accumulate(flat, pairs), want)


def test_multithreaded_equals_single():
    flat = np.random.default_rng(13).integers(0, 256, ((1 << 22) + 99, 2), dtype=np.uint8)
    one = jointhist.accumulate(flat, ((0, 1),), n_threads=1)
    many = jointhist.accumulate(flat, ((0, 1),), n_threads=4)
    np.testing.assert_array_equal(one, many)
    np.testing.assert_array_equal(one, numpy_joint(flat, ((0, 1),)))


def test_refusals():
    flat = np.zeros((8, 3), np.uint8)
    with pytest.raises(ValueError):
        jointhist.accumulate(flat.astype(np.uint16), ((0, 1),))
    with pytest.raises(ValueError):
        jointhist.accumulate(flat, ((0, 3),))
    with pytest.raises(ValueError):
        jointhist.accumulate(flat, ((0, 1),), out=np.zeros((1, 256, 256), np.int64))
    t = torch.zeros(8, 3, dtype=torch.uint8)
    out = torch.zeros(1, 256, 256, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        kjh.joint_histograms(t.float(), ((0, 1),), out)
    with pytest.raises(ValueError, match="out of range"):
        kjh.joint_histograms(t, ((0, 3),), out)
    with pytest.raises(ValueError, match="int32"):
        kjh.joint_histograms(t, ((0, 1),), out.long())
    with pytest.raises(ValueError, match="pairs"):
        kjh.joint_histograms(t, ((0, 1),) * 9, torch.zeros(9, 256, 256, dtype=torch.int32))
    with pytest.raises(ValueError, match="split it"):
        # a view of one byte: no memory behind its length
        kjh.joint_histograms(torch.zeros(1, 1, dtype=torch.uint8).expand(kjh.FLUSH_AT + 1, 1),
                             ((0, 0),), out)


def test_failed_build_raises_with_no_fallback(tmp_path, monkeypatch):
    """Unlike the JAX package's copy there is no numpy fallback: a source
    that does not compile raises with g++'s output."""
    (tmp_path / "jointhist.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build jointhist.cpp"):
        jointhist.accumulate(np.zeros((4, 3), np.uint8), ((0, 1),))
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_retries_without_a_refused_flag(tmp_path, monkeypatch):
    """A library's compile flag sets are tried in order: where g++ refuses
    the first (as it would -march=native on some hosts), the next builds."""
    src = _build.SRC_DIR / "jointhist.cpp"
    (tmp_path / "jointhist.cpp").write_text(src.read_text())
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "COMPILE_FLAGS", {"jointhist": (("-mno-such-flag",), ())})
    flat = np.random.default_rng(16).integers(0, 256, (999, 3), dtype=np.uint8)
    np.testing.assert_array_equal(jointhist.accumulate(flat, ((1, 2),)),
                                  numpy_joint(flat, ((1, 2),)))
    assert _build.build("jointhist") == _build.library_path("jointhist", ())
    assert _build.library_path("jointhist", ("-march=native",)) != \
        _build.library_path("jointhist", ())
