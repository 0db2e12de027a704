"""The byte count behind ``pass_roofline`` against a count by hand."""

from portbench.core import roofline


def test_pass_bytes_by_hand():
    # 2 frames of 4 x 8, 3 kinds, renders and the 50-bin histogram:
    # frames 2*4*8*3 = 192 read, WB 192 written, index maps 3*64*4 = 768,
    # renders 3*64*3 = 576, statistics 3*2*(6*4 + 4 + 50*4) = 1368
    assert roofline.pass_bytes(2, 4, 8, 3, True, True) == 192 + 192 + 768 + 576 + 1368
    # the stream's pass: no renders, no histogram: 3*2*(24 + 4) = 168
    assert roofline.pass_bytes(2, 4, 8, 3, False, False) == 192 + 192 + 768 + 168


def test_peaks_known_and_unknown():
    assert roofline.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_peak("cpu") is None
