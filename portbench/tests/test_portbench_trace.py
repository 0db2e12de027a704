"""``trace.reduce`` over synthetic profiler events: the program's own
``rgnir.`` ranges (its spans while a profiler runs, host-side and their
device-side user annotations) add no device record."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.core import trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def event(name, device, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def harness_events():
    return [event("pb.window", CPU, 0, 1000, True), event("pb.call", CPU, 0, 350, True),
            event("fused_kernel", CUDA, 100, 200), event("Memcpy HtoD", CUDA, 150, 300),
            event("byte_hist_kernel", CUDA, 500, 600)]


def program_events():
    return [event("rgnir.graph.replay", CPU, 120, 250, True),
            event("rgnir.graph.replay", CUDA, 100, 600, True),
            event("rgnir.gc", CPU, 420, 480, True)]


def test_program_annotations_add_no_device_record():
    plain = trace.reduce(harness_events())
    traced = trace.reduce(harness_events() + program_events())
    assert (plain.busy_s, plain.kernels, plain.memcpys) == (traced.busy_s, traced.kernels,
                                                            traced.memcpys)
    assert (plain.kernel_s, plain.memcpy_s) == (traced.kernel_s, traced.memcpy_s)
    assert plain.device_ops == traced.device_ops
    assert plain.busy_s == pytest.approx(300e-6) and (plain.kernels, plain.memcpys) == (2, 1)
