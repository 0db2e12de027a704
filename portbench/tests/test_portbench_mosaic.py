"""The survey cell's own pieces: its readers against readings made by hand
(and None where their series is missing, as at a program without the
session's spans), the ``jointhist`` byte count by hand, and the program's
spans and counters as the entry hands them to the readers."""

import pytest
import torch

from conftest import small_cell
from portbench.core import spec
from portbench.core.readings import Readings
from portbench.core.trace import DeviceTrace

CELL = "mosaic_streamed_32k.surveys"
NEW = ["pinned_mb_per_pass.mosaic", "closure_ms_per_pass.mosaic", "jointhist_roofline.mosaic",
       "copy_in_gbps.mosaic", "device_idle_pct.mosaic"]
H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    return spec._load(spec.reader_path(name), f"portbench_metric_{name}").read


def readings(values=None, trace=None, calls_traced=0):
    return Readings(setup_s=1.0, window_s=2.0, pixels_done=0, frames_done=0,
                    values=values or {}, trace=trace, calls_traced=calls_traced,
                    bytes_per_call=1_000_000, device_name=H100)


def device_trace(ops):
    return DeviceTrace(window_s=2.0, busy_s=0.5, kernel_s=0.1, memcpy_s=0.4, kernels=2,
                       memcpys=2, device_ops=ops, idle_gaps=[])


def test_the_cell_reads_every_new_metric():
    cell = spec.resolve(CELL)
    assert [m.name for m in cell.per_layer] == NEW
    assert [m.name for m in cell.end_to_end] == ["mpix_per_s", "setup_s"]


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_its_series(name):
    assert reader(name)(readings()) is None
    # a trace with no memcpy and no jointhist record, and spans of other layers
    other = readings({"stream.fill": [0.1]}, device_trace([("fused_kernel", 0.1)]), 3)
    assert reader(name)(other) is None or name == "device_idle_pct.mosaic"


def test_readers_by_hand():
    values = {"mosaic.pass": [0.2, 0.3], "mosaic.closure": [0.05, 0.07],
              "mosaic.pinned_bytes": [0], "mosaic.bands": [32], "copy_in_bytes": [3_000_000]}
    ops = [("Memcpy HtoD (Pinned -> Device)", 0.003),
           ("void (anonymous namespace)::jointhist_kernel<3, unsigned char const>", 0.002),
           ("Memcpy DtoH (Device -> Pageable)", 0.001)]
    r = readings(values, device_trace(ops), calls_traced=4)
    assert reader("closure_ms_per_pass.mosaic")(r) == pytest.approx(60.0)
    assert reader("pinned_mb_per_pass.mosaic")(r) == 0.0
    r.values["mosaic.pinned_bytes"] = [5_000_000]
    assert reader("pinned_mb_per_pass.mosaic")(r) == pytest.approx(2.5)
    # 4 surveys x 1 MB over 3.35 TB/s, over 2 ms of jointhist
    assert reader("jointhist_roofline.mosaic")(r) == pytest.approx(100 * 4e6 / 3.35e12 / 0.002)
    # 4 surveys x 3 MB in 3 ms of HtoD
    assert reader("copy_in_gbps.mosaic")(r) == pytest.approx(4.0)
    assert reader("device_idle_pct.mosaic")(r) == pytest.approx(75.0)


def test_jointhist_bytes_by_hand():
    cell = small_cell(CELL)
    st = cell.entry.settings(cell.config, cell.traffic)
    # 540 x 512 in bands of 64 rows: 9 bands; NDVI (0, 2), GNDVI and NDWI (1, 2): 2 pairs
    assert cell.entry.jointhist_bytes(st) == 3 * 540 * 512 + 9 * 2 * 65536 * 4
    full = spec.resolve(CELL)
    st = full.entry.settings(full.config, full.traffic)
    assert cell.entry.jointhist_bytes(st) == 16 * 201_850_880  # the kernel table's band


def test_program_series_of_a_recorded_session():
    from rgnir_torch.utils import profiling

    cell = small_cell(CELL)
    st = cell.entry.settings(cell.config, cell.traffic)
    pool = cell.entry.make_pool(st, 2**31 + 3, torch.device("cpu"))
    with cell.entry.MosaicStreamer(["cpu"], band_rows=st.band_rows) as session:
        with profiling.recording() as rec:
            session.analyze(pool[0], st.kinds)
    series = cell.entry.program_series(rec)
    assert len(series["mosaic.pass"]) == len(series["mosaic.closure"]) == 1
    assert series["mosaic.bands"] == [9] and series["mosaic.pinned_bytes"] == [0]
    with profiling.recording() as empty:
        pass
    assert cell.entry.program_series(empty) == {}
