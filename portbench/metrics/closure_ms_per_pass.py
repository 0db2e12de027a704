"""closure_ms_per_pass (ms): the mean of the program's ``mosaic.closure``
spans over a traced run's window: one survey's 65,536-value closure (the
white-balance LUTs, the index grids and their statistics) on the host."""


def read(r):
    v = r.values.get("mosaic.closure")
    return 1e3 * sum(v) / len(v) if v else None
