"""Rank processes of the port's multi-process tests.

They live apart from the test files so that a spawned rank imports only
the port (numpy and torch), not JAX. :func:`data_plane` is the work
each rank does; a test runs it in one process on four shards for the
reference, and in each of two gloo ranks on two shards each.
"""

import datetime

import numpy as np

H, W = 50, 64          # 50 rows pad to 52 over four row blocks
PAIR = (96, 64)        # the change-detection pair, (4, -3) apart
KINDS = ("NDVI", "GNDVI", "NDWI")


def mosaic():
    return np.random.default_rng(40).integers(0, 256, (H, W, 3), dtype=np.uint8)


def change_pair():
    """Smooth-ish content and its roll by (4, -3), as the sharded change
    tests make them."""
    h, w = PAIR
    rng = np.random.default_rng(41)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 11.0) + rng.normal(0, 6, (h, w))
    early = np.clip(np.stack([base, base * 0.8 + 20, base * 1.1], axis=-1),
                    0, 255).astype(np.uint8)
    return early, np.roll(early, (4, -3), axis=(0, 1))


def _stats(s):
    return {k: np.asarray(getattr(s, k).cpu()) for k in
            ("mean", "median", "std", "min", "max", "coverage_pct", "histogram", "n")}


def _change(r):
    out = {k: np.asarray(getattr(r.stats, k).cpu()) for k in
           ("mean", "std", "min", "max", "median", "n")}
    out.update(shift=r.shift.cpu().numpy(), shift_raw=r.shift_raw.cpu().numpy(),
               saturated=bool(r.shift_saturated), diff=r.diff.cpu().numpy())
    if r.field is not None:
        out.update(field=r.field.cpu().numpy(), field_saturated=bool(r.field_saturated))
    return out


def data_plane(shards_here):
    """This process's results of the data plane with ``shards_here`` CPU
    shards (four in all): the band of the padded mosaic, then
    ``analyze_mosaic`` (both bodies) over ``mosaic_from_local_rows``, and
    ``change_detection_mosaic`` on a 1-D mesh (rigid and ``local_tile``)
    and on a (2, 2) mesh."""
    from rgnir_torch.parallel import (
        analyze_mosaic, change_detection_mosaic, make_mesh, mosaic_from_local_rows,
        padded_height, process_row_band)

    out = {}
    mesh = make_mesh((4,), ("d",), devices=["cpu"] * shards_here)
    hp = padded_height(H, mesh)
    padded = np.zeros((hp, W, 3), np.uint8)
    padded[:H] = mosaic()
    lo, hi = process_row_band(hp, mesh)
    out["band"] = (lo, hi)
    sharded = mosaic_from_local_rows(padded[lo:hi], (hp, W, 3), mesh)
    for impl in ("kernel", "jnp"):
        res = analyze_mosaic(sharded, kinds=KINDS, mesh=mesh, impl=impl, valid_rows=H)
        out[f"analyze_{impl}"] = {k: _stats(s) for k, s in res.stats.items()}
        out[f"analyze_{impl}_wb"] = res.wb.cpu().numpy()
    early, late = change_pair()
    h = PAIR[0]
    lo, hi = process_row_band(h, mesh)
    se = mosaic_from_local_rows(early[lo:hi], early.shape, mesh)
    sl = mosaic_from_local_rows(late[lo:hi], late.shape, mesh)
    out["change_1d"] = _change(change_detection_mosaic(se, sl, "NDVI", mesh=mesh, halo=8,
                                                       proxy_stride=1))
    out["change_local"] = _change(change_detection_mosaic(
        se, sl, "NDVI", mesh=mesh, halo=8, proxy_stride=1, local_tile=(24, 32),
        upsample_factor=2))
    mesh22 = make_mesh((2, 2), ("dr", "dc"), devices=["cpu"] * shards_here)
    out["change_2d"] = _change(change_detection_mosaic(early, late, "NDVI", mesh=mesh22,
                                                       halo=8, proxy_stride=1))
    out["grown"] = _change(change_detection_mosaic(se, sl, "NDVI", mesh=mesh, halo=3,
                                                   proxy_stride=1))
    return out


def run_rank(rank, world, store, out_path):
    """One rank: joins the gloo group through the file store, runs
    :func:`data_plane` on its ``4 // world`` shards and saves the results."""
    import pickle

    import torch.distributed as dist

    from rgnir_torch.parallel import initialize_distributed

    initialize_distributed(f"file://{store}", world, rank,
                           timeout=datetime.timedelta(seconds=60))
    try:
        out = data_plane(4 // world)
        out["backend"] = str(dist.get_backend())
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
