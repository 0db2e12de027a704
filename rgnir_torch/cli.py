"""Command-line interface: the headless entry points of the port.

Counterpart: ``rgnir_tpu/cli.py``, with its 14 subcommands and the same
options, JSON and files. Every subcommand runs on the card unless
``--device`` names another (``--device cpu`` runs the plain PyTorch
path, as the tests do); without a card and without ``--device cpu`` it
raises. ``analyze`` and ``bench`` go through ``analyze_image_auto``, the
kernel path; ``mosaic`` and ``change --full-res`` run the sharded kernel
bodies with a shard on every visible card (one shard on another
device).

    rgnir-torch batch IN OUT --wb --indices NDVI,NDWI
    rgnir-torch watch IN OUT --interval 2
    rgnir-torch report IMAGE OUTDIR
    rgnir-torch analyze IMAGE --out DIR
    rgnir-torch mosaic IMAGE --out DIR
    rgnir-torch store upload|list|remove|dedupe ...
    rgnir-torch sites create|list|assign|timeseries ...
    rgnir-torch --device cpu analyze IMAGE
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from rgnir_torch.config import ALL_INDICES
from rgnir_torch.utils.logging import get_logger

logger = get_logger("rgnir_torch.cli")

# warmup's runs at the bench shapes: (frames shape, kinds)
WARMUP_SHAPES = (
    ((8, 1024, 1024, 3), ("NDVI",)),
    ((32, 512, 512, 3), ("NDVI", "GNDVI", "NDWI")),
    ((4096, 4096, 3), ("NDVI",)),
)


def _parse_indices(value: str):
    if not value:
        return ()
    return tuple(v.strip().upper() for v in value.split(",") if v.strip())


def _all_or(value: str):
    return _parse_indices(value) or tuple(k.value for k in ALL_INDICES)


def _loader_cfg(args):
    import dataclasses

    from rgnir_torch.config import LoaderConfig

    cfg = LoaderConfig()
    if args.decode_cache:
        cfg = dataclasses.replace(cfg, decode_cache_dir=args.decode_cache)
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    return cfg


def _mesh(device):
    """The sharded paths' mesh: a shard on every visible card on CUDA, one
    shard of ``device`` elsewhere."""
    from rgnir_torch.parallel import local_mesh, make_mesh

    if device.type == "cuda":
        return local_mesh()
    return make_mesh((1,), ("d",), devices=[device])


def _load_frame(path: str):
    """An ``(H, W, 3)`` uint8 frame: a ``.npy`` memory-mapped, else decoded."""
    import numpy as np

    from rgnir_torch.io.decode import decode_file

    return np.load(path, mmap_mode="r") if path.endswith(".npy") else decode_file(path)


def cmd_batch(args) -> int:
    from rgnir_torch.pipeline.batch import batch_process

    summary = batch_process(
        args.input, args.output,
        save_wb=args.wb,
        indices=_parse_indices(args.indices),
        figures=args.figures,
        resume=not args.no_resume,
        loader_cfg=_loader_cfg(args),
        fig_png_compress=args.fig_png_compress,
        device=args.device,
    )
    print(json.dumps({
        "processed": summary["processed"],
        "skipped": summary["skipped"],
        "failed": [str(p) for p, _ in summary["failed"]],
    }))
    return 1 if summary["failed"] else 0


def cmd_watch(args) -> int:
    """Poll a directory and process new images as they arrive.

    Each poll runs the batch pipeline with ``resume=True``, whose manifest
    skips inputs already done, so only new (or previously failed) files
    are processed. Producers should move files in atomically (write
    elsewhere, then rename). Exits after ``--max-idle`` consecutive polls
    that processed nothing (0: run until interrupted); a poll that only
    fails counts as idle, so a corrupt file cannot keep it running.
    """
    import time

    from rgnir_torch.pipeline.batch import batch_process

    cfg = _loader_cfg(args)
    idle = total_processed = rc = 0
    while True:
        summary = batch_process(
            args.input, args.output,
            save_wb=args.wb,
            indices=_parse_indices(args.indices),
            figures=args.figures,
            resume=True,
            loader_cfg=cfg,
            device=args.device,
        )
        total_processed += summary["processed"]
        if summary["failed"]:
            rc = 1
            for p, err in summary["failed"]:
                logger.error("watch: failed %s: %s", p, err)
        idle = idle + 1 if summary["processed"] == 0 else 0
        if args.max_idle and idle >= args.max_idle:
            break
        time.sleep(args.interval)
    print(json.dumps({"processed": total_processed, "idle_polls": idle}))
    return rc


def cmd_selftest(args) -> int:
    """Every kernel on the device against its plain version at awkward
    shapes (``rgnir_torch.testing.selftest``)."""
    from rgnir_torch.testing.selftest import main as selftest_main

    return selftest_main(args.device)


def cmd_warmup(args) -> int:
    """Build every library of the port (the CUDA kernels on a card, and the
    host C++) into the build cache and run each path once at the bench
    shapes (:data:`WARMUP_SHAPES`), so that a later process builds
    nothing. ``--check`` fails (rc 1) if any library had to be built:
    the cache was not warm for these sources. ``--prune`` first deletes
    the libraries that the current sources no longer build into."""
    import time

    import numpy as np
    import torch

    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.utils import compile_cache

    if args.prune and args.check:
        print("warmup: --prune and --check are mutually exclusive: prune first, then "
              "check in a separate run", file=sys.stderr)
        return 2
    t0 = time.time()
    cuda = args.device.type == "cuda"
    pruned = compile_cache.prune(cuda) if args.prune else []
    built = compile_cache.build_libraries(cuda)
    warmed = []
    rng = np.random.default_rng(0)
    for shape, kinds in WARMUP_SHAPES:
        img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        res = analyze_image_auto(img, kinds=kinds, with_renders=True, device=args.device)
        float(res.stats[kinds[0]].mean.sum())  # waits for the device
        warmed.append(f"pipeline{shape}")
    new = sorted(name for name, b in built.items() if b)
    print(json.dumps({
        "warmed": warmed,
        "cache_dir": str(args.cache_dir),
        "libraries": sorted(name for name, b in built.items() if b is not None),
        "unavailable": sorted(name for name, b in built.items() if b is None),
        "new_libraries": new,
        "pruned": len(pruned),
        "seconds": round(time.time() - t0, 1),
        "check": bool(args.check),
    }))
    if args.check and new:
        print(f"warmup --check FAILED: {len(new)} librar{'y' if len(new) == 1 else 'ies'} "
              f"had to be built: the build cache was stale: " + ", ".join(new),
              file=sys.stderr)
        return 1
    return 0


def cmd_bench(args) -> int:
    """Throughput of chained analysis calls on the device: each call takes
    the last one's white-balanced frames, chains of ``--iters`` and six
    times as many are timed in turns (CUDA events on the card), and the
    slope of the per-length minima is the time of a call. Prints one JSON
    line with the JAX command's keys."""
    import numpy as np
    import torch

    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.utils.microbench import chain_time_ab

    dev = args.device
    batch, size = args.batch, args.size
    kinds = _parse_indices(args.indices) or ("NDVI",)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)).to(dev)

    def body(i, carry):
        img, acc = carry
        res = analyze_image_auto(img, kinds=kinds, with_renders=args.renders, device=dev)
        return res.wb, acc + res.stats[kinds[0]].mean

    carry0 = (imgs, torch.zeros(batch, device=dev))
    ms = chain_time_ab({0: body}, carry0, ns=(args.iters, args.iters * 6), reps=args.reps,
                       device=dev)[0]
    mpix = batch * size * size / 1e6
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "batch": batch, "size": size, "kinds": list(kinds),
        "renders": bool(args.renders),
        "ms_per_step": round(ms, 3),
        "mpix_per_s": round(mpix / ms * 1e3, 1),
    }))
    return 0


def cmd_report(args) -> int:
    from rgnir_torch.pipeline.single import generate_ndvi_report

    _, stats = generate_ndvi_report(args.image, args.output, device=args.device)
    print("\nNDVI Analysis Summary:")
    for key, value in stats.items():
        print(f"{key}: {value:.4f}")
    if args.show:
        # the reference's plt.show() (process-ndvi.py:44-46): the platform viewer
        from PIL import Image

        viz = Path(args.output) / "ndvi_visualization.png"
        try:
            Image.open(viz).show(title="NDVI Values")
        except Exception as e:  # noqa: BLE001 - viewing is best-effort
            print(f"could not display {viz}: {e}", file=sys.stderr)
    return 0


def cmd_rgn(args) -> int:
    from rgnir_torch.pipeline.rgn import correct_file, visualize_correction_file

    if args.out:
        correct_file(args.image, args.out, method=args.method, device=args.device)
        print(f"corrected -> {args.out}")
    if args.viz:
        visualize_correction_file(args.image, args.viz, method=args.method, device=args.device)
        print(f"comparison -> {args.viz}")
    if not args.out and not args.viz:
        print("nothing to do: pass --out and/or --viz", file=sys.stderr)
        return 2
    return 0


def _write_renders(outdir: Path, stem: str, wb, renders, kinds, rows=None) -> None:
    """``<stem>_wb.png`` and ``<stem>_<kind>.png`` in ``outdir`` (the first
    ``rows`` rows of each)."""
    from rgnir_torch.io.writer import AsyncWriter

    with AsyncWriter() as writer:
        writer.submit_array(outdir / f"{stem}_wb.png", wb.cpu().numpy()[:rows])
        for kind in kinds:
            writer.submit_array(outdir / f"{stem}_{kind.lower()}.png",
                                renders[kind].cpu().numpy()[:rows])


def cmd_analyze(args) -> int:
    from rgnir_torch.io.decode import decode_file
    from rgnir_torch.ops.stats import to_analyze_index_dict
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    kinds = _all_or(args.indices)
    # renders only when they are written
    res = analyze_image_auto(decode_file(args.image), kinds=kinds, with_renders=bool(args.out),
                             device=args.device)
    print(json.dumps({k: to_analyze_index_dict(res.stats[k], k) for k in kinds}, indent=2))
    if args.out:
        _write_renders(Path(args.out), Path(args.image).stem, res.wb, res.renders, kinds)
    return 0


def cmd_compare(args) -> int:
    from rgnir_torch.io.decode import decode_file
    from rgnir_torch.pipeline.compare import comparison_analysis

    kinds = _all_or(args.indices)
    images = [(Path(p).name, decode_file(p)) for p in args.images]
    res = comparison_analysis(images, kinds=kinds, with_figures=bool(args.out),
                              device=args.device)
    print(json.dumps(res.index_stats, indent=2))
    if args.out:
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        res.original_figure.save(outdir / "comparison_original.png")
        res.wb_figure.save(outdir / "comparison_white_balanced.png")
        for kind, fig in res.index_figures.items():
            fig.save(outdir / f"comparison_{kind.lower()}.png")
    return 0


def cmd_change(args) -> int:
    """Change detection between two dates (the UI's first-vs-last flow,
    process-images.py:885-989). ``--full-res`` runs the sharded
    full-resolution path instead of the reference's 1024 px downscale."""
    import numpy as np

    from rgnir_torch.io.decode import decode_file

    kind = (args.index or "NDVI").upper()
    early = decode_file(args.early)
    late = decode_file(args.late)
    if args.full_res:
        from rgnir_torch.parallel.change import change_detection_mosaic

        tile = (args.refine_tile, args.refine_tile) if args.refine_tile else None
        res = change_detection_mosaic(early, late, kind, mesh=_mesh(args.device),
                                      upsample_factor=args.upsample, local_tile=tile)
        summary = {
            "shift": [float(s) for s in res.shift.cpu()],
            "diff_mean": float(res.stats.mean),
            "diff_std": float(res.stats.std),
            "diff_min": float(res.stats.min),
            "diff_max": float(res.stats.max),
            "diff_median": float(res.stats.median),
        }
        if args.refine_tile:
            fld = res.field.cpu().numpy()
            summary["field_dy_range"] = [float(fld[..., 0].min()), float(fld[..., 0].max())]
            summary["field_dx_range"] = [float(fld[..., 1].min()), float(fld[..., 1].max())]
        print(json.dumps(summary, indent=2))
        if args.out:
            from rgnir_torch.viz.figures import render_change_figure

            h, w = early.shape[:2]
            outdir = Path(args.out)
            outdir.mkdir(parents=True, exist_ok=True)
            fig = render_change_figure(
                res.early_index.cpu().numpy()[:h, :w], res.late_index.cpu().numpy()[:h, :w],
                res.diff.cpu().numpy()[:h, :w], kind, Path(args.early).stem,
                Path(args.late).stem,
            )
            fig.save(outdir / f"change_{kind.lower()}.png")
        return 0

    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.pipeline.change import change_detection
    from rgnir_torch.pipeline.fused import as_image

    def white_balanced(img):  # the hist and fused kernels, no index
        return analyze_image_kernel(as_image(img, args.device), kinds=()).wb

    res = change_detection(
        white_balanced(early), white_balanced(late), kind, early_label=Path(args.early).stem, late_label=Path(args.late).stem,
        with_figure=bool(args.out), upsample_factor=args.upsample,
        refine_tile=args.refine_tile or None, device=args.device,
    )
    summary = {
        "shift": [float(s) for s in res["shift"]],
        "diff_mean": float(np.asarray(res["diff"]).mean()),
        "diff_min": float(res["diff"].min()),
        "diff_max": float(res["diff"].max()),
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        res["figure"].save(outdir / f"change_{kind.lower()}.png")
    return 0


def cmd_mosaic(args) -> int:
    from rgnir_torch.ops.stats import to_analyze_index_dict

    kinds = _all_or(args.indices)
    if args.reduce != "device" and not args.streamed:
        # the sharded path reduces on the device; saying otherwise would
        # misreport what ran
        raise SystemExit("--reduce host requires --streamed")
    mosaic = _load_frame(args.image)
    if args.streamed:
        # exact global statistics of a mosaic of any size, in bands
        # (pipeline/gigapixel.py); statistics only
        from rgnir_torch.pipeline.gigapixel import analyze_mosaic_streamed

        sres = analyze_mosaic_streamed(
            mosaic, kinds=kinds, band_rows=args.band_rows, reduce=args.reduce,
            device=args.device if args.reduce == "device" else None,
        )
        print(json.dumps({k: to_analyze_index_dict(sres.stats[k], k) for k in kinds}, indent=2))
        return 0
    from rgnir_torch.parallel import analyze_mosaic

    res = analyze_mosaic(mosaic, kinds=kinds, mesh=_mesh(args.device),
                         with_renders=bool(args.out), impl="kernel")
    print(json.dumps({k: to_analyze_index_dict(res.stats[k], k) for k in kinds}, indent=2))
    if args.out:
        _write_renders(Path(args.out), Path(args.image).stem, res.wb, res.renders, kinds,
                       rows=mosaic.shape[0])
    return 0


def cmd_tune(args) -> int:
    """Measure the kernels' grids on the card and cache the winners
    (utils/autotune.py); later launches pick them up."""
    from rgnir_torch.utils.autotune import cache_path, tune_kernels

    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes else (512, 1024, 2048, 4096)
    winners = tune_kernels(sizes=sizes, device=args.device)
    print(json.dumps({"cache": str(cache_path()), "winners": winners}, indent=2))
    return 0


def _open_store(args):
    from rgnir_torch.store import FsImageStore, MongoImageStore

    if args.mongo:
        try:
            return MongoImageStore(args.mongo)
        except ImportError:
            print("pymongo is not installed", file=sys.stderr)
            raise SystemExit(2) from None
    return FsImageStore(args.root)


def cmd_store(args) -> int:
    store = _open_store(args)
    if args.action == "upload":
        from rgnir_torch.store import DuplicateImageError

        for path in args.files:
            p = Path(path)
            try:
                rec = store.save_image(p.name, p.read_bytes())
                print(f"stored {p.name} -> {rec.image_id}")
            except DuplicateImageError:
                print(f"duplicate skipped: {p.name}")
        return 0
    if args.action == "list":
        recs, total = store.list_images(page=args.page, per_page=args.per_page, with_total=True)
        print(f"total: {total}")
        for r in recs:
            print(f"{r.image_id}  {r.filename}  {r.upload_date:%Y-%m-%d %H:%M}"
                  f"  {r.image_dimensions[0]}x{r.image_dimensions[1]}")
        return 0
    if args.action == "remove":
        ok = store.remove_image(args.id)
        print("removed" if ok else "not found")
        return 0 if ok else 1
    if args.action == "dedupe":
        print(f"removed {store.remove_duplicates()} duplicates")
        return 0
    raise SystemExit(f"unknown store action {args.action}")


def cmd_sites(args) -> int:
    store = _open_store(args)
    if args.action == "create":
        coords = None
        if args.lat is not None and args.lng is not None:
            coords = {"lat": args.lat, "lng": args.lng}
        site = store.create_site(args.name, args.description or "", coords)
        print(f"created site {site.site_id}: {site.name}")
        return 0
    if args.action == "list":
        for s in store.list_sites():
            print(f"{s.site_id}  {s.name}  ({len(store.site_images(s.site_id))} images)")
        return 0
    if args.action == "assign":
        ok = store.assign_image_to_site(args.image_id, args.site_id)
        print("assigned" if ok else "not found")
        return 0 if ok else 1
    if args.action == "timeseries":
        from rgnir_torch.pipeline.timeseries import time_series_analysis

        seq = []
        for rec in store.site_images(args.site_id):
            _, arr = store.load_array(rec.image_id)
            seq.append((rec.upload_date, arr))
        # figures (matplotlib) only when they are written
        res = time_series_analysis(seq, args.index.upper(), with_figures=bool(args.out),
                                   device=args.device)
        print(res.table.to_string(index=False))
        if args.out:
            outdir = Path(args.out)
            outdir.mkdir(parents=True, exist_ok=True)
            if res.figure is not None:
                res.figure.save(outdir / f"timeseries_{args.index.lower()}.png")
            if res.change is not None and res.change["figure"] is not None:
                res.change["figure"].save(outdir / f"change_{args.index.lower()}.png")
        return 0
    raise SystemExit(f"unknown sites action {args.action}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rgnir_torch", description="RGNir image analysis on the card (PyTorch, CUDA)"
    )
    p.add_argument(
        "--device", default=None,
        help="the device every subcommand computes on: 'cuda' (the default, "
             "the kernel path; raises without a card), 'cuda:N' or 'cpu' (the "
             "plain PyTorch path)",
    )
    p.add_argument(
        "--define-index", action="append", default=[], metavar="SPEC",
        help="register a custom normalized-difference index usable in "
             "any --indices/--index argument. SPEC is "
             "NAME:POS,NEG[:THRESHOLD[:CMAP[:FEATURE]]] with POS/NEG "
             "channel numbers (0=Red, 1=Green, 2=NIR), e.g. "
             "'MYNDVI:2,0:0.3:RdYlGn:Vegetation'. Repeatable.",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def batch_options(q, figures_help):
        q.add_argument("input")
        q.add_argument("output")
        q.add_argument("--wb", action="store_true", help="save white-balanced TIFFs")
        q.add_argument("--indices", default="NDVI,GNDVI,NDWI")
        q.add_argument("--figures", action="store_true", help=figures_help)
        q.add_argument("--decode-cache", default="", metavar="DIR",
                       help="cache decoded images as .npy under DIR; repeat runs over "
                            "the same inputs skip image decode")
        q.add_argument("--batch-size", type=int, default=0,
                       help="device batch size (default 32)")

    b = sub.add_parser("batch", help="process a directory of images")
    batch_options(b, "matplotlib figures instead of raw colormap PNGs")
    b.add_argument("--no-resume", action="store_true")
    b.add_argument("--fig-png-compress", type=int, default=1, metavar="LVL",
                   help="zlib level for --figures PNGs (identical pixels at any level)")
    b.set_defaults(fn=cmd_batch)

    w = sub.add_parser("watch", help="hot-folder mode: poll a directory, process new "
                                     "images as they arrive (resumable manifest)")
    batch_options(w, "matplotlib figure outputs instead of device renders")
    w.add_argument("--interval", type=float, default=2.0, help="seconds between polls")
    w.add_argument("--max-idle", type=int, default=0,
                   help="exit after N consecutive empty polls (0 = forever)")
    w.set_defaults(fn=cmd_watch)

    st = sub.add_parser("selftest", help="check every kernel on the device against its "
                                         "plain version")
    st.set_defaults(fn=cmd_selftest)

    wu = sub.add_parser("warmup", help="build every library into the build cache and run "
                                       "each path once")
    wu.add_argument("--check", action="store_true",
                    help="fail if any library had to be built (the cache was stale)")
    wu.add_argument("--prune", action="store_true",
                    help="first delete the libraries the current sources no longer build")
    wu.set_defaults(fn=cmd_warmup)

    bm = sub.add_parser("bench", help="throughput of chained analysis calls on the device")
    bm.add_argument("--batch", type=int, default=8)
    bm.add_argument("--size", type=int, default=1024)
    bm.add_argument("--indices", default="NDVI")
    bm.add_argument("--renders", action="store_true", help="include colormap renders")
    bm.add_argument("--iters", type=int, default=10, help="base chain length")
    bm.add_argument("--reps", type=int, default=4)
    bm.set_defaults(fn=cmd_bench)

    r = sub.add_parser("report", help="single-image NDVI report")
    r.add_argument("image")
    r.add_argument("output")
    r.add_argument("--show", action="store_true",
                   help="open the visualization in the platform viewer")
    r.set_defaults(fn=cmd_report)

    g = sub.add_parser("rgn", help="standalone white-balance correction (process-rgn.py flow)")
    g.add_argument("image")
    g.add_argument("--out", default="", help="corrected image path")
    g.add_argument("--viz", default="", help="side-by-side canvas path")
    g.add_argument("--method", default="percentile", choices=["percentile", "gray_world"])
    g.set_defaults(fn=cmd_rgn)

    a = sub.add_parser("analyze", help="analyze one image (stats JSON)")
    a.add_argument("image")
    a.add_argument("--indices", default="")
    a.add_argument("--out", default="")
    a.set_defaults(fn=cmd_analyze)

    c = sub.add_parser("compare", help="N-up comparison analysis (UI comparison flow)")
    c.add_argument("images", nargs="+")
    c.add_argument("--indices", default="")
    c.add_argument("--out", default="")
    c.set_defaults(fn=cmd_compare)

    d = sub.add_parser("change", help="change detection between two images")
    d.add_argument("early")
    d.add_argument("late")
    d.add_argument("--index", default="NDVI")
    d.add_argument("--out", default="")
    d.add_argument("--upsample", type=int, default=1, help="subpixel registration factor")
    d.add_argument("--full-res", action="store_true",
                   help="sharded full-resolution alignment (no 1024 cap)")
    d.add_argument("--refine-tile", type=int, default=0,
                   help="non-rigid alignment: per-tile residual shifts on NxN tiles "
                        "(0 = rigid only)")
    d.set_defaults(fn=cmd_change)

    m = sub.add_parser("mosaic", help="sharded whole-mosaic analysis")
    m.add_argument("image", help="image file, or .npy (memory-mapped)")
    m.add_argument("--indices", default="")
    m.add_argument("--out", default="")
    m.add_argument("--streamed", action="store_true",
                   help="streamed band reduction (exact statistics at any size)")
    m.add_argument("--band-rows", type=int, default=2048)
    m.add_argument("--reduce", choices=("device", "host"), default="device",
                   help="where the streamed joint histograms are taken: the device's "
                        "jointhist kernel, or the native host accumulator (the same "
                        "results)")
    m.set_defaults(fn=cmd_mosaic)

    t = sub.add_parser("tune", help="measure the kernels' grids on the card, cache winners")
    t.add_argument("--sizes", default="",
                   help="comma-separated image sizes (default 512,1024,2048,4096)")
    t.set_defaults(fn=cmd_tune)

    s = sub.add_parser("store", help="image store operations")
    s.add_argument("action", choices=["upload", "list", "remove", "dedupe"])
    s.add_argument("files", nargs="*")
    s.add_argument("--root", default="./rgnir_store")
    s.add_argument("--mongo", default="")
    s.add_argument("--page", type=int, default=1)
    s.add_argument("--per-page", type=int, default=12)
    s.add_argument("--id", default="")
    s.set_defaults(fn=cmd_store)

    t = sub.add_parser("sites", help="monitoring sites")
    t.add_argument("action", choices=["create", "list", "assign", "timeseries"])
    t.add_argument("--root", default="./rgnir_store")
    t.add_argument("--mongo", default="")
    t.add_argument("--name", default="")
    t.add_argument("--description", default="")
    t.add_argument("--lat", type=float, default=None)
    t.add_argument("--lng", type=float, default=None)
    t.add_argument("--image-id", default="")
    t.add_argument("--site-id", default="")
    t.add_argument("--index", default="NDVI")
    t.add_argument("--out", default="")
    t.set_defaults(fn=cmd_sites)
    return p


def _apply_index_definitions(specs) -> None:
    """Register each --define-index NAME:POS,NEG[:THRESH[:CMAP[:FEAT]]]."""
    from rgnir_torch.config import register_index

    for spec in specs:
        parts = str(spec).split(":")
        if len(parts) < 2:
            raise SystemExit(f"--define-index {spec!r}: expected "
                             f"NAME:POS,NEG[:THRESHOLD[:CMAP[:FEATURE]]]")
        name, bands = parts[0], parts[1]
        try:
            ia, ib = (int(x) for x in bands.split(","))
            register_index(
                name, (ia, ib),
                coverage_threshold=float(parts[2]) if len(parts) > 2 and parts[2] else 0.2,
                cmap_name=parts[3] if len(parts) > 3 and parts[3] else "RdYlGn",
                feature_name=parts[4] if len(parts) > 4 and parts[4] else "Vegetation",
            )
        except (ValueError, TypeError) as e:
            raise SystemExit(f"--define-index {spec!r}: {e}") from None


def main(argv=None) -> int:
    from rgnir_torch.pipeline.fused import resolve_device
    from rgnir_torch.utils.compile_cache import enable_persistent_cache

    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)  # the card unless told otherwise; raises without
    args.cache_dir = enable_persistent_cache()
    _apply_index_definitions(args.define_index)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
