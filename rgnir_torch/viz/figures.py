"""Matplotlib composition of figures: the index figures the batch
pipeline's ``figures=True`` writes (reference parity:
process-images.py:669-716, backend-process.py:40-47) and the
comparison, time-series and change figures (process-images.py:718-989).

All functions take already-computed arrays (numpy) and compose figures
on the host; none of them touch the device. Agg only (no interactive
backend). matplotlib and Pillow are imported inside the functions that
use them: the card's machine has no matplotlib, so figures are composed
on machines that have it (the CPU tests hold them equal to the JAX
package's). The comparison, time-series and change figures serve
``pipeline.compare``, ``pipeline.timeseries`` and ``pipeline.change``;
the histogram figure ``pipeline.single`` and the side-by-side canvas
``pipeline.rgn``. Counterpart: ``rgnir_tpu/viz/figures.py``.
"""

from __future__ import annotations

import io
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from rgnir_torch.config import IndexKind


def _fig_to_pil(fig, pad_inches: float = 0.0, dpi: int = 100):
    """The figure rendered to a Pillow image (tight bbox)."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from PIL import Image

    canvas = FigureCanvasAgg(fig)
    buf = io.BytesIO()
    canvas.print_figure(
        buf, format="png", bbox_inches="tight", pad_inches=pad_inches, dpi=dpi
    )
    buf.seek(0)
    with Image.open(buf) as img:
        return img.copy()


def _new_figure(figsize, dpi: int = 100):
    from matplotlib.figure import Figure

    return Figure(figsize=figsize, dpi=dpi)


def render_index_figure(index_array: np.ndarray, kind: Union[IndexKind, str]):
    """Single index map with colorbar (process-images.py:669-716):
    10x8 in @ 100 dpi, cmap by kind, vmin/vmax +/-1, axis off,
    tight bbox with zero padding."""
    if index_array is None or np.asarray(index_array).size == 0:
        return None
    kind = IndexKind.parse(kind)
    index_array = np.asarray(index_array)
    fig = _new_figure((10, 8))
    ax = fig.add_subplot(111)
    im = ax.imshow(index_array, cmap=kind.cmap_name, vmin=-1, vmax=1)
    fig.colorbar(im, label=kind.value)
    ax.axis("off")
    return _fig_to_pil(fig, pad_inches=0.0)


def save_index_figure(
    index_array: np.ndarray, kind: Union[IndexKind, str], path
) -> None:
    """Compose and write the index figure straight to ``path`` (single
    PNG encode — the PIL round-trip of render_index_figure costs a
    second encode, which matters in batch figure mode)."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg

    kind = IndexKind.parse(kind)
    fig = _new_figure((10, 8))
    ax = fig.add_subplot(111)
    im = ax.imshow(np.asarray(index_array), cmap=kind.cmap_name, vmin=-1, vmax=1)
    fig.colorbar(im, label=kind.value)
    ax.axis("off")
    FigureCanvasAgg(fig).print_figure(
        str(path), format="png", bbox_inches="tight", pad_inches=0.0, dpi=100
    )


class IndexFigureWriter:
    """Blit-reuse composer for batch index-figure output.

    Pixel-identical (RGB) to :func:`save_index_figure` (asserted in
    tests/test_torch_batch.py), but pays only for what actually changes between
    figures of one layout:

    - The static panel (colorbar, label, ticks, margins) is rasterized
      ONCE per (kind, image shape): the figure is permanently resized
      to its tight bbox via matplotlib's own ``adjust_bbox`` (the same
      transform ``print_figure(bbox_inches=...)`` applies per call),
      drawn, and the Agg buffer captured as the restore region.
    - Per write, only the image artist is redrawn over the restored
      background (Agg's exact resample — bit-identical to a full
      draw), and the buffer is PNG-encoded directly (RGB, zlib level
      ``compress_level``) with no per-call re-layout or re-render of
      the static elements.

    The reference composes a fresh pyplot figure per image
    (backend-process.py:40-47); figure mode is bound by composition on
    the host, so this is its lever.

    The layout cache is PROCESS-GLOBAL (shared across writer
    instances): building one layout is matplotlib's text layout, the
    largest cost of a small figure batch, and a watch loop, an app or a
    repeated ``batch_process`` would otherwise pay it per call. Draw+grab runs under a lock (figure
    state is mutable); the PNG encode stays per-writer and concurrent.
    """

    # Each cached layout holds a live Agg canvas (10x8 in at 100 dpi);
    # ragged directories could otherwise grow the cache without bound.
    MAX_LAYOUTS = 8
    _layouts = None  # class-level OrderedDict, created on first use
    _lock = None

    def __init__(self, compress_level: int = 1):
        import collections
        import threading

        self.compress_level = compress_level
        cls = type(self)
        if cls._layouts is None:
            cls._layouts = collections.OrderedDict()
            cls._lock = threading.Lock()
        self._state = cls._layouts  # shared: key -> layout state
        # Set False to force the draw_artist fallback (A/B + tests).
        self.fast_draw = True
        # SUB+Z_RLE PNG encode (decoded pixels identical; slightly
        # larger files, a cheaper deflate). Set False for filter-NONE output.
        self.fast_encode = True

    @staticmethod
    def _capture_replay(canvas, ax, im):
        """Capture the data-independent half of the image artist's draw.

        ``AxesImage.draw`` -> ``_make_image`` spends much of its time on
        work that does not depend on the pixel values: bbox/transform
        math, and (for the no-mask scalar-data 'rgba' interpolation
        stage this writer always hits) a resample of the CONSTANT alpha
        plane. This instruments ONE real draw, capturing the exact
        ``_resample`` arguments (out_shape, transform) and draw position
        matplotlib itself computed plus the final alpha plane, so
        subsequent writes replay only the data-dependent calls — the
        same C resample, the same u8 conversion, the same C blend —
        and are pixel-identical by construction (asserted against
        save_index_figure in tests/test_torch_batch.py). Returns None (fallback
        to a full draw_artist) when the draw doesn't match the expected
        two-resample rgba-stage shape.
        """
        import matplotlib.image as mi

        calls = []
        drawn = {}
        real_resample = mi._resample
        renderer = canvas.get_renderer()
        real_draw_image = renderer.draw_image

        def rec_resample(image_obj, data, out_shape, t, **kw):
            out = real_resample(image_obj, data, out_shape, t, **kw)
            calls.append((data.ndim, out_shape, t, kw))
            return out

        def rec_draw_image(gc, x, y, img, *a, **kw):
            drawn["pos"] = (x, y)
            drawn["alpha_u8"] = np.array(img[..., 3], copy=True)
            return real_draw_image(gc, x, y, img, *a, **kw)

        mi._resample = rec_resample
        renderer.draw_image = rec_draw_image
        try:
            ax.draw_artist(im)
        finally:
            mi._resample = real_resample
            # draw_image is an INSTANCE attribute on RendererAgg
            # (_update_methods binds the C renderer's method) — restore
            # it by assignment; `del` would expose the NotImplementedError
            # base-class method.
            renderer.draw_image = real_draw_image
        # Expected rgba-stage shape: one 2-D (alpha) + one 3-D (rgb)
        # resample, then one draw_image.
        rgb_calls = [c for c in calls if c[0] == 3]
        if len(rgb_calls) != 1 or "pos" not in drawn or len(calls) != 2:
            return None
        _, out_shape, t, kw = rgb_calls[0]
        return {
            "out_shape": out_shape, "t": t, "kw": kw,
            "pos": drawn["pos"], "alpha_u8": drawn["alpha_u8"],
        }

    @staticmethod
    def _lean_rgba(im, arr):
        """Bit-exact, allocation-lean replica of
        ``mi._rgb_to_rgba(im.to_rgba(arr)[..., :3])`` for the shapes
        this writer always hits: 2-D unmasked float data under a plain
        ``Normalize``. Replays matplotlib's own arithmetic — in-place
        f32/f64 norm (`Normalize.__call__`), ``xa *= N`` /
        ``xa == N -> N-1`` / under-over-bad index routing
        (`Colormap._get_rgba_and_mask`), and the same float64 LUT take
        — while skipping the masked-array wrappers and the extra
        RGB->RGBA copy (alpha is 1 everywhere after `_rgb_to_rgba`, so
        it is written directly). Pixel identity with the full draw is
        asserted in tests/test_torch_batch.py.
        Returns ``(rgba_f64, had_bad_pixels)``, or None when any
        assumption fails (caller falls back to the full chain)."""
        import matplotlib.colors as mcolors

        norm = im.norm
        cmap = im.cmap
        if (
            type(norm) is not mcolors.Normalize
            or norm.clip  # clip=True clamps BEFORE the cmap: different path
            or norm.vmin is None or norm.vmax is None
            or norm.vmax <= norm.vmin
            or not isinstance(arr, np.ndarray)
            or np.ma.is_masked(arr)
            or arr.ndim != 2
            or arr.dtype.kind != "f"
        ):
            return None
        if not cmap._isinit:
            cmap._init()
        lut = cmap._lut
        if lut.dtype != np.float64 or lut.shape[1] != 4:
            return None
        xa = arr.copy()
        xa -= norm.vmin
        xa /= (norm.vmax - norm.vmin)
        xa *= cmap.N
        xa[xa == cmap.N] = cmap.N - 1
        under = xa < 0
        over = xa >= cmap.N
        bad = np.isnan(xa)
        with np.errstate(invalid="ignore"):
            ia = xa.astype(int)
        ia[under] = cmap._i_under
        ia[over] = cmap._i_over
        ia[bad] = cmap._i_bad
        rgba = lut.take(ia, axis=0, mode="clip")
        rgba[..., 3] = 1.0
        return rgba, bool(bad.any())

    def _replay_draw(self, canvas, ax, im, replay, arr) -> bool:
        """Redraw the image artist from ``arr`` using the captured
        replay state; True on success (pixel-identical to draw_artist),
        False to make the caller fall back to the full draw."""
        import matplotlib.image as mi

        try:
            # reads matplotlib colormap internals (_lut, _i_under, ...);
            # degrade to the public chain if an upgrade moves them
            lean = self._lean_rgba(im, arr)
        except Exception:
            lean = None
        if lean is None:
            A = im.to_rgba(arr)  # float RGBA via the fixed (-1, 1) norm
            rgba, may_have_nan = mi._rgb_to_rgba(A[..., :3]), True
        else:
            rgba, may_have_nan = lean
        out = mi._resample(
            im, rgba, replay["out_shape"], replay["t"], **replay["kw"],
        )
        # exact `to_rgba(out, bytes=True, norm=False)` for (h, w, 4)
        # float input (colorizer._pass_image_data), without re-entering
        # the dispatch: zero any nan rows, scale, truncate to u8. The
        # nan scan is skipped when the input had none (a finite f64
        # hanning/nearest resample of finite values stays finite).
        if may_have_nan:
            nans = np.isnan(out)
            if nans.any():
                out[np.any(nans, axis=2), :] = 0
        out_u8 = (out * 255).astype(np.uint8)
        out_u8[..., 3] = replay["alpha_u8"]
        renderer = canvas.get_renderer()
        gc = renderer.new_gc()
        im._set_gc_clip(gc)
        gc.set_alpha(im._get_scalar_alpha())
        gc.set_url(im.get_url())
        gc.set_gid(im.get_gid())
        x, y = replay["pos"]
        renderer.draw_image(gc, x, y, out_u8)
        gc.restore()
        return True

    def write(
        self, index_array: np.ndarray, kind: Union[IndexKind, str], path
    ) -> None:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib._tight_bbox import adjust_bbox

        kind = IndexKind.parse(kind)
        arr = np.asarray(index_array)
        key = (kind.value, arr.shape)
        with type(self)._lock:
            state = self._state.get(key)
            if state is None:
                fig = _new_figure((10, 8))
                ax = fig.add_subplot(111)
                im = ax.imshow(arr, cmap=kind.cmap_name, vmin=-1, vmax=1)
                fig.colorbar(im, label=kind.value)
                ax.axis("off")
                canvas = FigureCanvasAgg(fig)
                canvas.draw()  # measure the tight bbox once per layout
                bbox = fig.get_tightbbox(canvas.get_renderer())
                # Apply the tight-bbox transform PERMANENTLY
                # (print_figure applies and reverts this same
                # transform on every call).
                adjust_bbox(fig, bbox, fixed_dpi=100)
                canvas.draw()
                bg = canvas.copy_from_bbox(fig.bbox)
                replay = None
                if self.fast_draw:
                    try:
                        canvas.restore_region(bg)
                        replay = self._capture_replay(canvas, ax, im)
                    except Exception:
                        replay = None  # internals moved — full draw
                state = (canvas, ax, im, bg, replay)
                self._state[key] = state
                if len(self._state) > self.MAX_LAYOUTS:
                    self._state.popitem(last=False)  # evict least-recent
            else:
                self._state.move_to_end(key)
            canvas, ax, im, bg, replay = state
            canvas.restore_region(bg)
            if replay is not None and self.fast_draw:
                self._replay_draw(canvas, ax, im, replay, arr)
            else:
                im.set_data(arr)
                ax.draw_artist(im)
            buf = np.asarray(canvas.buffer_rgba())
            rgb = np.ascontiguousarray(buf[..., :3])
        # Native libpng with a fixed filter does less than Pillow's
        # adaptive-filter encoder, and the fast mode (filter SUB +
        # Z_RLE) deflates figure canvases more cheaply; identical
        # pixels either way, PNG being lossless under any filter or
        # strategy (tests/test_torch_batch.py compares decoded pixels).
        from PIL import Image

        from rgnir_torch.io.writer import _native_png

        data = _native_png(rgb, self.compress_level, fast=self.fast_encode)
        if data is not None:
            Path(path).write_bytes(data)
        else:
            Image.fromarray(rgb).save(
                str(path), "PNG", compress_level=self.compress_level
            )


def render_comparison_figure(
    items: Sequence[dict],
    index_type: Optional[Union[IndexKind, str]] = None,
):
    """N-up side-by-side comparison (process-images.py:718-799).

    Each item: ``{"filename": str, "array": ndarray, "stats": dict?}``.
    With ``index_type`` the arrays are index maps rendered with the
    index colormap and per-image stats are collected (the precomputed
    stats of the device pass); without it the arrays display as plain
    images. 4N x 4 in, filename titles at fontsize 8, tight layout with
    0.1 in padding. Returns ``(Pillow image or None, stats by name)``.
    """
    if not items:
        return None, {}
    n = len(items)
    fig = _new_figure((4 * n, 4))
    all_stats: Dict[str, dict] = {}
    kind = IndexKind.parse(index_type) if index_type else None
    for i, item in enumerate(items):
        ax = fig.add_subplot(1, n, i + 1)
        arr = np.asarray(item["array"])
        if kind is not None:
            im = ax.imshow(arr, cmap=kind.cmap_name, vmin=-1, vmax=1)
            fig.colorbar(im, ax=ax, label=kind.value)
            name = item.get("filename", f"image_{i}")
            if "stats" in item and item["stats"] is not None:
                all_stats[name] = item["stats"]
        else:
            ax.imshow(arr)
        if item.get("filename"):
            ax.set_title(item["filename"], fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    return _fig_to_pil(fig, pad_inches=0.1), all_stats


def render_time_series_figure(
    dates: Sequence,
    means: Sequence[float],
    mins: Sequence[float],
    maxs: Sequence[float],
    kind: Union[IndexKind, str],
):
    """Error-bar time series (process-images.py:801-883): mean with
    asymmetric yerr [mean-min, max-mean], fmt 'o-', capsize 5, red
    dashed threshold line, grid alpha 0.3, legend, autofmt_xdate.
    None for fewer than two dates."""
    if len(dates) < 2:
        return None
    kind = IndexKind.parse(kind)
    means = np.asarray(means, dtype=float)
    mins = np.asarray(mins, dtype=float)
    maxs = np.asarray(maxs, dtype=float)
    fig = _new_figure((10, 6))
    ax = fig.add_subplot(111)
    ax.errorbar(
        list(dates), means, yerr=[means - mins, maxs - means],
        fmt="o-", capsize=5, label=f"Mean {kind.value}",
    )
    ax.axhline(
        y=kind.coverage_threshold, color="r", linestyle="--",
        label=f"{kind.feature_name} Threshold",
    )
    ax.set_title(f"{kind.value} Time Series")
    ax.set_xlabel("Date")
    ax.set_ylabel(f"{kind.value} Value")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.autofmt_xdate()
    return _fig_to_pil(fig)


def render_change_figure(
    early_index: np.ndarray,
    late_index: np.ndarray,
    diff: np.ndarray,
    kind: Union[IndexKind, str],
    early_label: str = "",
    late_label: str = "",
):
    """3-panel change detection (process-images.py:927-989): early/late
    with the index colormap at +/-1, difference with bwr at +/-0.5 and a
    delta-labeled colorbar; 15x5 in."""
    kind = IndexKind.parse(kind)
    fig = _new_figure((15, 5))
    panels = [
        (np.asarray(early_index), kind.cmap_name, (-1, 1),
         f"Early: {early_label}", kind.value),
        (np.asarray(late_index), kind.cmap_name, (-1, 1),
         f"Late: {late_label}", kind.value),
        (np.asarray(diff), "bwr", (-0.5, 0.5),
         f"Change in {kind.value}", f"Δ{kind.value}"),
    ]
    for i, (arr, cmap, (vmin, vmax), title, cbar_label) in enumerate(panels):
        ax = fig.add_subplot(1, 3, i + 1)
        im = ax.imshow(arr, cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, label=cbar_label)
        ax.axis("off")
    fig.tight_layout()
    return _fig_to_pil(fig)


def render_histogram_figure(
    hist_counts: np.ndarray,
    kind: Union[IndexKind, str] = IndexKind.NDVI,
    bins_range: Tuple[float, float] = (-1.0, 1.0),
    out_path=None,
):
    """Index-value distribution (process-ndvi.py:96-102): 50 bins over
    (-1, 1), 10x6 in. Takes the device-computed histogram counts and
    draws the same bars ``plt.hist`` would.

    With ``out_path`` the figure is written straight to disk with plain
    ``savefig`` (default bbox, as the reference's ``plt.savefig``,
    process-ndvi.py:102) and None is returned; without it, a tight-bbox
    Pillow image. The ``out_path`` route reuses one cached Agg figure
    per (bins, kind, range) layout and updates only the bar heights and
    the autoscale, so its pixels equal a from-scratch render's."""
    kind = IndexKind.parse(kind)
    counts = np.asarray(hist_counts)
    if out_path is not None:
        _HIST_FIG_CACHE.save(counts, kind, bins_range, out_path)
        return None
    edges = np.linspace(bins_range[0], bins_range[1], counts.size + 1)
    fig = _new_figure((10, 6))
    ax = fig.add_subplot(111)
    ax.bar(edges[:-1], counts, width=np.diff(edges), align="edge")
    ax.set_title(f"Distribution of {kind.value} Values")
    ax.set_xlabel(kind.value)
    ax.set_ylabel("Pixel Count")
    return _fig_to_pil(fig, pad_inches=0.1)


class _HistFigureWriter:
    """One reused histogram figure for the report flow: constructing a
    figure costs a large share of a render, and a serving process writes
    many reports. Bar heights are updated in place; the data limits and
    the autoscale are set as a fresh ``ax.bar`` would set them, so a
    reused render is byte-identical to a fresh one."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._key = None
        self._fig = None
        self._ax = None
        self._bars = None

    def save(self, counts: np.ndarray, kind, bins_range, path) -> None:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.transforms import Bbox

        key = (counts.size, kind, tuple(bins_range))
        with self._lock:
            if self._key != key:
                edges = np.linspace(bins_range[0], bins_range[1], counts.size + 1)
                fig = _new_figure((10, 6))
                FigureCanvasAgg(fig)
                ax = fig.add_subplot(111)
                bars = ax.bar(edges[:-1], counts, width=np.diff(edges), align="edge")
                ax.set_title(f"Distribution of {kind.value} Values")
                ax.set_xlabel(kind.value)
                ax.set_ylabel("Pixel Count")
                self._key, self._fig, self._ax, self._bars = key, fig, ax, bars
            else:
                for b, c in zip(self._bars, counts):
                    b.set_height(c)
                # the data limits a fresh ax.bar would give (the union of
                # the bars, whose bases are at 0), then the autoscale, so
                # the axis range and every pixel match a fresh figure
                lo, hi = bins_range
                ymax = float(counts.max()) if counts.size else 1.0
                self._ax.dataLim.set(Bbox.from_extents(lo, min(0.0, ymax), hi, ymax))
                self._ax.autoscale_view()
            self._fig.savefig(path, format="png", pil_kwargs={"compress_level": 1})


_HIST_FIG_CACHE = _HistFigureWriter()


def side_by_side_canvas(left, right):
    """Two Pillow images pasted into a double-width canvas
    (process-rgn.py:51-68 ``visualize_correction``)."""
    from PIL import Image

    w, h = left.size
    canvas = Image.new("RGB", (w * 2, h))
    canvas.paste(left, (0, 0))
    canvas.paste(right, (w, 0))
    return canvas
