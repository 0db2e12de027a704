"""The Streamlit app: the interactive surface, run on the card.

Counterpart: ``rgnir_tpu/app/streamlit_app.py``, with the reference
app's features (process-images.py:993-1612): a wide layout with the tabs
"Image Analysis" and "Time Series Monitoring", a multi-file uploader
with in-batch hash dedupe, a paginated 3-column gallery (12 a page) with
select and remove, store management (remove duplicates, a two-step
delete-all), the comparison (originals, white balanced, each index with
its metric tiles, and the ZIP), and site-based time series with change
detection.

The comparison runs ``pipeline.compare.comparison_analysis`` and
``pipeline.export.export_processed_zip``, the time series
``pipeline.timeseries.time_series_analysis``, all on one device: the
card unless ``RGNIR_TORCH_DEVICE`` names another (the CPU tests set
``cpu``); without a card the app raises. Storage is the filesystem
store under ``RGNIR_STORE_ROOT``, or MongoDB when ``MONGODB_URI`` is
set, as in the reference (process-images.py:21, 29-32). Figures need
matplotlib; where it is missing the app shows the statistics and writes
the ZIP's plain colormap PNGs.

``streamlit`` is imported inside :func:`main` and the store is kept in
the session, so the module imports without streamlit, and
``rgnir_torch.testing.fake_streamlit.AppHarness`` drives every flow
headlessly (``tests/test_torch_app.py``). Run it where streamlit is
installed:

    streamlit run rgnir_torch/app/streamlit_app.py
"""

from __future__ import annotations

import importlib.util
import io
import os

import torch

from rgnir_torch.config import ALL_INDICES, StoreConfig, registered_indices
from rgnir_torch.pipeline.fused import resolve_device
from rgnir_torch.store import DuplicateImageError, FsImageStore, MongoImageStore
from rgnir_torch.store.base import compute_file_hash

IMAGES_PER_PAGE = StoreConfig().images_per_page  # 12 (process-images.py:1232)
DEVICE_SETTING = "RGNIR_TORCH_DEVICE"


def app_device() -> torch.device:
    """The device the app computes on: ``RGNIR_TORCH_DEVICE``, else the
    card (raising where there is none)."""
    return resolve_device(os.environ.get(DEVICE_SETTING) or None)


def figures_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _index_names() -> list:
    """The built-in indices and the registered custom ones."""
    return [k.value for k in ALL_INDICES] + [c.value for c in registered_indices()]


def open_store(st):
    """MongoDB when ``MONGODB_URI`` (environment or secrets) is set, else
    the filesystem store under ``RGNIR_STORE_ROOT``."""
    try:  # .env support as in the reference (process-images.py:21)
        from dotenv import load_dotenv

        load_dotenv()
    except ImportError:
        pass
    uri = os.environ.get("MONGODB_URI")
    if not uri:
        try:  # st.secrets raises when no secrets.toml exists
            uri = st.secrets.get("MONGODB_URI", None)
        except FileNotFoundError:
            uri = None
    if uri:
        return MongoImageStore(uri)
    return FsImageStore(os.environ.get("RGNIR_STORE_ROOT", "./rgnir_store"))


def uploader_section(st, store) -> None:
    uploaded = st.file_uploader(
        "Upload RGNir images",
        type=["tif", "tiff", "png", "jpg", "jpeg"],
        accept_multiple_files=True,
    )
    if not uploaded:
        return
    seen_hashes = set()
    stored = 0
    for f in uploaded:
        data = f.getvalue()
        digest = compute_file_hash(data)
        if digest in seen_hashes:
            st.warning(f"Skipped duplicate in batch: {f.name}")
            continue
        seen_hashes.add(digest)
        try:
            store.save_image(f.name, data)
            stored += 1
        except DuplicateImageError:
            st.info(f"Already stored: {f.name}")
        except Exception as e:  # noqa: BLE001
            st.error(f"Failed to store {f.name}: {e}")
    if stored:
        st.success(f"Stored {stored} new image(s)")
        st.rerun()


def management_section(st, store) -> None:
    with st.expander("Image store management"):
        if st.button("Remove duplicate images"):
            n = store.remove_duplicates()
            st.success(f"Removed {n} duplicates")
        if st.button("Delete ALL images"):
            st.session_state["confirm_delete_all"] = True
        if st.session_state.get("confirm_delete_all"):
            st.warning("This permanently deletes every stored image.")
            if st.button("Yes, really delete everything"):
                n = store.clear_all_images()
                st.session_state["confirm_delete_all"] = False
                st.success(f"Deleted {n} images")
                st.rerun()


def gallery_section(st, store) -> list:
    page = st.session_state.setdefault("gallery_page", 1)
    records, total = store.list_images(page=page, per_page=IMAGES_PER_PAGE, with_total=True)
    if total:
        pages = max(1, -(-total // IMAGES_PER_PAGE))
        cols = st.columns([1, 3, 1])
        if cols[0].button("Prev", disabled=page <= 1):
            st.session_state["gallery_page"] = page - 1
            st.rerun()
        cols[1].write(f"Page {page}/{pages} — {total} images")
        if cols[2].button("Next", disabled=page >= pages):
            st.session_state["gallery_page"] = page + 1
            st.rerun()

    selected = st.session_state.setdefault("selected_images", [])
    columns = st.columns(3)
    for i, rec in enumerate(records):
        with columns[i % 3]:
            cache_key = f"thumb_{rec.image_id}"
            if cache_key not in st.session_state:
                _, thumb = store.load_image(rec.image_id, thumbnail=True)
                st.session_state[cache_key] = thumb
            st.image(st.session_state[cache_key], caption=rec.filename)
            checked = st.checkbox("Select", key=f"sel_{rec.image_id}",
                                  value=rec.image_id in selected)
            if checked and rec.image_id not in selected:
                selected.append(rec.image_id)
            if not checked and rec.image_id in selected:
                selected.remove(rec.image_id)
            if st.button("Remove", key=f"rm_{rec.image_id}"):
                store.remove_image(rec.image_id)
                st.session_state.pop(cache_key, None)
                if rec.image_id in selected:
                    selected.remove(rec.image_id)  # a stale id would fail the comparison
                st.rerun()
    return selected


def comparison_section(st, store, selected: list, device: torch.device) -> None:
    if not selected:
        st.info("Select images in the gallery to compare.")
        return
    indices = st.multiselect("Indices", _index_names(), default=[k.value for k in ALL_INDICES])
    if not st.button("Generate Comparison Analysis"):
        return
    from rgnir_torch.pipeline.compare import comparison_analysis
    from rgnir_torch.pipeline.export import export_processed_zip

    figures = figures_available()
    images = []
    progress = st.progress(0.0)
    for i, image_id in enumerate(selected):
        rec, arr = store.load_array(image_id)
        images.append((rec.filename, arr))
        progress.progress((i + 1) / len(selected))
    result = comparison_analysis(images, kinds=indices, with_figures=figures, device=device)
    if not figures:
        st.info("Figures need matplotlib; the statistics follow.")
    st.subheader("Original Images")
    if figures:
        st.image(result.original_figure)
    st.subheader("White Balanced")
    if figures:
        st.image(result.wb_figure)
    for kind in indices:
        st.subheader(kind)
        if figures:
            st.image(result.index_figures[kind])
        for filename, stats in result.index_stats[kind].items():
            st.caption(filename)
            tiles = st.columns(len(stats))
            for tile, (label, value) in zip(tiles, stats.items()):
                tile.metric(label, f"{value:.3f}")
    if images:
        zip_bytes = export_processed_zip(result.wb_arrays[0], indices, figures=figures,
                                         device=device)
        st.download_button("Download processed images (ZIP)", zip_bytes,
                           file_name="processed_images.zip")


def time_series_tab(st, store, device: torch.device) -> None:
    st.header("Time Series Monitoring")
    with st.expander("Create New Monitoring Site"):
        name = st.text_input("Site Name")
        description = st.text_area("Description (optional)")
        # coordinates are an explicit opt-in; sites store None otherwise
        # (process-images.py:1008-1023)
        include_coords = st.checkbox("Include Coordinates")
        lat, lng = None, None
        if include_coords:
            col_lat, col_lng = st.columns(2)
            with col_lat:
                lat = st.number_input("Latitude", min_value=-90.0, max_value=90.0,
                                      format="%.6f")
            with col_lng:
                lng = st.number_input("Longitude", min_value=-180.0, max_value=180.0,
                                      format="%.6f")
        if st.button("Create Site"):
            if not name:
                st.error("Site name is required")
            else:
                coordinates = {"lat": lat, "lng": lng} if include_coords else None
                try:
                    store.create_site(name, description, coordinates)
                    st.success(f"Site '{name}' created successfully!")
                    st.rerun()
                except Exception as e:  # noqa: BLE001
                    st.error(str(e))

    sites = store.list_sites()
    if not sites:
        st.info("Create a monitoring site to begin.")
        return
    site = st.selectbox("Site", sites, format_func=lambda s: s.name)
    st.caption(site.description or "")

    assigned = {r.image_id for r in store.site_images(site.site_id)}
    all_recs, _ = store.list_images(page=1, per_page=1000)
    unassigned = [r for r in all_recs if r.image_id not in assigned]
    to_assign = st.multiselect("Assign images to this site", unassigned,
                               format_func=lambda r: r.filename)
    if st.button("Assign") and to_assign:
        for rec in to_assign:
            store.assign_image_to_site(rec.image_id, site.site_id)
        st.rerun()

    index_name = st.selectbox("Index", _index_names())
    if st.button("Generate Time Series Analysis"):
        from rgnir_torch.pipeline.timeseries import time_series_analysis

        recs = store.site_images(site.site_id)
        if len(recs) < 2:
            st.warning("Need at least two images for a time series.")
            return
        seq = []
        progress = st.progress(0.0)
        for i, rec in enumerate(recs):
            _, arr = store.load_array(rec.image_id)
            seq.append((rec.upload_date, arr))
            progress.progress((i + 1) / len(recs))
        res = time_series_analysis(seq, index_name, with_figures=figures_available(),
                                   device=device)
        if res.figure is not None:
            st.image(res.figure)
        st.dataframe(res.table)
        if res.change is not None:
            st.subheader("Change Detection (first vs last)")
            if res.change["figure"] is not None:
                st.image(res.change["figure"])
                buf = io.BytesIO()
                res.change["figure"].save(buf, format="PNG")
                d1 = recs[0].upload_date.strftime("%Y%m%d")
                d2 = recs[-1].upload_date.strftime("%Y%m%d")
                st.download_button("Download change report", buf.getvalue(),
                                   file_name=f"change_report_{index_name}_{d1}_to_{d2}.png")


def main() -> None:
    import streamlit as st

    device = app_device()
    st.set_page_config(layout="wide", page_title="RGNir Image Analyzer")
    if "store" not in st.session_state:
        st.session_state["store"] = open_store(st)
    store = st.session_state["store"]
    tab1, tab2 = st.tabs(["Image Analysis", "Time Series Monitoring"])
    with tab1:
        with st.sidebar:
            if st.button("Clear cached thumbnails"):
                for key in list(st.session_state):
                    if key.startswith("thumb_"):
                        del st.session_state[key]
        uploader_section(st, store)
        management_section(st, store)
        selected = gallery_section(st, store)
        comparison_section(st, store, selected, device)
    with tab2:
        time_series_tab(st, store, device)


if __name__ == "__main__":
    main()
