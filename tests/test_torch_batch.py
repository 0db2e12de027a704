"""The port's batch directory pipeline (rgnir_torch.pipeline.batch) on
the CPU against the JAX package's (rgnir_tpu.pipeline.batch).

One input directory: five PNG frames of one shape (a full batch of 3 and
a remainder of 2), two JPEG frames of another, a corrupt PNG and a text
file the extension filter skips. Both packages process it into their own
output directory. The summaries must be equal (paths relative to each
root), the output trees the same, and every output decoded equal (WB
TIFFs, renders, figures); the manifests interoperate. Inputs come from
numpy.random.default_rng(seed), written with Pillow.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import rgnir_tpu.io.writer as jwriter
from rgnir_tpu.config import LoaderConfig as JaxLoaderConfig
from rgnir_tpu.config import register_index as j_register_index
from rgnir_tpu.pipeline.batch import batch_process as jax_batch_process
from rgnir_torch.config import LoaderConfig, register_index
from rgnir_torch.io import writer as twriter
from rgnir_torch.pipeline import batch as tbatch
from rgnir_torch.pipeline.batch import HostBuffers, batch_process, list_input_images

BATCH = 3


@pytest.fixture(scope="module")
def input_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    rng = np.random.default_rng(21)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
            d / f"frame_{i}.png")
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)).save(
            d / f"jpeg_{i}.jpg", quality=90)
    (d / "broken.png").write_bytes(b"corrupt bytes")
    (d / "notes.txt").write_text("ignored")
    return d


def _run(package, input_dir, out, **kw):
    if package == "jax":
        return jax_batch_process(input_dir, out, loader_cfg=JaxLoaderConfig(batch_size=BATCH),
                                 **kw)
    return batch_process(input_dir, out, loader_cfg=LoaderConfig(batch_size=BATCH),
                         device="cpu", **kw)


def _rel(path, roots):
    path = Path(path)
    for root in roots:
        if path.is_relative_to(root):
            return str(path.relative_to(root))
    return str(path)


def _summary(s, roots):
    return (s["processed"], s["skipped"],
            [(_rel(p, roots), type(e).__name__) for p, e in s["failed"]])


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file() and p.name != ".manifest.jsonl")


def _assert_same_outputs(got_root, want_root):
    tree = _tree(want_root)
    assert _tree(got_root) == tree
    for rel in tree:
        got = np.asarray(Image.open(Path(got_root) / rel))
        want = np.asarray(Image.open(Path(want_root) / rel))
        np.testing.assert_array_equal(got, want, err_msg=rel)
    return tree


def _manifest(root, input_dir):
    import json

    recs = []
    for line in (Path(root) / ".manifest.jsonl").read_text().splitlines():
        r = json.loads(line)
        r["input"] = _rel(r["input"], [input_dir])
        r["outputs"] = [_rel(o, [root]) for o in r.get("outputs", [])]
        r.pop("error", None)
        recs.append(r)
    return recs


@pytest.mark.parametrize("save_wb,indices", [
    (True, ("NDVI", "GNDVI", "NDWI")),
    (False, ("NDVI",)),
    (True, ()),
], ids=["wb_three_kinds", "ndvi", "wb_only"])
def test_batch_matches_jax(input_dir, tmp_path, save_wb, indices):
    seen = {"jax": [], "torch": []}
    outs = {}
    summaries = {}
    for package in ("jax", "torch"):
        outs[package] = tmp_path / package
        summaries[package] = _run(
            package, input_dir, outs[package], save_wb=save_wb, indices=indices,
            progress=lambda i, n, p, package=package: seen[package].append((i, n, p.name)))
    roots = list(outs.values()) + [input_dir]
    assert _summary(summaries["torch"], roots) == _summary(summaries["jax"], roots)
    assert _summary(summaries["torch"], roots) == (7, 0, [("broken.png",
                                                          "UnidentifiedImageError")])
    assert seen["torch"] == seen["jax"]
    assert [n for _, _, n in seen["torch"]][:3] == ["frame_0.png", "frame_1.png", "frame_2.png"]
    tree = _assert_same_outputs(outs["torch"], outs["jax"])
    assert len(tree) == 7 * (int(save_wb) + len(indices))
    if save_wb:
        assert "white_balanced/frame_0_wb.tif" in tree
    assert _manifest(outs["torch"], input_dir) == _manifest(outs["jax"], input_dir)
    s = summaries["torch"]
    assert s["batches"] == 3  # 3 + 2 PNG frames, 2 JPEG frames
    assert set(s["seconds"]) >= {"decode", "dispatch", "write", "close", "wall"}
    assert s["pinned_peak_bytes"] == 0  # nothing is pinned on the CPU


def test_custom_kind_matches_jax(input_dir, tmp_path):
    spec = dict(coverage_threshold=0.1, cmap_name="viridis")
    j_register_index("TORCH_BATCH_CUSTOM", (2, 1), **spec)
    register_index("TORCH_BATCH_CUSTOM", (2, 1), **spec)
    kinds = ("NDVI", "TORCH_BATCH_CUSTOM")
    _run("jax", input_dir, tmp_path / "jax", indices=kinds)
    _run("torch", input_dir, tmp_path / "torch", indices=kinds)
    tree = _assert_same_outputs(tmp_path / "torch", tmp_path / "jax")
    assert "TORCH_BATCH_CUSTOM/frame_4_torch_batch_custom.png" in tree


@pytest.mark.parametrize("first,second", [("torch", "torch"), ("jax", "torch"),
                                          ("torch", "jax")])
def test_resume_skips_done(input_dir, tmp_path, first, second):
    """A second run over the same output directory, by either package,
    skips what the first did; the corrupt file is tried again."""
    out = tmp_path / "out"
    s1 = _run(first, input_dir, out, indices=("NDVI",))
    s2 = _run(second, input_dir, out, indices=("NDVI",))
    assert (s1["processed"], s1["skipped"], len(s1["failed"])) == (7, 0, 1)
    assert (s2["processed"], s2["skipped"], len(s2["failed"])) == (0, 7, 1)
    s3 = _run(second, input_dir, out, indices=("NDVI",), resume=False)
    assert (s3["processed"], s3["skipped"]) == (7, 0)


@pytest.mark.parametrize("package,module", [("torch", twriter), ("jax", jwriter)])
def test_write_failure_retried_on_resume(input_dir, tmp_path, monkeypatch, package, module):
    """A write that fails in the pool (seen only at close()) marks its
    input failed again, so a resumed run retries it alone; the same in
    both packages."""
    real = module._write_array

    def flaky(path, array):
        if path.name == "frame_2_ndvi.png":
            raise OSError("disk full (injected)")
        return real(path, array)

    monkeypatch.setattr(module, "_write_array", flaky)
    out = tmp_path / "out"
    s1 = _run(package, input_dir, out, indices=("NDVI",))
    assert [(p.name, str(e)) for p, e in s1["failed"]][-1] == (
        "frame_2_ndvi.png", "disk full (injected)")
    assert s1["processed"] == 7 and not (out / "NDVI" / "frame_2_ndvi.png").exists()
    monkeypatch.setattr(module, "_write_array", real)
    s2 = _run(package, input_dir, out, indices=("NDVI",))
    assert (s2["processed"], s2["skipped"]) == (1, 6)
    assert (out / "NDVI" / "frame_2_ndvi.png").exists()


def test_figures_match_jax(tmp_path):
    """figures=True: the reference's matplotlib figure of each index map,
    pixel for pixel the JAX package's (two frames, one kind: a figure is
    10 x 8 in at 100 dpi)."""
    pytest.importorskip("matplotlib")
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(22)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
            d / f"f{i}.png")
    for package in ("jax", "torch"):
        s = _run(package, d, tmp_path / package, indices=("NDVI",), figures=True)
        assert (s["processed"], s["failed"]) == (2, [])
    tree = _assert_same_outputs(tmp_path / "torch", tmp_path / "jax")
    assert tree == ["NDVI/f0_ndvi.png", "NDVI/f1_ndvi.png"]
    fig = np.asarray(Image.open(tmp_path / "torch" / tree[0]))
    assert fig.shape[0] > 400 and fig.shape[1] > 400  # a figure, not the 40 x 56 render


def test_index_figure_writer_equals_save_index_figure(tmp_path):
    """The reused-layout writer draws the pixels of a fresh figure."""
    pytest.importorskip("matplotlib")
    from rgnir_tpu.viz.figures import save_index_figure as jax_save_index_figure
    from rgnir_torch.viz import IndexFigureWriter, render_index_figure, save_index_figure

    arr = np.random.default_rng(4).uniform(-1, 1, (30, 44)).astype(np.float32)
    writer = IndexFigureWriter()
    for i in range(2):  # the second write reuses the layout
        writer.write(arr * (1 - 0.5 * i), "GNDVI", tmp_path / f"w{i}.png")
        save_index_figure(arr * (1 - 0.5 * i), "GNDVI", tmp_path / f"s{i}.png")
        jax_save_index_figure(arr * (1 - 0.5 * i), "GNDVI", tmp_path / f"j{i}.png")
        w, s, j = (np.asarray(Image.open(tmp_path / f"{k}{i}.png").convert("RGB"))
                   for k in "wsj")
        np.testing.assert_array_equal(w, s)
        np.testing.assert_array_equal(s, j)
    pil = render_index_figure(arr * 0.5, "GNDVI")  # the last array written
    np.testing.assert_array_equal(np.asarray(pil.convert("RGB")), s)
    assert render_index_figure(np.zeros((0, 0)), "NDVI") is None


def test_default_device_raises_without_cuda(input_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_process(input_dir, tmp_path / "out")
    assert not (tmp_path / "out").exists()  # refused before any work


def test_list_input_images(input_dir):
    names = [p.name for p in list_input_images(input_dir)]
    assert names == ["broken.png", "frame_0.png", "frame_1.png", "frame_2.png", "frame_3.png",
                     "frame_4.png", "jpeg_0.jpg", "jpeg_1.jpg"]


def test_host_buffers_reuse_and_bound(monkeypatch):
    """Buffers come back by shape and dtype, the last given back first;
    idle ones beyond the cap are released, oldest first; a buffer that
    is not the pool's is ignored."""
    monkeypatch.setattr(tbatch, "MAX_IDLE_PINNED_BYTES", 3000)
    bufs = HostBuffers(pinned=False)
    a = bufs.take((10, 100))
    b = bufs.take((10, 100))
    c = bufs.take((5, 100), torch.float32)
    assert bufs.held_bytes == 4000
    bufs.give(a)
    bufs.give(b.numpy()[:4])  # a view that starts where the buffer starts
    assert bufs.take((10, 100)).data_ptr() == b.data_ptr()
    bufs.give(b)
    bufs.give(torch.empty(3))  # not the pool's
    bufs.give(c)  # idle: 1000 + 1000 + 2000 > 3000 -> a (the oldest) goes
    assert bufs.held_bytes == 3000
    assert bufs.take((5, 100), torch.float32).data_ptr() == c.data_ptr()
    assert bufs.take((10, 100)).data_ptr() == b.data_ptr()
    assert bufs.take((10, 100)).data_ptr() not in (a.data_ptr(), b.data_ptr())  # a new one
    assert bufs.held_bytes == 4000
    assert bufs.take_array((2, 3)).shape == (2, 3)
    bufs.give(b)
    bufs.give(c)
    bufs.close()  # releases the idle ones
    assert bufs.held_bytes == 1006 and not bufs._idle


class _Event:
    """A stand-in for a CUDA event: ``done`` once its copy ended."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited, self.done = True, True


def test_host_buffers_prefer_a_buffer_whose_copy_ended():
    """Of the idle buffers of a shape, take() hands out one whose event
    has completed, the last given back first, without waiting; where
    every one is pending, it waits on the one given back earliest."""
    bufs = HostBuffers(pinned=False)
    a, b, c = (bufs.take((4, 8)) for _ in range(3))
    ev_a, ev_b, ev_c = _Event(False), _Event(True), _Event(False)
    bufs.give(a, ev_a)
    bufs.give(b, ev_b)
    bufs.give(c, ev_c)  # the last given back, but pending
    assert bufs.take((4, 8)).data_ptr() == b.data_ptr()
    assert not (ev_a.waited or ev_b.waited or ev_c.waited)
    assert bufs.take((4, 8)).data_ptr() == a.data_ptr() and ev_a.waited
    assert not ev_c.waited
    bufs.give(a)  # no event: ready
    assert bufs.take((4, 8)).data_ptr() == a.data_ptr() and not ev_c.waited


def test_white_balance_alone_matches_plain():
    """No kinds (a batch run that writes only the WB frames): the kernel
    path gives the plain path's WB bytes and nothing else."""
    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.pipeline.fused import analyze_image

    img = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 24, 40, 3),
                                                             dtype=np.uint8))
    for frames in (img, img[0]):
        res = analyze_image_kernel(frames, kinds=())
        assert not res.indices and not res.renders and not res.stats
        assert torch.equal(res.wb, analyze_image(frames, kinds=(), device="cpu").wb)
