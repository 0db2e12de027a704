"""rgnir_torch.cli against rgnir_tpu.cli: each subcommand's JSON and
written files, ``rgnir_torch.cli.main([..., "--device", "cpu"])`` against
``rgnir_tpu.cli.main([...])`` on the same small inputs, within the
contract (tests/torch_parity.py); ``warmup --check`` with a fake
library build; the card as the default device.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rgnir_tpu import cli as jcli
from rgnir_tpu.testing import fake_mongo as jfake_mongo
from rgnir_torch import cli as tcli
from rgnir_torch.testing import fake_mongo as tfake_mongo

from torch_parity import COVERAGE_RTOL, MEAN_ATOL

jfake_mongo.install()


def field(h, w, seed):
    """Smooth channels, texture and noise: an NDVI over many values."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 110 + 70 * np.sin(xx / 11.0) + 40 * np.cos(yy / 9.0)
    img = np.stack([base, 0.8 * base + 20, 1.3 * base - 30], axis=-1)
    return np.clip(img + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def write(path: Path, arr: np.ndarray) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)
    return path


def pixels(path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img)


def run_both(capsys, *argv):
    """(port rc, port stdout), (JAX rc, JAX stdout) of one command line."""
    rc_t = tcli.main(["--device", "cpu", *argv])
    out_t = capsys.readouterr().out
    rc_j = jcli.main(list(argv))
    out_j = capsys.readouterr().out
    return (rc_t, out_t), (rc_j, out_j)


def run_both_outputs(capsys, tmp_path, *argv):
    """As run_both, with the output paths (``Path``s named ``out*``) put
    under ``t/`` for the port and ``j/`` for the JAX package."""
    def under(pkg):
        return [str(tmp_path / pkg / a.name) if isinstance(a, Path) and a.name.startswith("out")
                else str(a) for a in argv]

    rc_t = tcli.main(["--device", "cpu", *under("t")])
    out_t = capsys.readouterr().out
    rc_j = jcli.main(under("j"))
    out_j = capsys.readouterr().out
    return (rc_t, out_t), (rc_j, out_j)


def same_stat(key: str, got: float, want: float) -> None:
    if key.startswith("Mean") or key in ("diff_mean", "mean_ndvi"):
        assert abs(got - want) <= MEAN_ATOL, (key, got, want)
    elif key in ("diff_std", "std_ndvi"):
        assert abs(got ** 2 - want ** 2) <= 1e-4, (key, got, want)
    elif "Coverage" in key or key == "vegetation_coverage":
        assert abs(got - want) <= COVERAGE_RTOL * abs(want), (key, got, want)
    else:
        assert got == want, (key, got, want)


def same_stats(got, want) -> None:
    """Nested dicts of statistics, the same keys in the same order."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            if isinstance(want[k], (dict, list)):
                same_stats(got[k], want[k])
            else:
                same_stat(k, got[k], want[k])
    else:
        assert got == want


def same_tree(a: Path, b: Path) -> None:
    """Two output trees: the same files, images pixel-equal."""
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    assert names
    for n in names:
        if n.endswith((".png", ".tif", ".jpg")):
            np.testing.assert_array_equal(pixels(a / n), pixels(b / n), err_msg=n)


@pytest.fixture
def frames(tmp_path):
    """Three 48 x 64 fields; the third the first moved by (2, -1)."""
    f0 = field(48, 64, 1)
    return [write(tmp_path / "in" / "f0.png", f0),
            write(tmp_path / "in" / "f1.png", field(48, 64, 2)),
            write(tmp_path / "in" / "f2.png", np.roll(f0, (2, -1), axis=(0, 1)))]


# --- analysis --------------------------------------------------------------------------

@pytest.mark.parametrize("indices", ["", "NDVI,NDWI"])
def test_analyze_matches_jax(tmp_path, capsys, frames, indices):
    (rc_t, t), (rc_j, j) = run_both_outputs(capsys, tmp_path, "analyze", frames[0],
                                            "--indices", indices, "--out", Path("out"))
    assert rc_t == rc_j == 0
    same_stats(json.loads(t), json.loads(j))
    same_tree(tmp_path / "t" / "out", tmp_path / "j" / "out")


def test_compare_matches_jax(tmp_path, capsys, frames):
    pytest.importorskip("matplotlib")
    (rc_t, t), (rc_j, j) = run_both_outputs(capsys, tmp_path, "compare", *frames[:2],
                                            "--indices", "NDVI,GNDVI", "--out", Path("out"))
    assert rc_t == rc_j == 0
    same_stats(json.loads(t), json.loads(j))
    same_tree(tmp_path / "t" / "out", tmp_path / "j" / "out")


def port_change_summary(early: Path, late: Path, upsample: int) -> dict:
    """The JSON of the port's ``change`` from its library calls on the
    CPU: the frames white-balanced, then ``change_detection``."""
    from rgnir_torch.io.decode import decode_file
    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.pipeline.change import change_detection
    from rgnir_torch.pipeline.fused import as_image

    cpu = torch.device("cpu")
    wb = [analyze_image_kernel(as_image(decode_file(str(p)), cpu), kinds=()).wb
          for p in (early, late)]
    res = change_detection(*wb, "NDVI", with_figure=False, upsample_factor=upsample,
                           device=cpu)
    return {"shift": [float(s) for s in res["shift"]],
            "diff_mean": float(np.asarray(res["diff"]).mean()),
            "diff_min": float(res["diff"].min()), "diff_max": float(res["diff"].max())}


@pytest.mark.parametrize("options", [
    (), ("--upsample", "4"), ("--full-res",), ("--full-res", "--refine-tile", "16"),
], ids=["downscaled", "subpixel", "full-res", "full-res-tiles"])
def test_change_matches_jax(tmp_path, capsys, frames, options, monkeypatch):
    """The port's --full-res on eight CPU shards, the JAX package's on its
    eight virtual devices; the rigid paths also equal the port's library
    calls bit for bit."""
    from rgnir_torch.parallel import make_mesh

    cpu = torch.device("cpu")
    monkeypatch.setattr(tcli, "_mesh", lambda device: make_mesh((8,), ("d",),
                                                                devices=[cpu] * 8))
    rc_t = tcli.main(["--device", "cpu", "change", str(frames[0]), str(frames[2]), *options])
    t = json.loads(capsys.readouterr().out)
    rc_j = jcli.main(["change", str(frames[0]), str(frames[2]), *options])
    j = json.loads(capsys.readouterr().out)
    assert rc_t == rc_j == 0
    if "--full-res" not in options:
        upsample = int(options[1]) if options else 1
        assert t == port_change_summary(frames[0], frames[2], upsample)
    if "--upsample" in options:
        np.testing.assert_allclose(t.pop("shift"), j.pop("shift"), atol=1e-5)
        for k in t:
            assert abs(t[k] - j[k]) <= 0.3, k  # the JAX warp moves border pixels (ROADMAP)
    else:
        same_stats(t, j)
    if "--full-res" in options:
        assert t["shift"] == [-2.0, 1.0]


@pytest.mark.parametrize("options", [(), ("--streamed", "--band-rows", "16"),
                                     ("--streamed", "--band-rows", "16", "--reduce", "host")],
                         ids=["sharded", "streamed", "streamed-host"])
def test_mosaic_matches_jax(tmp_path, capsys, options):
    src = write(tmp_path / "mosaic.png", field(50, 70, 3))
    out = () if options else ("--out", Path("out"))
    (rc_t, t), (rc_j, j) = run_both_outputs(capsys, tmp_path, "mosaic", src,
                                            "--indices", "NDVI,GNDVI", *options, *out)
    assert rc_t == rc_j == 0
    same_stats(json.loads(t), json.loads(j))
    if out:
        same_tree(tmp_path / "t" / "out", tmp_path / "j" / "out")


def test_mosaic_reduce_host_needs_streamed(tmp_path):
    src = write(tmp_path / "mosaic.png", field(8, 8, 3))
    for main, argv in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit, match="requires --streamed"):
            main([*argv, "mosaic", str(src), "--reduce", "host"])


def test_report_matches_jax(tmp_path, capsys, frames):
    pytest.importorskip("matplotlib")
    (rc_t, t), (rc_j, j) = run_both_outputs(capsys, tmp_path, "report", frames[1], Path("out"))
    assert rc_t == rc_j == 0

    def parse(text):
        return dict((k, float(v)) for k, v in re.findall(r"^(\w+): (\S+)$", text, re.M))

    got, want = parse(t), parse(j)
    assert list(got) == list(want) and len(got) == 6
    for k in want:  # printed to four decimals
        assert abs(got[k] - want[k]) <= (1e-4 if k in ("mean_ndvi", "std_ndvi") else 0), k
    assert sorted(p.name for p in (tmp_path / "t" / "out").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j" / "out").iterdir())


@pytest.mark.parametrize("method", ["percentile", "gray_world"])
def test_rgn_matches_jax(tmp_path, capsys, frames, method):
    (rc_t, _), (rc_j, _) = run_both_outputs(capsys, tmp_path, "rgn", frames[0], "--out",
                                            Path("out.png"), "--method", method)
    assert rc_t == rc_j == 0
    np.testing.assert_array_equal(pixels(tmp_path / "t" / "out.png"),
                                  pixels(tmp_path / "j" / "out.png"))


def test_rgn_needs_an_output(frames, capsys):
    assert tcli.main(["--device", "cpu", "rgn", str(frames[0])]) == 2


@pytest.mark.parametrize("command, options", [
    ("batch", ("--wb", "--indices", "NDVI,NDWI")),
    ("watch", ("--indices", "NDVI", "--interval", "0", "--max-idle", "1")),
])
def test_batch_and_watch_match_jax(tmp_path, capsys, frames, command, options):
    (tmp_path / "in" / "bad.png").write_bytes(b"not an image")
    (rc_t, t), (rc_j, j) = run_both_outputs(capsys, tmp_path, command, tmp_path / "in",
                                            Path("out"), *options)
    assert rc_t == rc_j == 1  # the bad file failed in both
    got, want = json.loads(t.strip().splitlines()[-1]), json.loads(j.strip().splitlines()[-1])
    assert got == want
    # the manifests name their paths; the images are compared
    for d in (tmp_path / "t" / "out", tmp_path / "j" / "out"):
        for p in d.rglob("*manifest*"):
            p.unlink()
    same_tree(tmp_path / "t" / "out", tmp_path / "j" / "out")


# --- store and sites -------------------------------------------------------------------

def without_ids(text: str) -> str:
    """Command output with ids and dates masked."""
    text = re.sub(r"\b[0-9a-f]{24,32}\b", "ID", text)
    return re.sub(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}", "DATE", text)


def store_session(main, argv, root_args, frames, capsys):
    """One store and sites session; returns the outputs, ids masked, and
    the time series' table."""
    def run(*a, rc=0):
        assert main([*argv, *a, *root_args]) == rc
        return capsys.readouterr().out

    outs = [run("store", "upload", *map(str, frames), str(frames[0]))]
    outs.append(run("store", "list", "--per-page", "2"))
    outs.append(run("sites", "create", "--name", "Field A", "--lat", "1.5", "--lng", "2.5"))
    site = re.search(r"created site (\S+):", outs[-1]).group(1)
    ids = re.findall(r"stored \S+ -> (\S+)", outs[0])
    for i in ids:
        outs.append(run("sites", "assign", "--image-id", i, "--site-id", site))
    outs.append(run("sites", "list"))
    table = run("sites", "timeseries", "--site-id", site, "--index", "ndvi")
    outs.append(run("store", "remove", "--id", ids[0]))
    outs.append(run("store", "remove", "--id", ids[0], rc=1))
    outs.append(run("store", "dedupe"))
    return [without_ids(o) for o in outs], table


def same_table(got: str, want: str) -> None:
    """Printed time-series tables: the same days and columns, the means
    within the contract, everything else but the times of day exact."""
    g, w = got.split("\n"), want.split("\n")
    assert g[0].split() == w[0].split() and len(g) == len(w)
    mean_col = w[0].split().index("Mean") + 1  # the Date column prints as two words
    for a, b in zip(g[1:], w[1:]):
        fa, fb = a.split(), b.split()
        assert len(fa) == len(fb)
        for i, (x, y) in enumerate(zip(fa, fb)):
            if i == mean_col:
                assert abs(float(x) - float(y)) <= MEAN_ATOL + 5e-7, (x, y)
            elif i != 1:  # the upload's time of day differs between the sessions
                assert x == y


@pytest.mark.parametrize("backend", ["fs", "mongo"])
def test_store_and_sites_match_jax(tmp_path, capsys, frames, backend):
    if backend == "fs":
        tgot, ttable = store_session(tcli.main, ["--device", "cpu"],
                                     ["--root", str(tmp_path / "ts")], frames, capsys)
        jgot, jtable = store_session(jcli.main, [], ["--root", str(tmp_path / "js")], frames,
                                     capsys)
    else:
        tfake_mongo.reset()
        jfake_mongo.reset()
        with tfake_mongo.installed():
            tgot, ttable = store_session(tcli.main, ["--device", "cpu"],
                                         ["--mongo", "mongodb://fake-cli"], frames, capsys)
        jgot, jtable = store_session(jcli.main, [], ["--mongo", "mongodb://fake-cli"], frames,
                                     capsys)
    assert tgot == jgot
    assert "duplicate skipped: f0.png" in tgot[0]
    same_table(ttable, jtable)


def test_a_store_written_by_one_cli_is_listed_by_the_other(tmp_path, capsys, frames):
    root = ["--root", str(tmp_path / "s")]
    assert jcli.main(["store", "upload", *map(str, frames), *root]) == 0
    assert tcli.main(["--device", "cpu", "store", "upload", str(frames[1]), *root]) == 0
    capsys.readouterr()
    assert tcli.main(["--device", "cpu", "store", "list", *root]) == 0
    t = capsys.readouterr().out
    assert jcli.main(["store", "list", *root]) == 0
    assert t == capsys.readouterr().out
    assert t.startswith("total: 3") and "duplicate" not in t


# --- bench, selftest, warmup, tune, the device ----------------------------------------

def test_bench_prints_the_jax_keys(capsys):
    argv = ["bench", "--batch", "1", "--size", "32", "--iters", "1", "--reps", "2"]
    (rc_t, t), (rc_j, j) = run_both(capsys, *argv)
    assert rc_t == rc_j == 0
    got, want = json.loads(t), json.loads(j)
    assert list(got) == list(want)
    assert got["device"] == "cpu" and got["ms_per_step"] > 0
    for k in ("batch", "size", "kinds", "renders"):
        assert got[k] == want[k]


def test_selftest_passes_on_the_cpu(capsys):
    assert tcli.main(["--device", "cpu", "selftest"]) == 0
    assert '"result": "PASS"' in capsys.readouterr().out


@pytest.mark.parametrize("built, rc", [({"framering": False, "jointhist": False,
                                          "imgio": None}, 0),
                                         ({"framering": False, "jointhist": True,
                                           "imgio": None}, 1)],
                         ids=["warm", "stale"])
@pytest.mark.parametrize("check", [False, True])
def test_warmup_check(monkeypatch, capsys, built, rc, check):
    """--check fails when a library had to be built; a plain warmup does not."""
    from rgnir_torch.utils import compile_cache

    calls = []
    monkeypatch.setattr(compile_cache, "build_libraries", lambda cuda: calls.append(cuda) or built)
    monkeypatch.setattr(tcli, "WARMUP_SHAPES", (((2, 8, 8, 3), ("NDVI",)),))
    got = tcli.main(["--device", "cpu", "warmup", *(["--check"] if check else [])])
    assert got == (rc if check else 0)
    assert calls == [False]
    out = json.loads(capsys.readouterr().out)
    assert out["new_libraries"] == sorted(k for k, v in built.items() if v)
    assert out["unavailable"] == ["imgio"] and out["warmed"] == ["pipeline(2, 8, 8, 3)"]


def test_warmup_prune_and_check_exclude_each_other(capsys):
    assert tcli.main(["--device", "cpu", "warmup", "--prune", "--check"]) == 2


def test_warmup_prune_removes_stale_libraries(tmp_path, monkeypatch):
    from rgnir_torch.native import _build as native_build
    from rgnir_torch.utils import compile_cache

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    current = compile_cache.current_libraries(cuda=False)
    for p in current + [tmp_path / "libframering_0123456789abcdef.so",
                        tmp_path / "libframering_0123456789abcdef.log"]:
        p.write_bytes(b"")
    gone = compile_cache.prune(cuda=False)
    assert sorted(p.name for p in gone) == ["libframering_0123456789abcdef.log",
                                            "libframering_0123456789abcdef.so"]
    assert all(p.exists() for p in current)


def test_tune_needs_the_card():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tcli.main(["--device", "cpu", "tune", "--sizes", "16"])


def test_the_default_device_is_the_card(monkeypatch, frames):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["analyze", str(frames[0])], ["store", "list"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)


def test_define_index_matches_jax(monkeypatch, capsys, frames):
    import rgnir_torch.config
    import rgnir_tpu.config

    for mod in (rgnir_torch.config, rgnir_tpu.config):
        monkeypatch.setattr(mod, "_CUSTOM_INDICES", dict(mod._CUSTOM_INDICES))
    (rc_t, t), (rc_j, j) = run_both(capsys, "--define-index", "CLIIDX:2,1:0.1:RdYlBu:Canopy",
                                    "analyze", str(frames[0]), "--indices", "CLIIDX")
    assert rc_t == rc_j == 0
    got, want = json.loads(t), json.loads(j)
    assert "Canopy Coverage (%)" in got["CLIIDX"]
    same_stats(got, want)
