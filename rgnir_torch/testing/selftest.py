"""Kernel self-test: every kernel of the port on the device, against its
plain version or numpy, at awkward (unaligned, ragged) shapes.

    python -m rgnir_torch.testing.selftest

Run it on a new card, after an upgrade of the CUDA stack, or after any
kernel edit. It builds the kernels (at first use), prints one JSON line
per check and a final ``{"result": "PASS" | "FAIL", "failures": [...]}``,
and exits 1 on any failure. It runs on CUDA; ``main(device="cpu")`` runs
the same checks through the plain versions, the sharded change detection
of section 5 on four CPU shards. Counterpart: sections 1-5 of
``rgnir_tpu/testing/selftest.py``; its render-mode checks have no
counterpart (the port has one render path).
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional, Union

import numpy as np
import torch


def main(device: Optional[Union[str, torch.device]] = None) -> int:
    from rgnir_torch.kernels.hist import channel_histograms, histograms_plain
    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.kernels.select import masked_median, radix_order_statistic
    from rgnir_torch.pipeline.fused import analyze_image, resolve_device

    dev = resolve_device(device)
    failures: List[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        print(json.dumps({"check": name, "ok": bool(ok), "detail": detail}), flush=True)
        if not ok:
            failures.append(name)

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def same(a: torch.Tensor, b: torch.Tensor) -> bool:
        return a.shape == b.shape and bool(torch.equal(a, b))

    def near(a: torch.Tensor, b: torch.Tensor, atol: float) -> bool:
        return bool(((a.double() - b.double()).abs() <= atol).all())

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": str(dev), "name": name}), flush=True)
    rng = np.random.default_rng(7)

    # 1. histogram kernel, unaligned shape
    img = on_dev(rng.integers(0, 256, (307, 450, 3), dtype=np.uint8))
    check("hist_unaligned", same(channel_histograms(img), histograms_plain(img)))

    # 2. the kernel path against the plain path: one frame, two kinds
    hwc = on_dev(rng.integers(0, 256, (301, 517, 3), dtype=np.uint8))
    rk = analyze_image_kernel(hwc, kinds=("NDVI", "NDWI"))
    rp = analyze_image(hwc, kinds=("NDVI", "NDWI"), device=dev)
    for kind in ("NDVI", "NDWI"):
        sk, sp = rk.stats[kind], rp.stats[kind]
        check(f"fused_{kind}",
              same(sk.histogram, sp.histogram) and same(sk.median, sp.median)
              and near(sk.mean, sp.mean, 1e-6)
              and same(rk.renders[kind], rp.renders[kind]))
    check("fused_wb_bytes", same(rk.wb, rp.wb))

    # 2a. a frame whose pixel count fills whole 1024-element rows
    hwc_a = on_dev(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8))
    rka = analyze_image_kernel(hwc_a, kinds=("NDVI",))
    rpa = analyze_image(hwc_a, kinds=("NDVI",), device=dev)
    check("fused_aligned_allvalid",
          same(rka.stats["NDVI"].median, rpa.stats["NDVI"].median)
          and near(rka.stats["NDVI"].mean, rpa.stats["NDVI"].mean, 1e-6)
          and same(rka.renders["NDVI"], rpa.renders["NDVI"]))

    # 2b. a batch of three kinds: NDWI's median and variance come from
    # GNDVI's (the antipodal plan), and the outputs are split per kind
    kinds3 = ("NDVI", "GNDVI", "NDWI")
    bhwc = on_dev(rng.integers(0, 256, (3, 161, 253, 3), dtype=np.uint8))
    rbk = analyze_image_kernel(bhwc, kinds=kinds3)
    rbp = analyze_image(bhwc, kinds=kinds3, device=dev)
    check("antipodal_medians", all(
        same(rbk.stats[k].median, rbp.stats[k].median)
        and near(rbk.stats[k].std, rbp.stats[k].std, 1e-6) for k in kinds3))
    check("batched_native_assembly", same(rbk.wb, rbp.wb) and all(
        same(rbk.renders[k], rbp.renders[k])
        and same(rbk.indices[k], rbp.indices[k])
        and same(rbk.stats[k].histogram, rbp.stats[k].histogram) for k in kinds3))

    # 2c. an aligned batch against one of its frames alone (the sums go
    # through atomics in no fixed order, so the mean is held to 1e-6)
    bhwc_a = on_dev(rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8))
    rba = analyze_image_kernel(bhwc_a, kinds=kinds3)
    rba1 = analyze_image_kernel(bhwc_a[2], kinds=kinds3)
    check("batched_aligned_vs_single", all(
        same(rba.stats[k].median[2], rba1.stats[k].median)
        and near(rba.stats[k].mean[2], rba1.stats[k].mean, 1e-6) for k in kinds3)
        and same(rba.renders["NDWI"][2], rba1.renders["NDWI"]))

    # 3. the selects against numpy
    x = rng.normal(size=4999).astype(np.float32)
    check("median_odd", float(masked_median(on_dev(x), 4999)) == float(np.median(x)))
    x2 = rng.choice([-1.0, 0.0, 0.0, 0.5], size=5000).astype(np.float32)
    check("median_even_ties",
          float(masked_median(on_dev(x2), 5000)) == float(np.median(x2)))
    check("rank_select",
          float(radix_order_statistic(on_dev(x), 1234)) == float(np.sort(x)[1234]))
    # q24 select on index-like values (uint8 band pairs, heavy ties)
    av = rng.integers(0, 256, 5000).astype(np.float32)
    bv = rng.integers(0, 256, 5000).astype(np.float32)
    av[:1200] = bv[:1200] = 7.0
    vq = np.clip((av - bv) / (av + bv + np.float32(1e-10)), -1.0, 1.0).astype(np.float32)
    check("median_quantized_even",
          float(masked_median(on_dev(vq), 5000, quantized=True)) == float(np.median(vq)))
    check("median_quantized_odd",
          float(masked_median(on_dev(vq[:4999]), 4999, quantized=True))
          == float(np.median(vq[:4999])))
    # the one-pass select at 512^2, where bin counts run to thousands
    n1 = 512 * 512
    a1 = rng.integers(0, 256, (2, n1)).astype(np.float32)
    b1 = rng.integers(0, 256, (2, n1)).astype(np.float32)
    v1 = np.clip((a1 - b1) / (a1 + b1 + np.float32(1e-10)), -1.0, 1.0).astype(np.float32)
    k1 = np.minimum(np.floor((v1.astype(np.float64) + 1.0) * 2**23), 2**24 - 1).astype(np.int64)
    r0_1 = np.stack([np.bincount(r >> 16, minlength=256) for r in k1]).astype(np.int32)
    m1, _ = masked_median(
        on_dev(v1), n1, quantized=True, onepass=True, round0_hist=on_dev(r0_1),
        means=on_dev(v1.mean(axis=-1, dtype=np.float64).astype(np.float32)))
    check("median_q24_onepass_bigcounts",
          np.array_equal(m1.cpu().numpy(), np.median(v1, axis=-1).astype(np.float32)))

    # 4. the sharded mosaic's kernel bodies: a one-device mesh (ragged
    # rows exercise n_valid; the 2-D body the rectangular select), and
    # four shards on the one device, whose last block is padding
    from rgnir_torch.parallel import analyze_mosaic, make_mesh

    mosaic = on_dev(rng.integers(0, 256, (1027, 1022, 3), dtype=np.uint8))
    mesh1 = make_mesh((1,), ("d",), devices=[dev])
    mk = analyze_mosaic(mosaic, kinds=("NDVI",), mesh=mesh1, impl="kernel")
    mj = analyze_mosaic(mosaic, kinds=("NDVI",), mesh=mesh1, impl="jnp")
    check("mosaic_1d_kernel_vs_jnp",
          same(mk.stats["NDVI"].median, mj.stats["NDVI"].median)
          and same(mk.stats["NDVI"].histogram, mj.stats["NDVI"].histogram))
    m2k = analyze_mosaic(mosaic, kinds=("NDVI",), mesh=make_mesh((1, 1), ("dr", "dc"),
                                                                  devices=[dev]),
                         impl="kernel")
    check("mosaic_2d_kernel_vs_1d", same(m2k.stats["NDVI"].median, mk.stats["NDVI"].median))
    for name, shape, axes in (("mosaic_4shard_1d_vs_one_shard", (4,), ("d",)),
                              ("mosaic_2x2_vs_one_shard", (2, 2), ("dr", "dc"))):
        m4 = analyze_mosaic(mosaic, kinds=("NDVI",), mesh=make_mesh(shape, axes, devices=[dev] * 4),
                            impl="kernel")
        s4, s1 = m4.stats["NDVI"], mk.stats["NDVI"]
        check(name, same(s4.median, s1.median) and same(s4.histogram, s1.histogram)
              and same(s4.min, s1.min) and same(s4.max, s1.max)
              and near(s4.mean, s1.mean, 1e-6) and near(s4.std, s1.std, 1e-6))

    # 5. sharded change detection (the f32 sharded select in the shard
    # body): a rolled pair's shift, then the non-rigid refinement, whose
    # per-tile batched FFTs, gathered field and per-pixel field warp must
    # lock on a near-constant field equal to -roll
    from rgnir_torch.parallel import change_detection_mosaic, local_mesh

    cmesh = (local_mesh() if dev.type == "cuda"
             else make_mesh((4,), ("d",), devices=[dev] * 4))
    early = mosaic.cpu().numpy()
    late = np.roll(early, (4, -3), axis=(0, 1))
    ch = change_detection_mosaic(early, late, "NDVI", mesh=cmesh, halo=16, proxy_stride=1)
    dy, dx = (float(s) for s in ch.shift.cpu())
    check("sharded_change_shift", (dy, dx) == (-4.0, 3.0), f"shift=({dy},{dx})")
    chf = change_detection_mosaic(early, late, "NDVI", mesh=cmesh, halo=16, proxy_stride=1,
                                  local_tile=(64, 64))
    fld = chf.field.cpu().numpy()
    check("sharded_change_local_field",
          fld.shape[-1] == 2 and not bool(chf.field_saturated)
          and np.abs(fld[1:-1] - np.float32([-4.0, 3.0])).max() <= 1.0,
          f"field_range=({fld.min()},{fld.max()})")

    print(json.dumps({"result": "PASS" if not failures else "FAIL",
                      "failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
