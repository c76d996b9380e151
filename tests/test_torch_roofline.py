"""The port's roofline package on the CPU.

``roofline.analysis`` holds the one count of each kernel's work that
``chip_smoke.py``'s kernel rows, the pipeline report and the tests read;
these tests hold it to the formulas ``chip_smoke.py`` carried inline
before the package held them and to the bounds PERF.md's kernel table printed,
to the printed digit, at every row's shape.  ``pipeline_report`` runs
its four stages on the CPU (the plain versions, the host clock, a
calibrated ceiling), and the report renders the dry-run's records.
"""
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.roofline import analysis as ra
from repro_torch.roofline import hw
from repro_torch.roofline import report
from repro_torch.roofline.pipeline import pipeline_report, render

B, D, P, G, C = 64, 8, 4_607_872, 192, 9       # main's shapes at n = 1M
NC = 71_998                                     # rankeval's E columns


def _rank_ops(c):
    return 6 + 3 * (c - 1) + 4 + 10


# (row, work from the roofline package, the former inline bytes and flops,
#  flop rate, PERF.md's printed bound_ms)
ROWS = [
    ("1a", ra.pdist_work(B, P, D),
     (4.0 * (B * D + P * D + B * P), B * P * (2 * D + 4) + 2 * D * (B + P)),
     None, "0.3961"),
    ("1a at (64, 192)", ra.pdist_work(B, G, D),
     (4.0 * (B * D + G * D + B * G), B * G * (2 * D + 4) + 2 * D * (B + G)),
     None, None),
    ("1a-bf16", ra.pdist_work(B, P, D, point_bytes=2),
     (4.0 * B * D + 2.0 * P * D + 4.0 * B * P,
      B * P * (2 * D + 4) + 2 * D * (B + P)), None, "0.3741"),
    ("2", ra.rankeval_work(G, NC, C),
     (4.0 * (G * NC + G * C + 3 * G) + 8.0 * G * NC,
      G * NC * _rank_ops(C)), None, "0.0495"),
    ("3", ra.range_filter_work(B, P, D),
     (4.0 * (B * D + P * D + B) + B * P + 4.0 * B * (-(-P // 128)),
      B * P * (2 * D + 5) + 2 * D * (B + P)), None, "0.1348"),
    ("3-bf16", ra.range_filter_work(B, P, D, point_bytes=2),
     (4.0 * (B * D + B) + 2.0 * P * D + B * P + 4.0 * B * (-(-P // 128)),
      B * P * (2 * D + 5) + 2 * D * (B + P)), None, "0.1128"),
    ("4", ra.pdist_rankeval_work(B, G, D, C),
     (4.0 * (B * D + G * D + G * C + 3 * G + B) + 4.0 * B * G
      + 8.0 * G * B,
      2 * D * (B + G) + B * G * (2 * D + 4 + 3 + 2 * _rank_ops(C))),
     None, "0.0000493"),
    ("1b", ra.pdist_lp_work(64, 3, 148_352, D),
     (4.0 * (64 * 3 * D + 64 * 148_352 * D + 64 * 3 * 148_352),
      3.0 * D * 64 * 3 * 148_352), None, "0.1247"),
    ("1b full", ra.pdist_lp_work(1, 48, 2_373_632, D),
     (4.0 * (48 * D + 2_373_632 * D + 48 * 2_373_632),
      3.0 * D * 48 * 2_373_632), None, "0.1587"),
    ("1c", ra.pdist_lp_work(64, 3, 289_664, D),
     (4.0 * (64 * 3 * D + 64 * 289_664 * D + 64 * 3 * 289_664),
      3.0 * D * 64 * 3 * 289_664), None, "0.2435"),
    ("1c full", ra.pdist_lp_work(1, 48, 4_634_624, D),
     (4.0 * (48 * D + 4_634_624 * D + 48 * 4_634_624),
      3.0 * D * 48 * 4_634_624), None, "0.3099"),
]


@pytest.mark.parametrize("row,work,inline,rate,printed", ROWS,
                         ids=[r[0] for r in ROWS])
def test_kernel_counts_give_chip_smokes_bounds(row, work, inline, rate,
                                               printed):
    assert work == tuple(float(v) for v in inline)
    ms, by = hw.bound(*work, rate)
    ms_inline, by_inline = hw.bound(*inline, rate)
    assert (ms, by) == (ms_inline, by_inline)
    if printed is not None:
        digits = len(printed.split(".")[1])
        assert f"{ms:.{digits}f}" == printed
        assert by == "bytes"


def _flash_work_inline(b, hq, hk, d, sq, kv_len, causal, window, itemsize=2):
    """chip_smoke.py's flash_work as the script carried it inline."""
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(kv_len)[None, :]
    ok = np.ones((sq, kv_len), bool)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= qpos - kpos < window
    live = int(ok.sum())
    return (live, 4.0 * b * hq * d * live,
            float(itemsize) * (2 * b * hq * sq * d + 2 * b * hk * kv_len * d))


FLASH_ROWS = [
    ("5", (4, 32, 8, 128, 2000, 2000, True, None), "0.1326", "operations"),
    ("5-d80", (4, 32, 32, 80, 2000, 2000, True, None), "0.0829",
     "operations"),
    ("5-d112", (2, 64, 8, 112, 2000, 2000, True, None), "0.1160",
     "operations"),
    ("5-win", (2, 32, 8, 128, 6000, 6000, True, 4096), "0.5364",
     "operations"),
    ("5-enc", (4, 16, 16, 64, 2000, 2000, False, None), "0.0663",
     "operations"),
    ("5-cross", (4, 16, 16, 64, 1, 2000, False, None), "0.0098", "bytes"),
    ("5-train", (2, 32, 8, 128, 4096, 4096, True, None), "0.2780",
     "operations"),
]


@pytest.mark.parametrize("row,args,printed,by", FLASH_ROWS,
                         ids=[r[0] for r in FLASH_ROWS])
def test_flash_work_gives_chip_smokes_bounds(row, args, printed, by):
    live, flops, nbytes = ra.flash_work(*args)
    assert (live, flops, nbytes) == _flash_work_inline(*args)
    ms, got_by = hw.bound(nbytes, flops, hw.PEAK_FLOPS_BF16)
    assert f"{ms:.4f}" == printed and got_by == by


def test_knn_loop_cond_bound():
    ms, by = hw.bound(*ra.knn_loop_cond_work(64))
    assert hw.bound(64 + 4 * 3, 0) == (ms, by)
    assert f"{ms:.10f}" == "0.0000000227" and by == "bytes"


def test_ceilings_are_the_h100_data_sheet():
    assert (hw.HBM_BW, hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_BF16,
            hw.HBM_BYTES) == (3.35e12, 67e12, 989e12, 80 * 10 ** 9)
    assert hw.bound(3.35e9, 0) == (1.0, "bytes")
    assert hw.bound(0, 67e9) == (1.0, "operations")
    assert hw.bound(0, 989e9, hw.PEAK_FLOPS_BF16) == (1.0, "operations")


def test_machine_profile_calibrates_off_the_h100():
    prof = hw.machine_profile("cpu")
    assert prof["calibrated"] and not hw.is_h100_sxm("cpu")
    assert prof["peak_flops"] > 0 and prof["mem_bw"] > 0
    assert hw.machine_profile("cpu") == prof         # cached


def test_pipeline_report_quick_on_the_cpu():
    rep = pipeline_report(quick=True, device="cpu")
    assert rep["device"] == "cpu" and rep["machine"]["calibrated"]
    names = [s["stage"] for s in rep["stages"]]
    assert names == ["pdist", "rankeval", "range_filter", "fused_plan"]
    sh = rep["shapes"]
    b, d, g, p = sh["batch"], sh["d"], sh["G"], sh["n_slots"]
    by = {s["stage"]: s for s in rep["stages"]}
    assert (by["pdist"]["io_bytes"], by["pdist"]["flops"]) == \
        ra.pdist_work(b, p, d)
    assert (by["range_filter"]["io_bytes"], by["range_filter"]["flops"]) \
        == ra.range_filter_work(b, -(-p // 128) * 128, d)
    for s in rep["stages"]:
        assert s["time_us"] > 0 and np.isfinite(s["roofline_utilization"])
        assert s["bound"] in ("compute", "memory", "cache")
    text = render(rep)
    assert "| fused_plan |" in text and "pipeline (staged 3 kernels)" in text


@pytest.mark.parametrize("entry", ["machine_profile", "pipeline_report",
                                   "report_cli"])
def test_roofline_entry_points_default_to_the_card(entry, monkeypatch,
                                                   capsys):
    """Without a card and without ``device="cpu"`` nothing runs on the
    host: each entry point refuses, as ``dispatch.resolve_device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "report_cli":
        assert report.main(["--pipeline", "--quick"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
        return
    fn = hw.machine_profile if entry == "machine_profile" \
        else functools.partial(pipeline_report, quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_pipeline_report_at_a_given_snapshot_and_batch():
    """Given a snapshot and a batch, the stages run at their shapes (as
    chip_smoke's ``roof:`` does at main's), on the snapshot's device."""
    from repro_torch.core import LIMSIndex, MetricSpace
    from repro_torch.core.snapshot import LIMSSnapshot
    from repro_torch.data.datasets import gauss_mix
    rng = np.random.default_rng(0)
    X = gauss_mix(3_000, 4, seed=1)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=8, m=2, n_rings=10)
    snap = LIMSSnapshot.build(ix, device="cpu")
    Q = X[rng.choice(len(X), 5)].astype(np.float32)
    radii = np.full(5, 0.05, np.float32)
    rep = pipeline_report(snapshot=snap, queries=(Q, radii), reps=1)
    assert rep["device"] == "cpu"
    assert rep["shapes"] == {"n": 3_000, "d": 4, "batch": 5, "G": 16,
                             "n_slots": snap.n_slots}
    by = {s["stage"]: s for s in rep["stages"]}
    assert (by["pdist"]["io_bytes"], by["pdist"]["flops"]) == \
        ra.pdist_work(5, snap.n_slots, 4)
    assert (by["fused_plan"]["io_bytes"], by["fused_plan"]["flops"]) == \
        ra.pdist_rankeval_work(5, 16, 4, snap.coef.shape[-1])


def test_report_renders_dryrun_records_and_the_pipeline(tmp_path, capsys):
    from repro_torch.launch import dryrun
    out = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                        "--both-meshes", "--out", str(out)]) == 0
    recs = report.load(str(out))
    assert {r["mesh"] for r in recs} == {"16x16", "2x16x16"}
    table = report.roofline_table(recs, "16x16")
    assert "mamba2-780m" in table and "decode_32k" in table
    assert "not measured" in report.collective_summary(recs)
    assert report.main([str(out)]) == 0
    path = tmp_path / "pipe.json"
    assert report.main(["--pipeline", "--quick", "--device", "cpu",
                        "--json", str(path)]) == 0
    assert [s["stage"] for s in json.loads(path.read_text())["stages"]] \
        == ["pdist", "rankeval", "range_filter", "fused_plan"]
    assert "Roofline" in capsys.readouterr().out


def test_roofline_terms_from_the_analytic_counts():
    r = ra.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2, model_flops=989e12)
    assert (r.t_compute, r.t_memory) == (1.0, 0.5)
    assert r.bottleneck == "compute" and r.step_time_lower_bound == 1.0
    assert r.mfu_bound == 1.0
    d = r.to_dict()
    assert d["bottleneck"] == "compute" and "t_collective_s" not in d


def test_pipeline_stage_counts_match_a_cpu_tensor_run():
    """The counted outputs are the ones the wrappers write."""
    from repro_torch.kernels import ops
    q, p = torch.randn(5, 8), torch.randn(300, 8)
    nbytes, _ = ra.pdist_work(5, 300, 8)
    assert nbytes == 4.0 * (q.numel() + p.numel() + ops.pdist(q, p).numel())
    mask, cnt = ops.range_filter(q, p[:256], torch.ones(5))
    nbytes, _ = ra.range_filter_work(5, 256, 8)
    assert nbytes == 4.0 * (q.numel() + 5 + 256 * 8) + mask.numel() \
        + 4.0 * cnt.numel()
