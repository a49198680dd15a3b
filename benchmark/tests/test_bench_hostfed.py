"""The rtl_sdr cell (benchmark/drivers/hostfed.py): it resolves, the
ingest metrics' counts hold to hand sums and to a synthetic trace, the
driver runs end to end at a tiny size on the CPU (the plain torch twins in
place of the kernels), and `correct` comes out false for the control and
for a feed that copies fewer bytes than due."""

import json

import numpy as np
import pytest

from benchmark import h2d, harness

CELL = "rtl6.hostfed32x16"
SEED = 2 ** 31 + 41


def metric(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def tiny_cell(name: str, e: int = 2, f: int = 2) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.traffic.update({"n_ensembles": e, "n_frames": f, "distinct": min(e, 2)})
    return cell


def run_tiny(cell, trace=False, seconds=0.0):
    return harness.driver_module(cell).run(cell, SEED, seconds, trace, "cpu", 0.0)


def test_cell_resolves():
    name = CELL
    cell = harness.load_cell(name)
    assert cell.driver == "hostfed" and cell.chips == 1
    assert cell.config["name"] == "rtl6" and cell.config["reduced"] == []
    front_end = cell.config["front_end"]
    assert front_end["format"] == "u8" and front_end["offset"] == 127.5
    assert name in cell.config["deployment"]
    assert {m["name"] for m in cell.end_to_end} == {"rtf_per_gpu", "step_ms_p95", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"span.ingest_ms", "ingest_overlap", "h2d_link_share", "carve_u8_roofline",
            "stats_u8_roofline"} <= names and "carve_roofline" not in names
    assert set(cell.limits) == {"bytes_wrong", "bytes_copied_gap", "mean_power_gap",
                                "const_rms_gap"}


def test_step_bytes():
    """201,326,592 B a step at 32 x 16 (the cell's traffic), 1,572,864 B at
    1 x 4 (the live radio's), whichever module counts them."""
    cell = harness.load_cell(CELL)
    drv = harness.driver_module(cell)
    link = metric("h2d_link_share")
    assert drv.step_bytes(cell) == 201_326_592
    cell.traffic.update({"n_ensembles": 1, "n_frames": 4})
    assert drv.step_bytes(cell) == 1_572_864
    assert link.step_bytes(1, 32, 16) == 32 * 16 * 196_608 * 2
    assert link.step_bytes(1, 1, 4) == 1_572_864


def test_h2d_link_share_hand_sum():
    """4.0 ms for a step's 201,326,592 B is 50.33 GB/s, 79.9% of 63 GB/s."""
    link = metric("h2d_link_share")
    assert link.share(201_326_592, 4.0e-3) == pytest.approx(100 * 201_326_592 / 4.0e-3 / 63e9)
    assert link.share(201_326_592, 4.0e-3) == pytest.approx(79.8915, abs=1e-3)
    cell = harness.load_cell(CELL)
    r = {"cell": cell, "steps": 20, "h2d": {"copy_s": 20 * 4.0e-3, "overlap_s": 0.0,
                                             "copies": 640, "bytes": 20 * 201_326_592}}
    assert link.read(r) == pytest.approx(79.8915, abs=1e-3)


def test_carve_u8_bound_hand_sum():
    """Mode I, 512 frames: 79,691,776 window samples; 2 B of u8 read and
    3 x 2 B of bf16 written a sample, 8,699,904 B of f32 tables: 646,234,112
    B, 0.19290 ms at 3.35 TB/s (the operations, 17 a sample, take 0.0404
    ms at 33.5e12/s)."""
    carve = metric("carve_u8_roofline")
    n = 512 * 76 * 2048
    assert n == 79_691_776
    n_bytes, ops = carve.step_bytes_ops(1, 512)
    assert n_bytes == 2 * n + 512 * (76 + 2048) * 8 + 6 * n == 646_234_112
    assert ops == 17 * n
    assert carve.step_bound_s(1, 512) == pytest.approx(646_234_112 / 3.35e12)
    trace = {"kernels": {"void (anonymous namespace)::carve_kernel<unsigned char>(unsigned "
                         "char const*, ...)": [20 * 0.25e-3, 20],
                         "void (anonymous namespace)::carve_kernel<__nv_bfloat16>(...)":
                         [1.0, 20]}}
    r = {"cell": harness.load_cell(CELL), "steps": 20, "trace": trace}
    assert carve.read(r) == pytest.approx(100 * 646_234_112 / 3.35e12 / 0.25e-3)


def test_stats_u8_bound_hand_sum():
    """Mode I, 512 frames: 100,663,296 samples x 2 B, the tap's 5,760 B of
    products and 3,840 B of output, 2,048 B of mean powers."""
    stats = metric("stats_u8_roofline")
    n_bytes, ops = stats.step_bytes_ops(1, 512)
    assert n_bytes == 512 * 196_608 * 2 + 480 * 2 * 3 * 2 + 2 * 480 * 4 + 512 * 4
    assert ops == 8 * 512 * 196_608
    trace = {"kernels": {"void (anonymous namespace)::stats_kernel<unsigned char>(...)":
                         [20 * 0.08e-3, 20]}}
    r = {"cell": harness.load_cell(CELL), "steps": 20, "trace": trace}
    assert stats.read(r) == pytest.approx(100 * n_bytes / 3.35e12 / 0.08e-3)
    assert stats.read({**r, "trace": {"kernels": {"stats_kernel<__nv_bfloat16>": [1.0, 1]}}}) \
        is None


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_ingest_overlap_synthetic_trace(tmp_path):
    """Two copies of 100 us: the first under kernels for 30 + 40 us (two
    overlapping kernels count once), the second under none; a pageable
    copy and a device-to-host copy are not counted."""
    events = [
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1000, 100, bytes=5_000_000),
        _x("kernel", "k1", 900, 130),           # 1000..1030
        _x("kernel", "k2", 1010, 10),           # inside k1
        _x("kernel", "k3", 1060, 100),          # 1060..1100 of the copy
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 2000, 100, bytes=5_000_000),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1000, 100, bytes=8),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1000, 100, bytes=8),
        _x("kernel", "k4", 3000, 50),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 2000},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = h2d.summarize(str(path))
    assert s == {"copies": 2, "copy_s": pytest.approx(200e-6), "overlap_s": pytest.approx(70e-6),
                 "bytes": 10_000_000}
    assert metric("ingest_overlap").read({"h2d": s}) == pytest.approx(35.0)
    assert h2d.summarize_events([events[1]]) is None


def test_quantise_front_end():
    """Each rail's RMS 32 LSB around 127.5, rounded and clipped."""
    drv = harness.driver_module(harness.load_cell(CELL))
    fe = harness.load_cell(CELL).config["front_end"]
    rng = np.random.default_rng(3)
    iq = (rng.standard_normal((2, 3, 4096)) + 1j * rng.standard_normal((2, 3, 4096))) * \
        np.array([0.01, 5.0])[:, None, None]
    u8 = drv.quantise(iq.astype(np.complex64), fe)
    assert u8.dtype == np.uint8 and u8.shape == (2, 3, 4096, 2)
    x = u8.astype(np.float64) - 127.5
    rms = np.sqrt((x ** 2).reshape(2, -1).mean(axis=1))
    assert np.allclose(rms, 32.0, rtol=0.01)
    big = iq.copy()
    big[0, 0, 0] = 1e3
    assert drv.quantise(big.astype(np.complex64), fe)[0, 0, 0, 0] == 255


@pytest.mark.parametrize("e, f", [(2, 2), (1, 4)], ids=["2x2", "live1x4"])
def test_driver_end_to_end(e, f):
    """At E = 2 x F = 2, and at the live radio's one ensemble x 4 frames."""
    cell = tiny_cell(CELL, e, f)
    result, checks = run_tiny(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"rtf_per_gpu", "step_ms_p95", "setup_s"}
    assert checks["bytes_wrong"][0] == 0 and checks["bytes_copied_gap"][0] == 0
    assert result["bytes_copied"] == (2 + result["attempted"]) * e * f * 2 * 196_608


def test_driver_traced(monkeypatch):
    cell = tiny_cell(CELL)
    drv = harness.driver_module(cell)
    monkeypatch.setattr(drv, "TRACED_STEPS", 1)      # the CPU twins trace slowly
    monkeypatch.setattr(drv, "GAP_STEPS", 1)
    result, checks = drv.run(cell, 5, 0.0, True, "cpu", 0.0)
    assert result["correct"] and result["steps_checked"] == result["attempted"]
    assert checks["bytes_copied_gap"][0] == 0
    assert set(result["step_ms_median"]) == {"plain", "device", "host"}
    # no device on the CPU: the device readers find nothing and are left out
    assert result["metrics"] == {} and "busy_s" not in result["device"]
    assert result["breakdown"]["idle_gaps"]


def test_control_fails():
    cell = tiny_cell(CELL)
    readings = harness.driver_module(cell).control(cell, SEED)
    assert any(v > cell.limits[k] for k, v in readings.items()), readings


def test_short_feed_fails(monkeypatch):
    """A feed that leaves out the last region once both buffers were filled:
    the IQ repeats every step, so the bytes still decode, and only
    bytes_copied tells."""
    from tpudab_torch.models.ingest import HostFeed

    feed = HostFeed.feed
    n = {"feeds": 0}

    def short(self, host):
        n["feeds"] += 1
        if n["feeds"] <= 2:
            return feed(self, host)
        i, parts = self._next, list(host)
        for row, part in zip(self.buffers[i][:-1], parts[:-1]):
            row.view(-1).copy_(part.reshape(-1))
        self.bytes_copied += sum(p.numel() for p in parts[:-1])
        self._fed.append(i)
        self._next = (i + 1) % len(self.buffers)
    monkeypatch.setattr(HostFeed, "feed", short)
    result, checks = run_tiny(tiny_cell(CELL))
    assert not result["correct"] and checks["bytes_copied_gap"][0] > 0, checks
    assert checks["bytes_wrong"][0] == 0
