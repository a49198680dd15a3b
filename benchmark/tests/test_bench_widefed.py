"""The wideband cell (benchmark/drivers/widefed.py): it resolves, its
configuration is the Band III table, the channeliser roofline's counts
hold to hand sums, the driver runs end to end at a tiny size on the CPU
(the plain torch paths in place of the kernels) loading no jax, and
`correct` comes out false for the control, for a block mixed with the
wrong offset and for a channeliser that skips a step."""

import copy
import json
import subprocess
import sys

import pytest

from benchmark import harness

CELL = "hackrf8.wide32x16"
SEED = 2 ** 31 + 43


def metric(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def tiny_cell(receivers: int = 1, blocks: int = 2, f: int = 1) -> harness.Cell:
    cell = harness.load_cell(CELL)
    cell.traffic.update({"receivers": receivers, "blocks_per_receiver": blocks,
                         "n_ensembles": receivers * blocks, "n_frames": f,
                         "distinct": min(2, receivers * blocks)})
    return cell


def run_tiny(cell, trace=False, seed=SEED):
    return harness.driver_module(cell).run(cell, seed, 0.0, trace, "cpu", 0.0)


def test_cell_resolves():
    cell = harness.load_cell(CELL)
    assert cell.driver == "widefed" and cell.chips == 1
    cfg = cell.config
    assert cfg["name"] == "hackrf8" and cfg["reduced"] == [] and CELL in cfg["deployment"]
    fe, ch = cfg["front_end"], cfg["channeliser"]
    assert fe["format"] == "s8" and fe["sample_rate_hz"] == 16_384_000 and fe["decimation"] == 8
    assert fe["centres_mhz"] == [181.0, 195.0, 209.0, 223.0] and len(fe["blocks"]) == 32
    assert (ch["taps"], ch["beta"], ch["cutoff_hz"]) == (120, 5.653, 1024000)
    tr = cell.traffic
    assert (tr["receivers"], tr["blocks_per_receiver"], tr["n_ensembles"], tr["n_frames"]) == \
        (4, 8, 32, 16)
    assert {m["name"] for m in cell.end_to_end} == {"rtf_per_gpu", "step_ms_p95", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"span.demod.ddc_ms", "ddc_roofline", "carve_roofline", "span.ingest_ms",
            "ingest_overlap", "h2d_link_share", "launches_per_step"} <= names
    assert not {"carve_u8_roofline", "stats_u8_roofline"} & names
    assert set(cell.limits) == {"bytes_wrong", "bytes_copied_gap", "ddc_samples_gap",
                                "mean_power_gap", "const_rms_gap", "ddc_gap"}


def test_plan_is_the_configurations():
    """The driver's ChannelPlan: the configuration's centres and blocks,
    each block's offset a whole kHz from its centre; a configuration that
    states taps, a decimation or a rate other than the port's is refused."""
    drv = harness.driver_module(harness.load_cell(CELL))
    plan = drv.plan(harness.load_cell(CELL))
    cell = harness.load_cell(CELL)
    for (centre, blocks), c, offs in zip(drv.receivers(cell.config, cell.traffic),
                                         plan.centres_hz, plan.offsets_hz()):
        assert centre == c
        assert [round(b - centre) for b in blocks] == [round(o) for o in offs]
    assert plan.n_ensembles == 32
    for group, key, value in (("channeliser", "taps", 96), ("front_end", "decimation", 4),
                              ("front_end", "sample_rate_hz", 8_192_000)):
        other = copy.deepcopy(cell)
        other.config[group][key] = value
        with pytest.raises(ValueError):
            drv.plan(other)


def test_step_bytes_and_samples():
    """201,326,592 s8 bytes a step (4 x 16 x 196,608 x 8 x 2): rtl6's load;
    the h2d metric's count, which reads E x F x 2 x frame_len, is the same."""
    cell = harness.load_cell(CELL)
    drv = harness.driver_module(cell)
    assert drv.samples(cell) == 16 * 196_608 * 8
    assert drv.step_bytes(cell) == 201_326_592
    assert metric("h2d_link_share").step_bytes(1, 32, 16) == 201_326_592


def test_ddc_roofline_counts():
    """4 receivers, 32 ensembles, 16 frames: 201,326,592 B of s8 read, the
    tails (1,572,983 samples a receiver) read and written, 402,653,184 B of
    bf16 frames: 629,147,504 B, 0.18781 ms at 3.35 TB/s; 8 x 120 flop a
    complex output, 96.6 GFLOP, 0.0977 ms at 989.4 TFLOP/s: bytes bound."""
    roof = metric("ddc_roofline")
    n_bytes, flops = roof.step_bytes_flops(1, 4, 32, 16, 8, 120)
    assert n_bytes == 201_326_592 + 4 * 1_572_983 * 2 * 2 + 402_653_184 == 629_147_504
    assert flops == 8 * 120 * 32 * 16 * 196_608 == 96_636_764_160
    assert roof.step_bound_s(1, 4, 32, 16, 8, 120) == pytest.approx(629_147_504 / 3.35e12)
    trace = {"kernels": {"void (anonymous namespace)::channelise_kernel(signed char const*, "
                         "long long, ...)": [20 * 0.4e-3, 20],
                         "void (anonymous namespace)::carve_kernel<__nv_bfloat16>(...)":
                         [1.0, 20]}}
    r = {"cell": harness.load_cell(CELL), "steps": 20, "trace": trace}
    assert roof.read(r) == pytest.approx(100 * 629_147_504 / 3.35e12 / 0.4e-3)
    assert roof.read({**r, "trace": {"kernels": {"carve_kernel<float>": [1.0, 1]}}}) is None
    assert roof.read({}) is None and metric("span.demod.ddc_ms").read({}) is None


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 2, 2)], ids=["1x2x1", "2x2x2"])
def test_driver_end_to_end(shape):
    cell = tiny_cell(*shape)
    result, checks = run_tiny(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1, checks
    assert set(result["metrics"]) == {"rtf_per_gpu", "step_ms_p95", "setup_s"}
    assert checks["bytes_wrong"][0] == 0 and checks["bytes_copied_gap"][0] == 0
    assert checks["ddc_samples_gap"][0] == 0
    r, _, f = shape
    assert result["bytes_copied"] == (2 + result["attempted"]) * r * 8 * f * 196_608 * 2
    assert result["ddc_calls"] == 2 + result["attempted"]


def test_driver_traced(monkeypatch):
    cell = tiny_cell()
    drv = harness.driver_module(cell)
    monkeypatch.setattr(drv, "TRACED_STEPS", 1)      # the CPU paths trace slowly
    monkeypatch.setattr(drv, "GAP_STEPS", 1)
    result, checks = drv.run(cell, 5, 0.0, True, "cpu", 0.0)
    assert result["correct"] and result["steps_checked"] == result["attempted"], checks
    assert set(result["step_ms_median"]) == {"plain", "device", "host"}
    # no device on the CPU: the device readers find nothing and are left out
    assert result["metrics"] == {} and "busy_s" not in result["device"]


def test_control_fails():
    cell = tiny_cell()
    readings = harness.driver_module(cell).control(cell, SEED)
    assert set(readings) == {"mean_power_gap", "const_rms_gap", "ddc_gap"}
    assert any(v > cell.limits[k] for k, v in readings.items()), readings


def test_wrong_offset_fails(monkeypatch):
    """The program's plan puts its first block 1 kHz off: the block is mixed
    with the wrong offset, and the check against the reference fails."""
    import numpy as np
    from tpudab_torch.ofdm.channelise import ChannelPlan

    offsets = ChannelPlan.offsets_hz

    def shifted(self):
        off = offsets(self).copy()
        off[0, 0] += 1000.0
        return off
    monkeypatch.setattr(ChannelPlan, "offsets_hz", shifted)
    assert np.all(ChannelPlan.band_iii([181e6]).offsets_khz()[0, :1] == -6071)
    result, checks = run_tiny(tiny_cell())
    assert not result["correct"] and checks["ddc_gap"][0] > cell_limit("ddc_gap"), checks


def cell_limit(key):
    return harness.load_cell(CELL).limits[key]


def test_skipped_step_fails(monkeypatch):
    """A channeliser that skips every other call after the warm-up (its
    frames buffer left as the step before wrote it, the tail as it was,
    nothing counted): the stream repeats every step, so the bytes still
    decode, and only step.ddc.samples_in tells."""
    from tpudab_torch.ofdm.channelise import Channeliser

    forward = Channeliser.forward
    n = {"calls": 0}

    def skipping(self, tail, streams, frame_offset=None):
        n["calls"] += 1
        if n["calls"] > 2 and n["calls"] % 2:
            return tail, self.out[0], self.out[1]
        return forward(self, tail, streams, frame_offset)
    monkeypatch.setattr(Channeliser, "forward", skipping)
    cell = tiny_cell(f=2)
    result, checks = harness.driver_module(cell).run(cell, SEED, 0.5, False, "cpu", 0.0)
    assert result["attempted"] >= 2
    assert not result["correct"] and checks["ddc_samples_gap"][0] > 0, checks
    assert checks["bytes_wrong"][0] == 0


def test_readback_copies_the_bytes_as_to_host():
    """Readback hands back the bytes step.py's to_host does, each output
    whole, and its buffers hold a call's bytes until the next call."""
    import numpy as np
    import torch

    drv = harness.driver_module(harness.load_cell(CELL))
    g = torch.Generator().manual_seed(7)
    outs = [{"fic_bytes": torch.randint(0, 256, (2, 12, 32), generator=g, dtype=torch.uint8),
             "subch": {sid: torch.randint(0, 256, (2, 64, 432), generator=g, dtype=torch.uint8)
                       for sid in (3, 1, 5)}} for _ in range(2)]
    readback = drv.Readback()
    for out in outs:
        fic, subch = readback(out)
        want_fic, want_subch = drv._step.to_host(out)
        assert np.array_equal(fic, want_fic) and sorted(subch) == sorted(want_subch)
        for sid, b in subch.items():
            assert np.array_equal(b, want_subch[sid])
    assert len(readback.buffers) == 4


SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.test_bench_widefed import run_tiny, tiny_cell
result, _ = run_tiny(tiny_cell())
print(json.dumps({{"correct": result["correct"],
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and "tpudab_torch" in line["modules"]
    assert not set(line["modules"]) & set(harness.REFUSED_MODULES)
