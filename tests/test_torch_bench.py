"""The port's bench (tpudab_torch/tools/bench.py) against the repo's
bench.py, on the CPU at a small size: E = 1-2 ensembles x F = 4 frames,
the Viterbi microbench on 8-32 codewords.

- the frames and payload equal bench.py's _synth_bench_frames on
  __graft_entry__._bench_subchannels(), bit for bit;
- the bf16 frames equal ml_dtypes' cast of the same tiles, bit for bit
  (both round to nearest even);
- run() passes bench.py's gate, and its first step's FIC and subchannel
  bytes equal tpudab's ReceiveStep on the same bf16 frames; its JSON
  line has bench.py's keys and, on a clock that returns set times,
  bench.py's numbers;
- the Viterbi bytes equal tpudab's viterbi_decode_bytes_best on the same
  default_rng(1) input, and its Mbit/s and spread follow bench.py's
  formulas on set times;
- main() with no card raises; a run that fails its gate prints bench.py's
  error line and exits 1.
"""

import ast
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_parsers import one_torch_thread  # noqa: F401  (autouse fixture)
from tpudab.models.step import ReceiveStep as JaxStep
from tpudab.ops.viterbi_pallas import viterbi_decode_bytes_best as jax_viterbi_bytes
from tpudab_torch.constants.ofdm_params import SAMPLING_RATE
from tpudab_torch.tools import bench
from tpudab_torch.tools.bench import bench_capture
from tpudab_torch.tools.exp_viterbi_sweep import NBITS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F = 4
FRAME_LEN = 196608


def repo_bench_keys() -> list:
    """The keys of the result dict in bench.py's main, read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no result dict")


@pytest.fixture(scope="module")
def jax_bench():
    """bench.py's own frames, payload and subchannel layout at F frames."""
    import bench as repo_bench
    from __graft_entry__ import _bench_subchannels

    subch = _bench_subchannels()
    frames, payload = repo_bench._synth_bench_frames(subch, F)
    return subch, frames, payload


def jax_bf16(step, frames, n_ens):
    """bench.py's bf16 IQ: the tiles cast by ml_dtypes, broadcast to n_ens."""
    tiled = step.tile_frames(frames.reshape(F, -1))
    re = np.ascontiguousarray(tiled.real, dtype=ml_dtypes.bfloat16)
    im = np.ascontiguousarray(tiled.imag, dtype=ml_dtypes.bfloat16)
    if n_ens > 1:
        re, im = (np.ascontiguousarray(np.broadcast_to(x, (n_ens,) + x.shape)) for x in (re, im))
    return re, im


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


class Clock:
    """time.perf_counter's stand-in: returns the given times in turn."""

    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def test_capture_equals_bench_py(jax_bench):
    _, frames, payload = jax_bench
    got_frames, got_payload = bench_capture(F)
    assert got_frames.dtype == frames.dtype
    np.testing.assert_array_equal(got_frames.view(np.uint32), frames.view(np.uint32))
    np.testing.assert_array_equal(got_payload, payload)


def test_bf16_frames_equal_ml_dtypes_cast(jax_bench):
    subch, frames, _ = jax_bench
    step, re, im, freq, payload = bench.bench_inputs(CPU, 2, F)
    want_re, want_im = jax_bf16(JaxStep(mode=1, subchannels=subch, n_ensembles=2), frames, 2)
    assert tuple(re.shape) == want_re.shape and re.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(re), bits(want_re))
    np.testing.assert_array_equal(bits(im), bits(want_im))
    assert float(freq) == 0.0


def test_run_passes_the_gate_and_equals_tpudab(jax_bench, monkeypatch):
    subch, frames, _ = jax_bench
    # step_rate: t_one 2 s -> iters = max(3, min(20, int(5 / 2))) = 3 over dt 3 s;
    # viterbi_rate: three reps of 1, 2 and 4 s
    monkeypatch.setattr(bench.time, "perf_counter",
                        Clock([0.0, 2.0, 10.0, 13.0, 20.0, 21.0, 30.0, 32.0, 40.0, 44.0]))
    line, first = bench.run(CPU, 1, F, viterbi_b=8, viterbi_iters=1)
    monkeypatch.undo()

    assert list(line) == repo_bench_keys() == list(bench.KEYS)
    samples_per_s = 3 * 1 * F * FRAME_LEN / 3.0
    rates = [8 * NBITS / dt / 1e6 for dt in (1.0, 2.0, 4.0)]
    assert line == {
        "metric": "realtime_factor_per_chip", "value": round(samples_per_s / SAMPLING_RATE, 2),
        "unit": "x_realtime_full_ensemble_decode",
        "vs_baseline": round(samples_per_s / SAMPLING_RATE, 2),
        "samples_per_s": round(samples_per_s), "viterbi_mbit_s": round(max(rates), 2),
        "viterbi_mbit_s_spread": round((max(rates) - min(rates)) / max(rates), 4),
        "device": "cpu (host times, not device times)", "n_frames_per_step": F,
        "n_ensembles_per_step": 1}

    jstep = JaxStep(mode=1, subchannels=subch, n_ensembles=1)
    re, im = jax_bf16(jstep, frames, 1)
    _, jout = jstep(jstep.init_carry(), re, im, np.float32(0.0))
    np.testing.assert_array_equal(first["fic_bytes"].numpy(), np.asarray(jout["fic_bytes"]))
    assert set(first["subch"]) == set(jout["subch"]) == {c.subch_id for c in subch}
    for sid, v in jout["subch"].items():
        np.testing.assert_array_equal(first["subch"][sid].numpy(), np.asarray(v),
                                      err_msg=f"subchannel {sid}")


def test_viterbi_rate_equals_tpudab(monkeypatch):
    b = 32
    monkeypatch.setattr(bench.time, "perf_counter", Clock([0.0, 1.0, 5.0, 7.0, 9.0, 12.0]))
    vit = bench.viterbi_rate(CPU, b, NBITS, iters=1)
    monkeypatch.undo()
    soft = np.random.default_rng(1).standard_normal((b, NBITS + 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(vit["bytes"].numpy(),
                                  np.asarray(jax_viterbi_bytes(soft, NBITS)))
    rates = [b * NBITS / dt / 1e6 for dt in (1.0, 2.0, 3.0)]
    assert vit["rates"] == pytest.approx(rates, rel=1e-12)
    assert vit["mbit_s"] == max(vit["rates"])
    assert vit["spread"] == (max(vit["rates"]) - min(vit["rates"])) / max(vit["rates"])


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_failing_run_exits_nonzero(monkeypatch, capsys):
    def wrong_payload(n_frames):
        frames, payload = bench_capture(n_frames)
        return frames, payload ^ 1
    monkeypatch.setattr(bench, "bench_capture", wrong_payload)
    monkeypatch.setenv("TPUDAB_BENCH_ENSEMBLES", "1")
    monkeypatch.setenv("TPUDAB_BENCH_FRAMES", str(F))
    with pytest.raises(SystemExit) as exit_info:
        bench.main(["--device", "cpu"])
    assert exit_info.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["metric"] == "realtime_factor_per_chip"
    assert "not the payload" in line["error"]
