"""The port's debugging, plotting and trace-reading helpers:
``utils/debug.py``, ``utils/viz.py`` and ``profiling/analyze.py``.

* ``checked`` raises on a NaN or inf in any floating-point tensor of the
  wrapped function's result (nested in tuples, dicts, named tuples) and
  passes a clean function's result through, as JAX's ``checked`` does in
  ``tests/test_debug_multihost.py``; ``enable_nan_debugging`` turns
  autograd's anomaly mode on (a backward that makes a NaN raises) and off.
* ``plot_losses`` and ``plot_output_ground_truth`` write their files.
* ``analyze`` reads a CPU ``torch.profiler`` chrome trace of a tiny train
  step (the CPU operators' self times: no time counted twice, so their sum
  is within the trace's window) and a hand-made device trace, plain and
  gzipped: kernel time and counts by name, and the device-busy share of the
  window with overlapping kernels counted once.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from avr_tpu_torch.profiling import analyze
from avr_tpu_torch.renderers.base import RenderOutput
from avr_tpu_torch.utils.debug import checked, enable_nan_debugging
from avr_tpu_torch.utils.viz import plot_losses, plot_output_ground_truth

torch.set_num_threads(2)


def test_checked_raises_on_nan():
    def bad(x):
        return torch.log(x) / torch.sum(x - x)  # 0/0 -> nan

    with pytest.raises(FloatingPointError, match="non-finite"):
        checked(bad)(torch.ones(4))


@pytest.mark.parametrize("where", ["tuple", "dict", "namedtuple"])
def test_checked_finds_nested_infs(where):
    good, inf = torch.ones(3), torch.tensor([1.0, float("inf")])
    out = {"tuple": (good, (good, inf)), "dict": {"loss": good, "grad": {"w": inf}},
           "namedtuple": RenderOutput(good, None, inf, good)}[where]
    with pytest.raises(FloatingPointError, match="non-finite"):
        checked(lambda: out)()


def test_checked_passes_clean_fn():
    f = checked(lambda x: (x * 2, {"n": torch.arange(3)}, None))
    y, aux, none = f(torch.ones(3))
    torch.testing.assert_close(y, torch.full((3,), 2.0))
    assert aux["n"].tolist() == [0, 1, 2] and none is None


def test_enable_nan_debugging():
    before = torch.is_anomaly_enabled()
    x = torch.zeros(2, requires_grad=True)
    try:
        enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
        enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_plot_losses_writes_its_file(tmp_path):
    path = str(tmp_path / "losses.png")
    assert plot_losses([0.5, 0.4, 0.35], 3, path) == path
    assert os.path.getsize(path) > 0


def test_plot_output_ground_truth_writes_its_file(tmp_path):
    rng = np.random.default_rng(0)
    out = RenderOutput(*(torch.from_numpy(rng.uniform(size=(1, 64, c)).astype(np.float32))
                         for c in (3, 3, 1, 1)))
    gt = rng.uniform(size=(1, 64, 3))
    path = str(tmp_path / "panels.png")
    assert plot_output_ground_truth(out, gt, (8, 8, 3), save_path=path) == path
    assert os.path.getsize(path) > 0


def _tiny_step_trace(path):
    """A CPU chrome trace of one tiny adaptive train step."""
    from torch.profiler import ProfilerActivity, profile

    from avr_tpu_torch.config import parse_conf_string
    from avr_tpu_torch.models.wrapper import make_model
    from avr_tpu_torch.training import (LossParams, create_train_state, make_optimizer,
                                        make_train_step)
    from tests.test_torch_rules import ROOT, TINY

    model = make_model(parse_conf_string(TINY, base_dir=str(ROOT / "conf")),
                       dtype=torch.float32, seed=1, device="cpu")
    opt = make_optimizer(1e-3)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    c2w = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    c2w[2, 3] = 1.3
    K = np.asarray([[1.09375, 0, 0.5], [0, 1.09375, 0.5], [0, 0, 1]], np.float32)
    batch = (t(rng.uniform(-1, 1, (1, 1, 16, 16, 3))), t(c2w[None, None]), 17.5, t([8.0, 8.0]),
             dict(x_pix=t(rng.uniform(0.1, 0.9, (1, 8, 2))),
                  cam2world=t(np.broadcast_to(c2w, (1, 8, 4, 4))), intrinsics=t(K[None])),
             t(rng.uniform(size=(1, 8, 3))))
    step = make_train_step(model, opt, LossParams())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(create_train_state(model, opt), *batch, (0, 1))
    prof.export_chrome_trace(str(path))


def test_analyze_reads_a_cpu_trace_of_a_tiny_step(tmp_path, capsys):
    _tiny_step_trace(tmp_path / "step.pt.trace.json")
    rows = analyze.op_breakdown(str(tmp_path))
    names = [r[0] for r in rows]
    assert len(set(names)) == len(names) and "aten::mm" in names
    assert all(us >= 0 and n >= 1 for _, us, n in rows)
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    b = analyze.busy_share(str(tmp_path))
    assert b["busy_us"] is None and b["share"] is None and b["device_events"] == 0
    # self times: nothing counted twice, so they fit in the window
    assert 0 < sum(r[1] for r in rows) <= b["window_us"] * 1.0001
    analyze.main([str(tmp_path), "5"])
    out = capsys.readouterr().out
    assert "no device lane" in out and len(out.splitlines()) == 1 + 5 + 1 + 1


def _device_trace():
    ev = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1,
                                         tid=7)
    return {"traceEvents": [
        ev("cpu_op", "aten::mm", 0.0, 100.0),
        ev("kernel", "gemm_kernel", 10.0, 20.0),
        ev("kernel", "gemm_kernel", 40.0, 20.0),
        ev("kernel", "relu_kernel", 50.0, 30.0),  # overlaps the second gemm
        ev("gpu_memcpy", "Memcpy DtoH", 90.0, 10.0),
        ev("Trace", "PyTorch Profiler (0)", -50.0, 500.0),  # not part of the window
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
    ]}


@pytest.mark.parametrize("gz", [False, True])
def test_analyze_reads_a_device_trace(tmp_path, gz):
    path = tmp_path / ("t.json.gz" if gz else "t.json")
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        json.dump(_device_trace(), f)
    assert analyze.op_breakdown(str(tmp_path)) == [
        ("gemm_kernel", 40.0, 2), ("relu_kernel", 30.0, 1), ("Memcpy DtoH", 10.0, 1)]
    b = analyze.busy_share(str(path))
    # busy: [10, 30] + [40, 80] + [90, 100] = 70 of the 100 us window
    assert b == dict(window_us=100.0, busy_us=70.0, share=0.7, device_events=4)


def test_analyze_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="chrome trace"):
        analyze.op_breakdown(str(tmp_path))
