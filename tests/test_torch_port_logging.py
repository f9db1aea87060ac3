"""The port's per-step logs, TensorBoard curves and profiler trace (A18).

  * utils/tensorboard.py writes event records byte-equal to the JAX
    package's for the same scalars at a fixed wall time, and each package
    reads the other's file;
  * ``MetricLogger.log_every`` prints JAX's lines (a fixed clock);
  * ``profiling.StepTrace`` writes a Chrome trace of loop iterations 3-6
    with the ``annotate`` spans in it, and ``trace`` one of its block;
    ``sync`` and ``StepTimer`` work on the CPU;
  * ``runners/common``'s writer writes on rank 0 only, and the train
    scalars every ``log_freq`` steps.  The runners' flags on the CPU are
    held in tests/test_torch_port_runner.py (``--tb_dir`` against JAX's)
    and tests/test_torch_port_ext.py (both flags).
"""
import json
import os
import time

import numpy as np
import torch

from hnd_ghnd_tpu.utils import logging as jax_logging
from hnd_ghnd_tpu.utils import tensorboard as jax_tb
from hnd_ghnd_tpu_torch.runners import ext_runner
from hnd_ghnd_tpu_torch.utils import logging as port_logging
from hnd_ghnd_tpu_torch.utils import profiling
from hnd_ghnd_tpu_torch.utils import tensorboard as port_tb
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

SCALARS = [("train/loss", 1234.5678, 0), ("train/layer1", 1e-7, 0),
           ("train/loss", float("inf"), 1000), ("val/map", 0.25, 3),
           ("train/ünïcode", -2.5, 2 ** 40)]


def _write(module, log_dir, monkeypatch):
    clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.125))
    monkeypatch.setattr(module.time, "time", lambda: float(next(clock)))
    with module.SummaryWriter(str(log_dir)) as w:
        for tag, value, step in SCALARS:
            w.add_scalar(tag, value, step)
    return w.path


def test_event_records_byte_equal_to_jax(tmp_path, monkeypatch):
    got = _write(port_tb, tmp_path / "port", monkeypatch)
    want = _write(jax_tb, tmp_path / "jax", monkeypatch)
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    read = [(t, v, s) for t, v, s in port_tb.read_scalars(want)]
    assert read == jax_tb.read_scalars(got)
    assert [(t, s) for t, _, s in read] == [(t, s) for t, _, s in SCALARS]
    np.testing.assert_array_equal(
        [v for _, v, _ in read], np.float32([v for _, v, _ in SCALARS]))


def test_no_dir_writes_nothing(tmp_path):
    w = port_tb.SummaryWriter(None)
    w.add_scalar("x", 1.0, 0)
    w.close()
    assert w.path is None and not os.listdir(tmp_path)


def test_log_every_prints_jax_lines(monkeypatch, capsys):
    def run(module):
        clock = iter(np.arange(0.0, 1000.0, 0.75))
        monkeypatch.setattr(module.time, "time", lambda: float(next(clock)))
        logger = module.MetricLogger()
        for i in module.MetricLogger.log_every(logger, range(7), 3, "Epoch"):
            logger.update(loss=10.0 - i, layer1=i * 0.5)
        return capsys.readouterr().out

    got = run(port_logging)
    assert got == run(jax_logging)
    assert got.count("Epoch [") == 3 and "Total time" in got


def _loop(trace, n):
    x = torch.ones(64, 64)
    for i in range(n):
        trace.before()
        with profiling.annotate(f"iteration_{i + 1}"):
            x = torch.tanh(x @ x * 1e-3)
        trace.after()
    return x


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_step_trace_writes_iterations_3_to_6(tmp_path, capsys):
    trace = profiling.StepTrace(str(tmp_path))
    _loop(trace, 9)
    trace.close()
    (path,) = profiling.trace_files(str(tmp_path))
    names = _names(path)
    assert {f"iteration_{i}" for i in range(3, 7)} <= names
    assert not names & {"iteration_2", "iteration_7"}
    assert "iterations 3-6" in capsys.readouterr().out


def test_step_trace_closes_a_short_run_and_none_is_a_no_op(tmp_path):
    trace = profiling.StepTrace(str(tmp_path / "short"))
    _loop(trace, 4)
    trace.close()
    (path,) = profiling.trace_files(str(tmp_path / "short"))
    assert {"iteration_3", "iteration_4"} <= _names(path)
    off = profiling.StepTrace(None)
    _loop(off, 8)
    off.close()
    with profiling.trace(str(tmp_path / "block")):
        with profiling.annotate("block_span"):
            torch.ones(8).sum()
    (path,) = profiling.trace_files(str(tmp_path / "block"))
    assert "block_span" in _names(path)


def test_sync_and_step_timer_on_the_cpu():
    profiling.sync({"a": [torch.ones(2)], "b": 1})
    profiling.sync(None)
    timer = profiling.StepTimer(skip_first=1)
    for _ in range(3):
        timer.start()
        time.sleep(0.001)
        timer.stop(torch.ones(1))
    summary = timer.summary()
    assert summary["steps"] == 2 and summary["mean_s"] > 0


def test_summary_writer_only_on_rank_zero(monkeypatch, tmp_path):
    from hnd_ghnd_tpu_torch.parallel import multihost
    from hnd_ghnd_tpu_torch.runners import common
    args = ext_runner.get_argparser().parse_args(
        ["--config", "x.yaml", "--tb_dir", str(tmp_path / "tb")])
    monkeypatch.setattr(multihost, "is_main_process", lambda: False)
    with common.summary_writer(args) as w:
        w.add_scalar("train/loss", 1.0, 0)
    assert w.path is None and not (tmp_path / "tb").exists()
    monkeypatch.setattr(multihost, "is_main_process", lambda: True)
    with common.summary_writer(args) as w:
        common.log_train_scalars(w, (4, 2.0, {"a": 3.0}, None), 2)
        common.log_train_scalars(w, (5, 2.0, {"a": 3.0}, None), 2)
    assert port_tb.read_scalars(w.path) == [("train/loss", 2.0, 4),
                                            ("train/a", 3.0, 4)]
