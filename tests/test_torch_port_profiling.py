"""The port's latency instrumentation (diffusiontexturepainting_torch/utils/
profiling.py) against the JAX package's (utils/profiling.py), and the
serving model's stages.

On the CPU:
- StageTimer.summary() is the JAX table character for character for the
  same records (long names cut at 20 characters, p50 / p99 / last / n), and
  percentile_stats the JAX dict;
- stage() records wall ms under its name, nothing when disabled, and keeps
  no device records off CUDA; timed_call and device_trace;
- TorchConditionalInpainter names its stages as the JAX model does
  (brush-encode, stamp raw / stamp / stamp u8 xN, session stamp xN), with
  verbose_timing=False recording nothing.
The tests marked `cuda` skip here; on the card (`--noconftest`: this file
imports JAX only inside its CPU tests) they hold a stage's device ms against
its work, a first call that captures a CUDA graph inside a stage, replays
byte-equal to the eager function with the timer on, and a session STAMP_AT
without pixels enqueued under torch.cuda.set_sync_debug_mode("error").
"""

import os

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.utils import profiling as t_prof

torch.set_num_threads(2)

RECORDS = [
    {"brush-encode": [12.5], "stamp u8 x4": [40.25, 39.5, 41.0]},
    {"a stage with a name longer than twenty": [1.0, 2.0, 3.0, 4.0],
     "x": [0.004]},
    {"stamp x20": [float(v) for v in range(1, 201)],
     "session stamp x4": [1234.5678, 0.0]},
    {},
]
SAMPLES = [[5.0], [3.0, 1.0, 2.0], [float(v) for v in range(100, 0, -1)],
           list(np.random.default_rng(0).random(37) * 100)]


def _jax_profiling():
    from diffusiontexturepainting_tpu.utils import profiling

    return profiling


@pytest.mark.parametrize("records", RECORDS)
def test_summary_matches_jax(records):
    j_prof = _jax_profiling()
    ours, theirs = t_prof.StageTimer(), j_prof.StageTimer()
    for name, vals in records.items():
        ours.records[name].extend(vals)
        theirs.records[name].extend(vals)
    assert ours.summary() == theirs.summary()


@pytest.mark.parametrize("samples", SAMPLES)
def test_percentile_stats_match_jax(samples):
    assert t_prof.percentile_stats(samples) == \
        _jax_profiling().percentile_stats(samples)


def test_stage_records_wall_ms():
    timer = t_prof.StageTimer(device="cpu")
    for _ in range(3):
        with timer.stage("work"):
            sum(range(1000))
    with pytest.raises(RuntimeError):
        with timer.stage("failing"):
            raise RuntimeError("boom")
    assert len(timer.records["work"]) == 3 and all(
        v >= 0 for v in timer.records["work"])
    assert len(timer.records["failing"]) == 1
    assert timer.device_records() == {}
    j_prof = _jax_profiling()
    theirs = j_prof.StageTimer()
    theirs.records.update(timer.records)
    assert timer.summary() == theirs.summary()


def test_disabled_timer_records_nothing():
    timer = t_prof.StageTimer(enabled=False)
    with timer.stage("work"):
        pass
    assert dict(timer.records) == {}


def test_timed_call_and_device_trace(tmp_path):
    out, ms = t_prof.timed_call(lambda a, b: {"s": [a + b]}, torch.ones(3),
                                b=torch.ones(3))
    assert torch.equal(out["s"][0], torch.full((3,), 2.0)) and ms >= 0
    with t_prof.device_trace(str(tmp_path)) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".trace.json")


@pytest.fixture(scope="module")
def tiny_model():
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    return TorchConditionalInpainter(64, device="cpu", tiny=True)


def test_model_stages_carry_the_jax_names(tiny_model):
    m = tiny_model
    m.timer.records.clear()
    canvas = np.zeros((64, 64, 4), np.uint8)
    canvas[:16, :, 3] = 255
    m.set_brush(np.full((64, 64, 3), 0.25, np.float32))
    m.generate_raw(canvas, steps=2)
    m.generate(canvas.astype(np.float32) / 255.0, steps=3)
    m.generate_u8(canvas, steps=2)
    m.begin_session(np.zeros((128, 128, 4), np.uint8))
    assert m.stamp_at(0, 0, return_pixels=False, steps=2) is None
    m.stamp_at(10, 20, steps=2)
    m.end_session()
    assert {k: len(v) for k, v in m.timer.records.items()} == {
        "brush-encode": 1, "stamp raw x2": 1, "stamp x3": 1,
        "stamp u8 x2": 1, "session stamp x2": 2}


def test_verbose_timing_off_records_nothing():
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    m = TorchConditionalInpainter(64, device="cpu", tiny=True,
                                  verbose_timing=False)
    m.generate_u8(np.zeros((64, 64, 4), np.uint8), steps=2)
    assert dict(m.timer.records) == {}


# --- on the card ---


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_stage_device_ms_on_the_card():
    """The device table follows the wall table; a stage's device ms is the
    time of the work enqueued inside it, read without a sync in stage()."""
    _card()
    timer = t_prof.StageTimer(device="cuda")
    a = torch.randn(2048, 2048, device="cuda")
    for _ in range(3):
        with timer.stage("matmul x8"):
            for _ in range(8):
                a = (a @ a).clamp_(-1, 1)
    with timer.stage("empty"):
        pass
    dev = timer.device_records()
    assert set(dev) == {"matmul x8", "empty"} and len(dev["matmul x8"]) == 3
    assert min(dev["matmul x8"]) > max(dev["empty"])
    lines = timer.summary().splitlines()
    assert len(lines) == 2 * (3 + 2 + 1)
    assert "Stage (device)" in lines[7]


@pytest.mark.cuda
def test_capture_inside_a_stage_and_replays_with_the_timer_on():
    """A program's first call (its capture) inside a stage, then replays:
    each byte-equal to the eager function on the same input."""
    _card()
    from diffusiontexturepainting_torch import _cuda
    from diffusiontexturepainting_torch.core.engine import Engine
    from diffusiontexturepainting_torch.ops.conv3x3 import conv3x3

    _cuda.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    prog = Engine("cuda").program(("conv",),
                                  lambda x, w, b: (conv3x3(x, w, b),))
    timer = t_prof.StageTimer(device="cuda")
    w = (torch.randn((3, 3, 64, 64), generator=gen, device="cuda")
         / 24).bfloat16()
    b = torch.randn((64,), generator=gen, device="cuda").bfloat16()
    for scale in (1.0, 0.5, 3.0):
        x = (torch.randn((2, 16, 16, 64), generator=gen, device="cuda")
             * scale).bfloat16()
        with timer.stage("conv"):
            (got,) = prog(x, w, b)
        assert torch.equal(got, conv3x3(x, w, b))
    assert prog.graph is not None and prog.replays == 3
    assert len(timer.device_records()["conv"]) == 3


@pytest.mark.cuda
def test_session_stamp_without_pixels_does_not_sync_with_the_timer_on():
    _card()
    from diffusiontexturepainting_torch import _cuda
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    _cuda.build_all()
    m = TorchConditionalInpainter(256, device="cuda")
    m.begin_session(np.zeros((512, 512, 4), np.uint8))
    m.stamp_at(0, 0, return_pixels=False, steps=4)  # captures
    m.sync_session()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in (64, 128):
            assert m.stamp_at(x, 0, return_pixels=False, steps=4) is None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    m.fetch_canvas()
    assert len(m.timer.records["session stamp x4"]) == 3
    assert len(m.timer.device_records()["session stamp x4"]) == 3
