"""``harness/phases.py`` on a hand-written Chrome trace, and the readings
that ``harness/trace.py`` (with the phases it keeps and the gaps it
labels by harness span, program span and host op) and the per-layer
metrics give on it, pinned.

The trace is one step of the int8 migrating cell, in microseconds: the
harness's spans (batch, step, loss copy) and the program's phase spans
on the main thread, ``downlink`` on autograd's thread inside
``backward``; runtime and driver launches with the kernels, copies and
set they queued; idle gaps under the program's spans and outside them;
one kernel cut by the window's end, and a flow event and a device-side
annotation that neither reader keeps.
"""
import json

import pytest

from harness import peaks, phases, session, spec, trace

CELL = "granite8b-4l.sflga-int8-cutmig-s1024"
MAIN, AUTOGRAD, STREAM = 1, 2, 7


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launched(corr, api, at, tid, cat, name, start, end):
    """A launch on the host and the device operation it queued."""
    launch_cat = "cuda_driver" if api.startswith("cu") and \
        not api.startswith("cuda") else "cuda_runtime"
    return [_x(launch_cat, api, at, 3, tid, correlation=corr),
            {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": STREAM,
             "ts": start, "dur": end - start,
             "args": {"correlation": corr, "stream": STREAM}}]


PROGRAM_SPANS = [
    _x("user_annotation", "repro_torch.client_forward", 110, 190),
    _x("user_annotation", "repro_torch.uplink", 300, 50),
    _x("user_annotation", "repro_torch.server_forward", 350, 150),
    _x("user_annotation", "repro_torch.backward", 500, 300),
    _x("user_annotation", "repro_torch.downlink", 600, 50, AUTOGRAD),
    _x("user_annotation", "repro_torch.optimizer", 800, 80),
]
HARNESS = [
    _x("user_annotation", "sflbench.traced", 0, 1000),
    _x("user_annotation", "sflbench.batch", 0, 100),
    _x("user_annotation", "sflbench.step", 100, 800),
    _x("user_annotation", "sflbench.loss_copy", 900, 100),
    _x("cpu_op", "aten::copy_", 20, 20),
    _x("cpu_op", "aten::mm", 120, 10),
    _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 520,
       270, AUTOGRAD),
    _x("cpu_op", "aten::_local_scalar_dense", 905, 85),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 2, "pid": 1,
     "tid": MAIN, "ts": 120},
    _x("gpu_user_annotation", "repro_torch.backward", 540, 250),
]
DEVICE = [
    *_launched(1, "cudaMemcpyAsync", 30, MAIN, "gpu_memcpy",
               "Memcpy HtoD (Pageable -> Device)", 40, 60),
    *_launched(2, "cuLaunchKernel", 120, MAIN, "kernel",
               "sm90_xmma_gemm_f32f32_f32f32_f32_tn", 125, 275),
    *_launched(3, "cudaLaunchKernel", 305, MAIN, "kernel",
               "quantize_warp_kernel", 305, 315),
    *_launched(4, "cudaLaunchKernel", 310, MAIN, "kernel",
               "dequant_vector_kernel", 315, 325),
    *_launched(5, "cuLaunchKernel", 360, MAIN, "kernel",
               "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128>", 360,
               480),
    *_launched(6, "cudaLaunchKernel", 520, AUTOGRAD, "kernel",
               "void at::native::elementwise_kernel<128, 2>", 540, 605),
    *_launched(7, "cudaLaunchKernel", 610, AUTOGRAD, "kernel",
               "void wave_kernel<4>(float const*)", 610, 620),
    *_launched(8, "cudaLaunchKernel", 615, AUTOGRAD, "kernel",
               "quantize_warp_kernel", 620, 625),
    *_launched(9, "cudaLaunchKernel", 620, AUTOGRAD, "kernel",
               "dequant_vector_kernel", 625, 630),
    *_launched(10, "cuLaunchKernel", 660, AUTOGRAD, "kernel",
               "sm90_xmma_gemm_f32f32_f32f32_f32_nn", 660, 790),
    *_launched(11, "cudaMemsetAsync", 805, MAIN, "gpu_memset",
               "Memset (Device)", 805, 815),
    *_launched(12, "cudaLaunchKernel", 810, MAIN, "kernel",
               "void at::native::vectorized_elementwise_kernel<4>", 815,
               870),
    *_launched(13, "cudaMemcpyAsync", 910, MAIN, "gpu_memcpy",
               "Memcpy DtoH (Device -> Pageable)", 910, 912),
    *_launched(14, "cudaLaunchKernel", 990, MAIN, "kernel",
               "void at::native::elementwise_kernel<128, 2>", 995, 1010),
]
EVENTS = HARNESS + PROGRAM_SPANS + DEVICE


class _Profile:
    """What ``trace.read`` and ``phases.events`` ask of a profiler."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_phases_exact():
    ph = phases.attribute(phases.events(_Profile(EVENTS)), steps=1)
    assert ph.busy_us == 597 and ph.window_us == 1000
    assert ph.device_us == {"client_forward": 150, "uplink": 20,
                            "server_forward": 120, "backward": 195,
                            "downlink": 20, "optimizer": 65}
    assert ph.idle_us == {"client_forward": 40, "uplink": 30,
                          "server_forward": 30, "backward": 60,
                          "downlink": 25, "optimizer": 15}
    assert ph.readings() == {"client_fwd_ms": 0.15, "server_fwd_ms": 0.12,
                             "backward_ms": 0.195, "boundary_us": 40.0,
                             "optimizer_ms": 0.065, "program_idle_ms": 0.2}
    assert ph.coverage == 570 / 597


def test_phases_per_step_and_without_program_spans():
    two = phases.attribute(EVENTS, steps=2)
    assert two.readings()["client_fwd_ms"] == 0.075
    assert two.readings()["boundary_us"] == 20.0
    bare = phases.attribute(HARNESS + DEVICE, steps=1)
    assert bare.readings() == {} and bare.device_us == {} \
        and bare.idle_us == {}
    assert bare.busy_us == 597
    with pytest.raises(RuntimeError, match="sflbench.traced"):
        phases.attribute(PROGRAM_SPANS + DEVICE, steps=1)


def test_trace_read_pinned():
    tr = trace.read(_Profile(EVENTS), steps=1)
    assert tr.window_us == (0.0, 1000.0) and tr.busy_us == 597.0
    assert tr.steps == 1 and len(tr.kernels) == 14
    assert tr.kernels[0] == ("Memcpy HtoD (Pageable -> Device)", 40.0, 20.0)
    assert tr.kernels[-1] == ("void at::native::elementwise_kernel<128, 2>",
                              995.0, 5.0)
    mm_bwd = "autograd::engine::evaluate_function: MmBackward0"
    assert tr.gaps == [
        ("loss_copy/aten::_local_scalar_dense", 83e-6),
        ("batch", 65e-6), ("step/backward", 60e-6),
        ("batch/aten::copy_", 40e-6), ("step", 40e-6),
        ("step/uplink", 35e-6), ("step/client_forward", 30e-6),
        ("step/downlink/" + mm_bwd, 30e-6), ("step/backward", 15e-6),
        ("step/downlink/" + mm_bwd, 5e-6)]
    assert tr.phases == phases.attribute(EVENTS, steps=1)
    assert tr.device_ops(3) == [
        ("sm90_xmma_gemm_f32f32_f32f32_f32_tn", 150e-6),
        ("sm90_xmma_gemm_f32f32_f32f32_f32_nn", 130e-6),
        ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128>", 120e-6)]


def test_accepted_metrics_pinned():
    """The seven accepted per-layer metrics on this trace, with the
    window's other numbers made up."""
    cell = spec.cell(CELL)
    w = session.Window(seconds=30.0, steps=[0.6, 0.61, 0.63, 0.62],
                       traced=[False, False, True, False],
                       migrations_ms=[6.5, 6.75],
                       trace=trace.read(_Profile(EVENTS), steps=1))
    run = session.RunRecord(cell=cell,
                            peaks=peaks.for_device("NVIDIA H100 80GB HBM3"),
                            window=w, step_flops=27_212_912_787_456,
                            peak_bytes=3 * 2 ** 30)
    want = {
        "step_mfu": 100 * 27_212_912_787_456 * 3 / 1.83 / 495e12,
        "gemm_busy_pct": 100 * 400 / 597,
        "grad_agg_us": 10.0,
        "codec_roofline": 100 * 210_370_600 / 3.35e12 / 30e-6,
        "migration_ms": 6.625,
        "peak_mem_gib": 3.0,
        "device_idle_pct": 40.3}
    got = {name: spec.metric_reader(name).read(run) for name in want}
    assert got == pytest.approx(want, rel=1e-12)


def test_phase_metrics_pinned():
    """The six phase metrics read ``Phases.readings()`` from the trace,
    and nothing from a trace without program spans or without a trace."""
    cell = spec.cell(CELL)

    def run(events):
        w = session.Window(seconds=30.0, steps=[0.6, 0.61],
                           traced=[False, True],
                           trace=trace.read(_Profile(events), steps=1)
                           if events else None)
        return session.RunRecord(cell=cell, peaks=None, window=w,
                                 step_flops=0.0)

    want = {"client_fwd_ms": 0.15, "server_fwd_ms": 0.12,
            "backward_ms": 0.195, "boundary_us": 40.0,
            "optimizer_ms": 0.065, "program_idle_ms": 0.2}
    for name, value in want.items():
        reader = spec.metric_reader(name)
        assert reader.read(run(EVENTS)) == pytest.approx(value, rel=1e-12)
        assert reader.read(run(HARNESS + DEVICE)) is None
        assert reader.read(run(None)) is None
    assert [m["name"] for m in cell.per_layer if m["name"] in want] == \
        list(want)
