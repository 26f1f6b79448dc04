"""The program's spans read from kineto-like events: the ``repro.*`` ranges
and their device-side shadows leave every reading of ``tracing.read`` and
every metric as it was; ``program_spans.read`` attributes a backward on
another thread to its forward mixer through ``sequence_nr``, and splits
the device's idle time by the innermost range open on any thread."""

import pytest
import torch

import program_spans
import run
import tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
EVAL = "autograd::engine::evaluate_function: "


class Ev:
    """The methods of a kineto event that the readers call."""

    def __init__(self, name, t0, dur, tid=1, *, device=False, corr=0,
                 linked=0, seq=-1, fwd=0, kind=None):
        self._name, self._t0, self._dur, self._tid = name, t0, dur, tid
        self._device, self._corr, self._linked = device, corr, linked
        self._seq, self._fwd = seq, fwd
        self._kind = kind or ("kernel" if device else "cpu_op")

    def name(self):
        return self._name

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid

    def device_type(self):
        return CUDA if self._device else CPU

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def sequence_nr(self):
        return self._seq

    def fwd_thread_id(self):
        return self._fwd

    def is_user_annotation(self):
        # the harder case: the shadow says so only by its activity type
        return self._kind == "user_annotation"

    def activity_type(self):
        return self._kind


def _kernel(t, dur, corr, tid=1, name="k"):
    """A launch on ``tid`` at ``t`` and its kernel on the device."""
    return [Ev("cudaLaunchKernel", t, 1, tid, corr=corr),
            Ev(name, t + 2, dur, device=True, corr=corr)]


def _ann(name, t0, t1, tid=1):
    return Ev(name, t0, t1 - t0, tid, kind="user_annotation")


def _shadow(name, t0, t1):
    """The device-side copy the profiler draws of a host range."""
    return Ev(name, t0, t1 - t0, device=True, kind="gpu_user_annotation")


def _harness_trace():
    """A window with the benchmark's spans: attention forward and its
    backward on the autograd thread between the marks, the optimizer, the
    feed and the readback."""
    ev = [_ann("bench.window", 0, 10_000)]
    ev += [_ann("bench.feed", 10, 60)] + _kernel(20, 30, 1)
    ev += [_ann("bench.attention", 100, 400)] + _kernel(150, 200, 2)
    ev += [_ann("bench.attention.bwd_start", 2000, 2001, 2)]
    ev += _kernel(2010, 500, 3, tid=2)
    ev += [_ann("bench.attention.bwd_end", 2600, 2601, 2)]
    ev += [_ann("bench.optimizer", 3000, 6000)] + _kernel(3100, 2500, 4)
    ev += [_ann("bench.readback", 8000, 9500)] + _kernel(8100, 100, 5)
    return ev


def _program_ranges():
    """The program's ranges over the same calls, and their shadows."""
    hosts = [("repro.step", 90, 7000, 1), ("repro.step.forward", 95, 500, 1),
             ("repro.mixer.attn", 98, 450, 1),
             ("repro.attention", 110, 390, 1),
             ("repro.launch.flash", 149, 152, 1),
             ("repro.step.backward", 1900, 2900, 1),
             ("repro.attention.bwd", 2005, 2590, 2),
             ("repro.step.update", 2950, 6500, 1),
             ("repro.optimizer", 2990, 6100, 1), ("repro.gc", 7100, 7300, 1)]
    out = [_ann(n, a, b, t) for n, a, b, t in hosts]
    out += [_shadow(n, a, b) for n, a, b, _ in hosts]
    return out


def _spans():
    spans = tracing.Spans()
    spans.bound_s.update(attention=1e-7, optimizer=0.0)
    spans.calls.update(attention=1, optimizer=1)
    return spans


def _metrics(summary):
    w = {"units": [{"tokens": 10, "latency": [0.1]}], "wall_s": 1.0,
         "setup_s": 1.0, "peak_bytes": 1, "flops": 1e12, "trace": summary}
    out = {}
    for m in run.spec()["per_layer"] + run.spec()["end_to_end"]:
        out[m["name"]] = run._metric_reader(m["name"])(w)
    return out


def test_program_ranges_leave_the_harness_readings_as_they_were():
    base = tracing.read(_harness_trace(), _spans())
    both = tracing.read(_harness_trace() + _program_ranges(), _spans())
    gaps = both["breakdown"].pop("idle_gaps")
    want = base["breakdown"].pop("idle_gaps")
    assert [g[1] for g in gaps] == [g[1] for g in want]
    assert both == base
    assert _metrics(both) == _metrics(base)
    assert base["op_device_s"]["attention"] == pytest.approx(700e-9)


def test_program_spans_match_the_wrappers_and_name_the_idle():
    events = _harness_trace() + _program_ranges()
    # the attention's backward node, made by its forward op
    events += [Ev("_Attention", 115, 5, 1, seq=40),
               Ev(EVAL + "_AttentionBackward", 2004, 590, 2, seq=40, fwd=1)]
    h = tracing.read(events, _spans())
    p = program_spans.read(events)
    assert p["device_s"] == pytest.approx(h["device_s"])
    for op in ("attention", "optimizer"):
        assert p["span_device_s"][f"repro.{op}"] == \
            pytest.approx(h["op_device_s"][op])
    assert p["ranges"]["repro.attention"] == 1
    assert p["idle_s"] == pytest.approx(1e-9 * (10_000 - 3330))
    assert sum(p["idle_by_span"].values()) == pytest.approx(p["idle_s"])
    assert p["idle_by_span"]["repro.gc"] == pytest.approx(200e-9)
    assert p["idle_by_span"]["bench.readback"] > 0
    assert p["mamba_glue_share"] is None


def _mamba_trace():
    """One Mamba mixer: its two GEMMs, the glue and the SSD forward on
    thread 1; their backward nodes on thread 2, each made by a forward op
    inside the mixer (an op outside it took the glue's number first and
    made no node)."""
    ev = [_ann("bench.window", 0, 10_000),
          _ann("repro.mixer.mamba", 100, 200),
          _ann("repro.mamba.in_proj", 110, 120), _ann("repro.ssd", 140, 160),
          _ann("repro.mamba.out_proj", 170, 180)]
    ev += _kernel(112, 10, 1) + _kernel(130, 5, 2) + _kernel(150, 20, 3)
    ev += _kernel(175, 8, 4) + _kernel(300, 7, 5)          # outside
    ev += [Ev("aten::empty", 50, 1, 1, seq=7),             # made no node
           Ev("aten::silu", 131, 2, 1, seq=7),
           Ev("_SSD", 151, 2, 1, seq=9), Ev("aten::mm", 113, 2, 1, seq=6)]
    ev += [Ev(EVAL + "SiluBackward0", 1000, 50, 2, seq=7, fwd=1)]
    ev += _kernel(1010, 11, 6, tid=2)
    ev += [Ev(EVAL + "_SSDBackward", 1100, 100, 2, seq=9, fwd=1),
           _ann("repro.ssd.bwd", 1101, 1190, 2)]
    ev += _kernel(1110, 40, 7, tid=2)
    ev += [Ev(EVAL + "MmBackward0", 1300, 50, 2, seq=6, fwd=1)]
    ev += _kernel(1310, 9, 8, tid=2)
    return ev


def test_mamba_glue_counts_its_backward_on_another_thread():
    p = program_spans.read(_mamba_trace())
    total = 10 + 5 + 20 + 8 + 7 + 11 + 40 + 9
    assert p["device_s"] == pytest.approx(total * 1e-9)
    assert p["mamba_glue_s"] == pytest.approx((5 + 11) * 1e-9)
    assert p["mamba_glue_share"] == pytest.approx(100.0 * 16 / total)
    assert p["span_device_s"]["repro.mixer.mamba"] == \
        pytest.approx((total - 7) * 1e-9)
    assert p["span_device_s"]["repro.ssd"] == pytest.approx(60e-9)
    assert p["span_device_s"]["repro.mamba.in_proj"] == pytest.approx(19e-9)


def test_phases_are_spans_of_time_on_any_thread():
    """A backward kernel launched on the autograd thread while the main
    thread is in ``repro.step.backward`` counts toward that phase, and
    toward its op's mixer, not toward the forward phase its op ran in."""
    ev = [_ann("bench.window", 0, 10_000), _ann("repro.step", 50, 5000),
          _ann("repro.step.forward", 60, 900),
          _ann("repro.mixer.mamba", 100, 200),
          _ann("repro.step.backward", 1000, 2000)]
    ev += _kernel(130, 5, 1) + [Ev("aten::silu", 131, 2, 1, seq=7)]
    ev += [Ev(EVAL + "SiluBackward0", 1100, 50, 2, seq=7, fwd=1)]
    ev += _kernel(1110, 11, 2, tid=2)
    p = program_spans.read(ev)
    d = p["span_device_s"]
    assert d["repro.step.forward"] == pytest.approx(5e-9)
    assert d["repro.step.backward"] == pytest.approx(11e-9)
    assert d["repro.step"] == pytest.approx(16e-9)
    assert d["repro.mixer.mamba"] == pytest.approx(16e-9)


def test_idle_under_nested_spans_on_two_threads():
    """Busy [0, 100), [300, 400), [500, 1000); idle [100, 300) and
    [400, 500).  The innermost range open on any thread is the one that
    started last."""
    ev = [_ann("bench.window", 0, 1000),
          Ev("k", 0, 100, device=True), Ev("k", 300, 100, device=True),
          Ev("k", 500, 500, device=True),
          _ann("repro.step", 90, 450), _ann("repro.step.forward", 95, 250),
          _ann("repro.gc", 150, 170), _ann("repro.ssd.bwd", 200, 280, 2),
          _ann("bench.readback", 460, 520),
          _ann("bench.attention.bwd_start", 120, 130)]
    p = program_spans.read(ev)
    want = {"repro.step.forward": 80, "repro.gc": 20, "repro.ssd.bwd": 80,
            "repro.step": 70, "bench.window": 10, "bench.readback": 40}
    assert p["idle_by_span"] == pytest.approx(
        {k: v * 1e-9 for k, v in want.items()})
    assert p["program_idle_s"] == pytest.approx(250e-9)
    assert p["program_idle_share"] == pytest.approx(25.0)


def test_a_trace_without_program_ranges_reads_none():
    p = program_spans.read(_harness_trace())
    assert p["program_idle_share"] is None and p["mamba_glue_share"] is None
    assert p["ranges"] == {}


@pytest.mark.parametrize("workload", ["zamba2-1.2b.train",
                                      "glm4-9b.prefill-short"])
def test_traced_window_on_the_cpu(workload):
    """The measuring run at smoke size: one traced window, read both ways;
    its top range counted once a step or call."""
    import smoke

    w = {c["name"]: c for c in run.spec()["workloads"]}[workload]
    line = program_spans.traced_window(
        workload, 2 ** 31 + 33, 0.3, "cpu",
        model=smoke.model(w["config"]), mix=smoke.mix(w["traffic"]))
    top = "repro.step" if workload.endswith("train") else "repro.prefill"
    assert line["units"] > 0 and line["tokens_per_s"] > 0
    assert line["program"]["ranges"][top] == line["units"]
    assert line["trace"]["window_s"] > 0
