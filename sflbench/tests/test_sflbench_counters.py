"""The program's ``obs`` counters and spans reach a metric's reader, in a
traced window on the CPU (the profiler on the host alone): a counter
planted in the port's step -- the test wraps the step -- is summed over
the profiled steps and no others into ``RunRecord.counters``; the
program's span names reach ``Trace.phases``; and the recorder in force
before the window is in force after it."""
from conftest import tiny_cell
from harness import program, session, spec
from harness.trace import Tracer

CELL = "granite8b-4l.sflga-int8-cutmig-s1024"
STEP_SPANS = {"client_forward", "uplink", "server_forward", "backward",
              "downlink", "optimizer"}


def test_planted_counter_reads_its_exact_total(monkeypatch):
    program.import_program()
    from repro_torch import obs
    from repro_torch.core import algorithms as alg

    real = alg.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def counted(params, opt_state, batch):
            rec = obs.get_recorder()
            rec.counter("planted.steps")
            rec.counter("planted.tokens", int(batch["tokens"].numel()))
            return step(params, opt_state, batch)

        return counted

    monkeypatch.setattr(alg, "make_train_step", make)
    c = tiny_cell(spec.cell(CELL))
    t = c.traffic
    before = obs.get_recorder()
    su = session.setup(c, 2 ** 31 + 3, "cpu")
    w = session.window(su, c, 2 ** 31 + 3, 0.0, Tracer(cuda=False))
    run = session.RunRecord(cell=c, peaks=None, window=w, step_flops=0.0)
    n = t["trace_steps"]
    assert sum(w.traced) == n and len(w.steps) == t["trace_start"] + n
    assert run.counters == {
        "planted.steps": n,
        "planted.tokens": n * t["cohort"] * t["batch"] * t["seq"]}
    assert obs.get_recorder() is before
    # the profiled steps cross the cut change 2 -> 1 of the window's cycle
    names = {name for _, _, name in w.trace.phases.spans}
    assert names == STEP_SPANS | {"resplit"}
    assert w.trace.phases.steps == n
