"""A small CPU run of a cell through the whole harness: the tests'
stand-in for a measuring run (the program on the CPU, few streams and
frames, a one-second window)."""
import json
import time

from hebench import harness
from hebench.tests.conftest import ROOT

SMALL = {
    "v2_batch_512": {"config": {"streams": 4},
                     "mix": {"check_streams": 4}},
    "v1s_stream_b1": {"mix": {"streams": 3, "frames": 4, "check_streams": 3,
                              "trace_streams": 1}},
    "v1s_batch_256": {"mix": {"streams": 2, "check_streams": 2}},
}


def run_cell(capsys, cell: str, trace: int = 0, root: str = ROOT,
             overrides: dict | None = None, seconds: float = 1.0) -> dict:
    """-> the result line as a dict (the run must print one)."""
    rc = harness.run(["--workload", cell, "--seed", "3000000007",
                      "--seconds", str(seconds), "--trace", str(trace)],
                     time.perf_counter(), root=root, device="cpu",
                     workers=1,
                     overrides=SMALL[cell] if overrides is None else overrides)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out
    return json.loads(out[-1])


def batch_data(monkeypatch) -> dict:
    """A dict that the batch kind's runs fill with their per-layer data
    (``Outcome.data``) as they return."""
    from hebench.traffic import batch
    data, real = {}, batch.run

    def run(ctx):
        out = real(ctx)
        data.update(out.data)
        return out
    monkeypatch.setattr(batch, "run", run)
    return data
