"""The port's examples (``examples/torch_*.py``) run on the CPU at a few
rounds and print the line structure of the reference examples they port,
which run here at their own sizes (quickstart cut to the same rounds, with
its convergence overlay; serve_batched with its dashboard): each line with
its numbers masked, and whole where the line is a count or a deterministic
host value (the serving counts, SLO verdicts, snapshot provenance, and the
dashboard's gossip and serving counters)."""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def _module(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys, fn):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out.splitlines()


def _template(line):
    return " ".join(NUMBER.sub("#", line).split())


def test_torch_quickstart_prints_the_reference_lines(capsys):
    ref = _module("quickstart")
    ref.SPEC = dataclasses.replace(ref.SPEC, run=dataclasses.replace(ref.SPEC.run, n_rounds=5,
                                                                     eval_every=5))
    want = _lines(capsys, ref.main)
    got = _lines(capsys, lambda: _module("torch_quickstart").main(
        ["--device", "cpu", "--rounds", "5"]))
    assert [_template(x) for x in got] == [_template(x) for x in want]
    final = float(re.search(r"final average accuracy ([\d.]+)", "\n".join(got)).group(1))
    assert final > 0.5
    # the lr = 0 overlay: ten rounds, and the ring's rate attained
    overlay = got[got.index(next(x for x in got if x.startswith("convergence overlay"))) + 1:]
    assert [x.split()[1] for x in overlay[:-1]] == [str(r) for r in range(1, 11)]
    assert overlay[-1].endswith("vs theory 1.0986 -> attainment 1.00")


def test_torch_quickstart_runs_the_launch_engine(capsys):
    got = _lines(capsys, lambda: _module("torch_quickstart").main(
        ["--device", "cpu", "--rounds", "2", "--engine", "launch"]))
    assert [x for x in got if x.startswith("round")] and "final average accuracy" in "\n".join(got)


def test_torch_linear_regression_prints_the_reference_lines(capsys):
    want = _lines(capsys, _module("linear_regression").main)
    got = _lines(capsys, lambda: _module("torch_linear_regression").main(
        ["--device", "cpu", "--rounds", "10"]))
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert got[0] == want[0]  # centrality and lambda_max: host numpy on the same W
    assert [x for x in got if x.startswith("round")][-1].startswith("round   10")


def test_torch_serve_batched_prints_the_reference_lines(capsys):
    want = _lines(capsys, _module("serve_batched").main)
    got = _lines(capsys, lambda: _module("torch_serve_batched").main(["--device", "cpu"]))
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert got[1:7] == want[1:7]  # every line but the loss: counts, provenance, verdicts
    dash = got.index(next(x for x in got if x.startswith("=== session dashboard")))
    assert got[dash] == want[dash]
    counters = [x for x in got[dash:] if x.startswith(("gossip:", "serving:"))]
    assert len(counters) == 2 and counters == [
        x for x in want[dash:] if x.startswith(("gossip:", "serving:"))]
