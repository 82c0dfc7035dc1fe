"""The port's examples (``examples/torch_*.py``) run on the CPU at a few
rounds and print the line structure of the reference examples they port,
which run here at their own sizes (quickstart cut to the same rounds, with
its convergence overlay; serve_batched with its dashboard): each line with
its numbers masked, and whole where the line is a count or a deterministic
host value (the serving counts, SLO verdicts, snapshot provenance, and the
dashboard's gossip and serving counters).  The dashboard's lines of the
spans the port opens inside a round or window, which the reference has
not, are left out."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
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


# the port's spans inside a round or window, which the reference does not open
PORT_ONLY_SPANS = {"local.forward", "local.backward", "local.optimizer", "round.local_phase",
                   "round.consensus", "gossip.local_phase", "gossip.consensus"}


def _reference_lines(lines):
    """``lines`` less the dashboard's lines of the port-only spans."""
    return [x for x in lines if not (x.startswith("span ") and x.split()[1] in PORT_ONLY_SPANS)]


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
    got = _reference_lines(_lines(capsys, lambda: _module("torch_serve_batched").main(
        ["--device", "cpu"])))
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert got[1:7] == want[1:7]  # every line but the loss: counts, provenance, verdicts
    dash = got.index(next(x for x in got if x.startswith("=== session dashboard")))
    assert got[dash] == want[dash]
    counters = [x for x in got[dash:] if x.startswith(("gossip:", "serving:"))]
    assert len(counters) == 2 and counters == [
        x for x in want[dash:] if x.startswith(("gossip:", "serving:"))]


def test_torch_async_gossip_prints_the_reference_lines(capsys):
    ref = _module("async_gossip")
    ref.SPEC = dataclasses.replace(ref.SPEC, run=dataclasses.replace(ref.SPEC.run, n_rounds=3,
                                                                     eval_every=3))
    want = _lines(capsys, ref.main)
    out = {}
    got = _reference_lines(_lines(capsys, lambda: out.update(_module("torch_async_gossip").main(
        ["--device", "cpu", "--rounds", "3"]))))
    assert [_template(x) for x in got] == [_template(x) for x in want]
    # the sharded run: 4 virtual shards, bitwise the dense run
    assert out == {"sharded_bitwise": True, "shards": 4}
    sharded = next(x for x in got if x.startswith("Sharded windows"))
    assert sharded.startswith("Sharded windows (4 shards over 1 devices")
    assert sharded.endswith("bit-identical to the dense run: True.")


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's many small ops: under the suite's
    parallel workers, spinning thread pools slow them by 10-200x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_train_decentralized_lm_prints_the_reference_lines(monkeypatch, capsys, one_torch_thread):
    """Both examples at the reduced repro-100m-cpu config, 2 rounds of one
    row of 16 tokens an agent: the same lines; the model line whole (the
    parameter count an agent, the agents, W)."""
    argv = ["--rounds", "2", "--batch", "1", "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train_decentralized_lm"] + argv)
    want = _lines(capsys, _module("train_decentralized_lm").main)
    final = {}
    got = _lines(capsys, lambda: final.update(nll=_module("torch_train_decentralized_lm").main(
        argv + ["--device", "cpu"])))
    assert [_template(x) for x in got] == [_template(x) for x in want]
    assert got[0] == want[0] == "model repro-100m-cpu: 6,293,760 params/agent, 2 agents, W=complete"
    assert 0 < final["nll"] < 12
