"""The cost model of repro_torch (``launch.costmodel``, ``launch.mesh``)
against the JAX package's, on the CPU.

* ``consensus_roofline``, ``gossip_window_roofline`` and ``serve_roofline``
  give the reference's keys and exactly its byte counts over a grid of
  agents, params, wire and history dtypes, edge counts, shards, delay
  depths and mc;
* every ``roofline_seconds`` value is those bytes over the port's
  ``HBM_BW`` (or ``ICI_BW`` for the interconnect terms): the H100 SXM5's
  3.35 TB/s and NVLink's 450 GB/s a direction, not the v5e's;
* the contracts of tests/test_gossip.py:493-559 and
  tests/test_wire_dtype.py:372 hold on the port.
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro.launch import costmodel as jcm  # noqa: E402
from repro_torch.launch import costmodel as tcm  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.costmodel import (  # noqa: E402
    consensus_roofline,
    gossip_window_roofline,
    serve_roofline,
)

WIRES = ("f32", "bf16", "f16")


def _same_bytes(got, want, path=""):
    """Every key of ``want`` in ``got``; every value equal, except the
    ``roofline_seconds`` blocks (another card's constants)."""
    assert set(got) == set(want), path
    for k, w in want.items():
        if k == "roofline_seconds":
            assert set(got[k]) == set(w), path
        elif isinstance(w, dict):
            _same_bytes(got[k], w, f"{path}.{k}")
        else:
            assert got[k] == w and type(got[k]) is type(w), f"{path}.{k}"


def _seconds_are_bytes_over_the_cards_rates(rec):
    for k, sec in rec["roofline_seconds"].items():
        if k.startswith("ici_"):
            assert sec == rec["ici_bytes"][k[len("ici_"):]] / mesh.ICI_BW, k
        elif k == "publish":
            assert sec == rec["snapshot_publish_bytes"] / mesh.HBM_BW
        elif k == "apply_per_batch":
            assert sec == rec["apply_bytes_per_batch"] / mesh.HBM_BW
        else:
            assert sec == rec["hbm_bytes"][k] / mesh.HBM_BW, k


def test_the_cards_constants():
    assert mesh.HBM_BW == 3.35e12
    assert mesh.PEAK_FLOPS_BF16 == 989e12
    assert mesh.ICI_BW == 450e9
    assert not hasattr(tcm, "analytic_costs")  # with the model zoo


@pytest.mark.parametrize("n,p", [(1, 5), (9, 199_210), (16, 1 << 14), (4_200, 199_210)])
@pytest.mark.parametrize("wire", WIRES)
def test_consensus_roofline_bytes_equal_the_reference(n, p, wire):
    for n_leaves, max_degree, n_edges, bpe in itertools.product(
            (1, 8), (None, 5), (None, 3 * n + 1), (4, 2)):
        kw = dict(max_degree=max_degree, bytes_per_el=bpe, wire_dtype=wire, n_edges=n_edges)
        got = consensus_roofline(n, p, n_leaves, **kw)
        _same_bytes(got, jcm.consensus_roofline(n, p, n_leaves, **kw))
        _seconds_are_bytes_over_the_cards_rates(got)


@pytest.mark.parametrize("n,p", [(9, 199_210), (16, 1 << 14), (4_200, 199_210)])
@pytest.mark.parametrize("wire,hist", [("f32", "f32"), ("bf16", "bf16"), ("f16", "bf16"),
                                       ("f32", "f16")])
def test_gossip_window_roofline_bytes_equal_the_reference(n, p, wire, hist):
    cases = itertools.product(
        (0, n // 2, n),  # participating
        (None, 0),  # merging: default (= participating) or none
        ((1, 0), (8, 0), (8, 3), (8, 7)),  # (shards, cross offsets)
        ((0, 0), (1, 4), (3, 10)),  # (delay depth, stale events)
        ((None, None), (12, None), (12, 8192), (None, 64)),  # (event edges, padded edges)
    )
    for part, merging, (shards, offsets), (depth, stale), (events, padded) in cases:
        kw = dict(n_merging=merging, n_shards=shards, n_cross_offsets=offsets,
                  delay_depth=depth, n_stale_events=stale, wire_dtype=wire, history_dtype=hist,
                  n_event_edges=events, n_padded_edges=padded)
        got = gossip_window_roofline(n, p, part, **kw)
        _same_bytes(got, jcm.gossip_window_roofline(n, p, part, **kw))
        _seconds_are_bytes_over_the_cards_rates(got)


@pytest.mark.parametrize("dtype", WIRES)
@pytest.mark.parametrize("mc", [0, 1, 8, 32])
def test_serve_roofline_bytes_equal_the_reference(dtype, mc):
    for n, p, batch, dim, classes in [(3, 1188 // 4, 1, 1, 2), (9, 199_210, 32, 784, 10),
                                      (9, 199_210, 1, 784, 10), (4_200, 90, 7, 8, 2)]:
        kw = dict(snapshot_dtype=dtype, mc_samples=mc, batch=batch, dim=dim, n_classes=classes)
        got = serve_roofline(n, p, **kw)
        _same_bytes(got, jcm.serve_roofline(n, p, **kw))
        _seconds_are_bytes_over_the_cards_rates(got)


def test_the_reference_refusals_hold():
    with pytest.raises(ValueError, match="wire_dtype"):
        consensus_roofline(4, 8, 1, wire_dtype="fp8")
    with pytest.raises(ValueError, match="n_merging"):
        gossip_window_roofline(4, 8, n_participating=2, n_merging=3)
    with pytest.raises(ValueError, match="n_event_edges"):
        gossip_window_roofline(4, 8, 2, n_event_edges=-1)
    with pytest.raises(ValueError, match="below the fired count"):
        gossip_window_roofline(4, 8, 2, n_event_edges=5, n_padded_edges=4)
    with pytest.raises(ValueError, match="mc_samples"):
        serve_roofline(4, 8, mc_samples=-1)


# -- tests/test_gossip.py:493-559 on the port ----------------------------------------


def test_gossip_window_roofline_monotone_vs_dense():
    n, p = 16, 1 << 14
    dense = consensus_roofline(n, p, n_leaves=8)["hbm_bytes"]["flat_fused"]
    prev = -1.0
    for k in range(n + 1):
        b = gossip_window_roofline(n, p, n_participating=k)["hbm_bytes"]["window_masked"]
        assert prev <= b <= dense
        prev = b
    full = gossip_window_roofline(n, p, n_participating=n)
    assert full["hbm_bytes"]["window_masked"] == dense
    assert full["hbm_passes"]["window_masked"] == 1.0
    half = gossip_window_roofline(n, p, n_participating=n, n_merging=n // 2)
    assert half["hbm_bytes"]["window_masked"] < dense
    with pytest.raises(ValueError, match="n_merging"):
        gossip_window_roofline(n, p, n_participating=2, n_merging=3)


def test_gossip_window_roofline_latency_and_interconnect_terms():
    n, p = 16, 1 << 14
    base = gossip_window_roofline(n, p, n_participating=8)
    assert "ici_bytes" not in base and "history" not in base["hbm_bytes"]
    s = 8
    allgather = gossip_window_roofline(
        n, p, n_participating=8, n_shards=s, n_cross_offsets=s - 1)["ici_bytes"]["dense_allgather"]
    prev = -1.0
    for k in range(s):
        rec = gossip_window_roofline(n, p, n_participating=8, n_shards=s, n_cross_offsets=k)
        ici = rec["ici_bytes"]["window_ppermute"]
        assert prev <= ici <= allgather
        assert rec["hbm_bytes"] == base["hbm_bytes"]
        prev = ici
    idle = gossip_window_roofline(n, p, n_participating=0, n_shards=s, n_cross_offsets=0)
    assert idle["ici_bytes"]["window_ppermute"] == 0.0
    d1 = gossip_window_roofline(n, p, n_participating=8, delay_depth=1, n_stale_events=4)
    d3 = gossip_window_roofline(n, p, n_participating=8, delay_depth=3, n_stale_events=4)
    assert d1["hbm_bytes"]["history"] == d3["hbm_bytes"]["history"] > 0
    assert d3["hist_resident_bytes"] == 2.0 * d1["hist_resident_bytes"]
    assert d1["hbm_bytes"]["window_masked"] == base["hbm_bytes"]["window_masked"]
    with pytest.raises(ValueError, match="n_cross_offsets"):
        gossip_window_roofline(n, p, n_participating=2, n_shards=4, n_cross_offsets=4)
    with pytest.raises(ValueError, match=">= 0"):
        gossip_window_roofline(n, p, n_participating=2, delay_depth=-1)


# -- tests/test_wire_dtype.py:372 on the port ----------------------------------------


def test_consensus_roofline_wire_bytes_halve_at_bf16():
    n, p = 16, 1 << 14
    f32 = consensus_roofline(n, p, n_leaves=8)["wire"]
    bf16 = consensus_roofline(n, p, n_leaves=8, wire_dtype="bf16")["wire"]
    f16 = consensus_roofline(n, p, n_leaves=8, wire_dtype="f16")["wire"]
    assert f32["dtype"] == "f32" and f32["model_saving_vs_f32"] == 1.0
    assert bf16["collective_bytes"] == 0.5 * f32["collective_bytes"]
    assert f16["collective_bytes"] == 0.5 * f32["collective_bytes"]
    assert bf16["model_saving_vs_f32"] == 2.0


def test_gossip_ici_bytes_halve_at_bf16():
    kw = dict(n_participating=8, n_shards=4, n_cross_offsets=2)
    f32 = gossip_window_roofline(16, 1 << 14, **kw)["ici_bytes"]
    bf16 = gossip_window_roofline(16, 1 << 14, wire_dtype="bf16", **kw)["ici_bytes"]
    assert bf16["window_ppermute"] == 0.5 * f32["window_ppermute"]
    assert bf16["dense_allgather"] == 0.5 * f32["dense_allgather"]


def test_the_slice_bounds_chip_smoke_prints():
    """chip_smoke.py phase 5 rows 1 and 3 and 3.serve: the modeled bytes at
    the slice's shapes (9 agents, P = 199,210)."""
    rec = consensus_roofline(9, 199_210, 1)
    assert rec["hbm_bytes"]["flat_fused"] == 16 * 9 * 199_210
    assert serve_roofline(9, 199_210, snapshot_dtype="f32")["snapshot_hbm_bytes"] == 14_343_120
    assert serve_roofline(9, 199_210, snapshot_dtype="bf16")["snapshot_hbm_bytes"] == 7_171_560
    # the hand-written bound adds W's 4 N^2 bytes: within 0.1%
    hand = 16 * 9 * 199_210 + 4 * 9 * 9
    assert abs(hand - rec["hbm_bytes"]["flat_fused"]) / hand < 1e-3
