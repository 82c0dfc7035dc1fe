"""The card-vs-CPU check's exemption of Adam's noise lanes (``chip_smoke.py``
``adam_noise_lanes`` and ``parity_errors``, ROADMAP C.3), on synthetic
moments and differences on the CPU.

A lane is noise where the two devices' Adam moments disagree by more than
``ADAM_NOISE_GAP`` (m relative to sqrt(v), v relative to v); the lanes
consensus mixes a noise lane into are exempt from ``PARITY_ATOL`` on the
posterior but held to the bound their Adam steps allow, and a phase with more
than ``EXEMPT_SHARE_MAX`` of its lanes exempt fails.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

N, P = 3, 1_000
W = torch.tensor([[0.5, 0.5, 0.0], [0.25, 0.5, 0.25], [0.0, 0.5, 0.5]])
U, LR = 4, 5e-3  # the phases' local steps and learning rate
EXEMPT_ATOL = 2 * U * LR


def _state(m_mean, v_mean, m_rho, v_rho):
    mu = SimpleNamespace(mean=m_mean, rho=m_rho)
    nu = SimpleNamespace(mean=v_mean, rho=v_rho)
    return SimpleNamespace(opt_state=SimpleNamespace(mu=mu, nu=nu))


def _pair(seed=0):
    """Card and CPU states whose moments agree to an ulp on every lane: a
    well-set gradient of a real size (v ~ 1e-6), and a lane whose gradient
    is exactly zero on both devices."""
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((N, P), generator=g) * 1e-3
    v = torch.rand((N, P), generator=g) * 1e-6 + 1e-7
    m[:, 0], v[:, 0] = 0.0, 0.0
    one_ulp = 1.0 + 2.0 ** -23
    card = _state(m.clone(), v.clone(), m.clone(), v.clone())
    cpu = _state(m * one_ulp, v * one_ulp, m.clone(), v * one_ulp)
    return card, cpu


def _diffs(**lanes):
    """Differences of 1e-7 everywhere, and the given ``{field: [(agent,
    lane, value)]}``."""
    d = {name: torch.full((N, P), 1e-7) for name in ("mean", "rho", "adam_mu_mean",
                                                     "adam_mu_rho")}
    for name, entries in lanes.items():
        for i, c, x in entries:
            d[name][i, c] = x
    return d


def test_well_set_moments_are_not_noise():
    card, cpu = _pair()
    assert not bool(cs.adam_noise_lanes(card, cpu).any())
    fields = cs.parity_errors("t", _diffs(), cs.adam_noise_lanes(card, cpu), W, EXEMPT_ATOL)
    assert fields["failures"] == [] and fields["exempt_lanes"] == 0


def test_rounding_noise_lane_like_c3_is_exempt_within_its_bound():
    """ROADMAP C.3: agent 1's rho lane at v = 5.17e-12 on the card and
    5.34e-12 on the CPU, its first moments apart by more than rounding of a
    well-set gradient explains, and its rho 6.6e-4 apart after the merge."""
    card, cpu = _pair(1)
    for s, v, m in ((card, 5.17e-12, 1.1e-7), (cpu, 5.34e-12, -0.9e-7)):
        s.opt_state.nu.rho[1, 887] = v
        s.opt_state.mu.rho[1, 887] = m
    noise = cs.adam_noise_lanes(card, cpu)
    assert noise.nonzero().tolist() == [[1, 887]]
    d = _diffs(rho=[(1, 887, 6.6e-4), (0, 887, 3e-4), (2, 887, 2e-4)])
    fields = cs.parity_errors("t", d, noise, W, EXEMPT_ATOL)
    # consensus mixes agent 1's lane into every agent's row (column 1 of W is positive)
    assert fields["failures"] == [] and fields["exempt_lanes"] == 3
    assert fields["exempt_max_abs_err"]["rho"] == pytest.approx(6.6e-4)
    assert fields["max_abs_err"]["rho"] == pytest.approx(1e-7)


@pytest.mark.parametrize("moment", ["v", "m"])
def test_either_moment_marks_noise(moment):
    card, cpu = _pair(2)
    if moment == "v":  # a gradient that lost all but 9 of its bits
        cpu.opt_state.nu.mean[2, 5] = card.opt_state.nu.mean[2, 5] * (1 + 2e-3)
    else:
        cpu.opt_state.mu.mean[2, 5] = (card.opt_state.mu.mean[2, 5]
                                       + 2e-3 * card.opt_state.nu.mean[2, 5].sqrt())
    assert cs.adam_noise_lanes(card, cpu).nonzero().tolist() == [[2, 5]]


def test_a_real_error_on_a_well_set_lane_fails():
    """A lane whose moments agree to an ulp (its gradient set to fp32
    accuracy) is not exempt: its posterior 5e-3 apart fails the check."""
    card, cpu = _pair(3)
    noise = cs.adam_noise_lanes(card, cpu)
    assert not bool(noise[0, 42])
    fields = cs.parity_errors("t", _diffs(mean=[(0, 42, 5e-3)]), noise, W, EXEMPT_ATOL)
    assert len(fields["failures"]) == 1 and "PARITY_ATOL" in fields["failures"][0]


def test_an_exempt_lane_beyond_its_adam_steps_fails():
    card, cpu = _pair(4)
    cpu.opt_state.nu.rho[1, 3] = card.opt_state.nu.rho[1, 3] * 2.0
    noise = cs.adam_noise_lanes(card, cpu)
    d = _diffs(rho=[(1, 3, 1.5 * EXEMPT_ATOL)])
    fields = cs.parity_errors("t", d, noise, W, EXEMPT_ATOL)
    assert len(fields["failures"]) == 1 and "exempt lane" in fields["failures"][0]


def test_the_adam_first_moment_is_not_exempt():
    card, cpu = _pair(5)
    cpu.opt_state.nu.rho[1, 3] = card.opt_state.nu.rho[1, 3] * 2.0
    noise = cs.adam_noise_lanes(card, cpu)
    fields = cs.parity_errors("t", _diffs(adam_mu_rho=[(1, 3, 1e-3)]), noise, W, EXEMPT_ATOL)
    assert len(fields["failures"]) == 1 and "PARITY_ATOL" in fields["failures"][0]


def test_more_exempt_lanes_than_the_cap_fails():
    """A wrong gradient that moves many lanes: the moments of 5% of agent
    1's lanes disagree, which consensus spreads to every agent's row, over
    the cap, although every difference is inside its bound."""
    card, cpu = _pair(6)
    lanes = torch.arange(1, P, 20)
    cpu.opt_state.nu.mean[1, lanes] = card.opt_state.nu.mean[1, lanes] * 1.5
    noise = cs.adam_noise_lanes(card, cpu)
    fields = cs.parity_errors("t", _diffs(), noise, W, EXEMPT_ATOL)
    assert fields["noise_lanes"] == len(lanes) and fields["exempt_lanes"] == N * len(lanes)
    assert fields["exempt_share"] > cs.EXEMPT_SHARE_MAX
    assert len(fields["failures"]) == 1 and "exempt, more than" in fields["failures"][0]
