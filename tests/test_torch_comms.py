"""The paper's Table-3 communication model in the port (core/comms.py:
``tig_round``, ``tg_round``, ``paper_ratio``, ``measured_paper_ratio``)
against the reference's at every d_l of
benchmarks/bench_communication.py's ``PAPER_DL``: byte counts exact,
ratios within 1e-12; the measured ratio, from Messages priced on the
port's ``NetworkChannel``, within 5% of the analytic one (the reference's
own acceptance, tests/test_wire.py)."""
import pytest

from benchmarks.bench_communication import PAPER_DL
from repro.configs.base import NetworkConfig as RefNetworkConfig
from repro.core import comms as ref_comms
from repro_torch.configs import NETWORK_PROFILES
from repro_torch.configs.base import NetworkConfig
from repro_torch.core import comms

pytestmark = pytest.mark.torch

WIDTHS = sorted(set(PAPER_DL.values()))
RATIO_RTOL = 1e-12


@pytest.mark.parametrize("d_l", WIDTHS)
def test_round_bytes_are_the_references(d_l):
    for batch in (1, 8, d_l):
        for c_dim in (1, 3):
            got = comms.tig_round(batch, c_dim)
            want = ref_comms.tig_round(batch, c_dim)
            assert (got.up_bytes, got.down_bytes, got.total) == \
                (want.up_bytes, want.down_bytes, want.total) == \
                (4 * batch * c_dim, 4 * batch * c_dim, 8 * batch * c_dim)
    got, want = comms.tg_round(d_l), ref_comms.tg_round(d_l)
    assert (got.up_bytes, got.down_bytes, got.total) == \
        (want.up_bytes, want.down_bytes, want.total) == \
        (4 * d_l, 4 * d_l, 8 * d_l)


@pytest.mark.parametrize("d_l", WIDTHS)
def test_table3_ratios_are_the_references(d_l):
    for batch in (1, 4):
        assert comms.paper_ratio(d_l, batch=batch) == pytest.approx(
            ref_comms.paper_ratio(d_l, batch=batch), rel=RATIO_RTOL)
        assert comms.measured_paper_ratio(d_l, batch=batch) == \
            pytest.approx(ref_comms.measured_paper_ratio(d_l, batch=batch),
                          rel=RATIO_RTOL)
    wan = NETWORK_PROFILES["wan"]
    ref_wan = RefNetworkConfig(latency_s=wan.latency_s,
                               bandwidth_Bps=wan.bandwidth_Bps)
    assert comms.measured_paper_ratio(
        d_l, network=NetworkConfig(latency_s=wan.latency_s,
                                   bandwidth_Bps=wan.bandwidth_Bps)) == \
        pytest.approx(ref_comms.measured_paper_ratio(d_l, network=ref_wan),
                      rel=RATIO_RTOL)


@pytest.mark.parametrize("d_l", WIDTHS)
def test_measured_table3_ratio_within_5pct_of_analytic(d_l):
    analytic = comms.paper_ratio(d_l, batch=1)
    measured = comms.measured_paper_ratio(d_l, batch=1)
    assert abs(measured - analytic) / analytic < 0.05
    # a wider gradient costs more to send than the function values
    assert measured > 1.0
