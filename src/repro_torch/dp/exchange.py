"""The defended exchange: ``ZOExchange`` with a mandatory, enabled
``DPConfig``, the port of the reference's ``DPExchange``. It sits in a
module of its own so that ``dp/mechanisms.py`` stays a leaf that
``core/exchange.py`` imports."""
from __future__ import annotations

from repro_torch.configs.base import DPConfig
from repro_torch.core.exchange import ZOExchange


class DPExchange(ZOExchange):
    """The defended exchange: a ZOExchange whose ``dp`` config is
    mandatory; ``ZOExchange`` itself carries the optional dp hook, so
    ``from_config`` inherits the defense. This is the explicit entry point
    for a defended seam:

        ex = DPExchange(resolve_dp(DPConfig(epsilon=8, clip=1.0),
                                   rounds=T), mu=1e-3, codec="int8")
    """

    def __init__(self, dp: DPConfig, **kw):
        if dp is None or not dp.enabled:
            raise ValueError(
                "DPExchange requires an ENABLED DPConfig (finite epsilon "
                "or an explicit noise_multiplier, plus a clip bound); use "
                "plain ZOExchange for the undefended path")
        super().__init__(dp=dp, **kw)

    @classmethod
    def wrap(cls, base: ZOExchange, dp: DPConfig) -> "DPExchange":
        """A defended copy of an existing exchange's semantics."""
        return cls(dp, mu=base.mu, direction=base.direction, lam=base.lam,
                   num_directions=base.num_directions,
                   seed_replay=base.seed_replay, codec=base.codec,
                   meter=base.meter, fused=base.fused)
