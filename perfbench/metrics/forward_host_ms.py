"""forward_host_ms (model step): the host's milliseconds a traced vfl-zoo
step in the model's forwards, its vfl.server_forward and
vfl.party_forward spans: what issuing the three server forwards and the
party towers costs the host. The rest of ``host_step_ms`` is the ZO
machinery's (draws, codec, perturbations, updates). The spans also hold
any wait on a full launch queue, so they bound the host's cost of issuing
the forwards from above."""
from perfbench import spans

FORWARDS = ("vfl.server_forward", "vfl.party_forward")


def read(rec):
    return spans.ms_per_step(rec, lambda name, depth: name in FORWARDS)
