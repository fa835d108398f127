"""Multi-process federation runtime: the AsyREVEL server and each party as
separate OS processes over TCP, behind the same typed Message/Channel
seam as the in-process executors, speaking the reference's ``ZV`` v1
wire byte for byte, and federated serving over the same transport
(``run_tcp_serving``), traced and monitored through repro_torch/obs as
the reference's runtime is."""
from repro_torch.runtime.failures import (CRASH_EXIT_CODE,  # noqa: F401
                                          NO_FAILURES, FailurePlan,
                                          PartyFault)
from repro_torch.runtime.harness import (history_losses,  # noqa: F401
                                         ms_per_update, run_federation,
                                         run_reference, serial_levels)
from repro_torch.runtime.server import (FederationError,  # noqa: F401
                                        RuntimeServer)
from repro_torch.runtime.serving import (RemotePartyBackend,  # noqa: F401
                                         run_tcp_serving, serving_party_main)
from repro_torch.runtime.transport import (WIRE_VERSION,  # noqa: F401
                                           ConnectionClosed, FramedSocket,
                                           TransportError, TransportTimeout,
                                           WireFormatError,
                                           connect_with_retry,
                                           decode_message, encode_message)
