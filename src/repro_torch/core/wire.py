"""The wire subsystem — every party<->server boundary crossing, typed.

Every crossing is a :class:`Message` routed through a :class:`Channel`
that accounts its measured bytes per kind. Message kinds and who sends
them (the reference's core/wire.py has the full threat-model notes):

  c_up       party -> server   function values c_m = F_m(w_m; x_m)
  c_hat_up   party -> server   perturbed values c_hat_m
  loss_down  server -> party   scalar losses (h, h_bar)
  grad_down  server -> party   intermediate gradient dL/dc_m  (TIG/TG only)
  param_down server -> party   a parameter block               (TG only)
  serve_down server -> party   an inference query (sample ids)

Payloads are numpy on the host, as the reference ships them. This slice
carries the in-memory channel; the network, recording and replay
channels come with the runtime slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core.exchange import SCALAR_BYTES, wire_nbytes

KINDS = ("c_up", "c_hat_up", "loss_down", "grad_down", "param_down",
         "serve_down")
UP_KINDS = ("c_up", "c_hat_up")
DOWN_KINDS = ("loss_down", "grad_down", "param_down", "serve_down")

SERVER = "server"


def party(m: int) -> str:
    """Canonical endpoint name of party m."""
    return f"party:{int(m)}"


def party_index(endpoint: str) -> int:
    """Inverse of :func:`party`; raises for the server endpoint."""
    kind, _, idx = endpoint.partition(":")
    if kind != "party" or not idx:
        raise ValueError(f"not a party endpoint: {endpoint!r}")
    return int(idx)


@dataclass(frozen=True)
class Message:
    """One boundary crossing. ``payload`` is the wire object exactly as
    encoded by the sender; ``nbytes`` is its measured size. ``meta``
    carries the shared sample alignment (protocol context, not payload,
    so it is excluded from byte accounting)."""

    kind: str
    sender: str
    receiver: str
    round: int
    payload: Any
    nbytes: int
    meta: Optional[dict] = None

    @classmethod
    def make(cls, kind: str, sender: str, receiver: str, round: int,
             payload: Any, nbytes: Optional[int] = None,
             meta: Optional[dict] = None) -> "Message":
        if kind not in KINDS:
            raise ValueError(f"unknown message kind {kind!r}; have {KINDS}")
        if nbytes is None:
            nbytes = (len(payload) * SCALAR_BYTES if kind == "loss_down"
                      else wire_nbytes(payload))
        return cls(kind, sender, receiver, int(round), payload, int(nbytes),
                   meta)

    def scalars(self) -> tuple:
        """The f32 scalar payload of a loss_down message."""
        assert self.kind == "loss_down", self.kind
        return tuple(self.payload)


class Channel:
    """Transport with measured per-kind accounting. ``send`` delivers a
    message (identity here) and returns the delivered message."""

    name = "abstract"

    def __init__(self):
        self.sent = 0
        self.bytes_by_kind: dict[str, int] = {}
        self.msgs_by_kind: dict[str, int] = {}

    def _account(self, msg: Message) -> None:
        self.sent += 1
        self.bytes_by_kind[msg.kind] = (
            self.bytes_by_kind.get(msg.kind, 0) + msg.nbytes)
        self.msgs_by_kind[msg.kind] = self.msgs_by_kind.get(msg.kind, 0) + 1

    @property
    def up_bytes(self) -> int:
        return sum(self.bytes_by_kind.get(k, 0) for k in UP_KINDS)

    @property
    def down_bytes(self) -> int:
        return sum(self.bytes_by_kind.get(k, 0) for k in DOWN_KINDS)

    def send(self, msg: Message) -> Message:
        if msg.kind not in KINDS:
            raise ValueError(f"unknown message kind {msg.kind!r}")
        self._account(msg)
        return msg


class InMemoryChannel(Channel):
    """Free, instant transport."""

    name = "inmemory"
