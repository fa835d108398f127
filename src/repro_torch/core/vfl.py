"""The VFL composite model — problem (P), Section 3.1.

    f_i(w_0, w) = F_0(w_0, c_{i,1}, ..., c_{i,q}; y_i) + lam * sum_m g(w_m),
    c_{i,m} = F_m(w_m; x_{i,m})

Each party m privately holds a vertical feature slice x_{i,m} and a
black-box local model F_m; the server holds labels and the global model
F_0. Only the c values (party -> server) and scalar losses (server ->
party) ever cross the boundary.

  * PaperLRModel  — generalized linear model, Eq. (22).
  * PaperFCNModel — party towers are 2-layer FCNs (d_m x 128, 128 x 1,
    ReLU) with scalar output; the server is a (q x 10) FC + softmax CE.
  * TransformerVFLModel — framework scale: an architecture of the
    registry (dense, rwkv6 or hymba) as the server model F_0, fed by the
    parties' private embedding slices.

Params are dicts of tensors; ``init_*`` take the device to build them on.
A round's two tower evaluations go through ``party_forward_pair``: the
FCN's pair of first-layer products is one dual_matmul kernel
(kernels/dual_matmul.py) on the card; every other product is plain
``torch.matmul`` (the reference leaves them to XLA, outside any kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_models import PaperFCNConfig, PaperLRConfig
from repro_torch.kernels import ops
from repro_torch.obs import trace
from repro_torch.models.layers import (cross_entropy_loss, dense_init,
                                       embedding_init)
from repro_torch.utils import prng, trees


def split_features(d_total: int, q: int) -> list[tuple[int, int]]:
    """Vertical partition: q nearly-equal contiguous feature blocks."""
    base, rem = divmod(d_total, q)
    out, start = [], 0
    for m in range(q):
        size = base + (1 if m < rem else 0)
        out.append((start, size))
        start += size
    return out


def pad_features(x: torch.Tensor, d_total: int, q: int) -> torch.Tensor:
    """Pad feature rows to q * ceil(d/q) so every party block has the same
    width."""
    target = -(-d_total // q) * q
    if x.shape[-1] == target:
        return x
    return torch.nn.functional.pad(x, (0, target - x.shape[-1]))


def nonconvex_reg(tree) -> torch.Tensor:
    """g(w) = sum_j w_j^2 / (1 + w_j^2)  (Eq. 22's regularizer)."""
    tot = None
    for x in trees.leaves(tree):
        x2 = torch.square(x.float())
        s = torch.sum(x2 / (1.0 + x2))
        tot = s if tot is None else tot + s
    return tot


class VFLModel:
    """Interface. c values are (B,) per party."""

    num_parties: int

    def init_party(self, key, m: int, device):
        raise NotImplementedError

    def init_server(self, key, device):
        raise NotImplementedError

    def party_forward(self, w_m, x_m, m: int):
        """F_m: private features -> c_m."""
        raise NotImplementedError

    def party_forward_pair(self, w_m, w_p, u, x_m, m: int, mu: float):
        """A round's two tower evaluations (c, c_hat) = (F_m(w_m; x_m),
        F_m(w_p; x_m)), where w_p = w_m + mu * u is the perturbed block."""
        return self.party_forward(w_m, x_m, m), self.party_forward(w_p, x_m, m)

    def server_forward(self, w0, cs, y):
        """F_0: the (B, q) table of c values + labels -> scalar loss."""
        raise NotImplementedError

    def server_predict(self, w0, cs):
        """F_0's decision from a received c table (B, q)."""
        raise NotImplementedError

    def regularizer(self, w_m):
        return 0.0                       # g = 0

    def slice_features(self, x, m: int):
        raise NotImplementedError

    def replace_party_output(self, cs, c_new, m: int):
        """cs (B, q) with party m's column swapped for c_new."""
        out = cs.clone()
        out[:, m] = c_new.to(cs.dtype)
        return out

    def map_party_outputs(self, cs, fn):
        """fn(c_m, m) on each party's column of the c table on its own: one
        message per party, as the wire carries them (a codec sees one
        party's upload at a time)."""
        return torch.stack([fn(cs[:, m].contiguous(), m)
                            for m in range(self.num_parties)], dim=1)

    # batch adapters: what the parties and the server read of a batch
    # (TransformerVFLModel overrides them)
    def party_args(self, batch):
        return batch["x"]

    def server_args(self, batch):
        return batch["y"]

    # --- conveniences -----------------------------------------------------
    def init_parties_stacked(self, key, device):
        keys = prng.split(key, self.num_parties)
        per = [self.init_party(keys[m], m, device)
               for m in range(self.num_parties)]
        return trees.tree_map(lambda *xs: torch.stack(xs), *per)

    def all_party_outputs(self, stacked_w, x):
        """c_m for every party, stacked (B, q)."""
        return torch.stack([
            self.party_forward(trees.tree_map(lambda a: a[m], stacked_w),
                               self.slice_features(x, m), m)
            for m in range(self.num_parties)], dim=1)

    def predict(self, w0, stacked_w, x):
        return self.server_predict(w0, self.all_party_outputs(stacked_w, x))

    def full_loss(self, w0, stacked_w, x, y, lam: float):
        """Centralized view of problem (P): F_0 on every party's c plus lam
        times the parties' regularizers."""
        cs = self.all_party_outputs(stacked_w, x)
        reg = sum(self.regularizer(trees.tree_map(lambda a: a[m], stacked_w))
                  for m in range(self.num_parties))
        return self.server_forward(w0, cs, y) + lam * reg


class PaperLRModel(VFLModel):
    """Black-box federated nonconvex logistic regression (Eq. 22)."""

    def __init__(self, cfg: PaperLRConfig):
        self.cfg = cfg
        self.num_parties = cfg.num_parties
        self.pad = -(-cfg.num_features // cfg.num_parties)

    def init_party(self, key, m: int, device):
        return {"w": torch.zeros((self.pad,), device=device)}

    def init_server(self, key, device):
        return {"b": torch.zeros((), device=device)}

    def slice_features(self, x, m: int):
        return x[..., m * self.pad:(m + 1) * self.pad]

    def party_forward(self, w_m, x_m, m: int):
        return x_m @ w_m["w"]             # (B,)

    def server_forward(self, w0, cs, y):
        z = torch.sum(cs, dim=1) + w0["b"]
        return torch.mean(torch.log1p(torch.exp(-y * z)))

    def regularizer(self, w_m):
        return nonconvex_reg(w_m)

    def server_predict(self, w0, cs):
        return torch.sign(torch.sum(cs, dim=1) + w0["b"])


class PaperFCNModel(VFLModel):
    """Black-box federated neural network (Section 5.1)."""

    def __init__(self, cfg: PaperFCNConfig):
        self.cfg = cfg
        self.num_parties = cfg.num_parties
        self.pad = -(-cfg.num_features // cfg.num_parties)

    def init_party(self, key, m: int, device):
        k1, k2 = prng.split(key)
        h = self.cfg.party_hidden
        return {"w1": dense_init(k1, self.pad, h, device),
                "b1": torch.zeros((h,), device=device),
                "w2": dense_init(k2, h, 1, device),
                "b2": torch.zeros((1,), device=device)}

    def init_server(self, key, device):
        return {"w": dense_init(key, self.num_parties, self.cfg.num_classes,
                                device),
                "b": torch.zeros((self.cfg.num_classes,), device=device)}

    def slice_features(self, x, m: int):
        return x[..., m * self.pad:(m + 1) * self.pad]

    @staticmethod
    def _tower_head(w, z):
        """The tower after its first product z = x_m @ w1."""
        h = torch.relu(z + w["b1"])
        return (h @ w["w2"] + w["b2"])[..., 0]          # (B,)

    def party_forward(self, w_m, x_m, m: int):
        return self._tower_head(w_m, x_m @ w_m["w1"])

    def party_forward_pair(self, w_m, w_p, u, x_m, m: int, mu: float):
        """Both first-layer products in one dual_matmul: the kernel forms
        w1 + mu * u1 itself, bitwise ``w_p["w1"]``; the rest of each tower
        runs on its own block's b1, w2, b2."""
        z, z_hat = ops.dual_matmul(x_m, w_m["w1"], u["w1"], mu)
        return self._tower_head(w_m, z), self._tower_head(w_p, z_hat)

    def server_forward(self, w0, cs, y):
        return cross_entropy_loss(cs @ w0["w"] + w0["b"], y)

    def server_predict(self, w0, cs):
        return torch.argmax(cs @ w0["w"] + w0["b"], dim=-1)


# --------------------------------------------------------- Transformer -----

class TransformerVFLModel(VFLModel):
    """Framework-scale VFL: an architecture of the registry (dense, ssm or
    hybrid) as the server model F_0.

    Party m privately owns columns [m*dq : (m+1)*dq) of the embedding
    feature space (dq = d_model/q), its vertical feature slice, plus a
    small MLP tower: c_m = tower_m(embed_m[tokens]), shaped (B, S, dq).
    The server concatenates the q slices to (B, S, d_model) and runs the
    backbone. Party params are f32 whatever the model's dtype is. Each
    call of ``party_forward`` and ``server_forward`` is a span
    (``obs.trace``: vfl.party_forward, vfl.server_forward).
    """

    def __init__(self, model, vfl: VFLConfig):
        cfg = model.cfg
        if cfg.d_model % vfl.num_parties:
            raise ValueError(f"d_model {cfg.d_model} must divide by q = "
                             f"{vfl.num_parties} for the vertical embedding "
                             "split")
        self.model = model
        self.vfl = vfl
        self.num_parties = vfl.num_parties
        self.dq = cfg.d_model // vfl.num_parties

    def init_party(self, key, m: int, device):
        cfg = self.model.cfg
        k0, k1, k2 = prng.split(key, 3)
        h = self.vfl.party_hidden
        return {"embed": embedding_init(k0, cfg.vocab_size, self.dq, device,
                                        torch.float32),
                "w1": dense_init(k1, self.dq, h, device),
                "w2": dense_init(k2, h, self.dq, device)}

    def init_server(self, key, device):
        return self.model.init(key, device)

    def slice_features(self, x, m: int):
        return x        # tokens are shared ids; the SLICE is the embedding

    def party_forward(self, w_m, tokens, m: int):
        with trace("vfl.party_forward"):
            e = w_m["embed"][tokens.long()]                 # (B, S, dq)
            h = F.gelu(e @ w_m["w1"], approximate="tanh")   # jax.nn.gelu's
            return e + h @ w_m["w2"]                        # residual tower

    def all_party_outputs(self, stacked_w, tokens):
        return torch.stack([
            self.party_forward(trees.tree_map(lambda a: a[m], stacked_w),
                               tokens, m)
            for m in range(self.num_parties)], dim=2)   # (B, S, q, dq)

    def replace_party_output(self, cs, c_new, m: int):
        """cs with party m's slice (B, S, dq) swapped for c_new."""
        out = cs.clone()
        out[:, :, m] = c_new.to(cs.dtype)
        return out

    def map_party_outputs(self, cs, fn):
        """fn(c_m, m) on each party's slice of the c table on its own: one
        message per party, as the wire carries them (a codec sees one
        party's upload at a time)."""
        return torch.stack([fn(cs[:, :, m].contiguous(), m)   # (B, S, dq)
                            for m in range(self.num_parties)], dim=2)

    # batch adapters: what the parties and the server read of a batch
    def party_args(self, batch):
        return batch["tokens"]

    def server_args(self, batch):
        return batch

    def server_forward(self, w0, cs, batch):
        with trace("vfl.server_forward"):
            B, S = cs.shape[:2]
            b = dict(batch)
            b["embeds"] = cs.reshape(B, S, -1)          # concat party slices
            loss, _ = self.model.loss(w0, b)
            return loss
