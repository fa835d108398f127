"""vfl-zoo training on a server that holds one card's share of each MoE
layer's experts (the configuration's ``moe_shard``): ``modes/zoo.py``'s
cell, with the port's config cut by ``sharding.rules.expert_shard`` and
run through the same ``launch.train.make_zoo_run``.

The server's parameters are counted from the file with the held experts
alone; the step's FLOPs count each token's K expert products at the
share that lands on the held experts on average (K x held / E) and the
router at its full width; the plain reference is
``perfbench/reference/moe_share.py``.
"""
from __future__ import annotations

import torch

from perfbench import check, inputs
from perfbench.bounds import model_flops
from perfbench.modes import zoo

KERNELS = zoo.KERNELS
BATCHES = zoo.BATCHES


def held_experts(cfg: dict) -> tuple:
    """(first, count) of the experts this card holds."""
    s = cfg["moe_shard"]
    n = s["experts_held"]
    return s["rank"] * n, n


def server_params(cfg: dict) -> int:
    """``model_flops.server_params`` with each layer's held experts."""
    cut = cfg["num_experts"] - held_experts(cfg)[1]
    return model_flops.server_params(cfg) - cfg["num_hidden_layers"] * 3 \
        * cut * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def forward_per_token(cfg: dict, seq_len: int) -> float:
    """``model_flops.forward_per_token`` with a token's K expert products
    at the share that the held experts compute, K x held / E."""
    cut = 1 - held_experts(cfg)[1] / cfg["num_experts"]
    experts = cfg["num_hidden_layers"] * cfg["num_experts_per_tok"] * 3 \
        * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    return model_flops.forward_per_token(cfg, seq_len) - 2.0 * experts * cut


class Cell(zoo.Cell):
    def __init__(self, port_cfg, cfg: dict, traffic: dict, seed: int,
                 device):
        from repro_torch.core.vfl import TransformerVFLModel
        from repro_torch.launch import train
        from repro_torch.sharding import rules

        s = cfg["moe_shard"]
        port_cfg = rules.expert_shard(port_cfg, s["cards"], s["rank"])
        if port_cfg.moe.held != held_experts(cfg):
            raise ValueError(f"the port holds experts {port_cfg.moe.held} "
                             f"(first, count), the file states "
                             f"{held_experts(cfg)}")
        self.traffic, self.seed, self.device = traffic, seed, device
        args = train.parse_args(zoo.launcher_argv(traffic,
                                                  inputs.weight_seed(seed)))
        vfl, self.step_fn, self.state, _ = train.make_zoo_run(
            args, port_cfg, device)
        if TransformerVFLModel.regularizer(None, {}) != 0.0:
            raise ValueError("the reference puts no regularizer on the "
                             "party blocks; the program's model has one")
        for name, want in (("max_delay", traffic["max_delay"]),
                           ("party_hidden", traffic["party_hidden"])):
            if getattr(vfl, name) != want:
                raise ValueError(f"the launcher's {name} is "
                                 f"{getattr(vfl, name)}, the traffic file "
                                 f"states {want}")
        B, S, n = traffic["batch"], traffic["seq_len"], traffic["rows"]
        toks, tgts = inputs.rows(seed, n, S, cfg["vocab_size"])
        self.tokens = torch.as_tensor(toks, device=device)
        self.targets = torch.as_tensor(tgts, device=device)
        self.order = torch.as_tensor(
            inputs.batch_order(seed, n, B, BATCHES), device=device)
        self.t = 0
        self.tokens_per_step = B * S
        dq, hid = cfg["hidden_size"] // traffic["parties"], vfl.party_hidden
        server = sum(t.numel() for _, t in check.named_leaves(self.state.w0))
        if server != server_params(cfg):
            raise ValueError(f"the server holds {server} parameters, the "
                             f"count from the file is {server_params(cfg)}")
        H = cfg["num_attention_heads"]
        self.facts = {
            # three server forwards and q + 1 party towers a step
            "step_flops": B * S * (
                3 * forward_per_token(cfg, S)
                + (traffic["parties"] + 1) * 2 * 2 * dq * hid),
            # one gaussian word per perturbed parameter: party m's block
            # and the server's w0
            "draw_words_per_step": server + cfg["vocab_size"] * dq
            + 2 * dq * hid,
            "attention": (B, S, H, cfg["num_key_value_heads"],
                          cfg.get("head_dim") or cfg["hidden_size"] // H,
                          2 if cfg["torch_dtype"] == "bfloat16" else 4,
                          True)}

    def reference(self, cfg: dict, prec=None, half_batch=False) -> dict:
        """The plain reference of the share over the same first steps. Its
        first update stays on the host, w0's leaves in the weight type
        (the reference stores them rounded to it, so nothing is lost)."""
        from perfbench.reference import model as M
        from perfbench.reference import moe_share as R
        from perfbench.reference import prng
        from perfbench.reference import zoo as Z

        sh, zo, share = M.Shape.of(cfg), Z.ZO(self.traffic), R.Share.of(cfg)
        st = R.init_state(prng.key(inputs.weight_seed(self.seed)), sh, share,
                          zo, self.device)

        def params(s):
            return (M.leaves(s["w0"], "w0.")
                    + M.leaves(s["parties"], "parties."))

        def host(s):      # copies: the reference moves w0 in place
            return [(n, t.detach().to("cpu", sh.dtype if n.startswith("w0.")
                                      else t.dtype, copy=True))
                    for n, t in params(s)]
        s0 = host(st)
        B = self.traffic["batch"]
        order = inputs.batch_order(self.seed, self.traffic["rows"], B,
                                   self.traffic["check_steps"])
        losses, grad, extra, s1 = [], None, [], None
        for rows in order:
            rows = torch.as_tensor(rows[:max(B // 2, 1)] if half_batch
                                   else rows, device=self.device)
            st, h, info = R.step(st, self.tokens[rows], self.targets[rows],
                                 sh, share, zo, prec or M.F32)
            losses.append(h)
            extra.append(info)
            if grad is None:
                grad = check.change_norms(s0, params(st))
                s1 = host(st)
        return {"losses": losses, "grad": grad,
                "change": check.change_norms(s0, params(st)),
                "first_update": (s0, s1), "info": extra}
