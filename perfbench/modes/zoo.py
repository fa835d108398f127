"""vfl-zoo training: the port's launcher path (``launch.train.make_zoo_run``
and the AsyREVEL step it returns), fed by the benchmark's own rows.

Set-up makes the step and its state from the weight key, then drives
that same state through the first ``check_steps`` steps with the
window's own call and feed; their losses and changes are the program's
readings, and the window goes on from that state. After the window the
plain reference (``perfbench/reference/zoo.py``) runs those steps again
from the same key and rows.
"""
from __future__ import annotations

import gc

import torch

from perfbench import check, inputs
from perfbench.bounds import model_flops

KERNELS = ("defended_encode", "prng_draw", "flash_attention")
BATCHES = 4096


def launcher_argv(traffic: dict, seed: int) -> list:
    argv = ["--arch", "benchmark", "--mode", "vfl-zoo",
            "--parties", str(traffic["parties"]),
            "--batch-size", str(traffic["batch"]),
            "--seq-len", str(traffic["seq_len"]),
            "--mu", repr(traffic["mu"]), "--lr", repr(traffic["lr"]),
            "--codec", traffic["codec"], "--seed", str(seed)]
    return argv + (["--fused"] if traffic["fused"] else [])


class Cell:
    def __init__(self, port_cfg, cfg: dict, traffic: dict, seed: int,
                 device):
        from repro_torch.launch import train

        self.traffic, self.seed, self.device = traffic, seed, device
        args = train.parse_args(launcher_argv(traffic,
                                              inputs.weight_seed(seed)))
        vfl, self.step_fn, self.state, _ = train.make_zoo_run(
            args, port_cfg, device)
        from repro_torch.core.vfl import TransformerVFLModel
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
        if server != model_flops.server_params(cfg):
            raise ValueError(f"the server holds {server} parameters, the "
                             f"count from the file is "
                             f"{model_flops.server_params(cfg)}")
        H = cfg["num_attention_heads"]
        self.facts = {
            # three server forwards and q + 1 party towers a step
            "step_flops": B * S * (
                3 * model_flops.forward_per_token(cfg, S)
                + (traffic["parties"] + 1) * 2 * 2 * dq * hid),
            # one gaussian word per perturbed parameter: party m's block
            # and the server's w0
            "draw_words_per_step": server + cfg["vocab_size"] * dq
            + 2 * dq * hid,
            "attention": (B, S, H, cfg["num_key_value_heads"],
                          cfg.get("head_dim") or cfg["hidden_size"] // H,
                          2 if cfg["torch_dtype"] == "bfloat16" else 4,
                          True)}

    def _batch(self):
        i = self.order[self.t % BATCHES]
        self.t += 1
        return {"tokens": self.tokens[i], "targets": self.targets[i]}

    def step(self) -> float:
        self.state, h = self.step_fn(self.state, self._batch())
        return float(h)

    def _params(self, st):
        return (check.named_leaves(st.w0, "w0.")
                + check.named_leaves(st.parties, "parties."))

    def warm_up(self) -> dict:
        """The first steps, through ``step``: the program's readings."""
        s0 = check.host_copy(self._params(self.state))
        losses = [self.step()]
        s1 = check.host_copy(self._params(self.state))
        grad = check.change_norms(s0, self._params(self.state))
        for _ in range(self.traffic["check_steps"] - 1):
            losses.append(self.step())
        change = check.change_norms(s0, self._params(self.state))
        return {"losses": losses, "grad": grad, "change": change,
                "first_update": (s0, s1)}

    def free(self):
        """Drop the program's state before the reference runs."""
        del self.state, self.step_fn
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def reference(self, cfg: dict, prec=None, half_batch=False) -> dict:
        """The plain reference's readings over the same first steps."""
        from perfbench.reference import model as M
        from perfbench.reference import zoo as R
        from perfbench.reference import prng

        sh, zo = M.Shape.of(cfg), R.ZO(self.traffic)
        st = R.init_state(prng.key(inputs.weight_seed(self.seed)), sh, zo,
                          self.device)

        def params(s):
            return (M.leaves(s["w0"], "w0.")
                    + M.leaves(s["parties"], "parties."))
        s0 = [(n, t.clone()) for n, t in params(st)]
        B = self.traffic["batch"]
        order = inputs.batch_order(self.seed, self.traffic["rows"], B,
                                   self.traffic["check_steps"])
        losses, grad, extra, s1 = [], None, [], None
        for rows in order:
            rows = torch.as_tensor(rows[:max(B // 2, 1)] if half_batch
                                   else rows, device=self.device)
            st, h, info = R.step(st, self.tokens[rows], self.targets[rows],
                                 sh, zo, prec or M.F32)
            losses.append(h)
            extra.append(info)
            if grad is None:
                grad = check.change_norms(s0, params(st))
                s1 = [(n, t.clone()) for n, t in params(st)]
        return {"losses": losses, "grad": grad,
                "change": check.change_norms(s0, params(st)),
                "first_update": (s0, s1), "info": extra}
