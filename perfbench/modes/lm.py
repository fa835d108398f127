"""First-order training (the launcher's ``--mode lm``): the port's
``launch.steps.make_train_state`` and ``make_train_step`` as the launcher
sets them up (f32 Adam moments, clip 1, a cosine schedule with warmup
max(1, steps // 20) over the traffic file's ``schedule_steps``), fed by
the benchmark's own rows.

Set-up makes the state from the weight key and drives it through the
first ``check_steps`` steps with the window's own call and feed; their
losses, the first gradient as Adam got it (its first moment after step
1 over 1 - b1) and the change over the steps are the program's readings.
After the window the plain reference (``perfbench/reference/lm.py``)
runs those steps again from the same key and rows.
"""
from __future__ import annotations

import gc

import torch

from perfbench import check, inputs
from perfbench.bounds import model_flops

KERNELS = ("prng_draw", "flash_attention", "flash_attention_bwd")
BATCHES = 4096
B1 = 0.9


class Cell:
    def __init__(self, port_cfg, cfg: dict, traffic: dict, seed: int,
                 device):
        from repro_torch.launch import steps
        from repro_torch.models.model import build_model
        from repro_torch.optim.schedules import make_schedule
        from repro_torch.utils import prng

        self.traffic, self.seed, self.device = traffic, seed, device
        model = build_model(port_cfg)
        total = traffic["schedule_steps"]
        sched = make_schedule("cosine", traffic["lr"], total,
                              warmup=max(1, total // 20))
        self.state = steps.make_train_state(
            model, prng.key(inputs.weight_seed(seed)), device, torch.float32)
        self.step_fn = steps.make_train_step(model, sched,
                                             grad_clip=traffic["grad_clip"])
        B, S, n = traffic["batch"], traffic["seq_len"], traffic["rows"]
        toks, tgts = inputs.rows(seed, n, S, cfg["vocab_size"])
        self.tokens = torch.as_tensor(toks, device=device)
        self.targets = torch.as_tensor(tgts, device=device)
        self.order = torch.as_tensor(
            inputs.batch_order(seed, n, B, BATCHES), device=device)
        self.t = 0
        self.tokens_per_step = B * S
        H = cfg["num_attention_heads"]
        self.facts = {
            # forward and backward as three forwards; remat's recompute
            # is not counted
            "step_flops": 3 * B * S * model_flops.forward_per_token(cfg, S),
            "attention": (B, S, H, cfg["num_key_value_heads"],
                          cfg.get("head_dim") or cfg["hidden_size"] // H,
                          2 if cfg["torch_dtype"] == "bfloat16" else 4,
                          True)}

    def _batch(self):
        i = self.order[self.t % BATCHES]
        self.t += 1
        return {"tokens": self.tokens[i], "targets": self.targets[i]}

    def step(self) -> float:
        self.state, (loss, _) = self.step_fn(self.state, self._batch())
        return float(loss)

    def warm_up(self) -> dict:
        """The first steps, through ``step``: the program's readings."""
        s0 = check.host_copy(check.named_leaves(self.state.params))
        losses = [self.step()]
        grad = {n: float(torch.linalg.vector_norm(m.float())) / (1 - B1)
                for n, m in check.named_leaves(self.state.opt["m"])}
        for _ in range(self.traffic["check_steps"] - 1):
            losses.append(self.step())
        change = check.change_norms(s0, check.named_leaves(self.state.params))
        return {"losses": losses, "grad": grad, "change": change}

    def free(self):
        """Drop the program's state before the reference runs."""
        del self.state, self.step_fn
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def reference(self, cfg: dict, prec=None, half_batch=False) -> dict:
        """The plain reference's readings over the same first steps."""
        from perfbench.reference import lm as R
        from perfbench.reference import model as M
        from perfbench.reference import prng

        sh, tr = M.Shape.of(cfg), R.Train(self.traffic)
        st = R.init_state(prng.key(inputs.weight_seed(self.seed)), sh,
                          self.device)
        s0 = [(n, t.clone()) for n, t in M.leaves(st["params"])]
        B = self.traffic["batch"]
        order = inputs.batch_order(self.seed, self.traffic["rows"], B,
                                   self.traffic["check_steps"])
        losses, grad = [], None
        for rows in order:
            rows = torch.as_tensor(rows[:max(B // 2, 1)] if half_batch
                                   else rows, device=self.device)
            st, loss, g = R.step(st, self.tokens[rows], self.targets[rows],
                                 sh, tr, prec or M.F32)
            losses.append(loss)
            if grad is None:
                grad = {n: float(torch.linalg.vector_norm(t))
                        for n, t in M.leaves(g)}
            del g
        return {"losses": losses, "grad": grad,
                "change": check.change_norms(s0, M.leaves(st["params"]))}
