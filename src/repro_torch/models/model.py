"""The model API of the dense, ssm (rwkv6) and hybrid (hymba) families,
mirroring the reference's models/model.py:

    model = build_model(get_config("qwen1.5-0.5b"))
    params = model.init(key, device)
    loss, metrics = model.loss(params, batch)
    logits, aux = model.forward(params, batch)                 # prefill
    cache = model.init_cache(params, batch_size, max_len)
    logits, cache = model.decode_step(params, cache, token, pos)  # serve

Batch dicts: {"tokens": (B, S) int, "targets": (B, S) int}; the VFL mode
(core/vfl.py) passes the party towers' concatenated output as
batch["embeds"] (B, S, d_model) instead of tokens. Positions are 0..S-1
(the attention kernel's and the window's mask); a "positions" entry
raises. ``decode_step`` updates the cache in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (cross_entropy_loss, embedding_init,
                                       rms_norm)
from repro_torch.utils import prng

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in tf.FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r}: the port builds the dense, ssm and "
                "hybrid families only (the moe, vlm and audio blocks are "
                "ROADMAP Queue 1 item 11)")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]

    def init(self, key, device):
        cfg = self.cfg
        ks = prng.split(key, 5)
        params = {
            "embed": embedding_init(ks[0], cfg.vocab_size, cfg.d_model,
                                    device, self.dtype),
            "layers": tf.stacked_layers_init(ks[1], cfg, device, self.dtype,
                                             cfg.num_layers),
            "final_norm": torch.ones((cfg.d_model,), dtype=self.dtype,
                                     device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = embedding_init(
                ks[2], cfg.vocab_size, cfg.d_model, device,
                self.dtype).T.contiguous()
        return params

    def _embed(self, params, batch):
        if "embeds" in batch:                 # VFL party-tower path
            return batch["embeds"].to(self.dtype)
        return params["embed"][batch["tokens"].long()]

    def _head(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        return x @ w.to(self.dtype)

    def forward(self, params, batch):
        if "positions" in batch:
            raise NotImplementedError(
                "explicit positions: the flash_attention kernel masks by "
                "position 0..S-1, which is what forward uses without them")
        x = self._embed(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        x, aux = tf.stack_forward(params["layers"], self.cfg, x, positions,
                                  causal=True)
        return self._head(params, x), aux

    def loss(self, params, batch):
        if self.cfg.chunked_ce:
            raise NotImplementedError("chunked_ce: no dense config sets it; "
                                      "the vocab-chunked loss is not ported")
        if "loss_mask" in batch:
            raise NotImplementedError("loss_mask is not ported")
        logits, aux = self.forward(params, batch)
        ce = cross_entropy_loss(logits, batch["targets"])
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, params, batch_size: int, max_len: int):
        """Zeros on the params' device: per layer a KV cache (dense, hybrid;
        a rolling buffer under a sliding window) and the recurrent states
        (ssm; hybrid's mamba heads), stacked on the layer axis, with the
        slot (batch) axis at axis 1 of every leaf."""
        cfg = self.cfg
        return {"layers": tf.stacked_cache_init(
            cfg, batch_size, max_len, self.dtype, cfg.num_layers,
            params["embed"].device)}

    def decode_step(self, params, cache, token, pos):
        """token: (B, 1) int, or {"embeds": (B, 1, d)}; pos: an int or a
        per-slot (B,) int tensor of absolute positions. Returns (logits
        (B, 1, V), cache): the cache is updated IN PLACE and returned, not
        copied (the reference's functional update is in place under jit;
        a copy here would move the whole cache each token)."""
        if isinstance(token, dict):
            x = token["embeds"].to(self.dtype)
        else:
            x = params["embed"][token.long()]
        B = x.shape[0]
        if isinstance(pos, torch.Tensor):
            pos = pos.to(x.device).expand(B)
        else:       # a fill on the device: a host copy would wait for it
            pos = torch.full((B,), int(pos), dtype=torch.int64,
                             device=x.device)
        x, cache["layers"] = tf.stack_decode(params["layers"], self.cfg, x,
                                             cache["layers"], pos)
        return self._head(params, x), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
