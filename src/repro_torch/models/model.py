"""The model API of every family of the registry (dense, moe, ssm
(rwkv6), hybrid (hymba), vlm (chameleon), audio (whisper)), mirroring the
reference's models/model.py:

    model = build_model(get_config("qwen1.5-0.5b"))
    params = model.init(key, device)
    loss, metrics = model.loss(params, batch)
    logits, aux = model.forward(params, batch)                 # prefill
    cache = model.init_cache(params, batch_size, max_len[, frames])
    logits, cache = model.decode_step(params, cache, token, pos)  # serve

Batch dicts: {"tokens": (B, S) int, "targets": (B, S) int}, plus
"modality_mask" (B, S) int for vlm (the VQ stub: image patches are token
ids of the shared vocabulary, the mask picks a modality embedding row)
and "frames" (B, F, d_model) for audio (the conv frontend stub's
output). The VFL mode (core/vfl.py) passes the party towers'
concatenated output as batch["embeds"] (B, S, d_model) instead of
tokens. Optional entries, as the reference reads them: "positions" (B,
S) int, for RoPE and as the causal mask's positions (default 0..S-1);
"loss_mask" (B, S), the tokens ``loss`` averages over; "pos_offset", which
decides whether sinusoidal positions are added (``_embed``). With
``cfg.chunked_ce`` the loss never builds the (B, S, V) logits.
``decode_step`` updates the cache in place and returns it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (chunked_cross_entropy,
                                       cross_entropy_loss, embedding_init,
                                       rms_norm, sinusoidal_position_at,
                                       sinusoidal_positions)
from repro_torch.utils import prng, trees

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in tf.FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; known: "
                             f"{tf.FAMILIES}")
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
        if cfg.frontend == "vq_stub":
            params["modality_embed"] = (
                prng.normal(ks[3], (2, cfg.d_model), device)
                * float(np.float32(0.02))).to(self.dtype)
        if cfg.enc_dec:
            params["encoder"] = {
                "layers": tf.stacked_layers_init(
                    ks[4], self._encoder_cfg(), device, self.dtype,
                    cfg.num_encoder_layers),
                "final_norm": torch.ones((cfg.d_model,), dtype=self.dtype,
                                         device=device)}
        return params

    def _encoder_cfg(self) -> ModelConfig:
        return self.cfg.replace(enc_dec=False, sliding_window=None)

    def _embed(self, params, batch):
        """The input embeddings. Sinusoidal positions 0..S-1 are added
        when batch["pos_offset"] is absent or an int, whatever its value,
        and not at all for any other offset (a tensor): the reference's
        rule, kept as it is."""
        cfg = self.cfg
        if "embeds" in batch:                 # VFL party-tower path
            x = batch["embeds"].to(self.dtype)
        else:
            x = params["embed"][batch["tokens"].long()]
        if cfg.frontend == "vq_stub" and "modality_mask" in batch:
            x = x + params["modality_embed"][batch["modality_mask"].long()]
        if cfg.pos_emb == "sinusoidal" and \
                isinstance(batch.get("pos_offset", 0), int):
            pe = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
            x = x + pe[None].to(self.dtype)
        return x

    def _encode(self, params, frames):
        """Whisper's encoder over the (stub) frame embeddings (B, F, d):
        sinusoidal positions, bidirectional layers, the final norm."""
        cfg = self.cfg
        B, F, _ = frames.shape
        x = frames.to(self.dtype)
        x = x + sinusoidal_positions(F, cfg.d_model, x.device)[None].to(
            self.dtype)
        positions = torch.arange(F, device=x.device)[None, :].expand(B, F)
        x, _ = tf.stack_forward(params["encoder"]["layers"],
                                self._encoder_cfg(), x, positions,
                                causal=False)
        return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)

    def _head(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        return x @ w.to(self.dtype)

    def _backbone(self, params, batch):
        """Embeddings through every layer: (x (B, S, d) before the final
        norm, aux). Explicit batch["positions"] feed RoPE and the causal
        mask; without them both use 0..S-1 (the mask by index)."""
        x = self._embed(params, batch)
        B, S = x.shape[:2]
        explicit = "positions" in batch
        positions = batch["positions"].to(x.device) if explicit else \
            torch.arange(S, device=x.device)[None, :].expand(B, S)
        enc_out = self._encode(params, batch["frames"]) \
            if self.cfg.enc_dec else None
        return tf.stack_forward(params["layers"], self.cfg, x, positions,
                                enc_out=enc_out, causal=True,
                                mask_positions=explicit)

    def forward(self, params, batch):
        x, aux = self._backbone(params, batch)
        return self._head(params, x), aux

    def loss(self, params, batch):
        """(ce + aux, {"ce", "aux"}): the token-mean cross entropy over
        batch["loss_mask"] where given. With ``cfg.chunked_ce`` the head
        runs inside the vocab-chunked loss, which never builds the
        logits."""
        mask = batch.get("loss_mask")
        if self.cfg.chunked_ce:
            x, aux = self._backbone(params, batch)
            x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
            w = params["embed"].T if self.cfg.tie_embeddings \
                else params["lm_head"]
            ce = chunked_cross_entropy(x, w.to(self.dtype), batch["targets"],
                                       mask)
            return ce + aux, {"ce": ce, "aux": aux}
        logits, aux = self.forward(params, batch)
        ce = cross_entropy_loss(logits, batch["targets"], mask)
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, params, batch_size: int, max_len: int, frames=None):
        """Zeros on the params' device: per layer a KV cache (a rolling
        buffer under a sliding window) and the recurrent states (ssm;
        hybrid's mamba heads), stacked on the layer axis, with the slot
        (batch) axis at axis 1 of every leaf. The encoder-decoder also
        encodes ``frames`` (batch_size, F, d) once and keeps each decoder
        layer's cross K/V, "cross_kv" {"k", "v"} (L, batch_size, F, KV,
        hd)."""
        cfg = self.cfg
        cache = {"layers": tf.stacked_cache_init(
            cfg, batch_size, max_len, self.dtype, cfg.num_layers,
            params["embed"].device)}
        if cfg.enc_dec:
            if frames is None:
                raise ValueError("enc-dec decode needs encoder frames")
            enc_out = self._encode(params, frames)
            per = [attn.encode_kv(tf._layer(params["layers"], i)["cross"],
                                  cfg, enc_out)
                   for i in range(cfg.num_layers)]
            cache["cross_kv"] = trees.tree_map(
                lambda *xs: torch.stack(xs), *per)
        return cache

    def decode_step(self, params, cache, token, pos):
        """token: (B, 1) int, or {"embeds": (B, 1, d)}; pos: an int or a
        per-slot (B,) int tensor of absolute positions. Returns (logits
        (B, 1, V), cache): the cache is updated IN PLACE and returned, not
        copied (the reference's functional update is in place under jit;
        a copy here would move the whole cache each token)."""
        cfg = self.cfg
        if isinstance(token, dict):
            x = token["embeds"].to(self.dtype)
        else:
            x = params["embed"][token.long()]
            if cfg.frontend == "vq_stub":
                # the new token's modality defaults to text (mask 0)
                x = x + params["modality_embed"][0][None, None, :]
        B = x.shape[0]
        if isinstance(pos, torch.Tensor):
            pos = pos.to(x.device).expand(B)
        else:       # a fill on the device: a host copy would wait for it
            pos = torch.full((B,), int(pos), dtype=torch.int64,
                             device=x.device)
        if cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal_position_at(pos, cfg.d_model)[:, None, :].to(
                self.dtype)
        x, cache["layers"] = tf.stack_decode(params["layers"], cfg, x,
                                             cache["layers"], pos,
                                             cross_kv=cache.get("cross_kv"))
        return self._head(params, x), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
