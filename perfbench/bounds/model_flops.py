"""The FLOPs of one forward of a decoder-only model per token, from a
configuration file's sizes: every matrix product (the q, k, v and o
projections, the MLP or the top-k experts a token is routed to and the
router, the head) and attention's two products over the keys a causal
query sees on average, (S + 1) / 2; a multiply and an add each. The
experts' capacity padding is not counted: it is not work the tokens
need."""
from __future__ import annotations


def forward_per_token(cfg: dict, seq_len: int) -> float:
    d = cfg["hidden_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    proj = d * H * hd * 2 + d * KV * hd * 2
    attn = 2 * H * hd * (seq_len + 1) / 2
    if "num_experts" in cfg:
        ffn = (cfg["num_experts_per_tok"] * 3 * d * cfg["moe_intermediate_size"]
               + d * cfg["num_experts"])
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"] * (proj + attn + ffn)
    return 2.0 * (layers + d * cfg["vocab_size"])


def server_params(cfg: dict) -> int:
    """The server model's parameters: embedding, head unless tied, final
    norm, and per layer the projections (with biases), qk-norm gammas, the
    two norms and the MLP or the router and the experts."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    layer = 2 * d * H * hd + 2 * d * KV * hd + 2 * d
    if cfg.get("qkv_bias"):
        layer += (H + 2 * KV) * hd
    if cfg.get("qk_norm"):
        layer += 2 * hd
    if "num_experts" in cfg:
        E, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        layer += d * E + 3 * E * d * f
    else:
        layer += 3 * d * cfg["intermediate_size"]
    head = 0 if cfg["tie_word_embeddings"] else V * d
    return V * d + head + d + L * layer
