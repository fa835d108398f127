"""The multimodal architectures of the registry, copied from the
reference's configs/{chameleon_34b,whisper_small}.py: full, paper-exact
sizes (``get_config(..., reduced=True)`` gives the smoke-test variant).
Both frontends are stubs, as in the reference: chameleon's VQ image
tokenizer gives token ids in the shared vocabulary plus a modality mask,
whisper's mel + conv feature extractor gives precomputed frame
embeddings (B, frames, d_model)."""
from repro_torch.configs.base import ModelConfig

# chameleon-34b: early-fusion VLM with VQ image tokens in the text vocab,
# qk-norm for training stability [arXiv:2405.09818]
CHAMELEON_34B = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=65536,
    qk_norm=True, frontend="vq_stub",
    citation="arXiv:2405.09818",
)

# whisper-small: encoder-decoder audio model, sinusoidal positions, a
# transformer encoder over 1500 frames and an autoregressive decoder with
# cross attention [arXiv:2212.04356]
WHISPER_SMALL = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51865,
    enc_dec=True, num_encoder_layers=12, encoder_frames=1500,
    frontend="audio_stub", pos_emb="sinusoidal",
    sliding_window=None,
    citation="arXiv:2212.04356",
)
