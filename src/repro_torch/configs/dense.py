"""The dense architectures of the registry, copied from the reference's
configs/{qwen15_05b,deepseek_7b,yi_34b,minicpm_2b}.py: full, paper-exact
sizes (``get_config(..., reduced=True)`` gives the smoke-test variant)."""
from repro_torch.configs.base import ModelConfig

# qwen1.5-0.5b: dense with QKV bias [hf:Qwen/Qwen1.5-0.5B]
QWEN15_05B = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=2816, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True,
    citation="hf:Qwen/Qwen1.5-0.5B",
)

# deepseek-7b: dense llama-arch, MHA (kv=32) [arXiv:2401.02954]
DEEPSEEK_7B = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    head_dim=128, d_ff=11008, vocab_size=102400,
    citation="arXiv:2401.02954",
)

# yi-34b: dense llama-arch GQA [arXiv:2403.04652]
YI_34B = ModelConfig(
    name="yi-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64000,
    rope_theta=5_000_000.0,
    citation="arXiv:2403.04652",
)

# minicpm-2b: dense llama-like, WSD schedule [arXiv:2404.06395]; kv=36 == MHA
MINICPM_2B = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    head_dim=64, d_ff=5760, vocab_size=122753,
    tie_embeddings=True,
    citation="arXiv:2404.06395",
)
