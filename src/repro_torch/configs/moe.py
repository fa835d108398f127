"""The mixture-of-experts architectures of the registry, copied from the
reference's configs/{phi35_moe_42b,qwen3_moe_30b}.py: full, paper-exact
sizes (``get_config(..., reduced=True)`` gives the smoke-test variant).
phi3.5-moe's 41.9B parameters take 83.7 GB in bf16, more than one 80 GB
card holds: at full size it needs more than one card."""
from repro_torch.configs.base import ModelConfig, MoEConfig

# phi3.5-moe-42b-a6.6b: 16 experts, top-2 routing
# [hf:microsoft/Phi-3.5-MoE-instruct]
PHI35_MOE_42B = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=6400, vocab_size=32064,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)

# qwen3-moe-30b-a3b: 128 experts, top-8, qk-norm [hf:Qwen/Qwen3-30B-A3B]
QWEN3_MOE_30B = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=768, vocab_size=151936,
    qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    citation="hf:Qwen/Qwen3-30B-A3B",
)
