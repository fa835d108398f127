"""The recurrent architectures of the registry, copied from the reference's
configs/{rwkv6_16b,hymba_15b}.py: full, paper-exact sizes
(``get_config(..., reduced=True)`` gives the smoke-test variant)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

# rwkv6-1.6b (Finch): attention-free RNN with data-dependent decay
# [arXiv:2404.05892]; head_size 64 -> 32 heads at d_model 2048
RWKV6_16B = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", state_size=64, chunk_size=128,
                  decay_lora_rank=64),
    citation="arXiv:2404.05892",
)

# hymba-1.5b: hybrid, parallel attention + mamba heads in every layer,
# ssm_state 16, sliding-window attention [arXiv:2411.13676]; the mamba heads
# use Mamba-2-style scalar-per-head decay, so their scan shares the chunked
# linear-attention engine with rwkv6
HYMBA_15B = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    sliding_window=1024,
    ssm=SSMConfig(kind="mamba2", state_size=16, expand=2, chunk_size=128),
    citation="arXiv:2411.13676",
)
