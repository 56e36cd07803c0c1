"""phi3.5-moe-42b-a6.6b — MoE, 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf].  The numbers of
``repro/configs/phi35_moe_42b.py``: 32 layers of d_model 4,096, 32 query
heads and 8 KV heads of 128, 16 experts of d_ff 6,400 (1.26B parameters a
layer), vocab 32,064; about 41.9B parameters."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    rope_theta=1e4, source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
