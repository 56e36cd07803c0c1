"""hymba-1.5b — hybrid parallel attention and mamba heads, sliding window
[arXiv:2411.13676; hf].  The numbers of ``repro/configs/hymba_1_5b.py``: 32
layers of d_model 1,600, each 25 attention heads of 64 (5 KV heads) in
parallel with 25 SSM heads (d_inner 1,600, state 16), mean-fused; a
1,024-token window except in the first, middle and last layers; about
1.39B parameters."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm=SSMConfig(state_dim=16, head_dim=64, conv_width=4, chunk=128,
                  d_inner=1600),
    attn_window=1024, rope_theta=1e4, source="arXiv:2411.13676; hf",
)
