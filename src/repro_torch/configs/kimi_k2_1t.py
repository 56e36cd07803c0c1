"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified].  The numbers of
``repro/configs/kimi_k2_1t.py``: 61 layers of d_model 7,168, 64 query heads
and 8 KV heads of 112, 384 experts of d_ff 2,048 (16.9B parameters a
layer), vocab 163,840, Adafactor as its optimizer."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048),
    rope_theta=1e6, source="arXiv:2501.kimi2; unverified",
    optimizer="adafactor",
)
