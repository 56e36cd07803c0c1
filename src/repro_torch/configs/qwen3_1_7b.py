"""qwen3-1.7b — dense, GQA(kv=8), qk_norm [hf:Qwen/Qwen3-8B; hf].  The
numbers of ``repro/configs/qwen3_1_7b.py``: 28 layers of d_model 2,048, 16
query heads and 8 KV heads of 128 with RMS-normed q and k, d_ff 6,144,
vocab 151,936; about 2.03B parameters."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=6144, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, source="hf:Qwen/Qwen3-8B; hf",
)
