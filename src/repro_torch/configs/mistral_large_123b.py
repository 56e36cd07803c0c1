"""mistral-large-123b — dense, GQA(kv=8)
[hf:mistralai/Mistral-Large-Instruct-2407; unverified].  The numbers of
``repro/configs/mistral_large_123b.py``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    rope_theta=1e6, source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
)
