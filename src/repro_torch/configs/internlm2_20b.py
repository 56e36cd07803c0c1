"""internlm2-20b — dense, GQA(kv=8) [arXiv:2403.17297; hf].  The numbers of
``repro/configs/internlm2_20b.py``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128,
    rope_theta=1e6, source="arXiv:2403.17297; hf",
)
