"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060;
unverified].  The numbers of ``repro/configs/mamba2_130m.py``."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=128),
    tie_embeddings=True, source="arXiv:2405.21060; unverified",
)
