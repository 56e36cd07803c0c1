"""smollm-135m — llama-arch small, GQA(kv=3) [hf:HuggingFaceTB/SmolLM-135M;
hf].  The numbers of ``repro/configs/smollm_135m.py``: 30 layers of
d_model 576, 9 query heads and 3 KV heads of 64, d_ff 1,536, vocab 49,152,
rope theta 1e4, an untied ``lm_head``; about 163M parameters (652 MB in
float32)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64,
    rope_theta=1e4, source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
