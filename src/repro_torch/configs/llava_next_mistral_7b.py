"""llava-next-mistral-7b — VLM, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  The numbers of
``repro/configs/llava_next_mistral_7b.py``: the vision frontend is a stub
(576 precomputed patch embeddings of 1,024 per sample), the projector
(``mm_proj``) and the mistral-7b text backbone (32 layers of d_model 4,096,
32 query and 8 KV heads of 128, d_ff 14,336, vocab 32,000) are real."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_patch_tokens=576, rope_theta=1e6,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
