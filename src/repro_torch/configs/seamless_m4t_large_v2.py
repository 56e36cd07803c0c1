"""seamless-m4t-large-v2 — encoder-decoder audio/text [arXiv:2308.11596;
hf].  The numbers of ``repro/configs/seamless_m4t_large_v2.py``: 24 encoder
and 24 decoder layers of d_model 1,024, 16 query and 16 KV heads of 64,
d_ff 8,192, vocab 256,206; about 2.04B parameters.  The modality frontend
is a stub, as in the reference: the encoder takes precomputed 1,024-wide
frame embeddings (w2v-BERT-style); both backbones are real."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    num_encoder_layers=24, encoder_input_dim=1024,
    rope_theta=1e4, source="arXiv:2308.11596; hf",
)
