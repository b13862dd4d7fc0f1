"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.  The transformer
backbone only: the mel-spectrogram + conv feature extractor frontend is a
stub, as in the reference: the caller hands in precomputed frame
embeddings [B, 1500, D].

Decoder layers alternate self-attention and cross-attention (each with its
own MLP), giving 24 backbone layers; a 24-layer encoder stack consumes the
stubbed frame embeddings.
"""
from repro_torch.models.config import ArchConfig, EncoderConfig

FULL = ArchConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    block_pattern=("attn", "xattn"),
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    source="Seamless-M4T v2 large [arXiv:2308.11596]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="seamless-m4t-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512, param_dtype="float32",
        encoder=EncoderConfig(n_layers=2, n_frames=16))
