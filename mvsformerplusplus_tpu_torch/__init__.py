"""PyTorch + CUDA port of mvsformerplusplus_tpu (flagship depth inference).

The JAX package `mvsformerplusplus_tpu` is the reference; this package keeps
its module layout and public layouts (NHWC features, [B, V, 2, 4, 4]
cameras, [B, N, H, Dh] attention) so each function has a counterpart by
name. It imports torch, numpy and the standard library only.

Entry point: `config.build_model(load_config(path))`, which runs on the card
unless the caller passes `device="cpu"`.
"""
