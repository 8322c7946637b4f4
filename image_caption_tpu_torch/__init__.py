"""PyTorch and CUDA port of image_caption_tpu, for one NVIDIA H100.

The JAX package ``image_caption_tpu`` stays the reference; this package
imports neither it nor JAX.  Its entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
