"""The caption Transformer and its decoders."""
