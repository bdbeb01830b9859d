"""Tensor operations: layers, attention dispatch, RoPE, resizing, activations."""
