"""Causal, windowed, softcapped GQA attention (forward)."""
