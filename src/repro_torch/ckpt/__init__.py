"""Checkpoints: durable save/restore and the PFS write-path accounting."""
