"""The LM's data path: a DIAL-tuned token pipeline through the PFS."""
