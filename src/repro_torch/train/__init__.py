"""LM training: AdamW and the train / prefill / decode step builders."""
