"""The RG-LRU gated linear recurrence (Griffin)."""
