"""The Mamba-1 selective scan."""
