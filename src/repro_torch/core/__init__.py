"""DIAL core on PyTorch: Θ, designed metrics, Algorithm 1, the GBDT
forests, the model and the fleet agent."""
