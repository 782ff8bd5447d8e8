"""GBDT training histograms: per-(node, feature, bin) gradient/hessian sums."""
