"""Dense-forest GBDT margins: single forest and the read/write pair."""
