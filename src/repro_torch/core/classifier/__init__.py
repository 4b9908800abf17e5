"""Mode classifier: features, CART tree, cost model, packed inference."""
