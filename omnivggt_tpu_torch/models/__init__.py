"""Model modules: DINOv2 embedder, aggregator, camera head, DPT heads."""
