"""Metrics of the port: VGG16 features and the VGG16-LPIPS embedding, and
the named detectors over them."""
