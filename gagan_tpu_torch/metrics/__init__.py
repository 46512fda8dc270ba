"""Metrics of the port: FID, KID, precision/recall, PPL and IS over the
feature statistics of a dataset and a generator, the metric registry, the
Inception-v3, VGG16 and AlexNet towers (with the VGG16 and AlexNet LPIPS),
the named detectors, and CLIP quality/diversity."""

from .metric_main import calc_metric, is_valid_metric, list_valid_metrics

__all__ = ["calc_metric", "is_valid_metric", "list_valid_metrics"]
