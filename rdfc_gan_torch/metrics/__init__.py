from .depth_metrics import METRIC_NAMES, RDFGANMetric, compute_depth_metrics

__all__ = ["METRIC_NAMES", "RDFGANMetric", "compute_depth_metrics"]
