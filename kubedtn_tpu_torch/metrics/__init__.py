"""The daemon's Prometheus exporter (metrics.py). Importing this package
does not import prometheus_client; importing kubedtn_tpu_torch.metrics
.metrics does."""
