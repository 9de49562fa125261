"""Observability of the PyTorch port (port of ``dpgo_tpu.obs``).  Only the
health thresholds (``health.HealthConfig``) are ported so far: the verdict
program judges its rows by them.  Runs, the event stream, the health
monitor and the flight recorder are ROADMAP item A10."""
