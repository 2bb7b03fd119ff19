"""Cloud and cloud-shadow detection (``satellite_approximation_tpu/models/detection``):
the pipeline and its five stages."""
