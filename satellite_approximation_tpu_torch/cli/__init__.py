"""Command-line entry points mirroring the reference's executables/:
laplace_main, poisson_main, cloud_detection_main (the port of
``satellite_approximation_tpu/cli``). Each takes ``--device``; without it
the work runs on the CUDA device and fails on a host without one."""
