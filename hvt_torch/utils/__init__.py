"""Run logging and throughput instrumentation."""
