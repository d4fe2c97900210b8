"""Workloads of the port: counterparts of ``tpu_operator.workloads``."""
