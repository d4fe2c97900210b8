"""The node agents on the card (port of ``tpu_operator/agents/``).

The four agents that do accelerator work, each a pod on its node:

    autotune_agent          the elected node's generation sweep
    compilecache_agent      the elected node's serving prewarm
    metrics_exporter_agent  HBM and compute probes held to the perf floors
    health_monitor_agent    device nodes, markers and a matmul burst

They read their Node through any client with the reference's verbs
(``tpu_operator_torch/kube.py`` in a cluster).
"""
