"""The pod data plane of the port (port of ``tpu_operator/dataplane/``):
the job worker's pod main and the registry a kubelet resolves pod-main
label values against (``worker.py``), and the rendezvous predicate
(``pods.py``)."""
