"""Validator operand on the card (port of ``tpu_operator/validator/``).

One entry, the component selected by ``COMPONENT``; a component checks its
piece of the stack and writes a status file under ``/run/tpu/validations``,
the barrier other operands wait on. The port runs the ``plugin``,
``workload``, ``smoke`` and ``slice`` components (``main.py``) and the
workload pod's entry (``workload_entry.py``).
"""

from tpu_operator_torch.validator.main import COMPONENTS, Context, run_component  # noqa: F401
