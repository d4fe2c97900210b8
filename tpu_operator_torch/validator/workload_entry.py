"""In-pod entry of the workload-validation pod: the vectorAdd analog (port
of ``tpu_operator/validator/workload_entry.py``).

Runs the device smoke on every local card and prints its report as one
JSON line; exit 0 marks the node's stack usable end to end:

    python -m tpu_operator_torch.validator.workload_entry

``EXPECTED_CHIPS`` (optional) is the least number of cards it must see.
The pod's ``MIN_TFLOPS`` is not read here, as in the reference: the rate
floor is the ``smoke`` component's (``main.validate_smoke``).
"""

import json
import os

from tpu_operator_torch.device import DeviceLike
from tpu_operator_torch.workloads.smoke import run_smoke


def main(device: DeviceLike = None) -> int:
    expected = os.environ.get("EXPECTED_CHIPS")
    report = run_smoke(expected_devices=int(expected) if expected else None, device=device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
