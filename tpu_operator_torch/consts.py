"""The cluster keys the port's data plane reads and writes (copied from
``tpu_operator/consts.py``, ``api/tpujob.py`` and ``api/tpuslice.py``).

The trainer and the job worker meet the control plane at the job's
progress ConfigMap and read the TPUJob, its TPUSlice and the Nodes. The
values must stay equal to the control plane's; a test holds them so.
"""

TPU_JOB_API_VERSION = "tpu.google.com/v1alpha1"
TPU_JOB_KIND = "TPUJob"
TPU_SLICE_API_VERSION = "tpu.google.com/v1alpha1"
TPU_SLICE_KIND = "TPUSlice"
# the job phases after which the gang does no more work
TERMINAL_PHASES = ("Succeeded", "Failed")

# the job's owned TPUSlice is <job> + JOB_SLICE_SUFFIX; the progress
# ConfigMap is <job> + JOB_PROGRESS_SUFFIX
JOB_SLICE_SUFFIX = "-slice"
JOB_PROGRESS_SUFFIX = "-progress"
# trainer-owned progress keys
JOB_PROGRESS_STEP = "step"                      # last completed train step
JOB_PROGRESS_EPOCH = "checkpointEpoch"          # newest checkpoint epoch
JOB_PROGRESS_CHECKPOINT_STEP = "checkpointStep"  # step that epoch covers
JOB_PROGRESS_WORLD = "world"                    # hosts the trainer is sized for
JOB_PROGRESS_STATUS = "status"                  # running | complete | error
JOB_PROGRESS_ERROR = "error"                    # last trainer error text
JOB_PROGRESS_CHECKPOINT_ACK = "checkpointAck"   # echoes the barrier token
JOB_PROGRESS_RUNNING = "running"
JOB_PROGRESS_COMPLETE = "complete"
JOB_PROGRESS_FAILED = "error"
# controller-owned progress keys: the checkpoint barrier and the restart
# handshake (the trainer echoes each token into its ack key)
JOB_CHECKPOINT_REQUEST = "checkpointRequest"
JOB_RESTART_REQUEST = "restartRequest"
JOB_PROGRESS_RESTART_ACK = "restartAck"
# worker-owned progress keys: rendezvous.<index> = gang hash
JOB_RENDEZVOUS_PREFIX = "rendezvous."

# the worker pod's main, selected by the pod-main label's value
POD_MAIN_JOB_WORKER = "tpu-job-worker"
# the worker env contract (rendered into the pod spec)
WORKER_ENV_JOB_NAME = "TPU_JOB_NAME"
WORKER_ENV_WORKER_INDEX = "TPU_WORKER_INDEX"
WORKER_ENV_WORKER_COUNT = "TPU_WORKER_COUNT"
WORKER_ENV_GANG_HASH = "TPU_GANG_HASH"
WORKER_ENV_CHECKPOINT_DIR = "TPU_CHECKPOINT_DIR"
WORKER_ENV_NAMESPACE = "TPU_NAMESPACE"
WORKER_ENV_STEPS_PER_SYNC = "TPU_STEPS_PER_SYNC"

# node labels that take a host out of service
TPU_HEALTH_LABEL = "tpu.google.com/tpu.health"  # healthy | degraded
HEALTH_DEGRADED = "degraded"
TPU_PERF_LABEL = "tpu.google.com/perf"  # degraded while below floor
PERF_DEGRADED = "degraded"
REPAIR_STATE_LABEL = "tpu.google.com/tpu.repair-state"
