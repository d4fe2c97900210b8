"""The cluster keys the port's data plane reads and writes (copied from
``tpu_operator/consts.py``, ``api/tpujob.py`` and ``api/tpuslice.py``).

The trainer and the job worker meet the control plane at the job's
progress ConfigMap and read the TPUJob, its TPUSlice and the Nodes; a
serving replica reads its env and the compile cache's ConfigMap; the
autotune sweep's entries go to the results ConfigMap; the node agents
read their Node's labels and elections, publish health and perf verdicts
on it and read the perf floors; the validator polls the node's
allocatable and runs the workload pod. The values must stay equal to the
control plane's; a test holds them so. The keys under "the card's own"
at the end have no counterpart there: they are NVIDIA's.
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
POD_MAIN_SERVING_WORKER = "tpu-serving-worker"
# the worker env contract (rendered into the pod spec)
WORKER_ENV_JOB_NAME = "TPU_JOB_NAME"
WORKER_ENV_WORKER_INDEX = "TPU_WORKER_INDEX"
WORKER_ENV_WORKER_COUNT = "TPU_WORKER_COUNT"
WORKER_ENV_GANG_HASH = "TPU_GANG_HASH"
WORKER_ENV_CHECKPOINT_DIR = "TPU_CHECKPOINT_DIR"
WORKER_ENV_NAMESPACE = "TPU_NAMESPACE"
WORKER_ENV_STEPS_PER_SYNC = "TPU_STEPS_PER_SYNC"
WORKER_ENV_SERVING_NAME = "TPU_SERVING_NAME"
WORKER_ENV_REPLICA_NAME = "TPU_REPLICA_NAME"
WORKER_ENV_POOL = "TPU_POOL"
# compile-cache addressing of a serving replica: its generation and
# topology (shape string)
WORKER_ENV_GENERATION = "TPU_GENERATION"
WORKER_ENV_TOPOLOGY = "TPU_TOPOLOGY"
# a serving replica's pool under disaggregation (no pool: aggregated)
SERVING_POOL_PREFILL = "prefill"
SERVING_POOL_DECODE = "decode"

# the fleet compile cache: one "<generation>.json" record map per
# generation, plus the prewarm handshake's request and ack keys; the
# node-local directory the built kernels live in (env-overridable)
COMPILE_CACHE_CONFIGMAP = "tpu-compile-cache"
COMPILE_PREWARM_REQUEST_KEY = "prewarm-requests.json"
COMPILE_PREWARM_ACK_KEY = "prewarm-acks.json"
COMPILE_CACHE_DIR_ENV = "TPU_COMPILE_CACHE_DIR"
COMPILE_CACHE_DIR_DEFAULT = "/var/cache/tpu-compile"

# the autotune results: "<generation>.json" sweep entries plus the
# merged winners blob
AUTOTUNE_RESULTS_CONFIGMAP = "tpu-autotune-results"
AUTOTUNE_WINNERS_KEY = "winners.json"

# node labels that take a host out of service
TPU_HEALTH_LABEL = "tpu.google.com/tpu.health"  # healthy | degraded
HEALTH_DEGRADED = "degraded"
TPU_PERF_LABEL = "tpu.google.com/perf"  # degraded while below floor
PERF_DEGRADED = "degraded"
REPAIR_STATE_LABEL = "tpu.google.com/tpu.repair-state"

# the node labels the reference's controllers identify a TPU node by: the
# platform's (GKE) and the operator's node-discovery labels
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
TFD_ACCELERATOR_TYPE_LABEL = "tpu.google.com/accelerator-type"
TFD_TOPOLOGY_LABEL = "tpu.google.com/topology"
TFD_CHIPS_PER_NODE_LABEL = "tpu.google.com/chips-per-node"

# the one node per generation the autotune and compile-cache controllers
# elect to sweep or prewarm (the agents' DaemonSets select on it)
AUTOTUNE_ELECTED_LABEL = "tpu.google.com/autotune"
AUTOTUNE_ELECTED = "elected"
COMPILE_CACHE_ELECTED_LABEL = "tpu.google.com/compile-cache"
COMPILE_CACHE_ELECTED = "elected"

# the per-generation perf floors the exporter holds its probes to, and
# the consecutive samples below a floor that make a sustained breach
PERF_FLOORS_CONFIGMAP = "tpu-perf-floors"
PERF_FLOORS_KEY = "floors.json"
PERF_BREACH_SAMPLES = 3

# the health monitor's verdict: the summary label (TPU_HEALTH_LABEL
# above), the per-chip verdict map, the time of the last flip, the node
# condition, and the verdicts file on the host path the device plugin
# reads
HEALTH_HEALTHY = "healthy"
TPU_HEALTH_CHIPS_ANNOTATION = "tpu.google.com/tpu.health.chips"
TPU_HEALTH_SINCE_ANNOTATION = "tpu.google.com/tpu.health.since"
TPU_HEALTH_CONDITION = "TPUHealthy"
HEALTH_DIR = "/run/tpu/health"
HEALTH_VERDICTS_FILE = "verdicts.json"

# validation status files (the barrier other operands wait on) and the
# installer's ready marker on the host install path. The driver installer
# writes the marker, the device plugin serves on the socket under the
# kubelet's device-plugin directory, and the health monitor checks both:
# they keep the reference's names, so the control plane's manifests and
# probes name the same files
PLUGIN_READY_FILE = "plugin-ready"
WORKLOAD_READY_FILE = "workload-ready"
LIBTPU_INSTALL_DIR = "/home/kubernetes/bin/tpu"
LIBTPU_CTR_READY_FILE = ".libtpu-ctr-ready"
KUBELET_SOCKET_DIR = "/var/lib/kubelet/device-plugins"
PLUGIN_SOCKET_NAME = "tpu-device-plugin.sock"

OPERATOR_NAMESPACE_ENV = "OPERATOR_NAMESPACE"
DEFAULT_OPERATOR_NAMESPACE = "tpu-operator"

# the card's own: the extended resource NVIDIA's device plugin advertises
# (the reference's is google.com/tpu), and the GPU feature discovery
# labels for the card's product name and count on the node
GPU_RESOURCE_NAME = "nvidia.com/gpu"
GFD_PRODUCT_LABEL = "nvidia.com/gpu.product"
GFD_COUNT_LABEL = "nvidia.com/gpu.count"
# GFD's memory (MiB) and driver version labels
GFD_MEMORY_LABEL = "nvidia.com/gpu.memory"
GFD_DRIVER_MAJOR_LABEL = "nvidia.com/cuda.driver.major"
GFD_DRIVER_MINOR_LABEL = "nvidia.com/cuda.driver.minor"
GFD_DRIVER_REV_LABEL = "nvidia.com/cuda.driver.rev"
# every label feature discovery publishes (and strips when the cards go)
GFD_LABELS = (GFD_PRODUCT_LABEL, GFD_COUNT_LABEL, GFD_MEMORY_LABEL, GFD_DRIVER_MAJOR_LABEL,
              GFD_DRIVER_MINOR_LABEL, GFD_DRIVER_REV_LABEL)
# Node Feature Discovery's PCI label for a device of NVIDIA's vendor id
# (0x10de): node discovery stamps it where the probe finds cards
NFD_PRESENT_LABEL = "feature.node.kubernetes.io/pci-10de.present"
# the platform's accelerator label on a GKE node with cards: where it is
# set, the platform owns the node's identity (discovery never strips)
GKE_GPU_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
# the driver check's status file (NVIDIA's validator writes the same name)
DRIVER_READY_FILE = "driver-ready"
# the driver library the installer copies into the install dir (its
# soname: the link every workload's loader resolves)
DRIVER_LIBRARY = "libcuda.so.1"
