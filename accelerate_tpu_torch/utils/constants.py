"""Framework-wide constants: the port's copy of ``accelerate_tpu/utils/constants.py``'s
mesh axis names (the canonical 6-way parallelism decomposition) and checkpoint file
names (the same on-disk naming contract as the JAX package's)."""

DATA_AXIS = "dp"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tp"
SEQUENCE_AXIS = "sp"
PIPELINE_AXIS = "pp"
EXPERT_AXIS = "ep"
MESH_AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQUENCE_AXIS, PIPELINE_AXIS, EXPERT_AXIS)
# Axes over which the global batch is sharded.
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)

MODEL_NAME = "model"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
CUSTOM_OBJECT_NAME = "custom_checkpoint"
SAFE_WEIGHTS_NAME = f"{MODEL_NAME}.safetensors"
SCHEDULER_STATE_NAME = f"{SCHEDULER_NAME}.json"
SAMPLER_STATE_NAME = f"{SAMPLER_NAME}.json"
# The directory that holds each rank's train-state files inside a checkpoint.
SHARDED_STATE_DIR = "sharded_state"
