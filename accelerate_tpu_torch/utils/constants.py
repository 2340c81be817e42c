"""Framework-wide constants: the port's copy of the mesh axis names of
``accelerate_tpu/utils/constants.py`` (the canonical 6-way parallelism decomposition)."""

DATA_AXIS = "dp"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tp"
SEQUENCE_AXIS = "sp"
PIPELINE_AXIS = "pp"
EXPERT_AXIS = "ep"
MESH_AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQUENCE_AXIS, PIPELINE_AXIS, EXPERT_AXIS)
# Axes over which the global batch is sharded.
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)
